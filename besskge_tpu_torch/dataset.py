"""Knowledge-graph datasets as collections of (head, relation, tail) triples.

Host-side numpy and pandas, copied from ``besskge_tpu/dataset.py`` so that
the port never imports the JAX package: the :class:`KGDataset` fields, its
``from_triples`` random split and ``from_dataframe``, the builders of
ogbl-biokg, ogbl-wikikg2, YAGO3-10 and OpenBioLink-HQ, and its pickle files,
which either package loads from the other. pandas, ``ogb`` and ``requests``
are imported only inside the methods that need them (``requests`` only to
download missing files), so that the rest of the port needs none of them.
"""

from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
from numpy.typing import NDArray

__all__ = ["KGDataset"]

#: Where a pickled KGDataset names its class: the JAX package's module, so
#: that a file of either package loads into the other.
_PICKLED_AS = ("besskge_tpu.dataset", "KGDataset")


@dataclasses.dataclass
class KGDataset:
    """A complete KG dataset: triples, optional labels, types and negatives."""

    #: Number of entities (nodes).
    n_entity: int
    #: Number of relation types (edge labels).
    n_relation_type: int
    #: {part: int32[n_triple, 3]} — (h, r, t) triples per dataset split.
    triples: Dict[str, NDArray[np.int32]]
    #: {part: int64[n_triple]} — position of each triple in the source data.
    original_triple_ids: Dict[str, NDArray[np.int64]]
    #: Entity labels by ID.
    entity_dict: Optional[List[str]] = None
    #: Relation labels by ID.
    relation_dict: Optional[List[str]] = None
    #: {type_label: first_global_id} — types own contiguous ID ranges.
    type_offsets: Optional[Dict[str, int]] = None
    #: {part: int32[n_triple or 1, n_neg]} — predefined negative heads.
    neg_heads: Optional[Dict[str, NDArray[np.int32]]] = None
    #: {part: int32[n_triple or 1, n_neg]} — predefined negative tails.
    neg_tails: Optional[Dict[str, NDArray[np.int32]]] = None

    @property
    def ht_types(self) -> Optional[Dict[str, NDArray[np.int32]]]:
        """Per-part type IDs of triple heads/tails; ``int32[n_triple, 2]``."""
        if not self.type_offsets:
            return None
        bins = np.fromiter(self.type_offsets.values(), dtype=np.int32)
        return {
            part: (np.digitize(tri[:, [0, 2]], bins) - 1).astype(np.int32)
            for part, tri in self.triples.items()
        }

    @classmethod
    def from_triples(
        cls,
        data: NDArray[np.int32],
        split: Tuple[float, float, float] = (0.7, 0.15, 0.15),
        seed: int = 1234,
        entity_dict: Optional[List[str]] = None,
        relation_dict: Optional[List[str]] = None,
        type_offsets: Optional[Dict[str, int]] = None,
    ) -> "KGDataset":
        """Random train/valid/test split of a pre-ID'd triple array.

        Entities of the same type must already have contiguous IDs when
        ``type_offsets`` is given.
        """
        n = data.shape[0]
        n_train = int(n * split[0])
        n_valid = int(n * split[1])
        perm = np.random.default_rng(seed).permutation(n)
        ids = {
            "train": perm[:n_train],
            "valid": perm[n_train : n_train + n_valid],
            "test": perm[n_train + n_valid :],
        }
        return cls(
            n_entity=int(data[:, [0, 2]].max()) + 1,
            n_relation_type=int(data[:, 1].max()) + 1,
            triples={k: data[v] for k, v in ids.items()},
            original_triple_ids=ids,
            entity_dict=entity_dict,
            relation_dict=relation_dict,
            type_offsets=type_offsets,
        )

    @classmethod
    def from_dataframe(
        cls,
        df,
        head_column: Union[int, str],
        relation_column: Union[int, str],
        tail_column: Union[int, str],
        entity_types=None,
        split: Tuple[float, float, float] = (0.7, 0.15, 0.15),
        seed: int = 1234,
    ) -> "KGDataset":
        """Build from labeled triples in pandas DataFrame(s).

        ``df`` is either one DataFrame (random split) or a dict of part-name
        -> DataFrame (fixed split). IDs are assigned so that entities of the
        same type (per ``entity_types``: label -> type string) are contiguous.
        """
        import pandas as pd

        df_dict = {"all": df} if isinstance(df, pd.DataFrame) else df
        unique_ent = pd.concat(
            [pd.concat([d[head_column], d[tail_column]]) for d in df_dict.values()]
        ).unique()
        ent2id = pd.Series(np.arange(len(unique_ent)), index=unique_ent)
        unique_rel = pd.concat([d[relation_column] for d in df_dict.values()]).unique()
        rel2id = pd.Series(np.arange(len(unique_rel)), index=unique_rel)

        type_offsets = None
        if entity_types is not None:
            ent2type = pd.Series(entity_types, name="ent_type")
            merged = pd.merge(
                ent2id.rename("ent_id"),
                ent2type,
                how="left",
                left_index=True,
                right_index=True,
            ).sort_values("ent_type")
            # Reassign IDs in type order so each type owns a contiguous range.
            ent2id = pd.Series(np.arange(len(merged)), index=merged.index)
            counts = merged.groupby("ent_type")["ent_type"].count()
            offs = counts.cumsum().shift(1).fillna(0).astype("int64")
            type_offsets = offs.to_dict()

        triples = {}
        for part, d in df_dict.items():
            h = d[head_column].map(ent2id).values.astype(np.int32)
            r = d[relation_column].map(rel2id).values.astype(np.int32)
            t = d[tail_column].map(ent2id).values.astype(np.int32)
            triples[part] = np.stack([h, r, t], axis=1)

        entity_dict = ent2id.index.tolist()
        relation_dict = rel2id.index.tolist()
        if isinstance(df, pd.DataFrame):
            return cls.from_triples(
                triples["all"], split, seed, entity_dict, relation_dict, type_offsets
            )
        return cls(
            n_entity=len(entity_dict),
            n_relation_type=len(relation_dict),
            triples=triples,
            original_triple_ids={
                k: np.arange(v.shape[0]) for k, v in triples.items()
            },
            entity_dict=entity_dict,
            relation_dict=relation_dict,
            type_offsets=type_offsets,
        )

    @classmethod
    def build_ogbl_biokg(cls, root: Path) -> "KGDataset":
        """ogbl-biokg (5 entity types, official valid/test negatives).

        Per-type local IDs from OGB are converted to global IDs via the type
        offsets; official ``head_neg``/``tail_neg`` candidate sets are kept.
        """
        import ogb.linkproppred
        import pandas as pd

        dataset = ogb.linkproppred.LinkPropPredDataset(name="ogbl-biokg", root=root)
        split_edge = dataset.get_edge_split()
        n_relation_type = len(dataset[0]["edge_reltype"].keys())
        type_counts = dataset[0]["num_nodes_dict"]
        offs = np.concatenate(
            ([0], np.cumsum(np.fromiter(type_counts.values(), dtype=int)))
        )
        n_entity = int(offs[-1])
        type_offsets = dict(zip(type_counts.keys(), offs))

        triples, neg_heads, neg_tails = {}, {}, {}
        for part, hrt in split_edge.items():
            h_lab, h_idx = np.unique(hrt["head_type"], return_inverse=True)
            t_lab, t_idx = np.unique(hrt["tail_type"], return_inverse=True)
            h_off = np.array([type_offsets[k] for k in h_lab])
            t_off = np.array([type_offsets[k] for k in t_lab])
            head = hrt["head"] + h_off[h_idx]
            tail = hrt["tail"] + t_off[t_idx]
            triples[part] = np.stack([head, hrt["relation"], tail], axis=-1)
            if part != "train":
                neg_heads[part] = hrt["head_neg"] + h_off[h_idx][:, None]
                neg_tails[part] = hrt["tail_neg"] + t_off[t_idx][:, None]

        ent_dict: List[str] = []
        for k in type_offsets:
            ent_dict.extend(
                pd.read_csv(Path(root) / f"ogbl_biokg/mapping/{k}_entidx2name.csv.gz")
                .sort_values("ent idx")["ent name"]
                .tolist()
            )
        rel_dict = (
            pd.read_csv(Path(root) / "ogbl_biokg/mapping/relidx2relname.csv.gz")
            .sort_values("rel idx")["rel name"]
            .tolist()
        )
        return cls(
            n_entity=n_entity,
            n_relation_type=n_relation_type,
            triples=triples,
            original_triple_ids={k: np.arange(v.shape[0]) for k, v in triples.items()},
            entity_dict=ent_dict,
            relation_dict=rel_dict,
            type_offsets=type_offsets,
            neg_heads=neg_heads,
            neg_tails=neg_tails,
        )

    @classmethod
    def build_ogbl_wikikg2(cls, root: Path) -> "KGDataset":
        """ogbl-wikikg2 (2.5M entities, official valid/test negatives)."""
        import ogb.linkproppred
        import pandas as pd

        dataset = ogb.linkproppred.LinkPropPredDataset(name="ogbl-wikikg2", root=root)
        split_data = dataset.get_edge_split()
        triples, neg_heads, neg_tails = {}, {}, {}
        for part, hrt in split_data.items():
            triples[part] = np.stack(
                [hrt["head"], hrt["relation"], hrt["tail"]], axis=-1
            )
            if part != "train":
                neg_heads[part] = hrt["head_neg"]
                neg_tails[part] = hrt["tail_neg"]
        ent_dict = (
            pd.read_csv(Path(root) / "ogbl_wikikg2/mapping/nodeidx2entityid.csv.gz")
            .sort_values("node idx")["entity id"]
            .tolist()
        )
        rel_dict = (
            pd.read_csv(Path(root) / "ogbl_wikikg2/mapping/reltype2relid.csv.gz")
            .sort_values("reltype")["rel id"]
            .tolist()
        )
        return cls(
            n_entity=dataset.graph["num_nodes"],
            n_relation_type=int(split_data["train"]["relation"].max()) + 1,
            triples=triples,
            original_triple_ids={k: np.arange(v.shape[0]) for k, v in triples.items()},
            entity_dict=ent_dict,
            relation_dict=rel_dict,
            neg_heads=neg_heads,
            neg_tails=neg_tails,
        )

    @classmethod
    def build_yago310(cls, root: Path) -> "KGDataset":
        """YAGO3-10: entities of YAGO3 with >= 10 relations."""
        import tarfile
        from io import BytesIO

        import pandas as pd

        root = Path(root)
        files = [root / f"{p}.txt" for p in ("train", "valid", "test")]
        if not all(f.is_file() for f in files):
            import requests

            res = requests.get(
                url="https://github.com/TimDettmers/ConvE/raw/master/YAGO3-10.tar.gz"
            )
            with tarfile.open(fileobj=BytesIO(res.content)) as tarf:
                tarf.extractall(path=root)
        parts = {
            p: pd.read_csv(root / f"{p}.txt", delimiter="\t", dtype=str, header=None)
            for p in ("train", "valid", "test")
        }
        return cls.from_dataframe(
            parts, head_column=0, relation_column=1, tail_column=2
        )

    @classmethod
    def build_openbiolink(cls, root: Path) -> "KGDataset":
        """OpenBioLink2020 high-quality benchmark (typed entities)."""
        import zipfile
        from io import BytesIO

        import pandas as pd

        root = Path(root)
        base = root / "HQ_DIR/train_test_data"
        needed = ["train_sample.csv", "val_sample.csv", "test_sample.csv",
                  "train_val_nodes.csv"]
        if not all((base / f).is_file() for f in needed):
            import requests

            res = requests.get(url="https://zenodo.org/record/3834052/files/HQ_DIR.zip")
            with zipfile.ZipFile(BytesIO(res.content)) as zf:
                zf.extractall(path=root)
        cols = ["h_label", "r_label", "t_label", "quality", "TP/TN", "source"]
        parts = {
            part: pd.read_csv(base / fname, header=None, names=cols, sep="\t")
            for part, fname in (
                ("train", "train_sample.csv"),
                ("valid", "val_sample.csv"),
                ("test", "test_sample.csv"),
            )
        }
        entity_types = (
            pd.read_csv(
                base / "train_val_nodes.csv",
                header=None,
                names=["ent_label", "ent_type"],
                sep="\t",
            )
            .set_index("ent_label")["ent_type"]
        )
        return cls.from_dataframe(
            parts,
            head_column="h_label",
            relation_column="r_label",
            tail_column="t_label",
            entity_types=entity_types,
        )

    def save(self, out_file: Path) -> None:
        """Pickle to disk, under the JAX package's class name: the file is
        the JAX package's ``KGDataset.save`` file of the same dataset, and
        loads into either package. The stream is written at protocol 3, whose
        class reference is one text opcode at the start, naming this class's
        module; that name is replaced by the JAX package's (pickle would
        import a module to write its name, and the port never imports the
        JAX package)."""
        ours = f"c{__name__}\n{type(self).__qualname__}\n".encode()
        theirs = "c{}\n{}\n".format(*_PICKLED_AS).encode()
        data = memoryview(pickle.dumps(self, protocol=3))
        head = len(pickle.PROTO) + 1
        if bytes(data[head:head + len(ours)]) != ours:
            raise AssertionError("unexpected start of a KGDataset pickle")
        with open(out_file, "wb") as f:
            f.write(data[:head])
            f.write(theirs)
            f.write(data[head + len(ours):])

    @classmethod
    def load(cls, path: Path) -> "KGDataset":
        """Load a dataset saved with :meth:`save` by either package; the
        JAX package's class name resolves to this class, without importing
        the JAX package."""
        with open(path, "rb") as f:
            ds = _Unpickler(f).load()
        if not isinstance(ds, KGDataset):
            raise ValueError(f"File at {path} is not a KGDataset")
        return ds


class _Unpickler(pickle.Unpickler):
    """Resolves the JAX package's ``KGDataset`` to the port's."""

    def find_class(self, module: str, name: str):
        if (module, name) in (_PICKLED_AS, (__name__, "KGDataset")):
            return KGDataset
        return super().find_class(module, name)
