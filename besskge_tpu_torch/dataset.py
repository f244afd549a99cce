"""Knowledge-graph datasets as collections of (head, relation, tail) triples.

Host-side numpy, copied from ``besskge_tpu/dataset.py`` so that the port
never imports the JAX package: the :class:`KGDataset` fields, its
``from_triples`` random split and its pickle files, which either package
loads from the other. ``from_dataframe`` and the dataset builders (OGB,
YAGO3-10, OpenBioLink) are not ported yet (ROADMAP A14).
"""

from __future__ import annotations

import dataclasses
import io
import pickle
from pathlib import Path
from typing import Dict, List, Optional, Tuple

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
