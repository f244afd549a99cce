"""The port's ``KGDataset.from_dataframe`` and dataset builders against the
JAX package's, on the same mocked sources.

No download: the OGB API is faked in ``sys.modules`` and the file-based
builders read tiny files written to a temporary directory, as
``tests/test_dataset_builders.py`` does. Each builder of either package runs
on the same source, and every field of the two datasets must be equal:
integer arrays bit for bit (dtypes included), labels and type offsets
equal.
"""

import sys
import types

import numpy as np
import pandas as pd
import pytest

from besskge_tpu.dataset import KGDataset as JaxKGDataset
from besskge_tpu_torch.dataset import KGDataset as PortKGDataset

FIELDS = ("n_entity", "n_relation_type", "triples", "original_triple_ids", "entity_dict",
          "relation_dict", "type_offsets", "neg_heads", "neg_tails")


def _same(got, want):
    assert isinstance(got, PortKGDataset) and isinstance(want, JaxKGDataset)
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(w, dict) and w and isinstance(next(iter(w.values())), np.ndarray):
            assert g.keys() == w.keys(), name
            for part in w:
                assert g[part].dtype == w[part].dtype, (name, part)
                np.testing.assert_array_equal(g[part], w[part], err_msg=f"{name}[{part}]")
        else:
            assert g == w, name
    ht_g, ht_w = got.ht_types, want.ht_types
    assert (ht_g is None) == (ht_w is None)
    for part in ht_w or {}:
        np.testing.assert_array_equal(ht_g[part], ht_w[part])


def _install_fake_ogb(monkeypatch, dataset_cls):
    linkproppred = types.ModuleType("ogb.linkproppred")
    linkproppred.LinkPropPredDataset = dataset_cls
    ogb = types.ModuleType("ogb")
    ogb.linkproppred = linkproppred
    monkeypatch.setitem(sys.modules, "ogb", ogb)
    monkeypatch.setitem(sys.modules, "ogb.linkproppred", linkproppred)


_BIOKG_COUNTS = {"disease": 4, "drug": 3, "protein": 5}


class _FakeBioKG:
    def __init__(self, name, root):
        assert name == "ogbl-biokg"

    def __getitem__(self, i):
        return {"edge_reltype": {"treats": None, "binds": None},
                "num_nodes_dict": dict(_BIOKG_COUNTS)}

    def get_edge_split(self):
        rng = np.random.default_rng(0)
        types_ = np.array(list(_BIOKG_COUNTS))

        def part(n, negatives):
            ht = types_[rng.integers(3, size=n)], types_[rng.integers(3, size=n)]
            out = {
                "head_type": ht[0], "tail_type": ht[1],
                "head": np.array([rng.integers(_BIOKG_COUNTS[t]) for t in ht[0]]),
                "tail": np.array([rng.integers(_BIOKG_COUNTS[t]) for t in ht[1]]),
                "relation": rng.integers(2, size=n),
            }
            if negatives:
                out["head_neg"] = rng.integers(3, size=(n, 4))
                out["tail_neg"] = rng.integers(3, size=(n, 4))
            return out

        return {"train": part(20, False), "valid": part(6, True), "test": part(5, True)}


def test_build_ogbl_biokg_matches_jax(tmp_path, monkeypatch):
    _install_fake_ogb(monkeypatch, _FakeBioKG)
    mdir = tmp_path / "ogbl_biokg/mapping"
    mdir.mkdir(parents=True)
    for k, n in _BIOKG_COUNTS.items():
        pd.DataFrame({"ent idx": np.arange(n)[::-1], "ent name": [f"{k}_{i}" for i in range(n)][::-1]}
                     ).to_csv(mdir / f"{k}_entidx2name.csv.gz", index=False, compression="gzip")
    pd.DataFrame({"rel idx": [1, 0], "rel name": ["binds", "treats"]}).to_csv(
        mdir / "relidx2relname.csv.gz", index=False, compression="gzip")
    want = JaxKGDataset.build_ogbl_biokg(tmp_path)
    got = PortKGDataset.build_ogbl_biokg(tmp_path)
    _same(got, want)
    assert got.type_offsets == {"disease": 0, "drug": 4, "protein": 7}
    assert got.relation_dict == ["treats", "binds"] and got.entity_dict[4] == "drug_0"
    assert got.neg_heads["valid"].shape == (6, 4) and "train" not in got.neg_tails


class _FakeWikiKG2:
    graph = {"num_nodes": 30}

    def __init__(self, name, root):
        assert name == "ogbl-wikikg2"

    def get_edge_split(self):
        rng = np.random.default_rng(1)

        def part(n, negatives):
            out = {"head": rng.integers(30, size=n), "relation": rng.integers(4, size=n),
                   "tail": rng.integers(30, size=n)}
            if negatives:
                out["head_neg"] = rng.integers(30, size=(n, 5))
                out["tail_neg"] = rng.integers(30, size=(n, 5))
            return out

        return {"train": part(40, False), "valid": part(7, True), "test": part(6, True)}


def test_build_ogbl_wikikg2_matches_jax(tmp_path, monkeypatch):
    _install_fake_ogb(monkeypatch, _FakeWikiKG2)
    mdir = tmp_path / "ogbl_wikikg2/mapping"
    mdir.mkdir(parents=True)
    pd.DataFrame({"node idx": np.arange(30), "entity id": [f"Q{i}" for i in range(30)]}).to_csv(
        mdir / "nodeidx2entityid.csv.gz", index=False, compression="gzip")
    pd.DataFrame({"reltype": np.arange(4), "rel id": [f"P{i}" for i in range(4)]}).to_csv(
        mdir / "reltype2relid.csv.gz", index=False, compression="gzip")
    want = JaxKGDataset.build_ogbl_wikikg2(tmp_path)
    got = PortKGDataset.build_ogbl_wikikg2(tmp_path)
    _same(got, want)
    assert got.n_entity == 30 and got.type_offsets is None


def test_build_yago310_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    names = [f"e{i}" for i in range(25)]
    rels = ["knows", "likes", "isIn"]
    for part, n in (("train", 60), ("valid", 8), ("test", 8)):
        rows = [(names[rng.integers(25)], rels[rng.integers(3)], names[rng.integers(25)])
                for _ in range(n)]
        (tmp_path / f"{part}.txt").write_text("\n".join("\t".join(r) for r in rows) + "\n")
    want = JaxKGDataset.build_yago310(tmp_path)
    got = PortKGDataset.build_yago310(tmp_path)
    _same(got, want)
    assert set(got.triples) == {"train", "valid", "test"} and got.n_relation_type == 3


def test_build_openbiolink_matches_jax(tmp_path):
    base = tmp_path / "HQ_DIR/train_test_data"
    base.mkdir(parents=True)
    rng = np.random.default_rng(3)
    ents = {f"d{i}": "drug" for i in range(6)} | {f"g{i}": "gene" for i in range(7)} | \
        {f"p{i}": "pheno" for i in range(4)}
    labels = list(ents)
    for fname, n in (("train_sample.csv", 50), ("val_sample.csv", 6), ("test_sample.csv", 6)):
        rows = [(labels[rng.integers(len(labels))], ("TREATS", "REG")[rng.integers(2)],
                 labels[rng.integers(len(labels))]) for _ in range(n)]
        (base / fname).write_text(
            "\n".join("\t".join((h, r, t, "HQ", "TP", "src")) for h, r, t in rows) + "\n")
    (base / "train_val_nodes.csv").write_text("".join(f"{e}\t{t}\n" for e, t in ents.items()))
    want = JaxKGDataset.build_openbiolink(tmp_path)
    got = PortKGDataset.build_openbiolink(tmp_path)
    _same(got, want)
    assert set(got.type_offsets) <= {"drug", "gene", "pheno"}


@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("split", ["random", "fixed"])
def test_from_dataframe_matches_jax(split, typed):
    """One DataFrame (a random split, through ``from_triples``) or a dict of
    parts, with column names or positions, with and without entity types."""
    rng = np.random.default_rng(4)
    ents = [f"n{i}" for i in range(40)]
    frame = pd.DataFrame({"h": [ents[i] for i in rng.integers(40, size=120)],
                          "r": [f"r{i}" for i in rng.integers(6, size=120)],
                          "t": [ents[i] for i in rng.integers(40, size=120)]})
    entity_types = pd.Series({e: ("a", "b", "c")[i % 3] for i, e in enumerate(ents)}) \
        if typed else None
    if split == "random":
        args = (frame, "h", "r", "t", entity_types, (0.6, 0.2, 0.2), 7)
    else:
        parts = {"train": frame.iloc[:90], "valid": frame.iloc[90:105], "test": frame.iloc[105:]}
        parts = {k: v.set_axis([0, 1, 2], axis=1) for k, v in parts.items()}
        args = (parts, 0, 1, 2, entity_types)
    want = JaxKGDataset.from_dataframe(*args)
    got = PortKGDataset.from_dataframe(*args)
    _same(got, want)
    assert (got.type_offsets is not None) == typed


def test_builders_import_no_download_module(tmp_path, monkeypatch):
    """With the files in place, the file builders never import ``requests``."""
    monkeypatch.setitem(sys.modules, "requests", None)  # any import raises
    for part in ("train", "valid", "test"):
        (tmp_path / f"{part}.txt").write_text("a\tr\tb\nb\tr\tc\n")
    ds = PortKGDataset.build_yago310(tmp_path)
    assert ds.n_entity == 3
