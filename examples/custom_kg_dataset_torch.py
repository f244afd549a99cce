"""Build a BESS ``KGDataset`` from your own dataframes with the PyTorch/CUDA
port (the twin of ``examples/custom_kg_dataset.py``).

Walks the reference notebook's path without the OGB download: start from
dataframes of string-labelled (head, relation, tail) edges plus an
entity→type map, and produce a type-contiguous, ID-mapped, split
``KGDataset`` (:class:`besskge_tpu_torch.dataset.KGDataset`, host numpy and
pandas):

1. per-split dataframes → :meth:`KGDataset.from_dataframe` (dict input);
2. inspect the derived attributes (``entity_dict``, ``type_offsets``,
   ``ht_types``) and verify an ID round-trip against the original labels;
3. single merged dataframe + random 80/10/10 split;
4. save / reload round trip (the file loads into either package).

Host only, with no kernel, and it needs pandas, which the card's machine
does not have: it runs in the CPU tests (``tests/test_torch_examples.py``)
and wherever pandas is installed. ``main(argv)`` returns the dataset.

Run:  python examples/custom_kg_dataset_torch.py
"""

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def make_raw_edges(seed: int = 0):
    """A toy typed KG in the reference notebook's 'generic starting point'
    shape: string-labelled edges plus an entity-type table."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    types = {
        "gene": [f"G{i:03d}" for i in range(120)],
        "drug": [f"D{i:03d}" for i in range(60)],
        "disease": [f"X{i:03d}" for i in range(40)],
    }
    relations = [
        ("targets", "drug", "gene"),
        ("interacts", "gene", "gene"),
        ("treats", "drug", "disease"),
        ("associated", "gene", "disease"),
    ]
    rows = []
    for rel, ht, tt in relations:
        n = rng.integers(300, 500)
        rows.append(pd.DataFrame({
            "head_label": rng.choice(types[ht], size=n),
            "relation_label": rel,
            "tail_label": rng.choice(types[tt], size=n),
        }))
    edges = pd.concat(rows, ignore_index=True).drop_duplicates()
    entity_types = pd.Series({lab: ty for ty, labs in types.items() for lab in labs},
                             name="ent_type")
    return edges, entity_types


def main(argv=None):
    argparse.ArgumentParser().parse_args(argv)
    import pandas as pd

    from besskge_tpu_torch.dataset import KGDataset

    edges, entity_types = make_raw_edges()
    print(f"raw edges: {len(edges)} rows, e.g.\n{edges.head(3)}\n")

    # ------- 1. pre-split dataframes -> KGDataset ----------------------------
    rng = np.random.default_rng(1)
    part = rng.choice(3, p=[0.8, 0.1, 0.1], size=len(edges))
    df_dict = {
        name: edges[part == i].reset_index(drop=True)
        for i, name in enumerate(("train", "valid", "test"))
    }
    kg = KGDataset.from_dataframe(
        df_dict, head_column="head_label", relation_column="relation_label",
        tail_column="tail_label", entity_types=entity_types,
    )
    print(f"entities: {kg.n_entity}, relation types: {kg.n_relation_type}")
    print(f"type_offsets: {kg.type_offsets}")
    print(f"splits: { {k: len(v) for k, v in kg.triples.items()} }")

    # ------ 2. ID round-trip against the original labels ---------------------
    t = kg.triples["test"][5]
    h_lab, t_lab = kg.entity_dict[t[0]], kg.entity_dict[t[2]]
    r_lab = kg.relation_dict[t[1]]
    orig = df_dict["test"].iloc[5]
    assert (h_lab, r_lab, t_lab) == (
        orig["head_label"], orig["relation_label"], orig["tail_label"]
    ), "ID mapping must invert to the original labels"
    print(f"round-trip check: triple 5 of test = ({h_lab}, {r_lab}, {t_lab}) OK")

    # IDs are type-contiguous: every entity ID in [off_ty, off_ty+1) belongs
    # to type ty.
    off = sorted(kg.type_offsets.items(), key=lambda kv: kv[1])
    for (ty, lo), hi in zip(off, [o for _, o in off[1:]] + [kg.n_entity]):
        labs = kg.entity_dict[lo:hi]
        assert all(entity_types[lab] == ty for lab in labs)
    print("type-contiguity check: OK")
    print(f"ht_types['train'][:3] =\n{kg.ht_types['train'][:3]}")

    # ------- 3. single dataframe + random split ------------------------------
    kg2 = KGDataset.from_dataframe(
        pd.concat(df_dict.values(), ignore_index=True),
        head_column="head_label", relation_column="relation_label",
        tail_column="tail_label", entity_types=entity_types, split=(0.8, 0.1, 0.1), seed=42,
    )
    print(f"random split: { {k: len(v) for k, v in kg2.triples.items()} }")

    # ------- 4. save / reload -------------------------------------------------
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "toy_kg.pkl"
        kg.save(path)
        reloaded = KGDataset.load(path)
    assert reloaded.n_entity == kg.n_entity
    np.testing.assert_array_equal(reloaded.triples["train"], kg.triples["train"])
    print("save/load round trip: OK")
    return kg


if __name__ == "__main__":
    main()
