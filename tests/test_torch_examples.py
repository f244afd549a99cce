"""The port's twins of ``examples/*.py`` (``examples/*_torch.py``), on the
CPU at a tiny scale.

Each twin's ``main([...])`` runs with ``--cpu`` and prints the JAX
script's lines and, where the JAX script ends with a JSON line, one with the
same keys, and a finite MRR. An AST scan holds each twin's ``add_argument``
flags and literal defaults equal to its JAX script's, less the deviations
listed here (each named in the twin's docstring), and its imports to the
port. ``train_and_evaluate_torch.py`` also runs over two gloo ranks, the
``torchrun`` path. The schedules the twins use are held to ``optax``'s.
"""

import ast
import importlib
import json
import math
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

from besskge_tpu_torch import schedules
from besskge_tpu_torch.parallel.multihost import _spawn

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
TWINS = ["biokg_parity", "wikikg2_parity", "wikikg2_oracle_vsall", "wikikg2_independent_control",
         "train_and_evaluate", "yago_topk_prediction", "wikikg2_bf16", "custom_kg_dataset"]
#: Flags a twin adds to its JAX script's (the JAX train_and_evaluate.py
#: takes none).
ADDED_FLAGS = {"train_and_evaluate": {"--epochs", "--cpu"}}
#: Root modules a twin may import: the standard library's, numpy, torch,
#: pandas (custom_kg_dataset only) and the port.
ALLOWED_ROOTS = {"argparse", "json", "os", "sys", "tempfile", "time", "pathlib", "numpy",
                 "torch", "pandas", "besskge_tpu_torch"}


def _twin(name):
    if str(EXAMPLES) not in sys.path:
        sys.path.insert(0, str(EXAMPLES))
    return importlib.import_module(f"{name}_torch")


def _arguments(path):
    """{flag: literal default or None} of every ``add_argument`` call."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            flag = node.args[0].value
            default = next((kw.value for kw in node.keywords if kw.arg == "default"), None)
            out[flag] = ast.literal_eval(default) if default is not None else None
    return out


def _json_keys(path):
    """Keys of the dict literal passed to ``json.dumps``, or None."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps" \
                and isinstance(node.args[0], ast.Dict):
            return [k.value for k in node.args[0].keys]
    return None


@pytest.mark.parametrize("name", TWINS)
def test_twin_keeps_the_flags_and_imports_only_the_port(name):
    ref = _arguments(EXAMPLES / f"{name}.py")
    got = _arguments(EXAMPLES / f"{name}_torch.py")
    extra = ADDED_FLAGS.get(name, set())
    assert set(got) - set(ref) == extra, name
    assert set(ref) <= set(got), name
    for flag, default in ref.items():
        assert got[flag] == default, (name, flag)
    roots = set()
    for node in ast.walk(ast.parse((EXAMPLES / f"{name}_torch.py").read_text())):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert roots <= ALLOWED_ROOTS, (name, roots - ALLOWED_ROOTS)
    assert "pandas" not in roots or name == "custom_kg_dataset"


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def _lines_start(out, *starts):
    lines = [line.strip() for line in out.splitlines()]
    for start in starts:
        assert any(line.startswith(start) for line in lines), (start, out[-2000:])


def test_biokg_parity_twin(capsys, monkeypatch, tmp_path):
    twin = _twin("biokg_parity")
    monkeypatch.setattr(twin, "CACHE_DIR", tmp_path)
    got = twin.main(["--scale", "0.002", "--epochs", "1", "--bps", "2", "--cpu",
                     "--eval-triples", "120", "--oracle-sample", "120"])
    out = capsys.readouterr().out
    _lines_start(out, "fixture: 2510 entities", "train: ", "valid (240 queries",
                 "planted-oracle MRR (120 triples)")
    line = _last_json(out)
    assert list(line) == _json_keys(EXAMPLES / "biokg_parity.py") and line == got
    assert line["metric"] == "biokg_fixture_valid_mrr" and math.isfinite(line["value"])
    assert line["oracle_mrr"] > 0.5
    assert len(list(tmp_path.iterdir())) == 1  # the cache, in the port's own directory


@pytest.mark.parametrize("packed", ["bf16", "fp16"])
def test_wikikg2_parity_twin(capsys, monkeypatch, packed):
    """Also: no gather of the packed table runs under vmap (a halfword view
    has no batching rule in the card's torch 2.11: the validation of this
    twin died there until ``bess._device_step`` gathered before its vmap)."""
    from besskge_tpu_torch import bess

    take = bess.take_rows

    def unbatched_take(table, idx, *args, **kw):
        assert not torch._C._functorch.is_batchedtensor(idx), "take_rows under vmap"
        return take(table, idx, *args, **kw)

    monkeypatch.setattr(bess, "take_rows", unbatched_take)
    got = _twin("wikikg2_parity").main([
        "--scale", "0.002", "--epochs", "1", "--cpu", "--vs-all", "128", "--eval-triples", "200",
        "--oracle-sample", "200", "--packed-dtype", packed])
    out = capsys.readouterr().out
    _lines_start(out, "fixture: 5001 entities", "train: 8 steps", "valid (400 queries",
                 "planted-oracle ceiling", "vs-ALL-entities (128 queries x 5001 entities")
    line = _last_json(out)
    assert line == got and line["packed_dtype"] == packed
    assert all(math.isfinite(v) for v in (line["value"], line["vs_all"]["mrr"]))


def test_wikikg2_oracle_vsall_twin(capsys):
    got = _twin("wikikg2_oracle_vsall").main(["--scale", "0.002", "--vs-all", "128", "--cpu"])
    out = capsys.readouterr().out
    _lines_start(out, "fixture: 5001 entities", "ORACLE vs-ALL (128 queries x 5001 entities")
    assert _last_json(out) == got and got["queries"] == 128
    assert 0.02 < got["value"] <= 1 and got["oracle_500_mrr"] > 0.2


def test_wikikg2_independent_control_twin(capsys):
    got = _twin("wikikg2_independent_control").main([
        "--scale", "0.002", "--epochs", "1", "--cpu", "--eval-triples", "200"])
    out = capsys.readouterr().out
    _lines_start(out, "fixture: 5001 entities", "training: 1 epochs", "epoch 0: loss/triple",
                 "independent control: valid MRR")
    assert _last_json(out) == got and 0 < got["value"] <= 1


def test_train_and_evaluate_twin(capsys):
    got = _twin("train_and_evaluate").main(["--cpu", "--epochs", "2"])
    out = capsys.readouterr().out
    _lines_start(out, "train: 134 steps", "valid vs 64 candidates", "test top-10 vs ALL entities",
                 "test filtered (train triples masked)",
                 "resharded checkpoint to 1 device: table (500, 128), step 134")
    assert _last_json(out) == got and got["shards"] == 1
    assert all(math.isfinite(got[k]) for k in ("value", "valid_mrr", "topk_mrr"))


def test_train_and_evaluate_twin_over_two_ranks():
    """The ``torchrun`` path: the twin's ``main`` on two gloo ranks (the
    process group up, so one shard each); every rank reports the same
    global metrics and reshards the checkpoint the ranks wrote."""
    twin = _twin("train_and_evaluate")
    ranks = _spawn(twin.main, 2, (["--cpu", "--epochs", "1"],), timeout=120.0)
    assert ranks[0] == ranks[1]
    assert ranks[0]["shards"] == 2 and ranks[0]["resharded_table"] == [500, 128]
    assert math.isfinite(ranks[0]["value"])


def test_yago_twin(capsys):
    got = _twin("yago_topk_prediction").main([
        "--cpu", "--entities", "400", "--triples", "6000", "--epochs", "2", "--eval-queries", "64"])
    out = capsys.readouterr().out
    _lines_start(out, "dataset: 400 entities", "epoch 0:", "train: ", "top-10 inference over 64",
                 "re-sharded 1 -> 2 -> 1 shards", "re-sharding parity: OK")
    assert math.isfinite(got["metrics"]["mrr"])
    assert abs(got["resharded"]["mrr"] - got["metrics"]["mrr"]) < 1e-3


def test_wikikg2_bf16_twin(capsys):
    got = _twin("wikikg2_bf16").main(["--cpu", "--entities", "4000", "--triples", "12000",
                                      "--steps", "2", "--shard-bs", "64", "--topk-queries", "128"])
    out = capsys.readouterr().out
    _lines_start(out, "dataset: 4,000 entities", "entity table: packed torch.int32 (6000, 128)",
                 "train: 2 steps", "top-10 vs ALL 4,000 entities, 128 queries")
    line = _last_json(out)
    assert list(line) == _json_keys(EXAMPLES / "wikikg2_bf16.py") and line == got
    assert line["value"] > 0 and line["table_gib"] > line["fp32_table_gib"]


def test_custom_kg_dataset_twin_matches_the_jax_script(capsys):
    """The twin's dataset equals the JAX package's from the same frames."""
    from besskge_tpu.dataset import KGDataset as JaxKGDataset

    twin = _twin("custom_kg_dataset")
    kg = twin.main([])
    out = capsys.readouterr().out
    _lines_start(out, "raw edges:", "round-trip check: triple 5 of test", "type-contiguity check: OK",
                 "save/load round trip: OK")
    edges, types = twin.make_raw_edges()
    part = np.random.default_rng(1).choice(3, p=[0.8, 0.1, 0.1], size=len(edges))
    want = JaxKGDataset.from_dataframe(
        {n: edges[part == i].reset_index(drop=True) for i, n in enumerate(("train", "valid", "test"))},
        head_column="head_label", relation_column="relation_label", tail_column="tail_label",
        entity_types=types)
    assert kg.entity_dict == want.entity_dict and kg.type_offsets == want.type_offsets
    for p in want.triples:
        np.testing.assert_array_equal(kg.triples[p], want.triples[p])


def test_twins_need_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, argv in (("biokg_parity", ["--scale", "0.002"]),
                       ("wikikg2_parity", ["--scale", "0.002"]),
                       ("wikikg2_oracle_vsall", ["--scale", "0.002"]),
                       ("wikikg2_independent_control", ["--scale", "0.002"]),
                       ("train_and_evaluate", []), ("yago_topk_prediction", []),
                       ("wikikg2_bf16", ["--entities", "1000"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            _twin(name).main(argv)


@pytest.mark.parametrize("case", ["cosine", "warmup_cosine", "warmup_constant", "linear"])
def test_schedules_match_optax(case):
    port, ref = {
        "cosine": (schedules.cosine_decay_schedule(1e-3, 100, alpha=0.05),
                   optax.cosine_decay_schedule(1e-3, 100, alpha=0.05)),
        "warmup_cosine": (schedules.warmup_cosine_decay_schedule(0.0, 4e-3, 20, 100, end_value=2e-4),
                          optax.warmup_cosine_decay_schedule(0.0, 4e-3, 20, 100, end_value=2e-4)),
        "warmup_constant": (schedules.warmup_constant_schedule(0.0, 1e-3, 10),
                            optax.schedules.warmup_constant_schedule(0.0, 1e-3, 10)),
        "linear": (schedules.linear_schedule(1.0, 0.1, 50), optax.linear_schedule(1.0, 0.1, 50)),
    }[case]
    counts = np.arange(0, 130)
    got = np.array([float(port(torch.tensor(int(c), dtype=torch.int32))) for c in counts])
    want = np.array([float(ref(int(c))) for c in counts], np.float32)
    # fp32 arithmetic on both sides, in other orders.
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    assert float(port(7)) == pytest.approx(float(ref(7)), rel=1e-6)
