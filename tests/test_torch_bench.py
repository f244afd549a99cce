"""``bench_torch.py`` against ``bench.py`` at ``BENCH_SMOKE=1`` on the CPU.

Every name that ``bench_torch.main()`` runs builds and runs here, through
the same runners the card runs, with ``device="cpu"``; each line carries
``bench.py``'s keys for that name (read from ``bench.py``'s source), but the
JAX-only ``xla_logical_bytes_per_step``, the trace fields (a CPU trace has
no device track) and ``overlap``'s ``blocked`` placeholder (the port prints
none). The training set-ups hold ``bench.py``'s per-step positives and byte
models, and the smoke ``wikikg2`` and ``biokg`` set-ups take one host-fed
step on the same batch from the JAX set-up's state, carried across with
``convert``, at the tolerances of ``tests/test_torch_train.py`` and
``tests/test_torch_dense_train.py``:

* ``wikikg2``: the JAX side through its own Pallas kernels in the
  interpreter, which take ``sign(0) = 0`` at a tie as the port does (its
  default CPU path gives ``+g``, and this batch holds such a tie in fp32);
  the positive score's exact ties, where ``jnp.abs`` still gives ``+g``,
  left out. fp32 scoring: ``|got − want| ≤ 1e-5·(|want| + max|want|)``.
  bf16 scoring: ``2^-7·(|want| + max|want|)``, the sparse bf16 gate of
  ``chip_smoke.py`` (PERF.md §2). ``tests/test_torch_train.py``'s bf16
  form (``2^-8·|want| + 2^-12·max|want|``) is under one bf16 ulp of a
  value at the foot of its binade, and a row's momentum after one step is
  its gradient: the positive score's and B2's contributions, each rounded
  to bf16 and then summed, so one ulp of a contribution can be several of
  the sum where they cancel. This batch holds such rows (4 ulps of
  ``|want|`` 0.18, 2^-9 of the gate's scale);
* ``biokg``: moments to ``1e-5·(|want| + max|want|)``, each param to that
  plus ``lr·|r_port − r_jax|`` (``r = m̂/(√v̂ + eps)`` of each side's
  moments); the loss to rtol 1e-5.
"""

import ast
import functools
import importlib
import inspect
import os
import subprocess
import sys

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["BENCH_SMOKE"] = "1"
import bench  # noqa: E402
import bench_torch  # noqa: E402
import chip_smoke  # noqa: E402

if not bench._SMOKE:  # an earlier import won the race: reload with the flag
    bench = importlib.reload(bench)
if not bench_torch._SMOKE:
    bench_torch = importlib.reload(bench_torch)

from besskge_tpu import scoring as jax_scoring  # noqa: E402
from besskge_tpu.ops import distance as jax_distance  # noqa: E402
from besskge_tpu.ops import pallas_distance as jax_pd  # noqa: E402
from besskge_tpu_torch import convert  # noqa: E402

TRAINING = ["biokg", "wikikg2", "wikikg2_bf16", "wikikg2_fp16"]
#: The sparse bf16 step's gate (``chip_smoke.BF16_STEP_RTOL``, PERF.md §2).
BF16_STEP_RTOL = 2.0**-7


def _names(fn):
    """The string constants of the lists in ``fn``'s source: the names
    ``main()`` iterates over."""
    return [
        n.value
        for node in ast.walk(ast.parse(inspect.getsource(fn)))
        if isinstance(node, ast.List)
        for n in node.elts
        if isinstance(n, ast.Constant) and isinstance(n.value, str)
    ]


def _line_dict(fn):
    """The last ``line = {...}`` of ``fn``'s source: (constant keys,
    ``metric``'s constant value or None, names of the ``**`` spreads)."""
    found = []
    for node in ast.walk(ast.parse(inspect.getsource(fn))):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "line" for t in node.targets)):
            found.append(node)
    d = max(found, key=lambda n: n.lineno).value
    keys = {k.value for k in d.keys if isinstance(k, ast.Constant)}
    metric = [v.value for k, v in zip(d.keys, d.values)
              if isinstance(k, ast.Constant) and k.value == "metric" and isinstance(v, ast.Constant)]
    spreads = [v.id for k, v in zip(d.keys, d.values) if k is None]
    return keys, (metric[0] if metric else None), spreads


def _cost_keys():
    """The keys ``bench._cost_fields`` can return."""
    tree = ast.parse(inspect.getsource(bench._cost_fields))
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys if isinstance(k, ast.Constant)}
        if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store):
            keys.add(node.slice.value)
    return keys


RUNNER = {"topk_yago": "run_topk", "census": "run_census", "overlap": "run_overlap",
          "valid": "run_valid", "allscores": "run_allscores"}
JAX_ONLY = {"xla_logical_bytes_per_step", "blocked"}


def test_main_runs_the_names_of_bench_main():
    """If ``bench.py``'s ``main()`` grows a config, the port's must too, in
    the same order."""
    assert _names(bench_torch.main) == _names(bench.main)
    assert set(_names(bench_torch.main)) == set(RUNNER) | set(TRAINING)


@pytest.mark.parametrize("name", _names(bench.main))
def test_every_name_runs_with_bench_keys(name):
    line = bench_torch.run_one(name, device="cpu")
    keys, metric, spreads = _line_dict(getattr(bench, RUNNER.get(name, "run_one")))
    if "cost" in spreads:
        keys |= _cost_keys()
    assert keys - JAX_ONLY <= set(line), sorted(keys - JAX_ONLY - set(line))
    want_metric = metric or bench.CONFIGS[name]["metric"]
    assert line["metric"] == want_metric == (bench_torch.CONFIGS.get(name) or line)["metric"]
    assert line["card"] is None  # a CPU run names no card
    if name == "overlap":  # a CPU trace has no device track
        assert line["value"] is None and line["ranks"] == 1
        return
    assert np.isfinite(line["value"]) and line["value"] > 0
    if name == "census":
        assert line["contract_ok"] and line["value"] == 8 * (64 + 2 * 32) * 128 * 4
    if name in TRAINING:
        # Device shares are not measured on the CPU.
        assert line["mfu_bf16_pct"] is None and line["hbm_bw_pct"] is None
        assert line["flops_model"] == "analytic" and line["flops_per_step"] > 0


def test_main_needs_a_card():
    """Without a card ``python3 bench_torch.py`` exits non-zero and prints
    no line: nothing falls back to the CPU."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "BENCH_SMOKE"}
    res = subprocess.run([sys.executable, "bench_torch.py", "wikikg2"], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 1 and "no CUDA device" in res.stderr
    assert "{" not in res.stdout


def test_kernel_selftest_cases_hold_on_the_cpu():
    """``_cuda_kernel_selftest``'s cases and tolerances, through the
    wrappers' plain versions (CPU tensors); the card runs the kernels."""
    bench_torch._cuda_kernel_selftest("cpu")


def test_make_dataset_is_bench_bit_for_bit():
    want = bench._make_dataset(1000, 7, 5000)
    got = bench_torch._make_dataset(1000, 7, 5000)
    assert (got.n_entity, got.n_relation_type) == (want.n_entity, want.n_relation_type)
    np.testing.assert_array_equal(got.triples["train"], want.triples["train"])
    assert got.triples["train"].dtype == want.triples["train"].dtype
    np.testing.assert_array_equal(got.original_triple_ids["train"],
                                  want.original_triple_ids["train"])


@pytest.fixture
def jax_kernel_path(monkeypatch):
    """Route the JAX package's p=1 distances through its TPU entry point
    (custom VJP over the batching rules), with the Pallas kernels in the
    interpreter."""
    orig = jax_scoring.p_distance_matrix
    monkeypatch.setattr(
        jax_scoring, "p_distance_matrix",
        lambda a, b, p: jax_distance._l1_tpu(a, b) if p == 1 else orig(a, b, p),
    )
    monkeypatch.setattr(jax_distance, "_PALLAS_MIN_ELEMS", 0)
    monkeypatch.setattr(jax_distance, "_PALLAS_MIN_ELEMS_BATCHED", 0)
    for name in ("l1_distance_matrix", "l1_distance_matrix_batched",
                 "l1_distance_grads", "l1_distance_grads_batched"):
        monkeypatch.setattr(jax_pd, name, functools.partial(getattr(jax_pd, name), interpret=True))


def _setups(name):
    jax_setup = {"biokg": bench._setup_biokg, "wikikg2": bench._setup_wikikg2,
                 "wikikg2_bf16": lambda: bench._setup_wikikg2(bf16_table=True),
                 "wikikg2_fp16": lambda: bench._setup_wikikg2(fp16_table=True)}[name]
    port_setup = {"biokg": bench_torch._setup_biokg, "wikikg2": bench_torch._setup_wikikg2,
                  "wikikg2_bf16": functools.partial(bench_torch._setup_wikikg2, bf16_table=True),
                  "wikikg2_fp16": functools.partial(bench_torch._setup_wikikg2, fp16_table=True)}
    return jax_setup(), port_setup[name](device="cpu")


@pytest.mark.parametrize("name", TRAINING)
def test_setup_models_equal_bench(name):
    want, got = _setups(name)
    assert got["pos_per_step"] == want["pos_per_step"]
    assert got["hbm_bytes_per_step"] == want["hbm_bytes_per_step"]
    # The same layouts: the widened (pair-major or triplet) entity table.
    assert {k: tuple(v.shape) for k, v in got["params"].items()} == {
        k: tuple(v.shape) for k, v in want["params"].items()}


def _first_batches(want, got):
    """The first host batch of each side's sampler: bit for bit equal."""
    jb = want["hbs"].sample_batch(next(want["hbs"].epoch_index_blocks(True)))
    pb = got["hbs"].sample_batch(next(got["hbs"].epoch_index_blocks(True)))
    assert jb.keys() == pb.keys()
    for k in jb:
        np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
    return jb


def _close(got, want, extra=0.0, skip=None, rtol=1e-5):
    tol = rtol * (np.abs(want) + np.abs(want).max()) + extra
    err = np.abs(got - want)
    if skip is not None:
        err, tol = err[~skip], tol[~skip]
    assert (err <= tol).all(), float((err - tol).max())


def _positive_ties(params, batch, compute):
    """Coordinates where the positive score's ``h + r − t`` is exactly 0 in
    the ``compute`` dtype: (entity mask (N, D), relation mask (R, D)) of the
    rows they touch."""
    table = np.asarray(params["entity_embedding"])[0::2]  # param rows of the pair table
    rel = np.asarray(params["relation_embedding"])
    dt = ml_dtypes.bfloat16 if compute == "bf16" else np.float32
    heads, tails, rels = (batch[k].reshape(-1) for k in ("head", "tail", "relation"))
    hr = table[heads].astype(dt).astype(np.float32) + rel[rels].astype(dt).astype(np.float32)
    tie = hr.astype(dt) == table[tails].astype(dt)
    ent = np.zeros(table.shape, bool)
    rel_mask = np.zeros(rel.shape, bool)
    for ids, mask in ((heads, ent), (tails, ent), (rels, rel_mask)):
        np.logical_or.at(mask, ids, tie)
    return ent, rel_mask


def _carry(want, got):
    """The JAX set-up's params and optimizer state, in the port's set-up."""
    got["params"] = convert.params_from_jax(
        {k: np.asarray(v) for k, v in want["params"].items()}, "cpu")
    got["opt_state"] = convert.opt_state_from_jax(
        jax.tree.map(np.asarray, want["opt_state"]), "cpu")


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_wikikg2_host_step_matches_bench(monkeypatch, jax_kernel_path, compute):
    if compute == "fp32":
        monkeypatch.setenv("BENCH_COMPUTE_DTYPE", "fp32")
    want, got = _setups("wikikg2")
    _carry(want, got)
    batch = _first_batches(want, got)
    ent_tie, rel_tie = _positive_ties(want["params"], batch, compute)
    params, state, jout = want["hstep"](want["params"], want["opt_state"], batch)
    pparams, pstate, pout = got["hstep"](got["params"], got["opt_state"], batch)
    pairs = [
        (pparams["entity_embedding"].numpy(), np.asarray(params["entity_embedding"]),
         np.repeat(ent_tie, 2, axis=0)),  # param and momentum rows
        (pparams["relation_embedding"].numpy(), np.asarray(params["relation_embedding"]), rel_tie),
        (pstate["other"]["trace"]["relation_embedding"].numpy(),
         np.asarray(state["other"][0].trace["relation_embedding"]), rel_tie),
    ]
    if compute == "fp32":
        np.testing.assert_allclose(float(pout["loss"]), float(jout["loss"]), rtol=1e-5)
        for g, w, skip in pairs:
            _close(g, w, skip=skip)
    else:
        np.testing.assert_allclose(float(pout["loss"]), float(jout["loss"]), rtol=2.0**-8)
        for g, w, skip in pairs:
            _close(g, w, skip=skip, rtol=BF16_STEP_RTOL)
    assert int(pstate["entity"]["count"]) == int(state["entity"]["count"]) == 1


def _moments(state):
    """The AdamW moments of every param, as numpy: the JAX package's optax
    tuple, or the port's dict."""
    if isinstance(state, (tuple, list)):
        state = {"mu": state[0].mu, "nu": state[0].nu}
    return {f"{m}.{k}": (v.numpy() if torch.is_tensor(v) else np.asarray(v))
            for m in ("mu", "nu") for k, v in state[m].items()}


def test_biokg_host_step_matches_bench():
    want, got = _setups("biokg")
    _carry(want, got)
    batch = _first_batches(want, got)
    params, state, jout = want["hstep"](want["params"], want["opt_state"], batch)
    pparams, pstate, pout = got["hstep"](got["params"], got["opt_state"], batch)
    np.testing.assert_allclose(float(pout["loss"]), float(jout["loss"]), rtol=1e-5)
    w_m, g_m = _moments(state), _moments(pstate)
    assert set(g_m) == set(w_m)
    lr, b1, b2, eps = 1e-3, 0.9, 0.999, 1e-8

    def ratio(m, key):
        return (m[f"mu.{key}"] / (1 - b1)) / (np.sqrt(m[f"nu.{key}"] / (1 - b2)) + eps)

    for key in params:
        moved = lr * np.abs(ratio(g_m, key) - ratio(w_m, key))
        _close(pparams[key].numpy(), np.asarray(params[key]), moved)
    for key in w_m:
        _close(g_m[key], w_m[key])
    assert int(pstate["count"]) == int(state[0].count) == 1


def test_chip_smoke_lists_bench_metrics():
    """``chip_smoke.py`` writes ``bench.py``'s metric names out (it cannot
    import ``bench``): they must be ``bench.py``'s, name for name."""
    want = {name: bench.CONFIGS[name]["metric"] if name in bench.CONFIGS
            else _line_dict(getattr(bench, RUNNER[name]))[1] for name in _names(bench.main)}
    assert chip_smoke.BENCH_METRICS == want


def _bench_lines():
    """Lines that meet ``chip_smoke.hold_bench_lines``' contract."""
    lines = []
    for name, metric in chip_smoke.BENCH_METRICS.items():
        line = {"metric": metric, "value": 7.5, "unit": "x"}
        if name == "census":
            line["contract_ok"] = True
        if name == "overlap":
            line.update(value=0.0, ranks=1, collective_pct_of_busy=0.0)
        if name in TRAINING:
            line.update(value=105.0, device_busy_pct=80.0, mfu_bf16_pct=0.1, hbm_bw_pct=1.0)
        lines.append(line)
    return lines


FAULTS = {
    "missing": lambda ls: ls.pop(3),
    "renamed": lambda ls: ls[4].update(metric="wikikg2_transe_train_triples_per_s"),
    "nan": lambda ls: ls[6].update(value=float("nan")),
    "zero": lambda ls: ls[7].update(value=0.0),
    "none": lambda ls: ls[8].update(value=None),
    "census": lambda ls: ls[0].update(contract_ok=False),
    "busy": lambda ls: ls[2].update(device_busy_pct=100.5),
    "mfu": lambda ls: ls[3].update(mfu_bf16_pct=0.0),
    "hbm": lambda ls: ls[4].update(hbm_bw_pct=None),
    "overlap_one_rank": lambda ls: ls[1].update(value=3.0),
    "overlap_ranks": lambda ls: ls[1].update(ranks=4),
    "slow": lambda ls: ls[5].update(value=70.0),
    "extra": lambda ls: ls.append(dict(ls[2])),
}


@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_chip_smoke_holds_the_bench_lines(fault):
    lines = _bench_lines()
    rates = {name: 100.0 for name in TRAINING}
    if fault is None:
        held = chip_smoke.hold_bench_lines(lines, rates)
        assert set(held) == set(chip_smoke.BENCH_METRICS)
        assert held["wikikg2"]["vs_device_phase"] == 1.05
        return
    FAULTS[fault](lines)
    with pytest.raises(AssertionError):
        chip_smoke.hold_bench_lines(lines, rates)
