"""The port's separate-buffer and gather-variant row optimizers against the
JAX package's, and the layouts of the port against each other.

* ``RowSGDM`` with a separate momentum buffer (momentum 0.9, and 0 with no
  buffer), ``RowAdamW`` with separate and with treble-interleaved moments,
  and the interleaved ``RowSGDM`` ``"pallas_gather"`` variant, each against
  ``besskge_tpu.optim``'s ``update_rows`` on the same table, state, indices
  and gradients over three steps, with duplicate indices, a weight decay
  and an lr schedule.
* The same arithmetic in two layouts gives equal bits in the port: the
  separate ``RowSGDM`` step and the interleaved one (after
  ``split_interleaved``), the separate ``RowAdamW`` step and the interleaved
  one (after ``split_interleaved_adamw``), and ``"pallas_gather"`` and
  ``"xla"``. The JAX package pins the ``RowAdamW`` equality in
  ``tests/test_adamw_interleaved.py``.

Tolerances. The gradients are small multiples of 1/4, so the per-row sums
are exact in fp32 in any order and both packages start each update from the
same summed gradient. What remains is the update arithmetic: XLA on the CPU
may contract a multiply and an add into one fused operation where the port
rounds both, and its ``b^t`` may differ from torch's in the last bit. Each
such difference is a relative 2^-24 of a term, and three steps compound a
few of them: held to rtol 1e-6 plus atol 1e-7 (the params are O(1), the
moments O(1) after three steps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from besskge_tpu import optim as jax_optim
from besskge_tpu_torch import convert
from besskge_tpu_torch import optim as port_optim
from besskge_tpu_torch.ops import row_kernels

N, D, R, STEPS = 40, 16, 120, 3
RTOL, ATOL = 1e-6, 1e-7


def _inputs(seed):
    """A table and STEPS batches of (idx with duplicates, dyadic gradients)."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(N, D)).astype(np.float32)
    batches = []
    for _ in range(STEPS):
        idx = rng.integers(0, N - 5, size=R).astype(np.int32)  # the last rows stay untouched
        g = (rng.integers(-8, 9, size=(R, D)) / 4).astype(np.float32)
        batches.append((idx, g))
    return table, batches


def _schedule(c):
    return 0.05 / (1.0 + c)


def _run_jax(opt, table, batches):
    t = jnp.asarray(table)
    s = opt.init(t, n_logical=N if opt.interleaved else None)
    for idx, g in batches:
        t, s = opt.update_rows(t, s, jnp.asarray(idx), jnp.asarray(g))
    return np.asarray(t), {k: np.asarray(v) for k, v in s.items()}


def _run_port(opt, table, batches):
    t = torch.from_numpy(table.copy())
    s = opt.init(t, n_logical=N if opt.interleaved else None)
    for idx, g in batches:
        t, s = opt.update_rows(t, s, torch.from_numpy(idx), torch.from_numpy(g))
    return t.numpy(), {k: v.numpy() for k, v in s.items()}


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("momentum", [0.9, 0.0])
@pytest.mark.parametrize("schedule", [False, True])
def test_row_sgdm_separate_buffer_matches_jax(momentum, schedule):
    table, batches = _inputs(0)
    lr = _schedule if schedule else 0.05
    want_t, want_s = _run_jax(jax_optim.RowSGDM(lr, momentum, 0.01), table, batches)
    got_t, got_s = _run_port(port_optim.RowSGDM(lr, momentum, 0.01), table, batches)
    assert set(got_s) == set(want_s) == ({"m", "count"} if momentum else {"count"})
    assert int(got_s["count"]) == int(want_s["count"]) == STEPS
    _close(got_t, want_t)
    if momentum:
        _close(got_s["m"], want_s["m"])
    np.testing.assert_array_equal(got_t[N - 5:], table[N - 5:])


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("schedule", [False, True])
def test_row_adamw_matches_jax(interleaved, schedule):
    table, batches = _inputs(1)
    lr = _schedule if schedule else 0.05
    kw = dict(weight_decay=0.01, interleaved=interleaved)
    jopt, popt = jax_optim.RowAdamW(lr, **kw), port_optim.RowAdamW(lr, **kw)
    start = np.asarray(jopt.widen_table(jnp.asarray(table)))
    np.testing.assert_array_equal(popt.widen_table(torch.from_numpy(table)).numpy(), start)
    want_t, want_s = _run_jax(jopt, start, batches)
    got_t, got_s = _run_port(popt, start, batches)
    assert int(got_s["count"]) == int(want_s["count"]) == STEPS
    _close(got_t, want_t)
    if not interleaved:
        _close(got_s["mu"], want_s["mu"])
        _close(got_s["nu"], want_s["nu"])
    untouched = got_t.reshape(N, -1)[N - 5:]
    np.testing.assert_array_equal(untouched, start.reshape(N, -1)[N - 5:])


@pytest.mark.parametrize("schedule", [False, True])
def test_row_sgdm_pallas_gather_matches_jax(schedule):
    """The JAX package on the CPU takes its "xla" path; the port reads the
    pairs with B9's plain version."""
    table, batches = _inputs(2)
    lr = _schedule if schedule else 0.05
    jopt = jax_optim.RowSGDM(lr, 0.9, 0.01, interleaved=True, fused_variant="pallas_gather")
    popt = port_optim.RowSGDM(lr, 0.9, 0.01, interleaved=True, fused_variant="pallas_gather")
    start = np.asarray(jax_optim.interleave_momentum(jnp.asarray(table)))
    want_t, _ = _run_jax(jopt, start, batches)
    got_t, _ = _run_port(popt, start, batches)
    _close(got_t, want_t)


def test_interleave_adamw_round_trip_matches_jax():
    rng = np.random.default_rng(3)
    p, m, v = (rng.normal(size=(7, 16)).astype(np.float32) for _ in range(3))
    for block in (False, True):
        tp = p[None] if block else p
        want = np.asarray(jax_optim.interleave_adamw(*map(jnp.asarray, (tp, m, v))))
        got = port_optim.interleave_adamw(*map(torch.from_numpy, (tp, m, v)))
        np.testing.assert_array_equal(got.numpy(), want)
        for g, w in zip(port_optim.split_interleaved_adamw(got),
                        jax_optim.split_interleaved_adamw(jnp.asarray(want))):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _port_steps(opt, table, batches):
    t = opt.widen_table(torch.from_numpy(table.copy()))
    s = opt.init(t, n_logical=N)
    for idx, g in batches:
        t, s = opt.update_rows(t, s, torch.from_numpy(idx), torch.from_numpy(g))
    return t, s


def test_row_sgdm_layouts_give_equal_bits():
    table, batches = _inputs(4)
    sep_t, sep_s = _port_steps(port_optim.RowSGDM(0.05, 0.9, 0.01), table, batches)
    p, m = port_optim.split_interleaved(
        _port_steps(port_optim.RowSGDM(0.05, 0.9, 0.01, interleaved=True), table, batches)[0])
    assert torch.equal(p, sep_t) and torch.equal(m, sep_s["m"])


def test_row_adamw_layouts_give_equal_bits():
    table, batches = _inputs(5)
    sep_t, sep_s = _port_steps(port_optim.RowAdamW(_schedule, weight_decay=0.01), table, batches)
    treb, _ = _port_steps(port_optim.RowAdamW(_schedule, weight_decay=0.01, interleaved=True),
                          table, batches)
    p, mu, nu = port_optim.split_interleaved_adamw(treb)
    assert torch.equal(p, sep_t) and torch.equal(mu, sep_s["mu"]) and torch.equal(nu, sep_s["nu"])


def test_row_sgdm_pallas_gather_equals_xla():
    table, batches = _inputs(6)
    runs = [_port_steps(port_optim.RowSGDM(0.05, 0.9, 0.01, interleaved=True, fused_variant=v),
                        table, batches)[0] for v in ("xla", "pallas_gather")]
    assert torch.equal(*runs)


def test_row_optimizers_route_to_their_kernels(monkeypatch):
    """Which row kernel each form calls (the CPU runs the plain versions
    behind the same wrappers): B8 with k = 2 and k = 3, B3 with h = 1, 2, 3,
    B9 with h = 2."""
    calls = []
    for name in ("scatter_rows", "scatter_rows_multi", "gather_rows"):
        orig = getattr(row_kernels, name)

        def spy(*args, _orig=orig, _name=name, **kw):
            calls.append((_name, len(args[0]) if _name == "scatter_rows_multi"
                          else kw["slice_rows"]))
            return _orig(*args, **kw)

        monkeypatch.setattr(row_kernels, name, spy)
    table, batches = _inputs(7)
    cases = [
        (port_optim.RowSGDM(0.05, 0.9), [("scatter_rows_multi", 2)]),
        (port_optim.RowSGDM(0.05, 0.0), [("scatter_rows", 1)]),
        (port_optim.RowAdamW(0.05), [("scatter_rows_multi", 3)]),
        (port_optim.RowAdamW(0.05, interleaved=True), [("scatter_rows", 3)]),
        (port_optim.RowSGDM(0.05, 0.9, interleaved=True), [("scatter_rows", 2)]),
        (port_optim.RowSGDM(0.05, 0.9, interleaved=True, fused_variant="pallas_gather"),
         [("gather_rows", 2), ("scatter_rows", 2)]),
    ]
    for opt, want in cases:
        calls.clear()
        _port_steps(opt, table, batches[:1])
        assert calls == want, (opt, calls)


def test_opt_state_from_jax_carries_row_states():
    table = jnp.asarray(np.random.default_rng(8).normal(size=(N, D)).astype(np.float32))
    for opt in (jax_optim.RowSGDM(0.1, 0.9), jax_optim.RowAdamW(0.1),
                jax_optim.RowAdamW(0.1, interleaved=True), jax_optim.FusedDenseAdamW(0.1)):
        t = opt.widen_table(table) if hasattr(opt, "widen_table") else table
        state = {"entity": opt.init(t), "other": ()}
        got = convert.opt_state_from_jax(
            {"entity": {k: np.asarray(v) for k, v in state["entity"].items()}, "other": ()}, "cpu")
        assert set(got["entity"]) == set(state["entity"])
        for k, v in state["entity"].items():
            np.testing.assert_array_equal(got["entity"][k].numpy(), np.asarray(v))
        assert int(got["other"]["count"]) == 0
