"""The port's ``RowAdagrad`` against the JAX package's, and its layouts
against each other.

Layouts: a separate ``acc`` buffer (B8, k = 2, on a card) and the
interleaved stores of ``RowSGDM`` (pair-major fp32, B3 h = 2; the packed
triplet store, B3 h = 3). Tables: fp32, row-pair-packed bf16 (int32 words)
and fp16 (uint32 words), and plain bf16/fp16 with a separate accumulator.
Learning rates: a constant and a schedule (read at the pre-increment count;
stochastic rounding hashes the post-increment one).

Tolerances, as ``tests/test_torch_row_optim.py`` and
``tests/test_torch_packed.py`` state them. The gradients are small multiples
of 1/4, so the duplicate-row sums and their squares are exact in any order;
what may differ is the update arithmetic of XLA on the CPU (a contracted
multiply-add): fp32 tables and accumulators at rtol 1e-6 plus atol 1e-7
over three chained steps. A 16-bit table is compared one step at a time from
the JAX package's state: each value equal or one 16-bit ulp apart (a
last-bit fp32 difference can move a stochastic rounding to the other
neighbour), untouched rows and sibling planes bit for bit.

Inside the port, bit for bit: the interleaved store equals the separate
buffers (the twin of ``tests/test_adagrad_interleaved.py:24``), and a packed
table equals a plain 16-bit one. The init-validation cases are the twins of
``tests/test_adagrad_interleaved.py:102``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from besskge_tpu import optim as jax_optim
from besskge_tpu import packed as jpk
from besskge_tpu_torch import convert
from besskge_tpu_torch import optim as port_optim
from besskge_tpu_torch import packed as ppk
from besskge_tpu_torch.ops import row_kernels

N, D, R, STEPS = 40, 16, 120, 3
RTOL, ATOL = 1e-6, 1e-7
HALVES = {"bf16": (jnp.bfloat16, torch.bfloat16), "fp16": (jnp.float16, torch.float16)}


def _schedule(c):
    return 0.05 / (1.0 + c)


def _inputs(seed):
    """A table and STEPS batches of (idx with duplicates, dyadic gradients);
    the last rows stay untouched, and row 10 is touched while 11 is not."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(N, D)).astype(np.float32)
    batches = []
    for _ in range(STEPS):
        idx = rng.integers(0, N - 6, size=R).astype(np.int32)
        idx[idx == 11] = 10
        g = (rng.integers(-8, 9, size=(R, D)) / 4).astype(np.float32)
        batches.append((idx, g))
    return table, batches


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("schedule", [False, True])
@pytest.mark.parametrize("interleaved", [False, True])
def test_fp32_row_adagrad_matches_jax(interleaved, schedule):
    table, batches = _inputs(0)
    lr = _schedule if schedule else 0.05
    jopt = jax_optim.RowAdagrad(lr, interleaved=interleaved)
    popt = port_optim.RowAdagrad(lr, interleaved=interleaved)
    jt = jopt.widen_table(jnp.asarray(table))
    pt = popt.widen_table(torch.from_numpy(table.copy()))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    n_logical = N if interleaved else None
    js, ps = jopt.init(jt, n_logical=n_logical), popt.init(pt, n_logical=n_logical)
    assert set(ps) == set(js) == ({"count"} if interleaved else {"acc", "count"})
    for idx, g in batches:
        jt, js = jopt.update_rows(jt, js, jnp.asarray(idx), jnp.asarray(g))
        pt, ps = popt.update_rows(pt, ps, torch.from_numpy(idx), torch.from_numpy(g))
    assert ps["count"].dtype == torch.int32 and ps["count"].dim() == 0
    assert int(ps["count"]) == int(js["count"]) == STEPS
    _close(pt.numpy(), np.asarray(jt))
    if not interleaved:
        _close(ps["acc"].numpy(), np.asarray(js["acc"]))
    untouched = pt.numpy().reshape(N, -1)[N - 6:]
    np.testing.assert_array_equal(untouched, np.asarray(jt).reshape(N, -1)[N - 6:])


def _ordinal(bits):
    """16-bit patterns as integers ordered like their values (±0 both 0)."""
    b = bits.astype(np.int32) & 0xFFFF
    return np.where(b & 0x8000, -(b & 0x7FFF), b)


def _logical(table, half):
    """The 16-bit params of a JAX or port packed table or triplet store, as
    int16 bits (N, D)."""
    if torch.is_tensor(table):
        table = table.view(torch.int32).numpy()
    table = np.asarray(table)
    p = (N + 1) // 2
    if table.shape[0] != p:
        table = table.reshape(p, -1, table.shape[-1])[:, 0]
    words = np.ascontiguousarray(table).view(np.uint32)
    out = np.empty((2 * p, table.shape[-1]), np.int16)
    out[0::2] = (words & 0xFFFF).astype(np.uint16).view(np.int16)
    out[1::2] = (words >> 16).astype(np.uint16).view(np.int16)
    return out[:N]


def _acc(opt, table, state):
    """The fp32 accumulator of a packed run, logical-major (2P, D)."""
    if not opt.interleaved:
        return np.asarray(state["acc"]) if not torch.is_tensor(state["acc"]) else state["acc"].numpy()
    if torch.is_tensor(table):
        return ppk.split_packed_state(table, 1)[1][0].numpy()
    return np.asarray(jpk.split_packed_state(table, 1)[1][0])


@pytest.mark.parametrize("schedule", [False, True])
@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("half", ["bf16", "fp16"])
def test_packed_row_adagrad_matches_jax(half, interleaved, schedule):
    table, batches = _inputs(1)
    lr = _schedule if schedule else 0.05
    jopt = jax_optim.RowAdagrad(lr, interleaved=interleaved)
    popt = port_optim.RowAdagrad(lr, interleaved=interleaved)
    jt = jopt.widen_table(jpk.pack_table(jnp.asarray(table).astype(HALVES[half][0])))
    js = jopt.init(jt, n_logical=N)
    touched = np.zeros(N, bool)
    differ = total = 0
    for idx, g in batches:
        # the port starts each step from the JAX package's state
        pt = convert.params_from_jax({"t": np.asarray(jt)}, "cpu")["t"]
        ps = convert.opt_state_from_jax({"entity": js, "other": ()}, "cpu")["entity"]
        before = _logical(jt, half)
        jt, js = jopt.update_rows(jt, js, jnp.asarray(idx), jnp.asarray(g))
        pt, ps = popt.update_rows(pt, ps, torch.from_numpy(idx), torch.from_numpy(g))
        assert pt.dtype == (torch.uint32 if half == "fp16" else torch.int32)
        assert int(ps["count"]) == int(js["count"])
        got, want = _logical(pt, half), _logical(jt, half)
        touched[idx] = True
        np.testing.assert_array_equal(got[~touched], before[~touched])
        np.testing.assert_array_equal(want[~touched], before[~touched])
        gap = np.abs(_ordinal(got) - _ordinal(want))
        assert gap.max() <= 1
        differ, total = differ + int((gap > 0).sum()), total + got[touched].size
        _close(_acc(popt, pt, ps), _acc(jopt, jt, js))
    assert not touched[11] and touched[10]
    assert differ <= 0.02 * total, (differ, total)


@pytest.mark.parametrize("half", ["bf16", "fp16"])
def test_plain_16bit_row_adagrad_matches_jax(half):
    """A plain bf16/fp16 table with a separate fp32 accumulator (B3 per
    table on a card), one step at a time from the JAX package's state."""
    table, batches = _inputs(2)
    jopt, popt = jax_optim.RowAdagrad(0.05), port_optim.RowAdagrad(0.05)
    jt = jnp.asarray(table).astype(HALVES[half][0])
    js = jopt.init(jt)
    for idx, g in batches:
        pt = convert.params_from_jax({"t": np.asarray(jt)}, "cpu")["t"]
        ps = convert.opt_state_from_jax({"entity": js, "other": ()}, "cpu")["entity"]
        jt, js = jopt.update_rows(jt, js, jnp.asarray(idx), jnp.asarray(g))
        pt, ps = popt.update_rows(pt, ps, torch.from_numpy(idx), torch.from_numpy(g))
        assert pt.dtype == HALVES[half][1]
        got = pt.view(torch.int16).numpy()
        want = np.asarray(jt).view(np.int16)
        assert np.abs(_ordinal(got) - _ordinal(want)).max() <= 1
        _close(ps["acc"].numpy(), np.asarray(js["acc"]))


def _port_run(opt, table, batches):
    t = opt.widen_table(table.clone())
    s = opt.init(t, n_logical=N)
    for idx, g in batches * 2:
        t, s = opt.update_rows(t, s, torch.from_numpy(idx), torch.from_numpy(g))
    return t, s


@pytest.mark.parametrize("schedule", [False, True])
@pytest.mark.parametrize("storage", ["fp32", "bf16", "fp16"])
def test_interleaved_store_equals_separate_buffers(storage, schedule):
    table, batches = _inputs(3)
    tab = torch.from_numpy(table)
    if storage != "fp32":
        tab = ppk.pack_table(tab.to(HALVES[storage][1]))
    lr = _schedule if schedule else 0.05
    sep_t, sep_s = _port_run(port_optim.RowAdagrad(lr), tab, batches)
    wide, _ = _port_run(port_optim.RowAdagrad(lr, interleaved=True), tab, batches)
    if storage == "fp32":
        p, acc = port_optim.split_interleaved(wide)
        assert torch.equal(p, sep_t)
    else:
        p, (acc,) = ppk.split_packed_state(wide, 1)
        assert torch.equal(p.view(torch.int32), sep_t.view(torch.int32))
    assert torch.equal(acc, sep_s["acc"])


@pytest.mark.parametrize("sr", [True, False])
@pytest.mark.parametrize("half", ["bf16", "fp16"])
def test_packed_equals_plain_16bit(half, sr):
    table, batches = _inputs(4)
    plain = torch.from_numpy(table).to(HALVES[half][1])
    packed_tab = ppk.pack_table(plain)
    opt = port_optim.RowAdagrad(0.05, stochastic_rounding=sr)
    plain, sp = _port_run(opt, plain, batches)
    packed_tab, sk = _port_run(opt, packed_tab, batches)
    assert torch.equal(ppk.unpack_table(packed_tab, N).view(torch.int16), plain.view(torch.int16))
    assert torch.equal(sp["acc"], sk["acc"])


def test_init_validation():
    """The twin of tests/test_adagrad_interleaved.py:102."""
    row = port_optim.RowAdagrad(learning_rate=0.1, interleaved=True)
    with pytest.raises(ValueError, match="interleave_momentum"):
        row.init(torch.zeros((8, 32), dtype=torch.float32), n_logical=8)
    row.init(torch.zeros((16, 32), dtype=torch.float32), n_logical=8)  # widened ok
    with pytest.raises(ValueError, match="fp32"):
        row.init(torch.zeros((16, 32), dtype=torch.bfloat16), n_logical=8)
    packed_tab = ppk.pack_table(torch.zeros((16, 128), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="interleave_packed_momentum"):
        row.init(packed_tab, n_logical=16)
    row.init(ppk.interleave_packed_momentum(packed_tab), n_logical=16)  # ok
    # the JAX package raises on the same inputs
    jrow = jax_optim.RowAdagrad(learning_rate=0.1, interleaved=True)
    with pytest.raises(ValueError, match="interleave_momentum"):
        jrow.init(jnp.zeros((8, 32), jnp.float32), n_logical=8)


def test_fields_and_layout_match_jax():
    port, ref = port_optim.RowAdagrad(0.1), jax_optim.RowAdagrad(0.1)
    assert port.eps == ref.eps == 1e-10 and port.stochastic_rounding and not port.interleaved
    assert port.interleave_layout == ref.interleave_layout == "adagrad"


def test_row_adagrad_routes_to_its_kernels(monkeypatch):
    """Which row kernel each layout calls (the CPU runs the plain versions
    behind the same wrappers): B8 with k = 2 (fp32 and packed separate), B3
    per table beside a plain 16-bit table, B3 with h = 2 (fp32 store) and
    h = 3 (packed triplet store)."""
    calls = []
    for name in ("scatter_rows", "scatter_rows_multi"):
        orig = getattr(row_kernels, name)

        def spy(*args, _orig=orig, _name=name, **kw):
            calls.append((_name, len(args[0]) if _name == "scatter_rows_multi"
                          else kw.get("slice_rows")))
            return _orig(*args, **kw)

        monkeypatch.setattr(row_kernels, name, spy)
    table, batches = _inputs(5)
    idx, g = map(torch.from_numpy, batches[0])
    fp32 = torch.from_numpy(table)
    packed_tab = ppk.pack_table(fp32.to(torch.bfloat16))
    for opt, tab, want in (
        (port_optim.RowAdagrad(0.05), fp32, [("scatter_rows_multi", 2)]),
        (port_optim.RowAdagrad(0.05), packed_tab, [("scatter_rows_multi", 2)]),
        (port_optim.RowAdagrad(0.05), fp32.to(torch.bfloat16),
         [("scatter_rows", 1), ("scatter_rows", 1)]),
        (port_optim.RowAdagrad(0.05, interleaved=True), fp32, [("scatter_rows", 2)]),
        (port_optim.RowAdagrad(0.05, interleaved=True), packed_tab, [("scatter_rows", 3)]),
    ):
        calls.clear()
        t = opt.widen_table(tab.clone())
        opt.update_rows(t, opt.init(t, n_logical=N), idx, g)
        assert calls == want, (opt, tab.dtype, calls)
