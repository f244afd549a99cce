"""The port's row-pair-packed 16-bit tables against the JAX package's.

Storage, reads and merges: ``besskge_tpu_torch.packed`` against
``besskge_tpu.packed`` on the same numpy inputs, bit for bit, in bf16
(int32 storage) and fp16 (uint32 storage), at D = 16 and D = 128:
``pack_table``/``unpack_table`` and the host pair (odd N, whose padding row
is zeros, included), ``take_rows``/``take_contiguous_rows`` over a plain
packed table and the triplet and quintuplet stores,
``merge_packed_row_writes`` (sorted and general, which also equal each
other), ``merge_packed_block_writes`` (k = 1, 2) and
``interleave_packed_state``/``split_packed_state``.

Stochastic rounding: ``optim._sr_round_16`` bit for bit on the same fp32
rows, ids and counts, with edge values (±0, subnormals, the largest finite
fp16 values, values that round to inf, inf and nan). A nan comes out a nan
on both sides; its payload is not compared (PyTorch's vectorised CPU cast
gives bf16 nan as 0xFFFF, XLA as 0x7FC0).

Row optimizers, one and two steps of packed ``RowSGDM`` and ``RowAdamW``
(triplet or quintuplet store, and separate buffers), SR on and off, bf16 and
fp16, against the JAX package. Each step starts from the same state on both
sides (the second from the JAX package's after the first). The gradients
are small multiples of 1/4, so the duplicate-row sums are exact in any
order; what differs is the update arithmetic (XLA on the CPU may contract a
multiply and an add, and its ``b^t`` may differ in the last bit), so:

* 16-bit params: equal, or one 16-bit ulp apart, where a last-bit fp32
  difference moved a rounding to the other neighbour (the share that
  differs is asserted to be small);
* untouched rows, and the untouched sibling plane of a touched packed row:
  bit-identical to the table before the step;
* fp32 moments: rtol 1e-6 plus atol 1e-7, as ``tests/test_torch_row_optim.py``.

Inside the port, bit for bit: the interleaved store equals the separate
buffers (the twins of ``tests/test_packed_interleaved.py:101`` and
``tests/test_adamw_interleaved.py:311``), and a packed table equals a plain
16-bit table (the twin of ``tests/test_packed.py:90``).

Also here: ``convert`` carries packed tables, the stores, fp16 arrays and
the (2P, D) moments both ways bit for bit, and ``TopKQueryBessKGE`` over a
packed bf16 table, a packed fp16 table and the triplet store equals the port
over the plain 16-bit table bit for bit and the JAX package over the packed
one within the top-k tolerances of ``tests/test_torch_topk.py``.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from besskge_tpu import bess as jax_bess
from besskge_tpu import negative_sampler as jax_ns
from besskge_tpu import optim as jax_optim
from besskge_tpu import packed as jpk
from besskge_tpu import scoring as jax_scoring
from besskge_tpu import sharding as jax_sh
from besskge_tpu_torch import bess as port_bess
from besskge_tpu_torch import convert
from besskge_tpu_torch import negative_sampler as port_ns
from besskge_tpu_torch import optim as port_optim
from besskge_tpu_torch import packed as ppk
from besskge_tpu_torch import scoring as port_scoring
from besskge_tpu_torch import sharding as port_sh

HALVES = {"bf16": (np.float32, torch.bfloat16), "fp16": (np.float16, torch.float16)}
RTOL, ATOL = 1e-6, 1e-7


def _table(rng, n, d, half):
    """A logical (n, d) table: float32 values for bf16 packing (packed by
    rounding), float16 values for fp16."""
    return rng.normal(size=(n, d)).astype(HALVES[half][0])


def _np(t):
    """A port tensor as numpy, 16-bit floats by their int16 bits and uint32
    words by their int32 view."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16).numpy()
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy()
    return t.numpy()


def _jnp(x):
    """A JAX array as numpy, as :func:`_np` shows a port tensor."""
    x = np.asarray(x)
    if x.dtype in (np.float16, ml_dtypes.bfloat16):
        return x.view(np.int16)
    if x.dtype == np.uint32:
        return x.view(np.int32)
    return x


def _equal(got, want):
    np.testing.assert_array_equal(_np(got), _jnp(want))


# --------------------------------------------------------------------------
# Storage and reads


@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("n", [6, 7])
@pytest.mark.parametrize("half", ["bf16", "fp16"])
def test_pack_unpack_match_jax(half, n, d):
    tab = _table(np.random.default_rng(n), n, d, half)
    want = jpk.pack_table(jnp.asarray(tab))
    got = ppk.pack_table(torch.from_numpy(tab))
    assert got.dtype == (torch.uint32 if half == "fp16" else torch.int32)
    assert ppk.half_dtype(got) == HALVES[half][1] and ppk.is_packed(got)
    _equal(got, want)
    host = ppk.pack_table_host(tab)
    np.testing.assert_array_equal(host, jpk.pack_table_host(tab))
    if n % 2:  # the padding plane is zeros
        assert not (host[-1].view(np.uint32) >> 16).any()
    _equal(ppk.unpack_table(got, n), jpk.unpack_table(want, n))
    _equal(ppk.unpack_table(got[None], n), jpk.unpack_table(want[None], n))
    unpacked = ppk.unpack_table_host(host, n)
    np.testing.assert_array_equal(
        unpacked, np.asarray(jpk.unpack_table_host(host, n)).astype(unpacked.dtype))
    # an ml_dtypes bfloat16 array packs by its own bits
    if half == "bf16":
        np.testing.assert_array_equal(ppk.pack_table_host(tab.astype(ml_dtypes.bfloat16)), host)


def _stores(rng, n, d, half):
    """(name, JAX store, port store) of a plain packed table and its triplet
    and quintuplet stores, with random fp32 state rows."""
    tab = _table(rng, n, d, half)
    jp = jpk.pack_table(jnp.asarray(tab))
    pp = ppk.pack_table(torch.from_numpy(tab))
    out = [("plain", jp, pp)]
    p = (n + 1) // 2
    for name, k in (("triplet", 1), ("quintuplet", 2)):
        states = [rng.normal(size=(2 * p, d)).astype(np.float32) for _ in range(k)]
        out.append((name, jpk.interleave_packed_state(jp, [jnp.asarray(s) for s in states]),
                    ppk.interleave_packed_state(pp, [torch.from_numpy(s) for s in states])))
    return out


@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("half", ["bf16", "fp16"])
def test_take_rows_match_jax(half, d):
    rng = np.random.default_rng(1)
    n = 40
    idx = rng.integers(n, size=(3, 7)).astype(np.int32)
    for name, js, ps in _stores(rng, n, d, half):
        assert ppk.is_tripled(ps, n) == (name == "triplet") == jpk.is_tripled(js, n)
        assert ppk.is_quintupled(ps, n) == (name == "quintuplet") == jpk.is_quintupled(js, n)
        got = ppk.take_rows(ps, torch.from_numpy(idx), n)
        assert got.shape == (3, 7, d) and got.dtype == HALVES[half][1]
        _equal(got, jpk.take_rows(js, jnp.asarray(idx), n))
        _equal(ppk.take_rows(ps[None], torch.from_numpy(idx), n),
               jpk.take_rows(js[None], jnp.asarray(idx), n))
        if name == "triplet":
            _equal(ppk.take_rows(ps, torch.from_numpy(idx), tripled=True),
                   jpk.take_rows(js, jnp.asarray(idx), tripled=True))
        for start, w in ((0, 8), (10, 16), (n - 6, 6)):
            _equal(ppk.take_contiguous_rows(ps, start, w, n),
                   jpk.take_contiguous_rows(js, start, w, n))
        with pytest.raises(ValueError):
            ppk.take_contiguous_rows(ps, 3, 8, n)  # packed windows start on even rows
        with pytest.raises(ValueError):
            ppk.take_contiguous_rows(ps, n - 4, 8, n)


def test_take_rows_of_the_fp32_layouts():
    table = torch.arange(48, dtype=torch.float32).reshape(12, 4)
    idx = torch.tensor([[2, 0], [1, 1]])
    assert torch.equal(ppk.take_rows(table, idx, 6), table[2 * idx])  # pair-major
    assert torch.equal(ppk.take_rows(table, idx, 4), table[3 * idx])  # treble-major
    assert torch.equal(ppk.take_rows(table, idx, paired=True), table[2 * idx])
    assert torch.equal(ppk.take_contiguous_rows(table, 1, 3, 6), table[2:8:2])
    assert torch.equal(ppk.take_contiguous_rows(table, 1, 2, 4), table[3:9:3])
    with pytest.raises(ValueError):
        ppk.take_rows(table, idx, tripled=True)  # a triplet store is packed
    with pytest.raises(ValueError):
        ppk.take_rows(table[:11], idx, paired=True)


def _sorted_writes(rng, n, d, size=40):
    """Sorted logical ids with duplicates and sibling pairs, rows 0 and n-1
    among them, and duplicate-identical rows."""
    ids = np.sort(np.concatenate([rng.integers(0, n, size=size), [0, n - 1]])).astype(np.int32)
    uniq, inv = np.unique(ids, return_inverse=True)
    rows = rng.normal(size=(len(uniq), d)).astype(np.float32)[inv]
    return ids, rows


@pytest.mark.parametrize("three_d", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("half", ["bf16", "fp16"])
def test_merge_packed_row_writes_matches_jax(half, seed, three_d):
    rng = np.random.default_rng(seed)
    n, d = 64, 128
    tab = _table(rng, n, d, half)
    jp, pp = jpk.pack_table(jnp.asarray(tab)), ppk.pack_table(torch.from_numpy(tab))
    if three_d:
        jp, pp = jp[None], pp[None]
    ids, rows = _sorted_writes(rng, n, d)
    results = []
    for srt in (True, False):
        ji, jr = jpk.merge_packed_row_writes(jp, jnp.asarray(ids), jnp.asarray(rows),
                                             sorted_idx=srt)
        pi, pr = ppk.merge_packed_row_writes(pp, torch.from_numpy(ids), torch.from_numpy(rows),
                                             sorted_idx=srt)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        _equal(pr, jr)
        results.append((pi, pr))
    assert torch.equal(results[0][0], results[1][0])
    assert torch.equal(_words(results[0][1]), _words(results[1][1]))
    # the general merge of unsorted writes
    perm = rng.permutation(len(ids))
    ji, jr = jpk.merge_packed_row_writes(jp, jnp.asarray(ids[perm]), jnp.asarray(rows[perm]))
    pi, pr = ppk.merge_packed_row_writes(pp, torch.from_numpy(ids[perm]),
                                         torch.from_numpy(rows[perm]))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    _equal(pr, jr)


def _words(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("half", ["bf16", "fp16"])
def test_merge_packed_block_writes_matches_jax(half, k):
    rng = np.random.default_rng(3 + k)
    n, d = 64, 16
    (_, jp, pp), *stores = _stores(rng, n, d, half)
    _, js, ps = stores[k - 1]
    ids, rows = _sorted_writes(rng, n, d)
    first = np.searchsorted(ids, ids)
    moms = [rng.normal(size=(len(ids), d)).astype(np.float32)[first] for _ in range(k)]
    jphys, jout = jpk.merge_packed_block_writes(js, jnp.asarray(ids), jnp.asarray(rows),
                                                [jnp.asarray(m) for m in moms])
    pphys, pout = ppk.merge_packed_block_writes(ps, torch.from_numpy(ids), torch.from_numpy(rows),
                                                [torch.from_numpy(m) for m in moms])
    np.testing.assert_array_equal(pphys.numpy(), np.asarray(jphys))
    assert pout.dtype == ps.dtype
    _equal(pout, jout)
    if k == 1:
        tphys, tout = ppk.merge_packed_triplet_writes(ps, torch.from_numpy(ids),
                                                      torch.from_numpy(rows),
                                                      torch.from_numpy(moms[0]))
        assert torch.equal(tphys, pphys) and torch.equal(_words(tout), _words(pout))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("half", ["bf16", "fp16"])
def test_interleave_split_match_jax(half, k):
    rng = np.random.default_rng(7)
    n, d = 41, 16
    tab = _table(rng, n, d, half)
    jp, pp = jpk.pack_table(jnp.asarray(tab)), ppk.pack_table(torch.from_numpy(tab))
    states = [rng.normal(size=(2 * 21, d)).astype(np.float32), None][:k]
    js = jpk.interleave_packed_state(jp, [None if s is None else jnp.asarray(s) for s in states])
    ps = ppk.interleave_packed_state(pp, [None if s is None else torch.from_numpy(s)
                                          for s in states])
    _equal(ps, js)
    _equal(ppk.interleave_packed_state(pp[None], [None] * k),
           jpk.interleave_packed_state(jp[None], [None] * k))
    jpar, jst = jpk.split_packed_state(js, k)
    ppar, pst = ppk.split_packed_state(ps, k)
    _equal(ppar, jpar)
    for got, want in zip(pst, jst):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    wrap = {1: (ppk.interleave_packed_momentum, ppk.split_packed_interleaved),
            2: (ppk.interleave_packed_adamw, ppk.split_packed_adamw)}[k]
    wide = wrap[0](pp, *[None if s is None else torch.from_numpy(s) for s in states])
    assert torch.equal(_words(wide), _words(ps))
    assert torch.equal(_words(wrap[1](wide)[0]), _words(ppar))
    with pytest.raises(ValueError):
        ppk.interleave_packed_state(torch.from_numpy(tab.astype(np.float32)), [None])
    with pytest.raises(ValueError):
        ppk.split_packed_state(ps[:-1], k)


# --------------------------------------------------------------------------
# Stochastic rounding


def _edge_rows(rng, d=128):
    """fp32 rows across magnitudes, with the edge values in the first two."""
    rows = (rng.normal(size=(48, d))
            * rng.choice([1e-7, 1e-3, 1.0, 1e3, 6e4], size=(48, 1))).astype(np.float32)
    rows[0, :9] = [0.0, -0.0, np.inf, -np.inf, np.nan, 65504.0, 65519.0, -65520.0, 3.4e38]
    rows[1, :10] = [6e-8, -6e-8, 1e-9, -1e-9, 6.1e-5, -6.1e-5, 3e-8, -3e-8, 1e-40, -1e-40]
    return rows


@pytest.mark.parametrize("half", ["bf16", "fp16"])
def test_sr_round_16_matches_jax(half):
    rng = np.random.default_rng(8)
    rows = _edge_rows(rng)
    idx = rng.integers(0, 2**31 - 1, size=rows.shape[0]).astype(np.int32)
    jt = jpk.pack_table(jnp.zeros((4, 128), jnp.float16 if half == "fp16" else jnp.bfloat16))
    pt = ppk.pack_table(torch.zeros(4, 128, dtype=HALVES[half][1]))
    for count in (1, 7, 2**31 - 1):
        want = np.asarray(jax_optim._sr_round_16(jnp.asarray(rows), jnp.asarray(idx),
                                                 jnp.asarray(count, jnp.int32), jt))
        got = port_optim._sr_round_16(torch.from_numpy(rows), torch.from_numpy(idx),
                                      torch.tensor(count, dtype=torch.int32), pt)
        assert got.dtype == HALVES[half][1]
        nan = np.isnan(rows)
        np.testing.assert_array_equal(np.isnan(got.float().numpy()), nan)
        np.testing.assert_array_equal(_np(got)[~nan], _jnp(want)[~nan])
    # no table: bf16; a plain 16-bit table: its dtype
    got = port_optim._sr_round_16(torch.from_numpy(rows), torch.from_numpy(idx),
                                  torch.tensor(3, dtype=torch.int32))
    assert got.dtype == torch.bfloat16
    got = port_optim._sr_round_16(torch.from_numpy(rows), torch.from_numpy(idx),
                                  torch.tensor(3, dtype=torch.int32),
                                  torch.zeros(2, 2, dtype=HALVES[half][1]))
    assert got.dtype == HALVES[half][1]


def test_sr_round_16_is_unbiased():
    """The mean of many rounds of a value lies far closer to it than a
    16-bit ulp (fp16 here; bf16 rides the same test in the JAX package)."""
    rng = np.random.default_rng(9)
    rows = torch.from_numpy((rng.normal(size=(4, 128)) * 0.3).astype(np.float32))
    idx = torch.tensor([5, 9, 14, 21], dtype=torch.int32)
    table = torch.zeros(2, 2, dtype=torch.float16)
    mean = sum(port_optim._sr_round_16(rows, idx, torch.tensor(c), table).double()
               for c in range(400)) / 400
    assert (mean - rows.double()).abs().mean() < 2e-4


# --------------------------------------------------------------------------
# Row optimizers

N, D, R = 40, 16, 90


def _inputs(seed, half):
    """A logical table and two (idx with duplicates, dyadic gradients)
    batches; the last rows stay untouched, and row 10 is touched while its
    sibling 11 is not."""
    rng = np.random.default_rng(seed)
    table = _table(rng, N, D, half)
    batches = []
    for _ in range(2):
        idx = rng.integers(0, N - 6, size=R).astype(np.int32)
        idx[idx == 11] = 10
        g = (rng.integers(-8, 9, size=(R, D)) / 4).astype(np.float32)
        batches.append((idx, g))
    return table, batches


def _make(opt_name, sr, interleaved, jax_side, **kw):
    mod = jax_optim if jax_side else port_optim
    if opt_name == "sgdm":
        return mod.RowSGDM(0.05, momentum=0.9, weight_decay=0.01, stochastic_rounding=sr,
                           interleaved=interleaved, **kw)
    return mod.RowAdamW(0.05, weight_decay=0.01, stochastic_rounding=sr,
                        interleaved=interleaved, **kw)


def _ordinal(bits):
    """16-bit patterns as integers ordered like their float values (±0 both
    0): one ulp apart is 1 apart."""
    b = bits.astype(np.int32) & 0xFFFF
    return np.where(b & 0x8000, -(b & 0x7FFF), b)


def _logical(table, n, half):
    """The 16-bit params of a JAX or port packed table or store, as int16
    bits (n, D)."""
    if torch.is_tensor(table):
        table = table.view(torch.int32).numpy().view(
            np.uint32 if half == "fp16" else np.int32)
    table = np.asarray(table)
    p = (n + 1) // 2
    if table.shape[0] != p:
        table = table.reshape(p, -1, table.shape[-1])[:, 0]
    words = np.ascontiguousarray(table).view(np.uint32)
    out = np.empty((2 * p, table.shape[-1]), np.int16)
    out[0::2] = (words & 0xFFFF).astype(np.uint16).view(np.int16)
    out[1::2] = (words >> 16).astype(np.uint16).view(np.int16)
    return out[:n]


def _moments(opt, table, state, n):
    """The fp32 moments of a packed run, logical-major (2P, D), by name."""
    if not opt.interleaved:
        return {k: np.asarray(v) if not torch.is_tensor(v) else v.numpy()
                for k, v in state.items() if k != "count"}
    if torch.is_tensor(table):
        _, states = ppk.split_packed_state(table, 1 if isinstance(opt, port_optim.RowSGDM) else 2)
        states = [s.numpy() for s in states]
    else:
        _, states = jpk.split_packed_state(table, 1 if isinstance(opt, jax_optim.RowSGDM) else 2)
        states = [np.asarray(s) for s in states]
    names = ["m"] if len(states) == 1 else ["mu", "nu"]
    return dict(zip(names, states))


@pytest.mark.parametrize("interleaved", [True, False])
@pytest.mark.parametrize("sr", [True, False])
@pytest.mark.parametrize("opt_name", ["sgdm", "adamw"])
@pytest.mark.parametrize("half", ["bf16", "fp16"])
def test_packed_row_optimizer_steps_match_jax(half, opt_name, sr, interleaved):
    table, batches = _inputs(11, half)
    jopt = _make(opt_name, sr, interleaved, True)
    popt = _make(opt_name, sr, interleaved, False)
    jt = jopt.widen_table(jpk.pack_table(jnp.asarray(table)))
    js = jopt.init(jt, n_logical=N)
    touched = np.zeros(N, bool)
    differ = total = 0
    for idx, g in batches:
        # the port starts each step from the JAX package's state
        pt = convert.params_from_jax({"t": np.asarray(jt)}, "cpu")["t"]
        ps = convert.opt_state_from_jax({"entity": js, "other": ()}, "cpu")["entity"]
        before = _logical(jt, N, half)
        jt, js = jopt.update_rows(jt, js, jnp.asarray(idx), jnp.asarray(g))
        pt, ps = popt.update_rows(pt, ps, torch.from_numpy(idx), torch.from_numpy(g))
        assert pt.dtype == (torch.uint32 if half == "fp16" else torch.int32)
        assert int(ps["count"]) == int(js["count"])
        got, want = _logical(pt, N, half), _logical(jt, N, half)
        touched[idx] = True
        # untouched rows (the sibling planes of touched packed rows among them)
        np.testing.assert_array_equal(got[~touched], before[~touched])
        np.testing.assert_array_equal(want[~touched], before[~touched])
        gap = np.abs(_ordinal(got) - _ordinal(want))
        assert gap.max() <= 1
        differ, total = differ + int((gap > 0).sum()), total + got[touched].size
        for name, m in _moments(popt, pt, ps, N).items():
            np.testing.assert_allclose(m, _moments(jopt, jt, js, N)[name], rtol=RTOL, atol=ATOL)
    assert not touched[11] and touched[10]
    assert differ <= 0.02 * total, (differ, total)


@pytest.mark.parametrize("sr", [True, False])
@pytest.mark.parametrize("opt_name", ["sgdm", "adamw"])
@pytest.mark.parametrize("half", ["bf16", "fp16"])
def test_interleaved_store_equals_separate_buffers(half, opt_name, sr):
    """The port's twins of tests/test_packed_interleaved.py:101 (SGDM) and
    tests/test_adamw_interleaved.py:311 (AdamW): the same trajectory, bit
    for bit, in the block store and in separate buffers."""
    table, batches = _inputs(12, half)
    packed = ppk.pack_table(torch.from_numpy(table))
    sep, inter = _make(opt_name, sr, False, False), _make(opt_name, sr, True, False)
    ts, tw = packed.clone(), inter.widen_table(packed.clone())
    ss, sw = sep.init(ts, n_logical=N), inter.init(tw, n_logical=N)
    for idx, g in batches * 2:
        ts, ss = sep.update_rows(ts, ss, torch.from_numpy(idx), torch.from_numpy(g))
        tw, sw = inter.update_rows(tw, sw, torch.from_numpy(idx), torch.from_numpy(g))
    k = 1 if opt_name == "sgdm" else 2
    params, states = ppk.split_packed_state(tw, k)
    assert torch.equal(_words(params), _words(ts))
    for got, name in zip(states, ["m"] if k == 1 else ["mu", "nu"]):
        assert torch.equal(got, ss[name])


@pytest.mark.parametrize("sr", [True, False])
@pytest.mark.parametrize("opt_name", ["sgdm", "adamw"])
@pytest.mark.parametrize("half", ["bf16", "fp16"])
def test_packed_equals_plain_16bit(half, opt_name, sr):
    """The port's twin of tests/test_packed.py:90: a packed table and a
    plain 16-bit table take the same trajectory bit for bit."""
    table, batches = _inputs(13, half)
    plain = torch.from_numpy(table).to(HALVES[half][1])
    packed = ppk.pack_table(torch.from_numpy(table))
    opt_plain, opt_packed = _make(opt_name, sr, False, False), _make(opt_name, sr, False, False)
    sp, sk = opt_plain.init(plain), opt_packed.init(packed)
    assert all(v.dtype == torch.float32 for k, v in sp.items() if k != "count")
    for idx, g in batches * 2:
        plain, sp = opt_plain.update_rows(plain, sp, torch.from_numpy(idx), torch.from_numpy(g))
        packed, sk = opt_packed.update_rows(packed, sk, torch.from_numpy(idx),
                                            torch.from_numpy(g))
    assert plain.dtype == HALVES[half][1]
    assert torch.equal(ppk.unpack_table(packed, N).view(torch.int16), plain.view(torch.int16))


@pytest.mark.parametrize("opt_name", ["sgdm", "adamw"])
@pytest.mark.parametrize("half", ["bf16", "fp16"])
def test_plain_16bit_row_optimizers_match_jax(half, opt_name):
    """A plain (unpacked) 16-bit table with separate fp32 moments, as the
    JAX package accepts it, against the JAX package step by step."""
    table, batches = _inputs(14, half)
    jopt, popt = _make(opt_name, True, False, True), _make(opt_name, True, False, False)
    jt = jnp.asarray(table).astype(jnp.float16 if half == "fp16" else jnp.bfloat16)
    js = jopt.init(jt)
    for idx, g in batches:
        pt = convert.params_from_jax({"t": np.asarray(jt)}, "cpu")["t"]
        ps = convert.opt_state_from_jax({"entity": js, "other": ()}, "cpu")["entity"]
        jt, js = jopt.update_rows(jt, js, jnp.asarray(idx), jnp.asarray(g))
        pt, ps = popt.update_rows(pt, ps, torch.from_numpy(idx), torch.from_numpy(g))
        assert pt.dtype == HALVES[half][1]
        assert np.abs(_ordinal(_np(pt)) - _ordinal(_jnp(jt))).max() <= 1


def test_layout_checks():
    packed = ppk.pack_table(torch.zeros(8, 4))
    sgdm = port_optim.RowSGDM(0.1, interleaved=True)
    assert set(sgdm.init(sgdm.widen_table(packed), n_logical=8)) == {"count"}
    with pytest.raises(ValueError):
        sgdm.init(packed, n_logical=8)  # not widened
    with pytest.raises(ValueError):
        sgdm.init(torch.zeros(8, 4, dtype=torch.bfloat16), n_logical=4)  # plain 16-bit
    adamw = port_optim.RowAdamW(0.1, interleaved=True)
    assert adamw.widen_table(packed).shape == (20, 4)
    with pytest.raises(ValueError):
        adamw.init(sgdm.widen_table(packed), n_logical=8)
    assert port_optim.RowAdamW(0.1).init(packed)["mu"].shape == (8, 4)
    with pytest.raises(ValueError):
        port_optim.interleave_momentum(packed)
    with pytest.raises(ValueError):
        port_optim.interleave_adamw(packed)


# --------------------------------------------------------------------------
# convert


@pytest.mark.parametrize("half", ["bf16", "fp16"])
def test_convert_carries_packed_storage(half):
    rng = np.random.default_rng(15)
    tab = _table(rng, 9, 16, half)
    host = jpk.pack_table_host(tab)
    arrays = {
        "packed": host,
        "triplet": np.asarray(jpk.interleave_packed_momentum(jnp.asarray(host))),
        "quintuplet": np.asarray(jpk.interleave_packed_adamw(jnp.asarray(host))[None]),
        "fp16": tab.astype(np.float16),
        "bf16": tab.astype(ml_dtypes.bfloat16),
    }
    params = convert.params_from_jax(arrays, "cpu")
    assert params["packed"].dtype == (torch.uint32 if half == "fp16" else torch.int32)
    assert params["fp16"].dtype == torch.float16 and params["bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(params["packed"]), host.view(np.int32))
    assert torch.equal(_words(params["packed"]),
                       _words(ppk.pack_table(torch.from_numpy(tab))))
    back = convert.params_to_numpy(params)
    for name in ("packed", "triplet", "quintuplet", "fp16"):
        assert back[name].dtype == arrays[name].dtype, name
        np.testing.assert_array_equal(back[name], arrays[name])
    assert back["bf16"].dtype == np.float32  # widened, exactly
    np.testing.assert_array_equal(back["bf16"], arrays["bf16"].astype(np.float32))
    # the (2P, D) moments of a separate-buffer packed RowSGDM
    jstate = jax_optim.RowSGDM(0.1).init(jnp.asarray(host))
    state = convert.opt_state_from_jax({"entity": jstate, "other": ()}, "cpu")["entity"]
    assert state["m"].shape == (10, 16) and state["m"].dtype == torch.float32


# --------------------------------------------------------------------------
# Top-k over packed tables

TOPK_ENTITY, TOPK_QUERY, TOPK_K = 600, 24, 2


def _topk(pkg, params, storage, window, head, rel):
    jax_side = pkg == "jax"
    sh, ns, sc, bess = ((jax_sh, jax_ns, jax_scoring, jax_bess) if jax_side
                        else (port_sh, port_ns, port_scoring, port_bess))
    sharding = sh.Sharding.create(TOPK_ENTITY, 1, seed=3)
    score_fn = sc.TransE(True, 1, sharding, 4, 128, seed=3)
    score_fn.compute_dtype = jnp.bfloat16 if jax_side else torch.bfloat16
    kw = dict(k=TOPK_K, candidate_sampler=ns.PlaceholderNegativeSampler("t"),
              score_fn=score_fn, return_scores=True, window_size=window)
    if jax_side:
        topk = bess.TopKQueryBessKGE(axis_name=None, **kw)
        out = topk.forward(params, jnp.asarray(rel), head=jnp.asarray(head))
    else:
        out = bess.TopKQueryBessKGE(**kw).forward(params, torch.from_numpy(rel),
                                                  head=torch.from_numpy(head))
    return np.asarray(out["topk_global_id"]), np.asarray(out["topk_scores"])


def _topk_params(storage, half):
    """JAX params (numpy) of the packed table, the store, or the plain
    16-bit table the packed one holds."""
    sharding = jax_sh.Sharding.create(TOPK_ENTITY, 1, seed=3)
    score_fn = jax_scoring.TransE(True, 1, sharding, 4, 128, seed=3)
    score_fn.dtype = jnp.float16 if half == "fp16" else jnp.bfloat16
    score_fn.packed_entity_storage = storage != "plain"
    params = {k: np.asarray(v) for k, v in score_fn.initial_params().items()}
    if storage == "triplet":
        params["entity_embedding"] = np.asarray(
            jpk.interleave_packed_momentum(jnp.asarray(params["entity_embedding"])))
    return params


@pytest.mark.parametrize("window", [512, 16, 75])
@pytest.mark.parametrize("storage,half", [("packed", "bf16"), ("packed", "fp16"),
                                          ("triplet", "bf16")])
def test_topk_over_packed_tables(storage, half, window):
    """Windows of 512 (the fused chunk merge, B7) and 16 (the sort merge)
    read packed windows; 75, odd, gathers rows. The sort merge's scores are
    bf16 (B5 returns its operands' dtype) and the JAX package's CPU path
    sums bf16 differences without an fp32 accumulator: one bf16 ulp,
    at most 2^-7 of a score."""
    rng = np.random.default_rng(16)
    max_rows = jax_sh.Sharding.create(TOPK_ENTITY, 1, seed=3).max_entity_per_shard
    head = rng.integers(max_rows, size=TOPK_QUERY).astype(np.int32)
    rel = rng.integers(4, size=TOPK_QUERY).astype(np.int32)
    jparams = _topk_params(storage, half)
    pparams = convert.params_from_jax(jparams, "cpu")
    ids, scores = _topk("port", pparams, storage, window, head, rel)
    plain = convert.params_from_jax(_topk_params("plain", half), "cpu")
    plain_ids, plain_scores = _topk("port", plain, "plain", window, head, rel)
    np.testing.assert_array_equal(ids, plain_ids)
    np.testing.assert_array_equal(scores, plain_scores)
    jids, jscores = _topk("jax", {k: jnp.asarray(v) for k, v in jparams.items()}, storage,
                          window, head, rel)
    tol = 2.0**-7 * np.abs(jscores) + 1e-4
    assert (np.abs(scores - jscores) <= tol).all()
    # IDs where the score is further than the tolerance from both neighbours
    gap = np.abs(np.diff(jscores, axis=1)) > 2 * tol[:, 1:]
    checked = np.concatenate([gap[:, :1], gap[:, :-1] & gap[:, 1:]], axis=1)
    np.testing.assert_array_equal(ids[:, :-1][checked], jids[:, :-1][checked])


@pytest.mark.parametrize("half", ["bf16", "fp16"])
def test_device_table_init_casts_as_jax(half):
    """``device_table_init`` at a 16-bit dtype: an array initializer lands on
    the JAX package's bits (a round-to-nearest cast), a drawn table is the
    fp32 draw cast once; ``initial_params_device`` packs that table."""
    from besskge_tpu import embedding as jax_embedding
    from besskge_tpu_torch import embedding as port_embedding

    jdt, pdt = (jnp.float16, torch.float16) if half == "fp16" else (jnp.bfloat16, torch.bfloat16)
    arr = (np.random.default_rng(17).normal(size=(6, 16)) / 3).astype(np.float32)
    want = jax_embedding.device_table_init(arr, [16], (6, 16), 0, jdt)
    got = port_embedding.device_table_init(arr, [16], (6, 16), 0, pdt, None, "cpu")
    _equal(got, want)
    init = [port_embedding.init_KGE_uniform]
    drawn = port_embedding.device_table_init(init, [16], (6, 16), 0, pdt, None, "cpu",
                                             torch.Generator("cpu").manual_seed(1))
    fp32 = port_embedding.device_table_init(init, [16], (6, 16), 0, torch.float32, None, "cpu",
                                            torch.Generator("cpu").manual_seed(1))
    assert drawn.dtype == pdt and torch.equal(drawn.view(torch.int16),
                                              fp32.to(pdt).view(torch.int16))
    score_fn = port_scoring.TransE(True, 1, port_sh.Sharding.create(12, 1, seed=0), 3, 16)
    score_fn.dtype, score_fn.packed_entity_storage = pdt, True
    params = score_fn.initial_params_device(device="cpu", generator=torch.Generator("cpu"))
    score_fn.packed_entity_storage = False
    plain = score_fn.initial_params_device(device="cpu", generator=torch.Generator("cpu"))
    assert params["relation_embedding"].dtype == pdt
    assert torch.equal(_words(params["entity_embedding"]),
                       _words(ppk.pack_table(plain["entity_embedding"])))
