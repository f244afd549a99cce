"""The plain versions of the port's row kernels against the JAX package's
Pallas kernels, run in the interpreter as ``tests/test_pallas_ops.py`` runs
them.

* B8 ``row_kernels.scatter_rows_multi`` against
  ``besskge_tpu.ops.pallas_scatter.scatter_rows_multi``: two and three
  tables, unequal index lists, a ``(1, n, D)`` block, and per-table
  duplicate runs under ``skip_dups`` (the cases of ``test_pallas_ops.py``
  but the packed-plus-moment one, whose packed table waits on ROADMAP A9).
* B9 ``row_kernels.gather_rows`` against ``pallas_scatter.gather_rows``:
  ragged R, pair slices of a ``(1, n, D)`` block, and ``skip_dups``, whose
  duplicate slots are compared nowhere (both leave them unwritten).
* B3 ``row_kernels.scatter_rows`` at h = 3 (the treble-major table of an
  interleaved ``RowAdamW``) and h = 5 (the quintuplet store of ROADMAP A9).

Every comparison is bit for bit: all of these copy rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from besskge_tpu.ops.pallas_scatter import gather_rows as jax_gather_rows
from besskge_tpu.ops.pallas_scatter import scatter_rows as jax_scatter_rows
from besskge_tpu.ops.pallas_scatter import scatter_rows_multi as jax_scatter_rows_multi
from besskge_tpu_torch.ops import row_kernels


def _t(a):
    return torch.from_numpy(np.array(a))


def _first_of_run(idx):
    return np.concatenate([[True], idx[1:] != idx[:-1]])


def _multi(tables, idxs, rows, skip_dups=False):
    """(JAX outputs, port tables after the in-place write), as numpy."""
    want = jax_scatter_rows_multi(
        tuple(map(jnp.asarray, tables)), tuple(map(jnp.asarray, idxs)),
        tuple(map(jnp.asarray, rows)), interpret=True, skip_dups=skip_dups,
    )
    got = [_t(t) for t in tables]
    out = row_kernels.scatter_rows_multi(got, [_t(i) for i in idxs], [_t(r) for r in rows],
                                         skip_dups=skip_dups)
    assert all(o is g for o, g in zip(out, got))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def test_scatter_rows_multi_two_buffers():
    rng = np.random.default_rng(7)
    tables = [rng.normal(size=(64, 128)).astype(np.float32),
              rng.normal(size=(40, 128)).astype(np.float32)]
    idxs = [np.array([3, 17, 0, 63, 40], np.int32), np.array([1, 2, 3, 4, 39], np.int32)]
    rows = [rng.normal(size=(5, 128)).astype(np.float32) for _ in range(2)]
    for want, got in zip(*_multi(tables, idxs, rows)):
        np.testing.assert_array_equal(got, want)


def test_scatter_rows_multi_three_buffers_unequal_lengths_and_3d():
    rng = np.random.default_rng(8)
    tables = [rng.normal(size=(1, 32, 128)).astype(np.float32),
              rng.normal(size=(64, 128)).astype(np.float32),
              rng.normal(size=(64, 128)).astype(np.float32)]
    idxs = [np.array([0, 31, 5], np.int32), np.array([2, 3, 4, 5, 6, 7, 8], np.int32),
            np.array([62, 63], np.int32)]
    rows = [rng.normal(size=(len(i), 128)).astype(np.float32) for i in idxs]
    want, got = _multi(tables, idxs, rows)
    for w, g, t in zip(want, got, tables):
        assert g.shape == t.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k", [2, 3])
def test_scatter_rows_multi_skip_dups_independent_runs(k):
    """Each table has its own runs; duplicate slots carry NaN and are never
    written."""
    rng = np.random.default_rng(11)
    tables = [rng.normal(size=(64, 128)).astype(np.float32) for _ in range(k)]
    idxs = [np.array([2, 2, 7, 7, 7, 8, 50, 50, 51], np.int32),
            np.array([0, 1, 1, 1, 1, 9, 9, 60, 60], np.int32),
            np.array([5, 6, 6, 30], np.int32)][:k]
    rows = []
    for idx in idxs:
        r = rng.normal(size=(len(idx), 128)).astype(np.float32)
        r[~_first_of_run(idx)] = np.nan
        rows.append(r)
    want, got = _multi(tables, idxs, rows, skip_dups=True)
    for w, g in zip(want, got):
        assert np.isfinite(g).all()
        np.testing.assert_array_equal(g, w)


def test_scatter_rows_multi_int32_words():
    """4-byte words of any dtype: an int32 table beside an fp32 one."""
    rng = np.random.default_rng(12)
    tables = [rng.integers(-2**31, 2**31 - 1, size=(20, 128)).astype(np.int32),
              rng.normal(size=(40, 128)).astype(np.float32)]
    idxs = [np.array([4, 5, 11], np.int32), np.array([8, 10, 22], np.int32)]
    rows = [rng.integers(0, 2**30, size=(3, 128)).astype(np.int32),
            rng.normal(size=(3, 128)).astype(np.float32)]
    for want, got in zip(*_multi(tables, idxs, rows)):
        np.testing.assert_array_equal(got, want)


def test_scatter_rows_multi_validates():
    t = torch.zeros(8, 4)
    with pytest.raises(ValueError):  # one index list short
        row_kernels.scatter_rows_multi([t, t.clone()], [torch.tensor([1])], [torch.zeros(1, 4)])
    with pytest.raises(ValueError):  # row widths differ
        row_kernels.scatter_rows_multi([t, torch.zeros(8, 3)], [torch.tensor([1])] * 2,
                                       [torch.zeros(1, 4), torch.zeros(1, 3)])
    with pytest.raises(ValueError):  # more tables than one launch takes
        row_kernels.scatter_rows_multi([t.clone() for _ in range(5)], [torch.tensor([1])] * 5,
                                       [torch.zeros(1, 4)] * 5)
    with pytest.raises(IndexError):
        row_kernels.scatter_rows_multi([t], [torch.tensor([8])], [torch.zeros(1, 4)])


@pytest.mark.parametrize("R", [5, 200])  # 5: the JAX kernel pads to its unroll
def test_gather_rows_matches_pallas(R):
    rng = np.random.default_rng(12 + R)
    table = rng.normal(size=(512, 128)).astype(np.float32)
    idx = rng.integers(0, 512, size=R).astype(np.int32)
    want = np.asarray(jax_gather_rows(jnp.asarray(table), jnp.asarray(idx), interpret=True))
    got = row_kernels.gather_rows(_t(table), _t(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), table[idx])


def test_gather_rows_pairs_3d():
    rng = np.random.default_rng(13)
    table = rng.normal(size=(1, 64, 128)).astype(np.float32)
    phys = np.array([0, 10, 10, 62], np.int32)
    want = np.asarray(jax_gather_rows(jnp.asarray(table), jnp.asarray(phys), interpret=True,
                                      slice_rows=2))
    got = row_kernels.gather_rows(_t(table), _t(phys), slice_rows=2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("h", [2, 3])
def test_gather_rows_skip_dups_first_of_run_only(h):
    rng = np.random.default_rng(14)
    table = rng.normal(size=(3 * 128, 128)).astype(np.float32)
    idx = np.sort(rng.integers(0, 128, size=96)).astype(np.int32) * h
    want = np.asarray(jax_gather_rows(jnp.asarray(table), jnp.asarray(idx), interpret=True,
                                      slice_rows=h, skip_dups=True))
    got = row_kernels.gather_rows(_t(table), _t(idx), slice_rows=h, skip_dups=True).numpy()
    sel = np.repeat(_first_of_run(idx), h)
    assert got.shape == want.shape == (h * 96, 128)
    np.testing.assert_array_equal(got[sel], want[sel])


def test_gather_rows_validates():
    with pytest.raises(IndexError):
        row_kernels.gather_rows(torch.zeros(8, 4), torch.tensor([7]), slice_rows=2)
    with pytest.raises(ValueError):
        row_kernels.gather_rows(torch.zeros(8, 4), torch.zeros(2, 2, dtype=torch.int32))


@pytest.mark.parametrize("h", [3, 5])
@pytest.mark.parametrize("skip_dups", [False, True])
@pytest.mark.parametrize("block", [False, True])
@pytest.mark.parametrize("R", [8, 29])
def test_scatter_rows_long_slices_match_pallas(h, skip_dups, block, R):
    """B3 writing (3, D) and (5, D) blocks at h-aligned rows."""
    rng = np.random.default_rng(h * 100 + R)
    n, D = 20 * h, 128
    idx = np.sort(rng.integers(0, n // h, size=R)).astype(np.int32)
    idx[1::3] = idx[0::3][: len(idx[1::3])]
    idx = np.sort(idx) * h
    table = rng.normal(size=(n, D)).astype(np.float32)
    rows = rng.normal(size=(R, h, D)).astype(np.float32)
    first = _first_of_run(idx)
    if skip_dups:
        rows[~first] = np.nan
    else:
        rows = rows[np.maximum.accumulate(np.where(first, np.arange(R), 0))]
    rows = rows.reshape(h * R, D)
    if block:
        table = table[None]
    want = np.asarray(jax_scatter_rows(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(rows),
                                       interpret=True, slice_rows=h, skip_dups=skip_dups))
    got = _t(table)
    row_kernels.scatter_rows(got, _t(idx), _t(rows), h, skip_dups)
    np.testing.assert_array_equal(got.numpy(), want)
