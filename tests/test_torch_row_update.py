"""The port's sparse row updates against the JAX package.

* Plain B3 (``row_kernels.scatter_rows``) against
  ``besskge_tpu.ops.pallas_scatter.scatter_rows`` in the Pallas interpreter,
  and plain B4 (``row_kernels.fused_pair_sgdm``) against
  ``besskge_tpu.ops.pallas_row_sgdm.fused_pair_sgdm``, as
  ``tests/test_pallas_ops.py`` runs them: B3 to equal bits; B4 to rtol and
  atol 1e-6 (the tolerance the JAX package's own test of the kernel uses),
  because XLA on the CPU contracts ``momentum·m + g`` into one fused
  multiply-add where the port rounds after the multiply and after the add.
* ``optim._dedup_row_grads``, ``interleave_momentum``/``split_interleaved``
  and ``RowSGDM.update_rows`` (both variants) against ``besskge_tpu.optim``.

Tolerances: sorted indices and layouts are compared bit for bit. The
per-row gradient sums are cumsum differences on both sides, but the two
frameworks scan in different orders: each prefix sum errs by at most
``R·2^-24·Σ|g|`` over the R rows of a column, so sums (and the momentum
built from them) are held to twice that, and the params, moved by ``lr``
times the momentum, to ``lr`` times it on top of an fp32 rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from besskge_tpu import optim as jax_optim
from besskge_tpu.ops.pallas_row_sgdm import fused_pair_sgdm as jax_fused_pair_sgdm
from besskge_tpu.ops.pallas_scatter import scatter_rows as jax_scatter_rows
from besskge_tpu_torch import optim as port_optim
from besskge_tpu_torch.ops import row_kernels

U = 2.0**-24


def _runs(rng, R, n):
    """Sorted indices in [0, n) with runs of equal values."""
    idx = rng.integers(0, n, size=R)
    idx[1::3] = idx[0::3][: len(idx[1::3])]
    return np.sort(idx).astype(np.int32)


def _first_of_run(idx):
    return np.concatenate([[True], idx[1:] != idx[:-1]])


@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("skip_dups", [False, True])
@pytest.mark.parametrize("block", [False, True])
@pytest.mark.parametrize("R", [8, 29])  # 29: not a multiple of the TPU unroll
def test_scatter_rows_matches_pallas(h, skip_dups, block, R):
    rng = np.random.default_rng(h * 100 + R)
    n, D = 64, 128
    idx = _runs(rng, R, n - h)
    if h == 2:
        idx -= idx % 2
    table = rng.normal(size=(n, D)).astype(np.float32)
    rows = rng.normal(size=(R, h, D)).astype(np.float32)
    first = _first_of_run(idx)
    if skip_dups:
        rows[~first] = np.nan  # never written
    else:  # duplicates carry identical rows by contract
        rows = rows[np.maximum.accumulate(np.where(first, np.arange(R), 0))]
    rows = rows.reshape(h * R, D)
    if block:
        table = table[None]
    want = np.asarray(jax_scatter_rows(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(rows), interpret=True,
        slice_rows=h, skip_dups=skip_dups,
    ))
    got = torch.from_numpy(table.copy())
    out = row_kernels.scatter_rows(got, torch.from_numpy(idx), torch.from_numpy(rows), h, skip_dups)
    assert out is got
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_rows_casts_rows_and_validates():
    table = torch.zeros(10, 8, dtype=torch.bfloat16)
    rows = torch.arange(16, dtype=torch.float32).reshape(2, 8)
    row_kernels.scatter_rows(table, torch.tensor([3, 7]), rows)
    assert torch.equal(table[[3, 7]], rows.to(torch.bfloat16))
    with pytest.raises(ValueError):
        row_kernels.scatter_rows(table, torch.tensor([3]), rows)
    with pytest.raises(IndexError):
        row_kernels.scatter_rows(table, torch.tensor([3, 9]), torch.zeros(4, 8), slice_rows=2)
    with pytest.raises(ValueError):
        row_kernels.scatter_rows(torch.zeros(10, 16)[:, ::2], torch.tensor([1]), torch.zeros(1, 8))


@pytest.mark.parametrize("lr_tensor", [False, True])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("block", [False, True])
def test_fused_pair_sgdm_matches_pallas(lr_tensor, weight_decay, block):
    rng = np.random.default_rng(21)
    n, D, R = 64, 128, 40
    logical = _runs(rng, R, n)
    table = rng.normal(size=(2 * n, D)).astype(np.float32)
    grads = rng.normal(size=(R, D)).astype(np.float32)
    grads[~_first_of_run(logical)] = np.nan  # only the first slot of a run is read
    if block:
        table = table[None]
    lr = np.float32(0.05)
    want = np.asarray(jax_fused_pair_sgdm(
        jnp.asarray(table), jnp.asarray(2 * logical), jnp.asarray(grads),
        lr=jnp.asarray(lr) if lr_tensor else 0.05, momentum=0.9,
        weight_decay=weight_decay, interpret=True,
    ))
    got = torch.from_numpy(table.copy())
    port_lr = torch.tensor(lr) if lr_tensor else 0.05
    row_kernels.fused_pair_sgdm(
        got, torch.from_numpy(2 * logical), torch.from_numpy(grads), port_lr, 0.9, weight_decay
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    untouched = np.setdiff1d(np.arange(n), logical)
    np.testing.assert_array_equal(
        got.numpy().reshape(n, 2, D)[untouched], table.reshape(n, 2, D)[untouched]
    )


def test_fused_pair_sgdm_validates():
    table = torch.zeros(8, 4)
    with pytest.raises(IndexError):
        row_kernels.fused_pair_sgdm(table, torch.tensor([1]), torch.zeros(1, 4), 0.1)
    with pytest.raises(IndexError):
        row_kernels.fused_pair_sgdm(table, torch.tensor([8]), torch.zeros(1, 4), 0.1)
    with pytest.raises(ValueError):
        row_kernels.fused_pair_sgdm(torch.zeros(7, 4), torch.tensor([0]), torch.zeros(1, 4), 0.1)


def _grad_inputs(seed, R=300, n=50, D=16):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=R).astype(np.int32)
    g = rng.normal(size=(R, D)).astype(np.float32)
    return idx, g


def test_dedup_row_grads_matches_jax():
    idx, g = _grad_inputs(0)
    want_i, want_g = jax_optim._dedup_row_grads(None, jnp.asarray(idx), jnp.asarray(g))
    got_i, got_g = port_optim._dedup_row_grads(torch.from_numpy(idx), torch.from_numpy(g))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    tol = 2 * len(idx) * U * np.abs(g).sum(0)
    assert (np.abs(got_g.numpy() - np.asarray(want_g)) <= tol).all()
    # Every occurrence of a row carries the row's full sum.
    for row in np.unique(idx):
        np.testing.assert_allclose(
            got_g.numpy()[got_i.numpy() == row], np.broadcast_to(
                g[idx == row].sum(0), ((idx == row).sum(), g.shape[1])
            ), rtol=1e-5, atol=float(tol.max()),
        )


@pytest.mark.parametrize("block", [False, True])
def test_interleave_round_trip_matches_jax(block):
    rng = np.random.default_rng(1)
    t = rng.normal(size=(7, 16)).astype(np.float32)
    m = rng.normal(size=(7, 16)).astype(np.float32)
    if block:
        t = t[None]
    want = np.asarray(jax_optim.interleave_momentum(jnp.asarray(t), jnp.asarray(m)))
    got = port_optim.interleave_momentum(torch.from_numpy(t), torch.from_numpy(m))
    np.testing.assert_array_equal(got.numpy(), want)
    p2, m2 = port_optim.split_interleaved(got)
    np.testing.assert_array_equal(p2.numpy(), t)
    np.testing.assert_array_equal(m2.numpy().reshape(7, 16), m)
    zero = port_optim.interleave_momentum(torch.from_numpy(t))
    assert not port_optim.split_interleaved(zero)[1].any()


@pytest.mark.parametrize("variant", ["xla", "fused"])
@pytest.mark.parametrize("schedule", [False, True])
def test_row_sgdm_update_rows_matches_jax(variant, schedule):
    n, D = 50, 16
    idx, g = _grad_inputs(2, n=n, D=D)
    rng = np.random.default_rng(3)
    table = np.asarray(jax_optim.interleave_momentum(
        jnp.asarray(rng.normal(size=(n, D)).astype(np.float32)),
        jnp.asarray(rng.normal(size=(n, D)).astype(np.float32)),
    ))
    jax_lr = (lambda c: 0.1 / (1.0 + c)) if schedule else 0.1
    port_lr = (lambda c: 0.1 / (1.0 + c)) if schedule else 0.1
    jrow = jax_optim.RowSGDM(jax_lr, momentum=0.9, weight_decay=0.01, interleaved=True)
    prow = port_optim.RowSGDM(port_lr, momentum=0.9, weight_decay=0.01, interleaved=True,
                              fused_variant=variant)
    jt, js = jnp.asarray(table), jrow.init(jnp.asarray(table), n_logical=n)
    pt = torch.from_numpy(table.copy())
    ps = prow.init(pt, n_logical=n)
    for step in range(2):  # the second step reads the first's momentum
        jt, js = jrow.update_rows(jt, js, jnp.asarray(idx), jnp.asarray(g))
        pt, ps = prow.update_rows(pt, ps, torch.from_numpy(idx), torch.from_numpy(g))
    assert int(ps["count"]) == int(js["count"]) == 2
    tol = 2 * 2 * len(idx) * U * np.abs(g).sum(0)  # two steps of summed gradients
    want = np.asarray(jt).reshape(n, 2, D)
    got = pt.numpy().reshape(n, 2, D)
    assert (np.abs(got[:, 1] - want[:, 1]) <= tol + 1e-6 * np.abs(want[:, 1])).all()
    assert (np.abs(got[:, 0] - want[:, 0]) <= 0.2 * tol + 1e-6 * np.abs(want[:, 0])).all()
    untouched = np.setdiff1d(np.arange(n), idx)
    np.testing.assert_array_equal(got[untouched], table.reshape(n, 2, D)[untouched])


def test_unported_row_sgdm_forms_raise():
    # The separate-buffer form (B8), the "pallas_gather" variant (B9) and
    # 16-bit tables (A9) are ported; unknown variants, inconsistent layouts
    # and a plain 16-bit table under interleaved momentum raise.
    row = port_optim.RowSGDM(0.1, momentum=0.9)
    assert set(row.init(torch.zeros(10, 4))) == {"m", "count"}
    port_optim.RowSGDM(0.1, momentum=0.9, interleaved=True, fused_variant="pallas_gather")
    with pytest.raises(ValueError):
        port_optim.RowSGDM(0.1, momentum=0.9, interleaved=True, fused_variant="other")
    with pytest.raises(ValueError):
        port_optim.RowSGDM(0.1, momentum=0.9, fused_variant="fused")
    with pytest.raises(ValueError):
        port_optim.RowSGDM(0.1, momentum=0.0, interleaved=True).init(torch.zeros(8, 4))
    row = port_optim.RowSGDM(0.1, momentum=0.9, interleaved=True)
    with pytest.raises(ValueError):
        row.init(torch.zeros(10, 4), n_logical=4)
    with pytest.raises(ValueError, match="row-pair-packed"):
        row.init(torch.zeros(8, 4, dtype=torch.bfloat16), n_logical=4)
    state = port_optim.RowSGDM(0.1).init(torch.zeros(8, 4, dtype=torch.bfloat16))
    assert state["m"].dtype == torch.float32 and state["m"].shape == (8, 4)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_dense_sgd_matches_optax(momentum):
    import optax

    rng = np.random.default_rng(4)
    p = {"relation_embedding": rng.normal(size=(5, 8)).astype(np.float32)}
    grads = [rng.normal(size=(5, 8)).astype(np.float32) for _ in range(3)]
    opt = optax.sgd(0.05, momentum=momentum or None)
    jp, js = dict(p), opt.init(p)
    sgd = port_optim.SGD(0.05, momentum=momentum)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    ts = sgd.init(tp)
    for g in grads:
        upd, js = opt.update({"relation_embedding": jnp.asarray(g)}, js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = sgd.update_({"relation_embedding": torch.from_numpy(g)}, ts, tp)
    np.testing.assert_allclose(tp["relation_embedding"].numpy(), np.asarray(jp["relation_embedding"]),
                               rtol=1e-6, atol=1e-7)
    if momentum:
        np.testing.assert_allclose(ts["trace"]["relation_embedding"].numpy(),
                                   np.asarray(js[0].trace["relation_embedding"]),
                                   rtol=1e-6, atol=1e-7)
    assert int(ts["count"]) == len(grads)
