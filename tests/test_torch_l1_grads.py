"""The port's batched L1 ops and the p=1 autograd path against the JAX package.

* Plain B1, B2 and B6 (``besskge_tpu_torch.ops.l1_kernels``) against
  ``besskge_tpu.ops.pallas_distance`` ``l1_distance_matrix_batched``,
  ``l1_distance_grads_batched`` and ``l1_distance_grads`` in the Pallas
  interpreter, as ``tests/test_pallas_ops.py`` runs them: fp32 and bf16,
  ragged B and N, planted exact ties; and at the edges of the CUDA gradient
  kernel's tiles (own rows 32, or 8 where the grid is small; stream tiles of
  32 rows; depth slices of 32), d = 1, one group, fewer stream rows than a
  tile; plain B1 (and B5 for one group) at the edges of the CUDA distance
  kernel's tiles.
* ``p_distance_matrix(·, ·, 1)`` carries a gradient (the repaired fault: on
  a card the result had no ``grad_fn``) equal to the JAX package's
  ``_l1_grads_formula``, and under ``torch.func.vmap`` of
  ``torch.func.vjp`` it reaches the batched rules (B1 forward, B2 backward),
  against ``jax.vmap`` of ``jax.vjp``.

Tolerances: distances rtol 1e-5, atol 1e-4 (fp32 sums of d ≤ 128 terms in
another order); one bf16 ulp (2^-7 relative) more where the output is bf16,
because each side rounds its own fp32 sum. Gradients are fp32 sums of n terms
``±w``; recursive summation errs by at most ``(n − 1)·2^-24·Σ|w|`` on each
side, so the two sides differ by at most ``2·n·2^-24·Σ|w|`` per output.
Ties: both packages' kernels take ``sign(0) = 0``; XLA's autodiff of ``abs``
(``jax.vjp`` of ``_l1_broadcast``) gives ``+g`` there, so against it the
inputs are drawn tie-free (fp32 normals) and against ``_l1_grads_formula``
ties are planted.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from besskge_tpu.ops import distance as jax_distance
from besskge_tpu.ops import pallas_distance as jax_pd
from besskge_tpu_torch.ops import distance as port_distance
from besskge_tpu_torch.ops import l1_kernels

RTOL, ATOL = 1e-5, 1e-4
BF16_ULP = 2.0**-7
U = 2.0**-24

# (G, B, N, d): the training shape cut in depth, ragged B and N, ragged d.
SHAPES = [(2, 64, 72, 128), (3, 37, 211, 48), (1, 5, 9, 33)]
# One below, at and one above the gradient kernel's tiles: B (da's own rows)
# about 32; N (da's stream rows, db's own rows) about 32 with d about the
# 32-column depth slice; one group, whose small grid takes 8-row own tiles,
# with B about 8 and N under one stream tile; d = 1.
EDGE_SHAPES = [
    (2, 31, 40, 32), (2, 32, 40, 32), (2, 33, 40, 32),
    (2, 20, 31, 33), (2, 20, 32, 31), (2, 20, 33, 32),
    (1, 7, 9, 8), (1, 8, 8, 16), (1, 9, 7, 24),
    (3, 5, 6, 1),
]
# At the edges of the CUDA distance kernel's tiles (32 rows, or 16 for one
# group, x 48 columns; depth slices of 128): a row and a column under and
# over whole tiles, depth one under and over a slice and two slices, d = 100
# (200-byte bf16 rows) with B and N one past a tile, rows that are not runs
# of 4 values, one group. (Unaligned bases and the step's full shapes are
# card cases: profiling.DISTANCE_EDGES in tests/test_torch_cuda.py.)
DISTANCE_EDGE_SHAPES = [
    (2, 31, 47, 127), (2, 33, 49, 129), (2, 32, 48, 256),
    (2, 33, 49, 100), (1, 17, 49, 100), (3, 37, 211, 33), (1, 15, 47, 3),
]


def _inputs(G, B, N, d, dtype, seed, ties=True):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(G, B, d)) / d).astype(np.float32)
    b = (rng.normal(size=(G, N, d)) / d).astype(np.float32)
    if ties:  # exact ties in half of the coordinates of a few pairs
        k = min(B, N) // 2
        b[:, :k, : d // 2] = a[:, :k, : d // 2]
    w = rng.normal(size=(G, B, N)).astype(np.float32)
    if dtype == "bfloat16":
        a = a.astype(ml_dtypes.bfloat16)
        b = b.astype(ml_dtypes.bfloat16)
    return a, b, w


def _torch(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _sum_tol(w, axis):
    """2·n·2^-24·Σ|w| along ``axis`` (the summed one), for broadcasting."""
    return 2 * w.shape[axis] * U * np.abs(w).sum(axis)[..., None] + 1e-30


def _within(got, want, tol):
    err = np.abs(got - want)
    assert (err <= tol).all(), float((err - tol).max())


def _assert_grads(got_da, got_db, want_da, want_db, w):
    _within(got_da, want_da, _sum_tol(w, -1))
    _within(got_db, want_db, _sum_tol(np.swapaxes(w, -1, -2), -1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES + DISTANCE_EDGE_SHAPES)
def test_batched_distance_matches_pallas(shape, dtype):
    """B1 on every group, and B5 where there is one group, planted ties
    included."""
    a, b, _ = _inputs(*shape, dtype, seed=sum(shape))
    want = np.asarray(
        jax_pd.l1_distance_matrix_batched(jnp.asarray(a), jnp.asarray(b), interpret=True)
    ).astype(np.float32)
    got = l1_kernels.l1_distance_matrix_batched(_torch(a), _torch(b))
    assert got.dtype == getattr(torch, dtype) and got.shape == shape[:2] + shape[2:3]
    tol = ATOL + (RTOL + (BF16_ULP if dtype == "bfloat16" else 0.0)) * np.abs(want)
    assert (np.abs(got.float().numpy() - want) <= tol).all()
    if shape[0] == 1:
        want5 = np.asarray(
            jax_pd.l1_distance_matrix(jnp.asarray(a[0]), jnp.asarray(b[0]), interpret=True)
        ).astype(np.float32)
        got5 = l1_kernels.l1_distance_matrix(_torch(a[0]), _torch(b[0]))
        assert (np.abs(got5.float().numpy() - want5) <= tol[0]).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_batched_grads_match_pallas(shape, dtype):
    a, b, w = _inputs(*shape, dtype, seed=2 * sum(shape))
    want_da, want_db = jax_pd.l1_distance_grads_batched(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(w), interpret=True
    )
    got_da, got_db = l1_kernels.l1_distance_grads_batched(_torch(a), _torch(b), torch.from_numpy(w))
    assert got_da.dtype == got_db.dtype == torch.float32
    _assert_grads(got_da.numpy(), got_db.numpy(), np.asarray(want_da), np.asarray(want_db), w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_grads_match_pallas(shape, dtype):
    a, b, w = _inputs(*shape, dtype, seed=3 * sum(shape))
    a, b, w = a[0], b[0], w[0]
    want_da, want_db = jax_pd.l1_distance_grads(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(w), interpret=True
    )
    got_da, got_db = l1_kernels.l1_distance_grads(_torch(a), _torch(b), torch.from_numpy(w))
    assert got_da.shape == a.shape and got_db.shape == b.shape
    _assert_grads(got_da.numpy(), got_db.numpy(), np.asarray(want_da), np.asarray(want_db), w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_grads_match_pallas_at_tile_edges(shape, dtype):
    """B2 on every group and B6 on the first, planted ties included."""
    a, b, w = _inputs(*shape, dtype, seed=5 * sum(shape))
    want_da, want_db = jax_pd.l1_distance_grads_batched(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(w), interpret=True
    )
    got_da, got_db = l1_kernels.l1_distance_grads_batched(_torch(a), _torch(b), torch.from_numpy(w))
    _assert_grads(got_da.numpy(), got_db.numpy(), np.asarray(want_da), np.asarray(want_db), w)
    want_da, want_db = jax_pd.l1_distance_grads(
        jnp.asarray(a[0]), jnp.asarray(b[0]), jnp.asarray(w[0]), interpret=True
    )
    got_da, got_db = l1_kernels.l1_distance_grads(_torch(a[0]), _torch(b[0]), torch.from_numpy(w[0]))
    _assert_grads(got_da.numpy(), got_db.numpy(), np.asarray(want_da), np.asarray(want_db), w[0])


def test_plain_grads_work_in_column_blocks(monkeypatch):
    a, b, w = (_torch(x) for x in _inputs(2, 9, 40, 16, "float32", seed=4))
    whole = l1_kernels.l1_distance_grads_batched_plain(a, b, w)
    monkeypatch.setattr(l1_kernels, "_PLAIN_TEMP_BYTES", 4 * 2 * 9 * 16 * 3)
    for x, y in zip(l1_kernels.l1_distance_grads_batched_plain(a, b, w), whole):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(
        l1_kernels.l1_distance_matrix_batched_plain(a, b),
        l1_kernels.l1_distance_matrix_batched(a, b),
    )


def test_wrappers_validate_inputs():
    a, b = torch.zeros(2, 4, 8), torch.zeros(2, 5, 8)
    with pytest.raises(ValueError):
        l1_kernels.l1_distance_matrix_batched(a, torch.zeros(3, 5, 8))
    with pytest.raises(ValueError):
        l1_kernels.l1_distance_grads_batched(a, b, torch.zeros(2, 5, 4))
    with pytest.raises(ValueError):
        l1_kernels.l1_distance_grads(a[0], b[0].to(torch.bfloat16), torch.zeros(4, 5))
    meta = torch.empty(2, 4, 8, device="meta")
    with pytest.raises(ValueError):
        l1_kernels.l1_distance_matrix_batched(meta, torch.empty(2, 5, 8, device="meta"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_p1_distance_has_the_sign_subgradient(dtype):
    """The repaired fault: p_distance_matrix(·, ·, 1) is an autograd node
    whose VJP is the JAX package's _l1_grads_formula, ties included."""
    a, b, w = _inputs(1, 37, 53, 64, dtype, seed=5)
    a, b, w = a[0], b[0], w[0]
    ta = _torch(a).requires_grad_()
    tb = _torch(b).requires_grad_()
    out = port_distance.p_distance_matrix(ta, tb, 1)
    assert isinstance(out.grad_fn, port_distance._L1._backward_cls)
    out.backward(torch.from_numpy(w).to(out.dtype))
    assert ta.grad.dtype == ta.dtype and tb.grad.dtype == tb.dtype
    w_cast = torch.from_numpy(w).to(out.dtype).float().numpy()
    want_da, want_db = jax_distance._l1_grads_formula(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(w_cast)
    )
    want_da = np.asarray(jnp.asarray(want_da).astype(a.dtype)).astype(np.float32)
    want_db = np.asarray(jnp.asarray(want_db).astype(b.dtype)).astype(np.float32)
    got_da, got_db = ta.grad.float().numpy(), tb.grad.float().numpy()
    if dtype == "bfloat16":  # each side rounds its own fp32 sum to bf16
        tol_a = _sum_tol(w_cast, -1) + BF16_ULP * np.abs(want_da)
        tol_b = _sum_tol(w_cast.T, -1) + BF16_ULP * np.abs(want_db)
        _within(got_da, want_da, tol_a)
        _within(got_db, want_db, tol_b)
    else:
        _assert_grads(got_da, got_db, want_da, want_db, w_cast)


def test_vjp_under_vmap_reaches_the_batched_rules(monkeypatch):
    """torch.func.vmap of torch.func.vjp through p=1 equals jax.vmap of
    jax.vjp of _l1_broadcast (tie-free fp32 inputs), and goes through the
    batched kernels (B1 forward, B2 backward) with the unbatched pool
    expanded to the group count."""
    G, B, N, d = 3, 17, 29, 40
    rng = np.random.default_rng(6)
    a = rng.normal(size=(G, B, d)).astype(np.float32)
    b = rng.normal(size=(G, N, d)).astype(np.float32)
    shared = rng.normal(size=(7, d)).astype(np.float32)
    w = rng.normal(size=(G, B, N)).astype(np.float32)

    calls = []
    for name in ("l1_distance_matrix_batched", "l1_distance_grads_batched"):
        orig = getattr(l1_kernels, name)

        def spy(*args, _orig=orig, _name=name):
            calls.append((_name, tuple(args[0].shape)))
            return _orig(*args)

        monkeypatch.setattr(l1_kernels, name, spy)

    def port_mb(a_, b_, w_):
        def f(x, y):
            return (port_distance.p_distance_matrix(x, y, 1) * w_).sum() + (
                port_distance.p_distance_matrix(x, torch.from_numpy(shared), 1).sum()
            )

        out, vjp = torch.func.vjp(f, a_, b_)
        return out, vjp(torch.ones(()))

    def jax_mb(a_, b_, w_):
        def f(x, y):
            return (jax_distance._l1_broadcast(x, y) * w_).sum() + (
                jax_distance._l1_broadcast(x, jnp.asarray(shared)).sum()
            )

        out, vjp = jax.vjp(f, a_, b_)
        return out, vjp(jnp.ones(()))

    got, (got_da, got_db) = torch.func.vmap(port_mb)(*map(torch.from_numpy, (a, b, w)))
    want, (want_da, want_db) = jax.vmap(jax_mb)(*map(jnp.asarray, (a, b, w)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL * B * N)
    w_all = np.concatenate([w, np.ones((G, B, 7), np.float32)], -1)
    _within(got_da.numpy(), np.asarray(want_da), _sum_tol(w_all, -1))
    _within(got_db.numpy(), np.asarray(want_db), _sum_tol(np.swapaxes(w, 1, 2), -1))
    # Two forwards and two backwards per micro-batch group, all batched;
    # the shared pool arrives expanded to (G, 7, d).
    assert sorted(calls) == sorted([
        ("l1_distance_matrix_batched", (G, B, d)),
        ("l1_distance_matrix_batched", (G, B, d)),
        ("l1_distance_grads_batched", (G, B, d)),
        ("l1_distance_grads_batched", (G, B, d)),
    ])


def test_launch_counts_only_move_on_cuda():
    l1_kernels.reset_launch_counts()
    a, b, w = _torch(np.zeros((2, 3, 8), np.float32)), torch.zeros(2, 5, 8), torch.zeros(2, 3, 5)
    l1_kernels.l1_distance_matrix_batched(a, b)
    l1_kernels.l1_distance_grads_batched(a, b, w)
    l1_kernels.l1_distance_grads(a[0], b[0], w[0])
    for wrapper in l1_kernels._WRAPPERS:
        assert wrapper.launches == 0
