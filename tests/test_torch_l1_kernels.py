"""The port's L1 window ops against the JAX package's Pallas kernels.

The plain PyTorch versions of B7 (``l1_scores_chunkmax``) and B5
(``l1_distance_matrix``) are held against ``besskge_tpu.ops.pallas_distance``
run in the Pallas interpreter, as ``tests/test_pallas_ops.py`` runs them.

Tolerances: fp32 sums of |a − b| over d ≤ 128 terms of size ≤ 1 agree to
rtol 1e-5, atol 1e-4 whatever the summation order; bf16 inputs are converted
to fp32 before the arithmetic in both packages, so the same holds. Where B5
stores bf16 (its output has a's dtype) the two sides may round an fp32 sum
that differs in its last bits to neighbouring bf16 values: one bf16 ulp,
at most 2^-7 of the value. fp16 operands (ROADMAP A17) are widened to fp32
at load in both packages as well; B5's fp16 output may differ by one fp16
ulp, at most 2^-10 of the value, and past 65,504 it is inf on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from besskge_tpu.ops.pallas_distance import (
    l1_distance_matrix as jax_l1_distance_matrix,
)
from besskge_tpu.ops.pallas_distance import (
    l1_scores_chunkmax as jax_l1_scores_chunkmax,
)
from besskge_tpu_torch import _build
from besskge_tpu_torch.ops import distance as port_distance
from besskge_tpu_torch.ops import l1_kernels

RTOL, ATOL = 1e-5, 1e-4
BF16_ULP = 2.0**-7
FP16_ULP = 2.0**-10

# (B, N, d): aligned, ragged B and d (the chip check's ragged shape), and
# shapes that are not multiples of the CUDA kernel's 64 x 128 tile.
SHAPES = [(8, 128, 16), (3, 256, 100), (37, 1536, 96), (130, 1152, 64)]
DTYPES = ["float32", "bfloat16", "float16"]


def _inputs(B, N, d, dtype, seed, invalid_chunk=False):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(B, d)).astype(np.float32)
    b = rng.normal(size=(N, d)).astype(np.float32)
    valid = rng.random(N) > 0.3
    if invalid_chunk:
        valid[128:256] = False
    ja, jb = jnp.asarray(a, dtype), jnp.asarray(b, dtype)
    ta = torch.from_numpy(a).to(getattr(torch, dtype))
    tb = torch.from_numpy(b).to(getattr(torch, dtype))
    return ja, jb, ta, tb, valid


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_scores_chunkmax_matches_pallas(shape, dtype):
    B, N, d = shape
    ja, jb, ta, tb, valid = _inputs(B, N, d, dtype, seed=B + N + d, invalid_chunk=N >= 256)
    js, jc = jax_l1_scores_chunkmax(ja, jb, jnp.asarray(valid), interpret=True)
    ts, tc = l1_kernels.l1_scores_chunkmax(ta, tb, torch.from_numpy(valid))
    assert ts.dtype == tc.dtype == torch.float32
    assert ts.shape == (B, N) and tc.shape == (B, N // 128)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=RTOL, atol=ATOL)
    # The chunk maxima are exactly the maxima of the returned scores.
    assert torch.equal(tc, ts.reshape(B, -1, 128).amax(-1))
    if N >= 256:
        # A wholly invalid chunk can never win the merge.
        assert (tc[:, 1] < -40000.0).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES + [(5, 200, 33)])
def test_distance_matrix_matches_pallas(shape, dtype):
    B, N, d = shape
    ja, jb, ta, tb, _ = _inputs(B, N, d, dtype, seed=3 * B + N)
    want = np.asarray(jax_l1_distance_matrix(ja, jb, interpret=True).astype(jnp.float32))
    got = l1_kernels.l1_distance_matrix(ta, tb)
    assert got.dtype == ta.dtype and got.shape == (B, N)
    err = np.abs(got.float().numpy() - want)
    tol = ATOL + RTOL * np.abs(want)
    if dtype != "float32":
        tol += (BF16_ULP if dtype == "bfloat16" else FP16_ULP) * np.abs(want)
    assert (err <= tol).all(), float((err - tol).max())


def test_fp16_distance_overflows_to_inf_as_pallas_does():
    """An fp16 distance past 65,504 is stored as inf by both kernels: no
    clamp. The chunk-max scores stay fp32 and finite."""
    a = np.full((4, 128), 300.0, np.float16)
    b = np.full((128, 128), -300.0, np.float16)
    b[:64] = 0.0  # 128 * 300 = 38,400 fits; 128 * 600 = 76,800 does not
    want = np.asarray(jax_l1_distance_matrix(jnp.asarray(a), jnp.asarray(b), interpret=True))
    got = l1_kernels.l1_distance_matrix(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float16 and want.dtype == np.float16
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isinf(want[:, 64:]).all() and np.isfinite(want[:, :64]).all()
    scores, _ = l1_kernels.l1_scores_chunkmax(torch.from_numpy(a), torch.from_numpy(b),
                                              torch.ones(128, dtype=torch.bool))
    assert torch.isfinite(scores).all() and float(scores.min()) == -76800.0


def test_p_distance_matrix_dispatch():
    """p=1 goes through the L1 op, p=2 through the matmul decomposition;
    both agree with the direct formula."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.normal(size=(6, 40)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(50, 40)).astype(np.float32))
    diff = a[:, None, :] - b[None, :, :]
    torch.testing.assert_close(
        port_distance.p_distance_matrix(a, b, p=1), diff.abs().sum(-1), rtol=RTOL, atol=ATOL
    )
    torch.testing.assert_close(
        port_distance.p_distance_matrix(a, b, p=2), diff.pow(2).sum(-1).sqrt(),
        rtol=1e-4, atol=1e-4,
    )
    with pytest.raises(ValueError):
        port_distance.p_distance_matrix(a, b, p=3)


def test_plain_version_works_in_column_blocks(monkeypatch):
    """The plain version's temporary is bounded: force many small column
    blocks and get the same result."""
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.normal(size=(9, 32)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(384, 32)).astype(np.float32))
    whole = l1_kernels.l1_distance_matrix_plain(a, b)
    monkeypatch.setattr(l1_kernels, "_PLAIN_TEMP_BYTES", 4 * 9 * 32 * 5)
    torch.testing.assert_close(l1_kernels.l1_distance_matrix_plain(a, b), whole)


def test_wrappers_validate_inputs():
    a = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        l1_kernels.l1_scores_chunkmax(a, torch.zeros(100, 8), torch.ones(100, dtype=torch.bool))
    with pytest.raises(ValueError):
        l1_kernels.l1_distance_matrix(a, torch.zeros(128, 8, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        l1_kernels.l1_distance_matrix(a.half(), torch.zeros(128, 8, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        l1_kernels.l1_distance_matrix(a.double(), torch.zeros(128, 8, dtype=torch.float64))
    with pytest.raises(ValueError):
        l1_kernels.l1_distance_matrix(a, torch.zeros(128, 7))


def test_cuda_entries_raise_instead_of_falling_back(monkeypatch, tmp_path):
    """Without a card or a compiler the kernel paths raise: nothing falls
    back to the plain version on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from besskge_tpu_torch.utils import resolve_device

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
    # A tensor on a device that is neither cpu nor cuda is refused.
    meta = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError):
        l1_kernels.l1_distance_matrix(meta, torch.empty(128, 8, device="meta"))
    with pytest.raises(ValueError):
        l1_kernels.l1_scores_chunkmax(
            meta, torch.empty(128, 8, device="meta"),
            torch.empty(128, dtype=torch.bool, device="meta"),
        )
    # No nvcc: building the kernels raises.
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "library_path", lambda name: tmp_path / f"lib{name}.so")
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    with pytest.raises(FileNotFoundError):
        _build.build(nvcc=str(tmp_path / "no-nvcc"))


def test_launch_counts_only_move_on_cuda():
    l1_kernels.reset_launch_counts()
    a, b = torch.zeros(2, 8), torch.zeros(128, 8)
    l1_kernels.l1_scores_chunkmax(a, b, torch.ones(128, dtype=torch.bool))
    l1_kernels.l1_distance_matrix(a, b)
    assert l1_kernels.l1_scores_chunkmax.launches == 0
    assert l1_kernels.l1_distance_matrix.launches == 0
