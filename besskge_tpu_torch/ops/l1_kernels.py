"""The L1 kernels on Hopper, their plain PyTorch versions, and launch counts.

The counterpart of ``besskge_tpu/ops/pallas_distance.py``:

* :func:`l1_scores_chunkmax` replaces the Pallas kernel of the same name
  (B7): masked negated L1 scores of a query block against a candidate window,
  fused with the maximum of every 128-column chunk of each row;
* :func:`l1_distance_matrix` replaces the Pallas ``l1_distance_matrix`` (B5):
  the plain all-pairs L1 distance, in the dtype of ``a``;
* :func:`l1_distance_matrix_batched` replaces ``l1_distance_matrix_batched``
  (B1): the same per group of a (G, B, d) x (G, N, d) batch;
* :func:`l1_distance_grads_batched` replaces ``l1_distance_grads_batched``
  (B2): both VJPs of B1 in fp32 with ``sign(0) = 0``, and
  :func:`l1_distance_grads` replaces ``l1_distance_grads`` (B6), its
  one-group case.

The kernels live in ``csrc/l1_distance.cu`` and are bound through ``ctypes``
(:mod:`besskge_tpu_torch._build`). A wrapper given CPU tensors computes the
plain version; given CUDA tensors it launches its kernel or raises. Each
wrapper counts its launches in ``wrapper.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from besskge_tpu_torch import _build
from besskge_tpu_torch.utils import on_cuda

__all__ = [
    "CHUNK",
    "l1_distance_grads",
    "l1_distance_grads_batched",
    "l1_distance_grads_batched_plain",
    "l1_distance_matrix",
    "l1_distance_matrix_batched",
    "l1_distance_matrix_batched_plain",
    "l1_distance_matrix_plain",
    "l1_scores_chunkmax",
    "l1_scores_chunkmax_plain",
    "reset_launch_counts",
]

#: Column chunk of the fused chunk-max: one block of the CUDA kernel.
CHUNK = 128
#: Largest temporary of the plain versions, in bytes.
_PLAIN_TEMP_BYTES = 256 << 20
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_dtypes(a: torch.Tensor, b: torch.Tensor) -> None:
    if torch.float16 in (a.dtype, b.dtype):
        raise NotImplementedError(
            "the L1 kernels take float32 or bfloat16 operands, got float16: an fp16 table"
            " scores through compute_dtype=torch.bfloat16 (fp16 operands for the L1"
            " kernels: ROADMAP A17)"
        )
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE:
        raise ValueError(f"a and b must share a dtype in float32/bfloat16, got {a.dtype}, {b.dtype}")


def _check_pair(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"expected a (B, d) and b (N, d), got {tuple(a.shape)}, {tuple(b.shape)}")
    _check_dtypes(a, b)
    if a.device != b.device:
        raise ValueError(f"a on {a.device} and b on {b.device}")


def _check_groups(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] or a.shape[2] != b.shape[2]:
        raise ValueError(
            f"expected a (G, B, d) and b (G, N, d), got {tuple(a.shape)}, {tuple(b.shape)}"
        )
    _check_dtypes(a, b)
    if a.device != b.device:
        raise ValueError(f"a on {a.device} and b on {b.device}")


def _check_cotangent(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    want = (*a.shape[:-1], b.shape[-2])
    if tuple(g.shape) != want:
        raise ValueError(f"g has shape {tuple(g.shape)}, expected {want}")
    if g.device != a.device:
        raise ValueError(f"g on {g.device} and a on {a.device}")
    return g.float()


def _library() -> ctypes.CDLL:
    lib = _build.load_library("l1_distance")
    if not hasattr(lib, "_bess_declared"):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bess_l1_scores_chunkmax.argtypes = [p, p, p, p, p, i, i, i, i, ctypes.c_float, p]
        lib.bess_l1_scores_chunkmax.restype = i
        lib.bess_l1_distance_matrix_batched.argtypes = [p, p, p, i, i, i, i, i, p]
        lib.bess_l1_distance_matrix_batched.restype = i
        lib.bess_l1_distance_grads_batched.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        lib.bess_l1_distance_grads_batched.restype = i
        lib._bess_declared = True
    return lib


def l1_distance_matrix_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``out[i, j] = Σ_k |a[i, k] − b[j, k]|`` in plain PyTorch: the
    one-group case of :func:`l1_distance_matrix_batched_plain` (fp32
    arithmetic in column blocks of at most 256 MB, the result in the dtype of
    ``a``)."""
    _check_pair(a, b)
    return l1_distance_matrix_batched_plain(a[None], b[None])[0]


def l1_distance_matrix_batched_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``out[g, i, j] = Σ_k |a[g, i, k] − b[g, j, k]|`` in plain PyTorch: fp32
    arithmetic in column blocks whose (G, B, block, d) temporary stays under
    256 MB; the result has the dtype of ``a``."""
    _check_groups(a, b)
    a32, b32 = a.float(), b.float()
    G, B, d = a32.shape
    out = torch.empty((G, B, b32.shape[1]), dtype=a.dtype, device=a.device)
    block = max(1, _PLAIN_TEMP_BYTES // (4 * max(G * B * d, 1)))
    for j in range(0, b32.shape[1], block):
        diff = a32[:, :, None, :] - b32[:, None, j : j + block, :]
        out[:, :, j : j + block] = diff.abs_().sum(-1)
    return out


def l1_distance_grads_batched_plain(
    a: torch.Tensor, b: torch.Tensor, g: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`l1_distance_grads_batched`:
    ``da = Σ_j g·sign(a − b)`` and ``db = −Σ_i g·sign(a − b)`` in fp32, the
    sign taken of the fp32 difference (``sign(0) = 0``), in column blocks
    whose (G, B, block, d) temporary stays under 256 MB."""
    _check_groups(a, b)
    g = _check_cotangent(a, b, g)
    a32, b32 = a.float(), b.float()
    G, B, d = a32.shape
    da = torch.zeros((G, B, d), dtype=torch.float32, device=a.device)
    db = torch.empty((G, b32.shape[1], d), dtype=torch.float32, device=a.device)
    block = max(1, _PLAIN_TEMP_BYTES // (4 * max(G * B * d, 1)))
    for j in range(0, b32.shape[1], block):
        weighted = g[:, :, j : j + block, None] * torch.sign(
            a32[:, :, None, :] - b32[:, None, j : j + block, :]
        )
        da += weighted.sum(2)
        db[:, j : j + block] = -weighted.sum(1)
    return da, db


def l1_scores_chunkmax_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    valid: torch.Tensor,
    chunk: int = CHUNK,
    bad: float = -50000.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`l1_scores_chunkmax`: fp32
    ``s = −cdist₁(a, b) + bad·(1 − valid)`` and its per-``chunk`` maxima."""
    _check_pair(a, b)
    B, N = a.shape[0], b.shape[0]
    if N % chunk:
        raise ValueError(f"N={N} is not a multiple of chunk={chunk}")
    dist = l1_distance_matrix_plain(a.float(), b.float())
    scores = -dist + bad * (1.0 - valid.to(torch.float32))[None, :]
    cmax = scores.reshape(B, N // chunk, chunk).amax(-1)
    return scores, cmax


def l1_scores_chunkmax(
    a: torch.Tensor,
    b: torch.Tensor,
    valid: torch.Tensor,
    chunk: int = CHUNK,
    bad: float = -50000.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked L1 scores and their chunk maxima (replaces Pallas B7).

    :param a: (B, d) transformed queries (e.g. h + r for TransE tails).
    :param b: (N, d) candidate rows, same dtype, N a multiple of ``chunk``.
    :param valid: (N,) bool column validity.
    :return: ``(scores (B, N) fp32, chunk_max (B, N // chunk) fp32)``.
    """
    _check_pair(a, b)
    B, N = a.shape[0], b.shape[0]
    if valid.shape != (N,):
        raise ValueError(f"valid has shape {tuple(valid.shape)}, expected ({N},)")
    if not on_cuda("l1_scores_chunkmax", a):
        return l1_scores_chunkmax_plain(a, b, valid, chunk, bad)
    if chunk != CHUNK:
        raise ValueError(f"the CUDA kernel takes chunk={CHUNK} only, got {chunk}")
    if N % chunk:
        raise ValueError(f"N={N} is not a multiple of chunk={chunk}")
    a, b = a.contiguous(), b.contiguous()
    valid = valid.to(device=a.device, dtype=torch.bool).contiguous()
    scores = torch.empty((B, N), dtype=torch.float32, device=a.device)
    cmax = torch.empty((B, N // chunk), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = _library().bess_l1_scores_chunkmax(
        a.data_ptr(), b.data_ptr(), valid.data_ptr(), scores.data_ptr(),
        cmax.data_ptr(), B, N, a.shape[1], _DTYPE_CODE[a.dtype], bad, stream,
    )
    _build.check_launch("l1_scores_chunkmax", rc)
    l1_scores_chunkmax.launches += 1
    return scores, cmax


def l1_distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs L1 distance in the dtype of ``a`` (replaces Pallas B5).

    :param a: (B, d) queries; :param b: (N, d) candidates, same dtype.
    """
    _check_pair(a, b)
    if not on_cuda("l1_distance_matrix", a):
        return l1_distance_matrix_plain(a, b)
    out = _launch_distance("l1_distance_matrix", a[None], b[None])[0]
    l1_distance_matrix.launches += 1
    return out


def _launch_distance(name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One launch of the (batched) distance kernel; a (G, B, d), b (G, N, d)."""
    a, b = a.contiguous(), b.contiguous()
    G, B, d = a.shape
    out = torch.empty((G, B, b.shape[1]), dtype=a.dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = _library().bess_l1_distance_matrix_batched(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), G, B, b.shape[1], d,
        _DTYPE_CODE[a.dtype], stream,
    )
    _build.check_launch(name, rc)
    return out


def _launch_grads(
    name: str, a: torch.Tensor, b: torch.Tensor, g: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one launch of the (batched) gradient kernel: da and db together."""
    a, b, g = a.contiguous(), b.contiguous(), g.contiguous()
    G, B, d = a.shape
    N = b.shape[1]
    da = torch.empty((G, B, d), dtype=torch.float32, device=a.device)
    db = torch.empty((G, N, d), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = _library().bess_l1_distance_grads_batched(
        a.data_ptr(), b.data_ptr(), g.data_ptr(), da.data_ptr(), db.data_ptr(),
        G, B, N, d, _DTYPE_CODE[a.dtype], stream,
    )
    _build.check_launch(name, rc)
    return da, db


def l1_distance_matrix_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-group all-pairs L1 distance in the dtype of ``a`` (replaces
    Pallas B1).

    :param a: (G, B, d) queries; :param b: (G, N, d) candidates, same dtype.
    :return: (G, B, N).
    """
    _check_groups(a, b)
    if not on_cuda("l1_distance_matrix_batched", a):
        return l1_distance_matrix_batched_plain(a, b)
    out = _launch_distance("l1_distance_matrix_batched", a, b)
    l1_distance_matrix_batched.launches += 1
    return out


def l1_distance_grads_batched(
    a: torch.Tensor, b: torch.Tensor, g: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both VJPs of :func:`l1_distance_matrix_batched` (replaces Pallas B2):
    ``da[g, i] = Σ_j w[g, i, j]·sign(a[g, i] − b[g, j])`` and
    ``db[g, j] = −Σ_i w[g, i, j]·sign(a[g, i] − b[g, j])``, fp32, with
    ``sign(0) = 0`` where a coordinate of a equals b's exactly.

    :param a: (G, B, d); :param b: (G, N, d), same dtype;
    :param g: (G, B, N) cotangent (taken in fp32).
    :return: ``(da (G, B, d), db (G, N, d))`` in fp32.
    """
    _check_groups(a, b)
    g = _check_cotangent(a, b, g)
    if not on_cuda("l1_distance_grads_batched", a):
        return l1_distance_grads_batched_plain(a, b, g)
    out = _launch_grads("l1_distance_grads_batched", a, b, g)
    l1_distance_grads_batched.launches += 1
    return out


def l1_distance_grads(
    a: torch.Tensor, b: torch.Tensor, g: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both VJPs of :func:`l1_distance_matrix` (replaces Pallas B6): the
    one-group case of :func:`l1_distance_grads_batched`.

    :param a: (B, d); :param b: (N, d); :param g: (B, N).
    :return: ``(da (B, d), db (N, d))`` in fp32.
    """
    _check_pair(a, b)
    g = _check_cotangent(a, b, g)
    if not on_cuda("l1_distance_grads", a):
        da, db = l1_distance_grads_batched_plain(a[None], b[None], g[None])
        return da[0], db[0]
    da, db = _launch_grads("l1_distance_grads", a[None], b[None], g[None])
    l1_distance_grads.launches += 1
    return da[0], db[0]


_WRAPPERS = (
    l1_scores_chunkmax,
    l1_distance_matrix,
    l1_distance_matrix_batched,
    l1_distance_grads_batched,
    l1_distance_grads,
)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for wrapper in _WRAPPERS:
        wrapper.launches = 0  # type: ignore[attr-defined]


reset_launch_counts()
