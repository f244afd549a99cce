"""The L1 window kernels on Hopper, their plain PyTorch versions, and launch counts.

The counterpart of ``besskge_tpu/ops/pallas_distance.py`` for the kernels on
the top-k serving path:

* :func:`l1_scores_chunkmax` replaces the Pallas kernel of the same name
  (B7): masked negated L1 scores of a query block against a candidate window,
  fused with the maximum of every 128-column chunk of each row;
* :func:`l1_distance_matrix` replaces the Pallas ``l1_distance_matrix`` (B5):
  the plain all-pairs L1 distance, in the dtype of ``a``.

Both kernels live in ``csrc/l1_distance.cu`` and are bound through ``ctypes``
(:mod:`besskge_tpu_torch._build`). A wrapper given CPU tensors computes the
plain version; given CUDA tensors it launches its kernel or raises. Each
wrapper counts its launches in ``wrapper.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from besskge_tpu_torch import _build

__all__ = [
    "CHUNK",
    "l1_distance_matrix",
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


def _check_pair(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"expected a (B, d) and b (N, d), got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE:
        raise ValueError(f"a and b must share a dtype in float32/bfloat16, got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"a on {a.device} and b on {b.device}")


def _library() -> ctypes.CDLL:
    lib = _build.load_library("l1_distance")
    if not hasattr(lib, "_bess_declared"):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bess_l1_scores_chunkmax.argtypes = [p, p, p, p, p, i, i, i, i, ctypes.c_float, p]
        lib.bess_l1_scores_chunkmax.restype = i
        lib.bess_l1_distance_matrix.argtypes = [p, p, p, i, i, i, i, p]
        lib.bess_l1_distance_matrix.restype = i
        lib._bess_declared = True
    return lib


def _check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def l1_distance_matrix_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``out[i, j] = Σ_k |a[i, k] − b[j, k]|`` in plain PyTorch.

    The arithmetic is fp32 (bf16 inputs are converted first), worked in
    column blocks whose (B, block, d) temporary stays under 256 MB; the
    result has the dtype of ``a``.
    """
    _check_pair(a, b)
    a32, b32 = a.float(), b.float()
    B, d = a32.shape
    out = torch.empty((B, b32.shape[0]), dtype=a.dtype, device=a.device)
    block = max(1, _PLAIN_TEMP_BYTES // (4 * max(B * d, 1)))
    for j in range(0, b32.shape[0], block):
        diff = a32[:, None, :] - b32[None, j : j + block, :]
        out[:, j : j + block] = diff.abs_().sum(-1)
    return out


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
    if a.device.type == "cpu":
        return l1_scores_chunkmax_plain(a, b, valid, chunk, bad)
    if a.device.type != "cuda":
        raise ValueError(f"l1_scores_chunkmax runs on cuda or cpu, not {a.device}")
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
    _check_launch("l1_scores_chunkmax", rc)
    l1_scores_chunkmax.launches += 1
    return scores, cmax


def l1_distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs L1 distance in the dtype of ``a`` (replaces Pallas B5).

    :param a: (B, d) queries; :param b: (N, d) candidates, same dtype.
    """
    _check_pair(a, b)
    if a.device.type == "cpu":
        return l1_distance_matrix_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"l1_distance_matrix runs on cuda or cpu, not {a.device}")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((a.shape[0], b.shape[0]), dtype=a.dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = _library().bess_l1_distance_matrix(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], b.shape[0],
        a.shape[1], _DTYPE_CODE[a.dtype], stream,
    )
    _check_launch("l1_distance_matrix", rc)
    l1_distance_matrix.launches += 1
    return out


l1_scores_chunkmax.launches = 0  # type: ignore[attr-defined]
l1_distance_matrix.launches = 0  # type: ignore[attr-defined]


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    l1_scores_chunkmax.launches = 0  # type: ignore[attr-defined]
    l1_distance_matrix.launches = 0  # type: ignore[attr-defined]
