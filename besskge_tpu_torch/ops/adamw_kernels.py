"""The fused in-place dense AdamW on Hopper, its plain PyTorch version, and
its launch count.

:func:`dense_adamw_update` replaces ``besskge_tpu/ops/pallas_adamw.py``
``dense_adamw_update`` (B10), the update of
:class:`~besskge_tpu_torch.optim.FusedDenseAdamW`: one pass over
(grad, param, mu, nu) that writes param, mu and nu in place. The kernel lives
in ``csrc/dense_adamw.cu`` and is bound through ``ctypes``
(:mod:`besskge_tpu_torch._build`). Given CPU tensors the wrapper computes the
plain version; given CUDA tensors it launches the kernel or raises.

The bias corrections ``1/(1 − b1^t)`` and ``1/(1 − b2^t)`` come from the step
count where it lies, in fp32 as the JAX package computes them: the plain
version calls :func:`bias_corrections`, and the kernel computes the same
operations itself from the count it reads in device memory, so an update is
one launch. It reads a tensor learning rate there too, so a step makes no
host synchronisation. Both versions multiply by these reciprocals, as the
Pallas kernel does, and round each operation on its own in the same order:
the moments are equal bit for bit on one device, and the param too unless
the card's ``powf`` and ``torch.pow`` differ in the last bit of ``b^t``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple, Union

import torch

from besskge_tpu_torch import _build
from besskge_tpu_torch.utils import on_cuda

__all__ = [
    "bias_corrections",
    "dense_adamw_update",
    "dense_adamw_update_plain",
    "reset_launch_counts",
]

LearningRate = Union[float, torch.Tensor]

_PARAM_DTYPES = (torch.float32, torch.bfloat16)
_COUNT_DTYPES = (torch.int32, torch.int64)


def _library() -> ctypes.CDLL:
    lib = _build.load_library("dense_adamw")
    if not hasattr(lib, "_bess_declared"):
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.bess_dense_adamw.argtypes = [p, p, p, p, ll, i, i, p, i, p, f, f, f, f, f, f, f, i, p]
        lib.bess_dense_adamw.restype = i
        lib._bess_declared = True
    return lib


def bias_corrections(count: torch.Tensor, b1: float, b2: float) -> torch.Tensor:
    """``[1/(1 − b1^t), 1/(1 − b2^t)]`` in fp32 for the post-increment step
    ``t = count``, on the count's device (no host synchronisation)."""
    t = count.to(torch.float32)
    return torch.stack([1.0 / (1.0 - torch.pow(b1, t)), 1.0 / (1.0 - torch.pow(b2, t))])


def _check(param, mu, nu, grad) -> None:
    if param.dtype not in _PARAM_DTYPES or grad.dtype not in _PARAM_DTYPES:
        raise ValueError(
            f"dense_adamw_update takes fp32 or bf16 param and grad, got {param.dtype},"
            f" {grad.dtype}"
        )
    if mu.dtype != torch.float32 or nu.dtype != torch.float32:
        raise ValueError(f"mu and nu must be fp32, got {mu.dtype}, {nu.dtype}")
    if not param.shape == mu.shape == nu.shape == grad.shape:
        raise ValueError(
            f"shapes differ: param {tuple(param.shape)}, mu {tuple(mu.shape)},"
            f" nu {tuple(nu.shape)}, grad {tuple(grad.shape)}"
        )
    if not (param.is_contiguous() and mu.is_contiguous() and nu.is_contiguous()):
        raise ValueError("param, mu and nu must be contiguous (they are written in place)")


def dense_adamw_update_plain(
    param: torch.Tensor,
    mu: torch.Tensor,
    nu: torch.Tensor,
    grad: torch.Tensor,
    count: torch.Tensor,
    lr: LearningRate,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    wd: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`dense_adamw_update`: the kernel's arithmetic
    in PyTorch elementwise ops, written in place."""
    _check(param, mu, nu, grad)
    corr = bias_corrections(count, b1, b2)
    g = grad.float()
    p = param.float()
    m = b1 * mu + (1.0 - b1) * g
    v = b2 * nu + (1.0 - b2) * (g * g)
    step = (m * corr[0]) / (torch.sqrt(v * corr[1]) + eps) + wd * p
    param.copy_(p - lr * step)
    mu.copy_(m)
    nu.copy_(v)
    return param, mu, nu


def dense_adamw_update(
    param: torch.Tensor,
    mu: torch.Tensor,
    nu: torch.Tensor,
    grad: torch.Tensor,
    count: torch.Tensor,
    lr: LearningRate,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    wd: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One AdamW step over a whole table, in place (replaces Pallas B10);
    returns ``(param, mu, nu)``.

    ``mu ← b1·mu + (1−b1)·g``, ``nu ← b2·nu + (1−b2)·g²``,
    ``param ← param − lr·((mu·c1) / (√(nu·c2) + eps) + wd·param)``.

    :param param: table of any shape, fp32 or bf16, contiguous.
    :param mu: fp32 first moment, the param's shape, contiguous.
    :param nu: fp32 second moment, likewise.
    :param grad: fp32 or bf16 gradient of the param's shape.
    :param count: the post-increment step number, an int32 or int64
        one-element tensor on the param's device (``c1 = 1/(1 − b1^count)``,
        ``c2`` likewise).
    :param lr: learning rate: a Python float, or a one-element tensor on the
        param's device (an lr schedule's value), read there by the kernel.
    """
    _check(param, mu, nu, grad)
    lr_tensor = torch.is_tensor(lr)
    if not on_cuda("dense_adamw_update", param, mu, nu, grad, count,
                   *([lr] if lr_tensor else [])):
        return dense_adamw_update_plain(param, mu, nu, grad, count, lr, b1, b2, eps, wd)
    if count.dtype not in _COUNT_DTYPES or count.numel() != 1:
        raise ValueError(
            f"count must be one int32 or int64 value, got {count.dtype} {tuple(count.shape)}"
        )
    grad = grad.contiguous()
    lr_ptr, lr_value = None, 0.0
    if lr_tensor:
        if lr.numel() != 1:
            raise ValueError(f"lr must hold one value, got shape {tuple(lr.shape)}")
        lr = lr.to(torch.float32).contiguous()
        lr_ptr = lr.data_ptr()
    else:
        lr_value = float(lr)
    aligned = all(t.data_ptr() % 16 == 0 for t in (param, mu, nu, grad))
    rc = _library().bess_dense_adamw(
        param.data_ptr(), mu.data_ptr(), nu.data_ptr(), grad.data_ptr(), param.numel(),
        int(param.dtype == torch.bfloat16), int(grad.dtype == torch.bfloat16), count.data_ptr(),
        int(count.dtype == torch.int64), lr_ptr, lr_value, float(b1), float(b2), float(eps),
        float(wd), float(1.0 - b1), float(1.0 - b2), int(aligned),
        torch.cuda.current_stream(param.device).cuda_stream,
    )
    _build.check_launch("dense_adamw_update", rc)
    dense_adamw_update.launches += 1
    return param, mu, nu


def reset_launch_counts() -> None:
    """Set the kernel's launch count to 0."""
    dense_adamw_update.launches = 0  # type: ignore[attr-defined]


reset_launch_counts()
