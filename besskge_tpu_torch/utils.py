"""Small tensor helpers shared across the port's modules."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

#: A 32-bit value held in an int64 tensor (or a Python int).
Word = Union[torch.Tensor, int]

__all__ = [
    "as_complex_pair", "complex_multiplication", "complex_rotation", "gather_indices",
    "interleaved_to_blocked", "on_cuda", "resolve_device",
]


_M32 = 0xFFFFFFFF


def _mul32(x: Word, c: int) -> Word:
    """``x · c mod 2^32`` for ``0 ≤ x < 2^32`` without leaving int64: a
    constant at or above 2^31 is split into ``c − 2^31`` and ``2^31``, whose
    product with ``x`` is ``(x & 1) << 31`` mod 2^32."""
    if c < 1 << 31:
        return (x * c) & _M32
    return (x * (c - (1 << 31)) + ((x & 1) << 31)) & _M32


def _mix32(x: Word) -> Word:
    """The ``lowbias32`` finaliser: a bijection of 32-bit values, on Python
    ints or int64 tensors alike."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when CUDA is asked for and no card is there, so that no
    entry point carries on on the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "besskge_tpu_torch runs on a CUDA device and none is available;"
            " pass device='cpu' to run the plain versions on the CPU"
        )
    return dev


def on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """How a kernel wrapper dispatches: True when its tensors lie on a CUDA
    device (launch the kernel), False when they lie on the CPU (compute the
    plain version); raises for any other device or for tensors on two."""
    device = tensors[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {device}")
    if any(t.device != device for t in tensors[1:]):
        raise ValueError(f"{name}: tensors on {[str(t.device) for t in tensors]}")
    return device.type == "cuda"


def gather_indices(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Gather columns of a 2-D tensor with a (broadcastable) 2-D index.

    ``out[i, j] = x[i, index[i, j]]``; if ``index`` has a single row it is
    shared by all rows of ``x`` (and vice versa), as in
    ``besskge_tpu.utils.gather_indices``.
    """
    rows = torch.broadcast_shapes(x.shape[:1], index.shape[:1])
    x_b = x.expand(rows + x.shape[1:])
    idx_b = index.expand(rows + index.shape[1:])
    return torch.gather(x_b, 1, idx_b.long())


def complex_multiplication(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Complex-multiply two batches of complex vectors stored as
    ``[re_0..re_{d/2}, im_0..im_{d/2}]`` along the last axis (reference
    ``besskge/utils.py:72-89``)."""
    re1, im1 = torch.chunk(v1, 2, dim=-1)
    re2, im2 = torch.chunk(v2, 2, dim=-1)
    return torch.cat([re1 * re2 - im1 * im2, re1 * im2 + im1 * re2], dim=-1)


def complex_rotation(v: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Rotate complex vectors ``v`` (``[re, im]``, last dim ``2k``) by the
    phases ``r`` (radians, last dim ``k``)."""
    return complex_multiplication(v, torch.cat([torch.cos(r), torch.sin(r)], dim=-1))


def interleaved_to_blocked(x: torch.Tensor) -> torch.Tensor:
    """(re, im, re, im, ...) -> (re..., im...) along the last axis."""
    return torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)


def as_complex_pair(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split a blocked complex vector into (real, imaginary) halves."""
    return tuple(torch.chunk(x, 2, dim=-1))  # type: ignore[return-value]
