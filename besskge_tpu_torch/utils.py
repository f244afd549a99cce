"""Small tensor helpers shared across the port's modules, and the host-side
filter of filtered evaluation (:func:`get_entity_filter`, numpy, copied from
``besskge_tpu/utils.py``)."""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch
from numpy.typing import NDArray

#: A 32-bit value held in an int64 tensor (or a Python int).
Word = Union[torch.Tensor, int]

__all__ = [
    "as_complex_pair", "complex_multiplication", "complex_rotation", "gather_indices",
    "get_entity_filter", "interleaved_to_blocked", "on_cuda", "resolve_device",
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


def _tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of a nested dict of tensors (a params dict with
    ConvE's trunk, or an optimizer state mirroring one), with the leaves at
    the same keys of the ``rest`` trees as further arguments; the result
    has ``tree``'s keys."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _first_leaf(tree: Any) -> torch.Tensor:
    """The first tensor of a nested dict of tensors."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


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


def get_entity_filter(
    triples: NDArray[np.int32],
    filter_triples: NDArray[np.int32],
    filter_mode: str,
) -> NDArray[np.int64]:
    """Sparse filter pairs for filtered evaluation (host-side, numpy).

    For each triple in ``triples``, find the entities that complete the same
    query — same (h, r) when ``filter_mode == "t"``, same (r, t) when
    ``filter_mode == "h"`` — in ``filter_triples``.

    :param triples: (n, 3) triples to evaluate.
    :param filter_triples: (m, 3) known true triples.
    :param filter_mode: "h" to filter known heads, "t" for known tails.
    :return: (k, 2) array of ``(triple_index, entity_to_filter)`` pairs.

    Mirrors reference ``besskge/utils.py:36-69``.
    """
    if filter_mode == "t":
        q_cols, ent_col = (0, 1), 2
    elif filter_mode == "h":
        q_cols, ent_col = (2, 1), 0
    else:
        raise ValueError(f"filter_mode must be 'h' or 't', got {filter_mode}")

    base = np.int64(max(triples.max(), filter_triples.max())) + 1
    q_key = triples[:, q_cols[0]].astype(np.int64) * base + triples[:, q_cols[1]]
    f_key = (
        filter_triples[:, q_cols[0]].astype(np.int64) * base
        + filter_triples[:, q_cols[1]]
    )

    # Sort filter keys once; for each query key locate its matching span.
    order = np.argsort(f_key, kind="stable")
    f_sorted = f_key[order]
    lo = np.searchsorted(f_sorted, q_key, side="left")
    hi = np.searchsorted(f_sorted, q_key, side="right")
    lengths = hi - lo
    triple_idx = np.repeat(np.arange(triples.shape[0]), lengths)
    if triple_idx.size == 0:
        return np.empty((0, 2), dtype=np.int64)
    # Positions within each span, flattened.
    span_pos = np.arange(lengths.sum()) - np.repeat(
        np.cumsum(lengths) - lengths, lengths
    )
    filter_rows = order[np.repeat(lo, lengths) + span_pos]
    entities = filter_triples[filter_rows, ent_col]
    return np.stack([triple_idx, entities.astype(np.int64)], axis=1)


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
