"""Sparse row reads and in-place row updates on Hopper, their plain PyTorch
versions, and launch counts.

The counterpart of four Pallas TPU kernels of the sparse optimizer path:

* :func:`scatter_rows` replaces ``besskge_tpu/ops/pallas_scatter.py``
  ``scatter_rows`` (B3): ``table[idx[i] : idx[i]+h] = rows[h·i : h·i+h]`` in
  place, optionally writing only the first slot of each sorted run;
* :func:`fused_pair_sgdm` replaces ``besskge_tpu/ops/pallas_row_sgdm.py``
  ``fused_pair_sgdm`` (B4): the whole SGD-momentum update of the touched
  [param | momentum] pairs of a pair-major table, in place;
* :func:`scatter_rows_multi` replaces ``pallas_scatter.py``
  ``scatter_rows_multi`` (B8): the single-row write of B3 into several tables
  (a param table and its moment buffers) in one launch, each table with its
  own index list;
* :func:`gather_rows` replaces ``pallas_scatter.py`` ``gather_rows`` (B9):
  ``out[h·i : h·i+h] = table[idx[i] : idx[i]+h]``, optionally reading only the
  first slot of each sorted run.

All four kernels live in ``csrc/row_update.cu`` and are bound through ``ctypes``
(:mod:`besskge_tpu_torch._build`). A wrapper given CPU tensors computes the
plain version; given CUDA tensors it launches its kernel or raises. Each
wrapper counts its launches in ``wrapper.launches``.

Unlike the TPU kernels these need no padding of ``idx`` to a multiple of a
block: the grid masks the ragged tail, which writes the same set of rows.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple, Union

import torch

from besskge_tpu_torch import _build
from besskge_tpu_torch.utils import on_cuda

__all__ = [
    "MAX_TABLES",
    "fused_pair_sgdm",
    "fused_pair_sgdm_plain",
    "gather_rows",
    "gather_rows_plain",
    "reset_launch_counts",
    "scatter_rows",
    "scatter_rows_multi",
    "scatter_rows_multi_plain",
    "scatter_rows_plain",
]

#: Most tables :func:`scatter_rows_multi` writes in one launch.
MAX_TABLES = 4

LearningRate = Union[float, torch.Tensor]


def _library() -> ctypes.CDLL:
    lib = _build.load_library("row_update")
    if not hasattr(lib, "_bess_declared"):
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.bess_scatter_rows.argtypes = [p, p, p, ll, i, ll, i, i, i, p]
        lib.bess_scatter_rows.restype = i
        lib.bess_fused_pair_sgdm.argtypes = [p, p, p, ll, i, ll, p, f, f, f, p]
        lib.bess_fused_pair_sgdm.restype = i
        lib.bess_scatter_rows_multi.argtypes = [i, p, p, p, p, p, i, i, i, p]
        lib.bess_scatter_rows_multi.restype = i
        lib.bess_gather_rows.argtypes = [p, p, p, ll, i, ll, i, i, i, p]
        lib.bess_gather_rows.restype = i
        lib._bess_declared = True
    return lib


def _flat(table: torch.Tensor) -> torch.Tensor:
    """The (n, D) view of a table that may carry a leading unit axis."""
    if table.dim() == 3 and table.shape[0] == 1:
        return table[0]
    if table.dim() != 2:
        raise ValueError(f"expected an (n, D) or (1, n, D) table, got {tuple(table.shape)}")
    return table


def _first_of_run(idx: torch.Tensor) -> torch.Tensor:
    """True at the first slot of each run of equal sorted indices."""
    keep = torch.ones_like(idx, dtype=torch.bool)
    keep[1:] = idx[1:] != idx[:-1]
    return keep


def _check_range(idx: torch.Tensor, n_rows: int, h: int) -> None:
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) > n_rows - h):
        raise IndexError(f"row index outside [0, {n_rows - h}] for {h}-row slices")


def _copy_unit(name: str, row_bytes: int, tensors, units) -> int:
    """The widest copy unit (bytes) of ``units`` that divides a row and the
    address of every tensor; raises when none does."""
    for u in units:
        if row_bytes % u == 0 and all(t.data_ptr() % u == 0 for t in tensors):
            return u
    raise ValueError(f"{name} copies {units[-1]}-byte units at least; rows of {row_bytes} bytes")


_WORDS = (torch.int32, torch.uint32)


def _as_storage(rows: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``rows`` in a table's dtype: a value cast, but the bits as they are
    between the 32-bit integer dtypes of packed storage (int32, uint32)."""
    if rows.dtype != dtype and rows.dtype in _WORDS and dtype in _WORDS:
        return rows.view(dtype)
    return rows.to(dtype)


def _indexable(t: torch.Tensor) -> torch.Tensor:
    """A view PyTorch's indexing writes: uint32 (packed fp16 storage) has
    no ``index_put``, so its int32 view."""
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def _check_scatter(table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor, h: int) -> None:
    t = _flat(table)
    if idx.dim() != 1:
        raise ValueError(f"idx must be 1-D, got {tuple(idx.shape)}")
    if rows.shape != (h * idx.shape[0], t.shape[1]):
        raise ValueError(
            f"rows has shape {tuple(rows.shape)}, expected {(h * idx.shape[0], t.shape[1])}"
        )
    if not t.is_contiguous():
        raise ValueError("the table must be contiguous (it is written in place)")


def scatter_rows_plain(
    table: torch.Tensor,
    idx: torch.Tensor,
    rows: torch.Tensor,
    slice_rows: int = 1,
    skip_dups: bool = False,
) -> torch.Tensor:
    """Plain version of :func:`scatter_rows`: one index write of the
    selected slots' ``(h, D)`` blocks into ``table``, in place."""
    h = slice_rows
    _check_scatter(table, idx, rows, h)
    t = _flat(table)
    _check_range(idx, t.shape[0], h)
    blocks = _indexable(_as_storage(rows, t.dtype)).reshape(idx.shape[0], h, t.shape[1])
    t = _indexable(t)
    idx = idx.long()
    if skip_dups:
        keep = _first_of_run(idx)
        idx, blocks = idx[keep], blocks[keep]
    offsets = torch.arange(h, dtype=torch.long, device=idx.device)
    t[(idx[:, None] + offsets).reshape(-1)] = blocks.reshape(-1, t.shape[1])
    return table


def scatter_rows(
    table: torch.Tensor,
    idx: torch.Tensor,
    rows: torch.Tensor,
    slice_rows: int = 1,
    skip_dups: bool = False,
) -> torch.Tensor:
    """``table[idx[i] : idx[i]+h] = rows[h·i : h·i+h]`` in place (replaces
    Pallas B3); returns ``table``.

    :param table: (n, D) table, or its (1, n, D) block; contiguous.
    :param idx: (R,) row indices in ``[0, n − h]``; duplicates allowed when
        their rows are identical, or under ``skip_dups``.
    :param rows: (h·R, D) replacement rows (cast to the table's dtype; int32
        and uint32 words, packed storage, keep their bits).
    :param slice_rows: rows ``h`` written per index (``h = 2``: the
        [param | momentum] pairs of a pair-major table).
    :param skip_dups: ``idx`` is sorted and only the first slot of each run
        of equal indices is written; later slots' rows may hold anything.
    """
    h = slice_rows
    _check_scatter(table, idx, rows, h)
    if not on_cuda("scatter_rows", table, idx, rows):
        return scatter_rows_plain(table, idx, rows, h, skip_dups)
    t = _flat(table)
    idx = idx.to(torch.int32).contiguous()
    rows = _as_storage(rows, t.dtype).contiguous()
    row_bytes = t.shape[1] * t.element_size()
    unit = _copy_unit("scatter_rows", row_bytes, (t, rows), (16, 4, 2))
    rc = _library().bess_scatter_rows(
        t.data_ptr(), idx.data_ptr(), rows.data_ptr(), idx.shape[0], h, t.shape[0],
        row_bytes, unit, int(skip_dups), torch.cuda.current_stream(t.device).cuda_stream,
    )
    _build.check_launch("scatter_rows", rc)
    scatter_rows.launches += 1
    return table


def _check_pair_sgdm(table: torch.Tensor, phys: torch.Tensor, grads: torch.Tensor) -> None:
    t = _flat(table)
    if t.dtype != torch.float32 or t.shape[0] % 2:
        raise ValueError(f"expected a pair-major (2N, D) fp32 table, got {t.dtype} {tuple(t.shape)}")
    if phys.dim() != 1 or grads.shape != (phys.shape[0], t.shape[1]):
        raise ValueError(
            f"expected phys (R,) and grads (R, {t.shape[1]}),"
            f" got {tuple(phys.shape)}, {tuple(grads.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError("the table must be contiguous (it is written in place)")


def fused_pair_sgdm_plain(
    table: torch.Tensor,
    phys: torch.Tensor,
    grads: torch.Tensor,
    lr: LearningRate,
    momentum: float = 0.9,
    weight_decay: float = 0.0,
) -> torch.Tensor:
    """Plain version of :func:`fused_pair_sgdm`: index reads of the runs'
    first slots, the update, one index write of the pairs, in place."""
    _check_pair_sgdm(table, phys, grads)
    t = _flat(table)
    if phys.numel() and (bool((phys % 2 != 0).any())):
        raise IndexError("fused_pair_sgdm takes even physical rows only")
    _check_range(phys, t.shape[0], 2)
    keep = _first_of_run(phys)
    rows = phys.long()[keep]
    g = grads.float()[keep]
    p, m = t[rows], t[rows + 1]
    if weight_decay:
        g = g + weight_decay * p
    m = momentum * m + g
    p = p - lr * m
    t[torch.stack([rows, rows + 1], 1).reshape(-1)] = torch.stack([p, m], 1).reshape(-1, t.shape[1])
    return table


def fused_pair_sgdm(
    table: torch.Tensor,
    phys: torch.Tensor,
    grads: torch.Tensor,
    lr: LearningRate,
    momentum: float = 0.9,
    weight_decay: float = 0.0,
) -> torch.Tensor:
    """In-place SGD with momentum over the touched pairs of a pair-major
    table (replaces Pallas B4); returns ``table``. For every sorted slot
    that starts a run: ``m ← momentum·m + g (+ weight_decay·p)`` and
    ``p ← p − lr·m`` on the pair [p | m] at rows ``phys[i], phys[i] + 1``.

    :param table: (2N, D) fp32 pair-major table or its (1, 2N, D) block;
        contiguous, D a multiple of 4 on a card.
    :param phys: (R,) sorted even physical rows; duplicates carry the same
        summed gradient, and only the first slot of each run is applied.
    :param grads: (R, D) summed per-row gradients.
    :param lr: learning rate, a Python float or a one-element tensor on the
        table's device (read there by the kernel: no host synchronisation).
    """
    _check_pair_sgdm(table, phys, grads)
    lr_tensor = torch.is_tensor(lr)
    if not on_cuda("fused_pair_sgdm", table, phys, grads, *([lr] if lr_tensor else [])):
        return fused_pair_sgdm_plain(table, phys, grads, lr, momentum, weight_decay)
    t = _flat(table)
    if t.shape[1] % 4:
        raise ValueError(f"the CUDA kernel takes D a multiple of 4, got {t.shape[1]}")
    phys = phys.to(torch.int32).contiguous()
    grads = grads.to(torch.float32).contiguous()
    lr_ptr, lr_value = None, 0.0
    if lr_tensor:
        if lr.numel() != 1:
            raise ValueError(f"lr must hold one value, got shape {tuple(lr.shape)}")
        lr = lr.to(torch.float32).contiguous()
        lr_ptr = lr.data_ptr()
    else:
        lr_value = float(lr)
    rc = _library().bess_fused_pair_sgdm(
        t.data_ptr(), phys.data_ptr(), grads.data_ptr(), phys.shape[0], t.shape[1],
        t.shape[0], lr_ptr, lr_value, float(momentum), float(weight_decay),
        torch.cuda.current_stream(t.device).cuda_stream,
    )
    _build.check_launch("fused_pair_sgdm", rc)
    fused_pair_sgdm.launches += 1
    return table


def _check_multi(tables, idxs, rows) -> None:
    if not len(tables) == len(idxs) == len(rows) or not 1 <= len(tables) <= MAX_TABLES:
        raise ValueError(
            f"expected 1 to {MAX_TABLES} tables with one index list and one rows"
            f" buffer each, got {len(tables)}, {len(idxs)}, {len(rows)}"
        )
    width = _flat(tables[0]).shape[1]
    for t, i, r in zip(tables, idxs, rows):
        if _flat(t).shape[1] != width:
            raise ValueError("every table of scatter_rows_multi must have the same row width")
        _check_scatter(t, i, r, 1)


def scatter_rows_multi_plain(
    tables: Sequence[torch.Tensor],
    idxs: Sequence[torch.Tensor],
    rows: Sequence[torch.Tensor],
    skip_dups: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Plain version of :func:`scatter_rows_multi`: one index write per
    table, in place."""
    _check_multi(tables, idxs, rows)
    return tuple(
        scatter_rows_plain(t, i, r, 1, skip_dups) for t, i, r in zip(tables, idxs, rows)
    )


def scatter_rows_multi(
    tables: Sequence[torch.Tensor],
    idxs: Sequence[torch.Tensor],
    rows: Sequence[torch.Tensor],
    skip_dups: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """``tables[b][idxs[b][i]] = rows[b][i]`` for every table ``b``, in place
    and in one launch (replaces Pallas B8); returns ``tuple(tables)``.

    :param tables: 1 to :data:`MAX_TABLES` contiguous ``(n_b, D)`` tables or
        ``(1, n_b, D)`` blocks with 4-byte elements on a card (fp32, or
        int32/uint32 packed storage), D shared.
    :param idxs: one ``(R_b,)`` index list per table, in ``[0, n_b)``; the
        lengths may differ. Duplicates allowed when their rows are identical,
        or under ``skip_dups``.
    :param rows: one ``(R_b, D)`` buffer per table (cast to its dtype as
        :func:`scatter_rows` casts).
    :param skip_dups: every ``idxs[b]`` is sorted, and only the first slot of
        each of its runs is written; each table has its own runs.
    """
    _check_multi(tables, idxs, rows)
    flat_args = [*tables, *idxs, *rows]
    if not on_cuda("scatter_rows_multi", *flat_args):
        return scatter_rows_multi_plain(tables, idxs, rows, skip_dups)
    flats = [_flat(t) for t in tables]
    if any(t.element_size() != 4 for t in flats):
        raise ValueError(
            "scatter_rows_multi copies 4-byte words: tables of"
            f" {[t.dtype for t in flats]} (a plain 16-bit table takes scatter_rows)"
        )
    idxs = [i.to(torch.int32).contiguous() for i in idxs]
    rows = [_as_storage(r, t.dtype).contiguous() for r, t in zip(rows, flats)]
    row_bytes = flats[0].shape[1] * 4
    unit = _copy_unit("scatter_rows_multi", row_bytes, (*flats, *rows), (16, 4))
    k = len(flats)
    ptrs = ctypes.c_void_p * k
    lens = ctypes.c_longlong * k
    rc = _library().bess_scatter_rows_multi(
        k, ptrs(*(t.data_ptr() for t in flats)), ptrs(*(i.data_ptr() for i in idxs)),
        ptrs(*(r.data_ptr() for r in rows)), lens(*(i.shape[0] for i in idxs)),
        lens(*(t.shape[0] for t in flats)), row_bytes, unit, int(skip_dups),
        torch.cuda.current_stream(flats[0].device).cuda_stream,
    )
    _build.check_launch("scatter_rows_multi", rc)
    scatter_rows_multi.launches += 1
    return tuple(tables)


def _check_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    t = _flat(table)
    if idx.dim() != 1:
        raise ValueError(f"idx must be 1-D, got {tuple(idx.shape)}")
    return t


def gather_rows_plain(
    table: torch.Tensor, idx: torch.Tensor, slice_rows: int = 1, skip_dups: bool = False
) -> torch.Tensor:
    """Plain version of :func:`gather_rows`: one index read of the selected
    slots' ``(h, D)`` blocks into a fresh ``torch.empty`` buffer (duplicate
    slots under ``skip_dups`` keep whatever it held)."""
    h = slice_rows
    t = _check_gather(table, idx)
    _check_range(idx, t.shape[0], h)
    out = torch.empty((idx.shape[0], h, t.shape[1]), dtype=t.dtype, device=t.device)
    idx = idx.long()
    offsets = torch.arange(h, dtype=torch.long, device=idx.device)
    if skip_dups:
        keep = _first_of_run(idx)
        out[keep] = t[idx[keep, None] + offsets]
    else:
        out[:] = t[idx[:, None] + offsets]
    return out.reshape(h * idx.shape[0], t.shape[1])


def gather_rows(
    table: torch.Tensor, idx: torch.Tensor, slice_rows: int = 1, skip_dups: bool = False
) -> torch.Tensor:
    """``out[h·i : h·i+h] = table[idx[i] : idx[i]+h]`` (replaces Pallas B9).

    :param table: (n, D) table, or its (1, n, D) block; contiguous.
    :param idx: (R,) row indices in ``[0, n − h]``.
    :param slice_rows: rows ``h`` read per index (``h = 2`` with even indices:
        the [param | momentum] pairs of a pair-major table).
    :param skip_dups: ``idx`` is sorted and only the first slot of each run of
        equal indices is read; the later slots' rows of the output hold
        anything, and callers read first-of-run slots only.
    :return: (h·R, D) rows in the table's dtype.
    """
    h = slice_rows
    t = _check_gather(table, idx)
    if not on_cuda("gather_rows", table, idx):
        return gather_rows_plain(table, idx, h, skip_dups)
    if not t.is_contiguous():
        raise ValueError("gather_rows reads a contiguous table")
    idx = idx.to(torch.int32).contiguous()
    out = torch.empty((h * idx.shape[0], t.shape[1]), dtype=t.dtype, device=t.device)
    row_bytes = t.shape[1] * t.element_size()
    unit = _copy_unit("gather_rows", row_bytes, (t, out), (16, 4, 2))
    rc = _library().bess_gather_rows(
        out.data_ptr(), t.data_ptr(), idx.data_ptr(), idx.shape[0], h, t.shape[0], row_bytes,
        unit, int(skip_dups), torch.cuda.current_stream(t.device).cuda_stream,
    )
    _build.check_launch("gather_rows", rc)
    gather_rows.launches += 1
    return out


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    scatter_rows.launches = 0  # type: ignore[attr-defined]
    fused_pair_sgdm.launches = 0  # type: ignore[attr-defined]
    scatter_rows_multi.launches = 0  # type: ignore[attr-defined]
    gather_rows.launches = 0  # type: ignore[attr-defined]


reset_launch_counts()
