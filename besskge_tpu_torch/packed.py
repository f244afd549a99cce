"""Logical-row reads of the entity table.

Counterpart of ``besskge_tpu/packed.py``'s :func:`take_rows`,
:func:`take_contiguous_rows` and :func:`is_paired` for plain floating-point
tables and for the pair-major ``(2N, D)`` table of an interleaved
``RowSGDM``, whose param row ``i`` sits at physical row ``2i`` (its momentum
at ``2i + 1``): :func:`take_rows` reads such a table's param rows. The 16-bit
row-pair-packed tables and the other interleaved layouts (trebled, tripled,
quintupled) are not ported yet: given one, these functions raise
``NotImplementedError`` (ROADMAP A9).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["take_rows", "take_contiguous_rows", "check_plain_table", "is_paired"]


def _flat(table: torch.Tensor) -> torch.Tensor:
    """Strip the optional leading unit (device) axis."""
    return table[0] if table.dim() == 3 else table


def is_paired(table: torch.Tensor, n_logical: Optional[int]) -> bool:
    """True when ``table`` is a pair-major floating-point ``(2·n_logical, D)``
    table. As in the JAX package, detection is by the row count, so
    ``n_logical`` must be the logical row count of the exact table passed."""
    t = _flat(table)
    return bool(n_logical) and t.is_floating_point() and t.shape[0] == 2 * n_logical


def check_plain_table(table: torch.Tensor, n_logical: Optional[int] = None) -> torch.Tensor:
    """``table`` without its unit device axis; raises for any layout but a
    plain floating-point ``(n_logical, D)`` table."""
    t = _flat(table)
    if not t.is_floating_point():
        raise NotImplementedError(
            f"row-pair-packed 16-bit tables ({t.dtype} storage) are not ported"
            " yet (ROADMAP A9)"
        )
    if n_logical and t.shape[0] == 3 * n_logical:
        raise NotImplementedError(
            "interleaved (3N, D) optimizer-state tables are not ported yet (ROADMAP A9)"
        )
    if is_paired(t, n_logical):
        raise NotImplementedError(
            "a pair-major (2N, D) table is read row by row with take_rows;"
            " split_interleaved it for contiguous windows"
        )
    return t


def take_rows(
    table: torch.Tensor, idx: torch.Tensor, n_logical: Optional[int] = None
) -> torch.Tensor:
    """Rows ``idx`` (any shape) of a plain or pair-major table, as
    ``(*idx.shape, D)``; for a pair-major table the param rows ``2·idx``."""
    if is_paired(table, n_logical):
        t, rows = _flat(table), 2 * idx.reshape(-1).long()
    else:
        t, rows = check_plain_table(table, n_logical), idx.reshape(-1).long()
    return t[rows].reshape(*idx.shape, t.shape[-1])


def take_contiguous_rows(
    table: torch.Tensor, start: int, w: int, n_logical: Optional[int] = None
) -> torch.Tensor:
    """Rows ``[start, start + w)`` of a plain table as a ``(w, D)`` view."""
    t = check_plain_table(table, n_logical)
    if not 0 <= start <= t.shape[0] - w:
        raise ValueError(f"window [{start}, {start + w}) outside {t.shape[0]} rows")
    return t[start : start + w]
