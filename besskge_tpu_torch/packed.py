"""Logical-row reads of the entity table.

Counterpart of ``besskge_tpu/packed.py``'s :func:`take_rows`,
:func:`take_contiguous_rows`, :func:`is_paired` and :func:`is_trebled` for
plain floating-point tables, for the pair-major ``(2N, D)`` table of an
interleaved ``RowSGDM``, whose param row ``i`` sits at physical row ``2i``
(its momentum at ``2i + 1``), and for the treble-major ``(3N, D)`` table of
an interleaved ``RowAdamW`` (param row ``i`` at ``3i``): :func:`take_rows`
reads such a table's param rows. The 16-bit row-pair-packed tables and their
interleaved layouts (tripled, quintupled) are not ported yet: given one,
these functions raise ``NotImplementedError`` (ROADMAP A9).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["take_rows", "take_contiguous_rows", "check_plain_table", "is_paired", "is_trebled"]


def _flat(table: torch.Tensor) -> torch.Tensor:
    """Strip the optional leading unit (device) axis."""
    return table[0] if table.dim() == 3 else table


def is_paired(table: torch.Tensor, n_logical: Optional[int]) -> bool:
    """True when ``table`` is a pair-major floating-point ``(2·n_logical, D)``
    table. As in the JAX package, detection is by the row count, so
    ``n_logical`` must be the logical row count of the exact table passed."""
    t = _flat(table)
    return bool(n_logical) and t.is_floating_point() and t.shape[0] == 2 * n_logical


def is_trebled(table: torch.Tensor, n_logical: Optional[int]) -> bool:
    """True when ``table`` is a treble-major floating-point
    ``(3·n_logical, D)`` table (same detection contract as :func:`is_paired`)."""
    t = _flat(table)
    return bool(n_logical) and t.is_floating_point() and t.shape[0] == 3 * n_logical


def check_plain_table(table: torch.Tensor, n_logical: Optional[int] = None) -> torch.Tensor:
    """``table`` without its unit device axis; raises for any layout but a
    plain floating-point ``(n_logical, D)`` table."""
    t = _flat(table)
    if not t.is_floating_point():
        raise NotImplementedError(
            f"row-pair-packed 16-bit tables ({t.dtype} storage) are not ported"
            " yet (ROADMAP A9)"
        )
    if is_paired(t, n_logical) or is_trebled(t, n_logical):
        raise NotImplementedError(
            "an interleaved (2N, D) or (3N, D) table is read row by row with take_rows;"
            " split it (split_interleaved, split_interleaved_adamw) for contiguous windows"
        )
    return t


def take_rows(
    table: torch.Tensor, idx: torch.Tensor, n_logical: Optional[int] = None
) -> torch.Tensor:
    """Rows ``idx`` (any shape) of a plain, pair-major or treble-major table,
    as ``(*idx.shape, D)``; for an interleaved table the param rows ``2·idx``
    or ``3·idx``."""
    if is_paired(table, n_logical):
        t, rows = _flat(table), 2 * idx.reshape(-1).long()
    elif is_trebled(table, n_logical):
        t, rows = _flat(table), 3 * idx.reshape(-1).long()
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
