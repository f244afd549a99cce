"""Logical-row reads of the entity table.

Counterpart of ``besskge_tpu/packed.py``'s :func:`take_rows` and
:func:`take_contiguous_rows` for plain floating-point tables. The 16-bit
row-pair-packed tables and the interleaved optimizer layouts (paired,
trebled, tripled, quintupled) are not ported yet: given one, these functions
raise ``NotImplementedError`` (ROADMAP A9).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["take_rows", "take_contiguous_rows", "check_plain_table"]


def _flat(table: torch.Tensor) -> torch.Tensor:
    """Strip the optional leading unit (device) axis."""
    return table[0] if table.dim() == 3 else table


def check_plain_table(table: torch.Tensor, n_logical: Optional[int] = None) -> torch.Tensor:
    """``table`` without its unit device axis; raises for any layout but a
    plain floating-point ``(n_logical, D)`` table."""
    t = _flat(table)
    if not t.is_floating_point():
        raise NotImplementedError(
            f"row-pair-packed 16-bit tables ({t.dtype} storage) are not ported"
            " yet (ROADMAP A9)"
        )
    if n_logical and t.shape[0] in (2 * n_logical, 3 * n_logical):
        raise NotImplementedError(
            f"interleaved ({t.shape[0] // n_logical}N, D) optimizer-state tables"
            " are not ported yet (ROADMAP A9)"
        )
    return t


def take_rows(
    table: torch.Tensor, idx: torch.Tensor, n_logical: Optional[int] = None
) -> torch.Tensor:
    """Rows ``idx`` (any shape) of a plain table, as ``(*idx.shape, D)``."""
    t = check_plain_table(table, n_logical)
    return t[idx.reshape(-1).long()].reshape(*idx.shape, t.shape[-1])


def take_contiguous_rows(
    table: torch.Tensor, start: int, w: int, n_logical: Optional[int] = None
) -> torch.Tensor:
    """Rows ``[start, start + w)`` of a plain table as a ``(w, D)`` view."""
    t = check_plain_table(table, n_logical)
    if not 0 <= start <= t.shape[0] - w:
        raise ValueError(f"window [{start}, {start + w}) outside {t.shape[0]} rows")
    return t[start : start + w]
