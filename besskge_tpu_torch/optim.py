"""Sparse row-wise optimizers for the entity table, and the dense optimizers
(torch).

Counterpart of ``besskge_tpu/optim.py``. A BESS step only uses the gathered
rows (heads, tails, negatives), so the entity table may be updated sparsely:

1. the trainer differentiates the loss w.r.t. the gathered rows;
2. :func:`_dedup_row_grads` sorts the touched rows and sums duplicate-row
   gradients with the JAX package's cumsum-difference segment sums;
3. the optimizer updates parameters and fp32 moments only at touched rows,
   in place, writing each row once.

Row optimizers, and the kernels that write them on a card:

=====================================  =======================================
:class:`RowSGDM` ``interleaved=True``  fp32: B3 (h = 2), or B4 (``"fused"``),
                                       or B9 reads and B3 writes
                                       (``"pallas_gather"``); packed: B3
                                       (h = 3) on the triplet store
:class:`RowSGDM` separate buffer       B8 (table and momentum; an int32 or
                                       uint32 packed table is 4-byte words
                                       too), B3 (h = 1) at momentum 0 and for
                                       each table when one is plain 16-bit
:class:`RowAdamW` separate buffers     B8 (table, mu, nu), or B3 per table
                                       beside a plain 16-bit table
:class:`RowAdamW` ``interleaved=True``  fp32: B3 (h = 3) on the treble-major
                                       table; packed: B3 (h = 5) on the
                                       quintuplet store
:class:`RowAdagrad` separate buffer    B8 (table and accumulator), or B3 per
                                       table beside a plain 16-bit table
:class:`RowAdagrad` ``interleaved``    fp32: B3 (h = 2) on the pair-major
                                       table; packed: B3 (h = 3) on the
                                       triplet store (``RowSGDM``'s layouts)
=====================================  =======================================

A 16-bit table, plain or row-pair-packed (:mod:`besskge_tpu_torch.packed`),
keeps fp32 moments, and its updated rows are stochastically rounded to
16 bits by default (:func:`_sr_round_16`).

Dense optimizers, in place: :class:`SGD` (``optax.sgd(lr, momentum)``) and
:class:`AdamW` (``optax.adamw``) for the replicated params, or for every
param in the dense step; :class:`FusedDenseAdamW`, the entity table's dense
AdamW through the fused kernel B10.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from besskge_tpu_torch.ops import adamw_kernels, row_kernels
from besskge_tpu_torch.packed import (
    _bits16,
    _from_bits16,
    _words,
    half_dtype,
    interleave_packed_adamw,
    interleave_packed_momentum,
    is_packed,
    merge_packed_block_writes,
    merge_packed_row_writes,
    take_rows,
)
from besskge_tpu_torch.utils import _first_leaf, _mix32, _mul32, _tree_map

__all__ = [
    "AdamW",
    "EntityRowOptimizer",
    "FusedDenseAdamW",
    "RowAdagrad",
    "RowAdamW",
    "RowSGDM",
    "SGD",
    "interleave_adamw",
    "interleave_momentum",
    "split_interleaved",
    "split_interleaved_adamw",
]

#: A learning rate: a float, or a schedule called with the step count.
LearningRate = Union[float, Callable[[torch.Tensor], Any]]


def _flat(table: torch.Tensor) -> torch.Tensor:
    """Read view of a table that may carry a leading unit (device) axis."""
    return table[0] if table.dim() == 3 else table


def _lr_at(lr: LearningRate, count: torch.Tensor):
    """The learning rate at step ``count`` (the pre-increment count: the
    first step sees ``schedule(0)``), as ``optax.scale_by_schedule`` does."""
    return lr(count) if callable(lr) else lr


def _is_16bit_table(table: torch.Tensor) -> bool:
    """A row-pair-packed table, or a plain bf16 or fp16 one."""
    t = _flat(table)
    return is_packed(t) or t.dtype in (torch.bfloat16, torch.float16)


def _moment_shape(table: torch.Tensor) -> Tuple[int, ...]:
    """Shape of a per-logical-row fp32 moment buffer for ``table``: a packed
    table's moments stay unpacked, ``(2·P, D)`` for ``P`` packed rows."""
    t = _flat(table)
    if is_packed(t):
        return (2 * t.shape[0], t.shape[1])
    return tuple(table.shape)


def _sr_round_16(
    rows: torch.Tensor, idx: torch.Tensor, count: torch.Tensor,
    table: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Stochastically round fp32 rows to the table's 16-bit dtype (bf16
    without a table), bit for bit as ``besskge_tpu.optim._sr_round_16``.

    Round-to-nearest drops an update smaller than half a 16-bit ulp of the
    weight, so a 16-bit table at a small learning rate stops learning; with
    stochastic rounding an update lands with probability proportional to its
    size, and the expected weight follows the fp32 trajectory. The random
    bits are a counter-based hash of (row id, lane, step count), computed in
    int64 with 32-bit wraparound: duplicate occurrences of a row round alike,
    so their writes stay byte-identical.

    bf16 is the top half of fp32: a uniform ``r ∈ [0, 2^16)`` added to the
    fp32 bit pattern, then truncation, rounds exactly. fp16 takes the
    two-candidate form: round to nearest, then take the neighbour on the
    error's side (from the bit pattern) with probability error/gap.
    Non-finite values pass through.
    """
    half = half_dtype(_flat(table)) if table is not None else torch.bfloat16
    device = rows.device
    lane = torch.arange(rows.shape[-1], dtype=torch.int64, device=device)[None, :]
    x = (
        _mul32(idx.to(torch.int64)[:, None] & 0xFFFFFFFF, 2654435761)
        ^ _mul32(lane, 0x9E3779B9)
        ^ _mul32(count.to(torch.int64) & 0xFFFFFFFF, 0x85EBCA6B)
    )
    x = _mix32(x)
    r32 = rows.to(torch.float32)
    if half == torch.float16:
        y = r32.to(torch.float16)  # round to nearest
        y32 = y.to(torch.float32)
        err = r32 - y32
        up = err > 0
        # the fp16 neighbour of y toward ±inf: one bit pattern step away
        # from zero when the signs agree, toward it otherwise; ±0 steps to
        # the smallest subnormal of the direction's sign
        b = _bits16(y, torch.float16)
        away = (y > 0) == up
        nb_bits = torch.where(y == 0, torch.where(up, 0x0001, 0x8001),
                              torch.where(away, b + 1, b - 1))
        nb = _from_bits16(nb_bits, torch.float16)
        gap = nb.to(torch.float32) - y32
        p = torch.where(gap != 0.0, err / gap, torch.zeros_like(err))  # in [0, 1/2]
        u = (x >> 8).to(torch.float32) * 2.0**-24  # [0, 1)
        sr = torch.where(u < p, nb, y)
        return torch.where(torch.isfinite(rows), sr, rows.to(torch.float16))
    bits = _words(r32.contiguous()).to(torch.int64) & 0xFFFFFFFF
    sr = _from_bits16((bits + (x & 0xFFFF)) >> 16, torch.bfloat16)
    # inf/nan payloads must not pick up carries
    return torch.where(torch.isfinite(rows), sr, rows.to(torch.bfloat16))


def interleave_momentum(
    table: torch.Tensor, momentum: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Interleave a plain fp32 ``(N, D)`` table with its momentum into one
    pair-major ``(2N, D)`` table — param row ``i`` at physical row ``2i``,
    momentum at ``2i+1`` — the storage of :class:`RowSGDM`
    ``interleaved=True``: a touched row's param and momentum are one
    contiguous 1 KB block at D = 128. A leading unit axis is kept."""
    t = _flat(table)
    if is_packed(t):
        raise ValueError(
            "interleaved momentum requires a plain fp32 table (a packed table widens with"
            " interleave_packed_momentum)"
        )
    m = torch.zeros_like(t) if momentum is None else momentum.to(t.dtype)
    n, d = t.shape
    paired = torch.stack([t, m], dim=1).reshape(2 * n, d)
    return paired[None] if table.dim() == 3 else paired


def interleave_adamw(
    table: torch.Tensor,
    mu: Optional[torch.Tensor] = None,
    nu: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Interleave a plain fp32 ``(N, D)`` table with its Adam moments into one
    treble-major ``(3N, D)`` table — param row ``i`` at physical row ``3i``,
    first moment at ``3i+1``, second at ``3i+2`` — the storage of
    :class:`RowAdamW` ``interleaved=True``. A leading unit axis is kept."""
    t = _flat(table)
    if is_packed(t):
        raise ValueError(
            "interleaved Adam moments require a plain fp32 table (a packed table widens"
            " with interleave_packed_adamw)"
        )
    m = torch.zeros_like(t) if mu is None else mu.reshape(t.shape).to(t.dtype)
    v = torch.zeros_like(t) if nu is None else nu.reshape(t.shape).to(t.dtype)
    n, d = t.shape
    treb = torch.stack([t, m, v], dim=1).reshape(3 * n, d)
    return treb[None] if table.dim() == 3 else treb


def split_interleaved(table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`interleave_momentum`: ``(2N, D) -> ((N, D) params,
    (N, D) momentum)``, as views."""
    t = _flat(table)
    pairs = t.reshape(t.shape[0] // 2, 2, t.shape[-1])
    p, m = pairs[:, 0], pairs[:, 1]
    if table.dim() == 3:
        return p[None], m[None]
    return p, m


def split_interleaved_adamw(
    table: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inverse of :func:`interleave_adamw`: ``(3N, D) -> ((N, D) params,
    (N, D) mu, (N, D) nu)``, as views. As in the JAX package, a leading unit
    axis is kept on the params only."""
    t = _flat(table)
    if t.shape[0] % 3:
        raise ValueError(f"expected a treble-major (3N, D) table; got {tuple(t.shape)}")
    trio = t.reshape(t.shape[0] // 3, 3, t.shape[-1])
    p, m, v = trio[:, 0], trio[:, 1], trio[:, 2]
    if table.dim() == 3:
        return p[None], m, v
    return p, m, v


def _dedup_row_grads(
    idx: torch.Tensor, grad_rows: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted occurrences with per-row summed gradients, no table-sized
    buffer: returns ``(sorted_idx, summed_grads)``, both length R.

    The touched-row occurrences are sorted by row id (stable), summed per
    run with a cumsum difference — the JAX package's rounding, not a direct
    sum — and each run's total is given to every occurrence of the row, so
    row writes keyed by ``sorted_idx`` are idempotent. The result stays in
    sorted order.
    """
    r = idx.shape[0]
    si, order = torch.sort(idx, stable=True)
    sg = grad_rows.float()[order]
    # The scan runs along the last, contiguous axis: along the first, a CUDA
    # scan walks the R rows one after another in D threads.
    cs = torch.cumsum(sg.T.contiguous(), dim=1).T
    pos = torch.arange(r, dtype=torch.int64, device=idx.device)
    boundary = si[1:] != si[:-1]
    true = torch.ones(1, dtype=torch.bool, device=idx.device)
    is_last = torch.cat([boundary, true])
    is_first = torch.cat([true, boundary])
    # seg_end[i] = smallest j >= i with is_last[j]: a reverse running minimum.
    end_candidates = torch.where(is_last, pos, r - 1)
    seg_end = torch.flip(torch.cummin(torch.flip(end_candidates, [0]), 0).values, [0])
    seg_start = torch.cummax(torch.where(is_first, pos, 0), 0).values
    before = torch.where(
        (seg_start > 0)[:, None], cs[(seg_start - 1).clamp(min=0)], torch.zeros_like(cs[:1])
    )
    return si, cs[seg_end] - before




def is_packed_table(t: torch.Tensor) -> bool:
    """True for a row-pair-packed table (int32 or uint32 words)."""
    return is_packed(t)


class EntityRowOptimizer:
    """Interface: sparse per-row optimizer for the local entity table."""

    #: True when optimizer state lives inside the widened param table.
    interleaved: bool = False
    #: The interleaved layout that a checkpoint de- and re-interleaves:
    #: "momentum" (pair-major / triplet stores of one state row), "adamw"
    #: (treble-major / quintuplet stores of mu and nu), "adagrad" (the
    #: momentum layouts, holding the accumulator).
    interleave_layout: str = "momentum"

    def widen_table(self, table: torch.Tensor) -> torch.Tensor:
        """Widen a plain table into this optimizer's interleaved storage
        (identity for non-interleaved optimizers)."""
        return table

    def init(self, table: torch.Tensor, n_logical: Optional[int] = None) -> Dict[str, Any]:
        """Optimizer state for one local table; ``n_logical`` (the logical
        entity-row count) lets layout-sensitive optimizers check the height."""
        raise NotImplementedError

    def update_rows(
        self,
        table: torch.Tensor,
        state: Dict[str, Any],
        idx: torch.Tensor,
        grad_rows: torch.Tensor,
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Apply one step given flat touched-row indices (R,) — duplicates
        allowed — and their per-occurrence gradients (R, row), in place on
        ``table``; returns ``(table, new_state)``."""
        raise NotImplementedError


def _check_interleaved(
    table: torch.Tensor, n_logical: Optional[int], h: int, packed_h: int, widen: str,
    widen_packed: str,
) -> None:
    """An interleaved table is either fp32 and ``h``-major, ``(h·n_logical,
    D)``, or a packed store of ``packed_h`` rows per packed row,
    ``(packed_h·ceil(n_logical/2), D)``; a plain 16-bit table raises."""
    t = _flat(table)
    rows = n_logical
    if is_packed(t):
        h, widen = packed_h, widen_packed
        rows = None if n_logical is None else (n_logical + 1) // 2
    elif _is_16bit_table(t) or t.element_size() != 4:
        raise ValueError(
            "an interleaved row optimizer requires a plain fp32 or a row-pair-packed table,"
            f" got {t.dtype}"
        )
    if rows is not None and t.shape[0] != h * rows:
        raise ValueError(
            f"interleaved table must be ({h}*{rows}, D) — got {tuple(t.shape)};"
            f" widen it with {widen}()"
        )
    if t.shape[0] % h:
        raise ValueError(f"interleaved table must be ({h}N, D) — widen it with {widen}()")


def _apply_rows(
    table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor, sorted_dedup: bool = False
) -> torch.Tensor:
    """In-place row writes ``table[idx[i]] = rows[i]``: B3 (h = 1) on a card,
    its plain version on the CPU. A packed table's logical writes are first
    merged into packed-row writes (:func:`merge_packed_row_writes`), which
    come sorted with duplicate-identical rows. ``sorted_dedup``: ``idx`` is
    sorted and only the first slot of each run is written."""
    if is_packed(_flat(table)):
        idx, rows = merge_packed_row_writes(table, idx, rows, sorted_idx=sorted_dedup)
        sorted_dedup = True
    return row_kernels.scatter_rows(table, idx, rows, slice_rows=1, skip_dups=sorted_dedup)


def _apply_rows_multi(
    writes: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]], sorted_dedup: bool = False
) -> Tuple[torch.Tensor, ...]:
    """Several in-place ``(table, idx, rows)`` row writes: one launch of the
    multi-table scatter (B8) when every table has 4-byte elements (fp32, or
    packed), else one B3 launch per table, as the JAX package falls back to
    per-buffer writes. A packed table's writes are merged first, as in
    :func:`_apply_rows`. Returns the tables in order."""
    resolved = []
    for table, idx, rows in writes:
        if is_packed(_flat(table)):
            idx, rows = merge_packed_row_writes(table, idx, rows, sorted_idx=sorted_dedup)
            resolved.append((table, idx, rows, True))
        else:
            resolved.append((table, idx, rows, sorted_dedup))
    if len(resolved) > 1 and all(_flat(t).element_size() == 4 for t, _, _, _ in resolved):
        tables, idxs, rows, srt = zip(*resolved)
        return row_kernels.scatter_rows_multi(tables, idxs, rows, skip_dups=all(srt))
    return tuple(
        row_kernels.scatter_rows(table, idx, rows, slice_rows=1, skip_dups=srt)
        for table, idx, rows, srt in resolved
    )


def _apply_row_slices(
    table: torch.Tensor, phys: torch.Tensor, rows: torch.Tensor, h: int,
    sorted_dedup: bool = False,
) -> torch.Tensor:
    """In-place ``(h, D)`` block writes at physical rows ``phys`` (``rows`` is
    ``(h·R, D)`` stacked slices): the ``scatter_rows`` kernel (B3) on a card,
    its plain version on the CPU. ``sorted_dedup``: ``phys`` is sorted and
    only the first slot of each run is written."""
    return row_kernels.scatter_rows(table, phys, rows, slice_rows=h, skip_dups=sorted_dedup)


def _read_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """fp32 values of the touched logical rows of a plain or packed table."""
    return take_rows(_flat(table), idx).float()


def _read_slices(table: torch.Tensor, phys: torch.Tensor, h: int) -> torch.Tensor:
    """The ``(R, h, D)`` blocks at physical rows ``phys`` of an h-major table,
    by PyTorch indexing."""
    t = _flat(table)
    flat_idx = (phys.long()[:, None] + torch.arange(h, device=phys.device)).reshape(-1)
    return t[flat_idx].reshape(-1, h, t.shape[-1])


def _state_rows(table: torch.Tensor, phys: torch.Tensor) -> torch.Tensor:
    """fp32 state rows held by their bits at physical rows ``phys`` of a
    packed store."""
    return _words(_flat(table))[phys.long()].view(torch.float32)


def _round_rows(
    opt: "EntityRowOptimizer", rows: torch.Tensor, idx: torch.Tensor, count: torch.Tensor,
    table: torch.Tensor,
) -> torch.Tensor:
    """Updated fp32 rows for a write into ``table``: stochastically rounded
    to 16 bits for a 16-bit table under ``opt.stochastic_rounding``, else as
    they are (a write into a 16-bit table then rounds to nearest)."""
    if opt.stochastic_rounding and _is_16bit_table(table):
        return _sr_round_16(rows, idx, count, table)
    return rows


def _adam_moments(b1: float, b2: float, mu_prev, nu_prev, g, count):
    """The reference's row-AdamW moments and their bias-corrected values
    (division by ``1 − b^t`` in fp32, ``t`` the post-increment count)."""
    mu_rows = b1 * mu_prev + (1 - b1) * g
    nu_rows = b2 * nu_prev + (1 - b2) * (g * g)
    tf = count.to(torch.float32)
    mu_hat = mu_rows / (1 - torch.pow(b1, tf))
    nu_hat = nu_rows / (1 - torch.pow(b2, tf))
    return mu_rows, nu_rows, mu_hat, nu_hat


@dataclasses.dataclass
class RowAdamW(EntityRowOptimizer):
    """Lazy AdamW on touched rows, fp32 moments (``besskge_tpu.optim.RowAdamW``).
    The learning rate is read at the pre-increment step count, the bias
    correction at the post-increment one, as in the reference.

    :param learning_rate: a float, or a schedule called with the step count.
    :param stochastic_rounding: round the updated rows of a 16-bit table
        stochastically (:func:`_sr_round_16`); no effect on an fp32 table.
    :param interleaved: keep both moments in the table: treble-major
        ``(3N, D)`` for an fp32 table (:func:`interleave_adamw`), written back
        as one 3-row block per touched row (B3, h = 3); the quintuplet store
        ``(5P, D)`` for a packed one
        (:func:`~besskge_tpu_torch.packed.interleave_packed_adamw`), one 5-row
        block per touched packed row (B3, h = 5). Otherwise separate ``mu``
        and ``nu`` buffers written with the table in one launch (B8, k = 3).
    """

    learning_rate: LearningRate
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    stochastic_rounding: bool = True
    interleaved: bool = False
    interleave_layout: str = "adamw"

    def init(self, table: torch.Tensor, n_logical: Optional[int] = None) -> Dict[str, Any]:
        count = torch.zeros((), dtype=torch.int32, device=table.device)
        if self.interleaved:
            _check_interleaved(table, n_logical, 3, 5, "interleave_adamw",
                               "interleave_packed_adamw")
            return {"count": count}
        shape = _moment_shape(table)
        return {
            "mu": torch.zeros(shape, dtype=torch.float32, device=table.device),
            "nu": torch.zeros(shape, dtype=torch.float32, device=table.device),
            "count": count,
        }

    def widen_table(self, table: torch.Tensor) -> torch.Tensor:
        if not self.interleaved:
            return table
        if is_packed(_flat(table)):
            return interleave_packed_adamw(table)
        return interleave_adamw(table)

    def _step(self, p_rows, mu_prev, nu_prev, g, state):
        count = state["count"] + 1
        mu_rows, nu_rows, mu_hat, nu_hat = _adam_moments(
            self.b1, self.b2, mu_prev, nu_prev, g, count)
        upd = _lr_at(self.learning_rate, state["count"]) * (
            mu_hat / (torch.sqrt(nu_hat) + self.eps) + self.weight_decay * p_rows
        )
        return p_rows - upd, mu_rows, nu_rows, count

    def update_rows(self, table, state, idx, grad_rows):
        idx, g = _dedup_row_grads(idx, grad_rows)
        if self.interleaved and is_packed(_flat(table)):
            # the quintuplet store: [packed | mu 2p | mu 2p+1 | nu 2p | nu 2p+1]
            p5, odd = 5 * (idx >> 1), idx & 1
            new_p, mu_rows, nu_rows, count = self._step(
                take_rows(table, idx, n_logical=2 * (_flat(table).shape[0] // 5)).float(),
                _state_rows(table, p5 + 1 + odd), _state_rows(table, p5 + 3 + odd), g, state)
            new_p = _round_rows(self, new_p, idx, count, table)
            phys, out = merge_packed_block_writes(table, idx, new_p, [mu_rows, nu_rows])
            _apply_row_slices(table, phys, out, 5, sorted_dedup=True)
            return table, {"count": count}
        if self.interleaved:
            phys = 3 * idx
            trios = _read_slices(table, phys, 3)
            new_p, mu_rows, nu_rows, count = self._step(
                trios[:, 0], trios[:, 1], trios[:, 2], g, state)
            new_trios = torch.stack([new_p, mu_rows, nu_rows], dim=1).reshape(-1, g.shape[-1])
            _apply_row_slices(table, phys, new_trios, 3, sorted_dedup=True)
            return table, {"count": count}
        new_p, mu_rows, nu_rows, count = self._step(
            _read_rows(table, idx), _read_rows(state["mu"], idx), _read_rows(state["nu"], idx),
            g, state)
        _apply_rows_multi([
            (table, idx, _round_rows(self, new_p, idx, count, table)),
            (state["mu"], idx, mu_rows), (state["nu"], idx, nu_rows),
        ], sorted_dedup=True)
        return table, {"mu": state["mu"], "nu": state["nu"], "count": count}


#: RowSGDM update variants of the interleaved fp32 table: "xla" gathers the
#: pairs with PyTorch indexing, updates them and writes them with B3;
#: "pallas_gather" reads them with B9 instead; "fused" runs B4.
_VARIANTS = ("xla", "pallas_gather", "fused")


@dataclasses.dataclass
class RowSGDM(EntityRowOptimizer):
    """Lazy SGD with momentum on touched rows (the reference wikikg2 recipe,
    notebook 3 cell 14), fp32 momentum (``besskge_tpu.optim.RowSGDM``).

    :param learning_rate: a float, or a schedule called with the step count
        (a 0-dim tensor on the table's device).
    :param momentum: momentum coefficient; 0 keeps no momentum buffer.
    :param weight_decay: L2 term added to the gradient.
    :param stochastic_rounding: round the updated rows of a 16-bit table
        stochastically (:func:`_sr_round_16`); no effect on an fp32 table.
    :param interleaved: keep the momentum in the table: pair-major
        ``(2N, D)`` for an fp32 table (:func:`interleave_momentum`); the
        triplet store ``(3P, D)`` for a packed one
        (:func:`~besskge_tpu_torch.packed.interleave_packed_momentum`),
        written back as one 3-row block per touched packed row (B3, h = 3).
        Otherwise a separate ``m`` buffer, written with the table in one
        launch (B8, k = 2).
    :param fused_variant: the interleaved fp32 update: ``"xla"`` (the
        default): PyTorch gathers and updates the pairs and B3 writes them;
        ``"pallas_gather"``: B9 reads them instead; ``"fused"``: B4 does all
        three. A packed store always takes the ``"xla"`` form, as in the JAX
        package.
    """

    learning_rate: LearningRate
    momentum: float = 0.9
    weight_decay: float = 0.0
    stochastic_rounding: bool = True
    interleaved: bool = False
    fused_variant: Optional[str] = None

    def __post_init__(self) -> None:
        if self.fused_variant not in (None, *_VARIANTS):
            raise ValueError(f"unknown fused_variant {self.fused_variant!r}")
        if self.fused_variant is not None and not self.interleaved:
            raise ValueError("fused_variant selects an update of the interleaved table only")

    def widen_table(self, table: torch.Tensor) -> torch.Tensor:
        if not self.interleaved:
            return table
        if is_packed(_flat(table)):
            return interleave_packed_momentum(table)
        return interleave_momentum(table)

    def init(self, table: torch.Tensor, n_logical: Optional[int] = None) -> Dict[str, Any]:
        count = torch.zeros((), dtype=torch.int32, device=table.device)
        if self.interleaved:
            if self.momentum == 0.0:
                raise ValueError("interleaved=True requires momentum != 0")
            _check_interleaved(table, n_logical, 2, 3, "interleave_momentum",
                               "interleave_packed_momentum")
            return {"count": count}
        if self.momentum == 0.0:
            return {"count": count}
        return {
            "m": torch.zeros(_moment_shape(table), dtype=torch.float32, device=table.device),
            "count": count,
        }

    def _step(self, p_rows, m_prev, g, lr):
        if self.weight_decay:
            g = g + self.weight_decay * p_rows
        m_rows = self.momentum * m_prev + g
        return p_rows - lr * m_rows, m_rows

    def _update_rows_interleaved(self, table, state, idx, g):
        phys = 2 * idx
        lr = _lr_at(self.learning_rate, state["count"])
        variant = self.fused_variant or "xla"
        if variant == "fused":
            row_kernels.fused_pair_sgdm(
                table, phys, g, lr, momentum=self.momentum, weight_decay=self.weight_decay
            )
            return table
        d = g.shape[-1]
        if variant == "pallas_gather":
            # Duplicate slots are left unread (garbage): their updates are
            # never written, as B3 below skips them too.
            pairs = row_kernels.gather_rows(_flat(table), phys, slice_rows=2, skip_dups=True)
            pairs = pairs.reshape(-1, 2, d)
        else:
            pairs = _read_slices(table, phys, 2)
        new_p, m_rows = self._step(pairs[:, 0], pairs[:, 1], g, lr)
        new_pairs = torch.stack([new_p, m_rows], dim=1).reshape(-1, d)
        return _apply_row_slices(table, phys, new_pairs, 2, sorted_dedup=True)

    def _update_rows_interleaved_packed(self, table, state, idx, g, count):
        """The triplet store ``[packed | m 2p | m 2p+1]``: the same update as
        the separate-buffer form (same dedup, momentum rule and rounding
        hash), written back as one (3, D) block per touched packed row."""
        new_p, m_rows = self._step(
            take_rows(table, idx, tripled=True).float(),
            _state_rows(table, 3 * (idx >> 1) + 1 + (idx & 1)), g,
            _lr_at(self.learning_rate, state["count"]))
        new_p = _round_rows(self, new_p, idx, count, table)
        phys, out = merge_packed_block_writes(table, idx, new_p, [m_rows])
        return _apply_row_slices(table, phys, out, 3, sorted_dedup=True)

    def update_rows(self, table, state, idx, grad_rows):
        idx, g = _dedup_row_grads(idx, grad_rows)
        new_state = dict(state, count=state["count"] + 1)
        if self.interleaved and is_packed(_flat(table)):
            return self._update_rows_interleaved_packed(
                table, state, idx, g, new_state["count"]), new_state
        if self.interleaved:
            return self._update_rows_interleaved(table, state, idx, g), new_state
        lr = _lr_at(self.learning_rate, state["count"])
        p_rows = _read_rows(table, idx)
        if self.momentum == 0.0:
            if self.weight_decay:
                g = g + self.weight_decay * p_rows
            new_p = _round_rows(self, p_rows - lr * g, idx, new_state["count"], table)
            return _apply_rows(table, idx, new_p, sorted_dedup=True), new_state
        new_p, m_rows = self._step(p_rows, _read_rows(state["m"], idx), g, lr)
        new_p = _round_rows(self, new_p, idx, new_state["count"], table)
        _apply_rows_multi([(table, idx, new_p), (state["m"], idx, m_rows)], sorted_dedup=True)
        return table, new_state


@dataclasses.dataclass
class RowAdagrad(EntityRowOptimizer):
    """Lazy Adagrad on touched rows, fp32 accumulator
    (``besskge_tpu.optim.RowAdagrad``): ``acc ← acc + g²``, ``p ← p −
    lr·g / (√acc + eps)``, the learning rate read at the pre-increment step
    count, stochastic rounding hashed with the post-increment one.

    :param learning_rate: a float, or a schedule called with the step count.
    :param stochastic_rounding: round the updated rows of a 16-bit table
        stochastically (:func:`_sr_round_16`); no effect on an fp32 table.
    :param interleaved: keep the accumulator in the table, in
        :class:`RowSGDM`'s single-state layouts: pair-major ``(2N, D)`` for
        an fp32 table (:func:`interleave_momentum`, B3 h = 2), the triplet
        store ``(3P, D)`` for a packed one
        (:func:`~besskge_tpu_torch.packed.interleave_packed_momentum`, B3
        h = 3). Otherwise a separate ``acc`` buffer, written with the table
        in one launch (B8, k = 2).
    """

    learning_rate: LearningRate
    eps: float = 1e-10
    stochastic_rounding: bool = True
    interleaved: bool = False
    interleave_layout: str = "adagrad"

    def init(self, table: torch.Tensor, n_logical: Optional[int] = None) -> Dict[str, Any]:
        count = torch.zeros((), dtype=torch.int32, device=table.device)
        if self.interleaved:
            _check_interleaved(table, n_logical, 2, 3, "interleave_momentum",
                               "interleave_packed_momentum")
            return {"count": count}
        return {
            "acc": torch.zeros(_moment_shape(table), dtype=torch.float32, device=table.device),
            "count": count,
        }

    def widen_table(self, table: torch.Tensor) -> torch.Tensor:
        if not self.interleaved:
            return table
        if is_packed(_flat(table)):
            return interleave_packed_momentum(table)
        return interleave_momentum(table)

    def _step(self, p_rows, acc_prev, g, lr):
        acc_rows = acc_prev + g * g
        return p_rows - lr * g / (torch.sqrt(acc_rows) + self.eps), acc_rows

    def update_rows(self, table, state, idx, grad_rows):
        idx, g = _dedup_row_grads(idx, grad_rows)
        count = state["count"] + 1
        lr = _lr_at(self.learning_rate, state["count"])
        if self.interleaved and is_packed(_flat(table)):
            new_p, acc_rows = self._step(
                take_rows(table, idx, tripled=True).float(),
                _state_rows(table, 3 * (idx >> 1) + 1 + (idx & 1)), g, lr)
            new_p = _round_rows(self, new_p, idx, count, table)
            phys, out = merge_packed_block_writes(table, idx, new_p, [acc_rows])
            _apply_row_slices(table, phys, out, 3, sorted_dedup=True)
            return table, {"count": count}
        if self.interleaved:
            phys = 2 * idx
            pairs = _read_slices(table, phys, 2)
            new_p, acc_rows = self._step(pairs[:, 0], pairs[:, 1], g, lr)
            new_pairs = torch.stack([new_p, acc_rows], dim=1).reshape(-1, g.shape[-1])
            _apply_row_slices(table, phys, new_pairs, 2, sorted_dedup=True)
            return table, {"count": count}
        new_p, acc_rows = self._step(_read_rows(table, idx), _read_rows(state["acc"], idx), g, lr)
        _apply_rows_multi([
            (table, idx, _round_rows(self, new_p, idx, count, table)),
            (state["acc"], idx, acc_rows),
        ], sorted_dedup=True)
        return table, {"acc": state["acc"], "count": count}


@dataclasses.dataclass
class SGD:
    """Dense SGD with momentum, in place: ``m ← momentum·m + g``,
    ``p ← p − lr·m`` (``optax.sgd(lr, momentum)``; ``torch.optim.SGD`` with
    ``dampening=0``, no Nesterov).

    :param learning_rate: a float, or a schedule called with the step count.
    :param momentum: 0 for plain SGD.
    """

    learning_rate: LearningRate
    momentum: float = 0.0

    def init(self, params: Dict[str, Any]) -> Dict[str, Any]:
        device = _first_leaf(params).device
        state: Dict[str, Any] = {"count": torch.zeros((), dtype=torch.int32, device=device)}
        if self.momentum:
            state["trace"] = _tree_map(torch.zeros_like, params)
        return state

    def update_(
        self,
        grads: Dict[str, Any],
        state: Dict[str, Any],
        params: Dict[str, Any],
    ) -> Dict[str, Any]:
        """Update ``params`` (and the momentum in ``state``) in place, leaf by
        leaf of ``grads`` (nested dicts, as ConvE's trunk, like
        ``optax``'s trees); returns the new state."""
        lr = _lr_at(self.learning_rate, state["count"])

        def leaf(g: torch.Tensor, p: torch.Tensor, m: torch.Tensor) -> None:
            p.sub_(lr * m.mul_(self.momentum).add_(g))

        if self.momentum:
            _tree_map(leaf, grads, params, state["trace"])
        else:
            _tree_map(lambda g, p: p.sub_(lr * g), grads, params)
        return {**state, "count": state["count"] + 1}


@dataclasses.dataclass
class AdamW:
    """Dense AdamW, in place, with the update rule and defaults of
    ``optax.adamw`` (not ``torch.optim.AdamW``, whose weight decay defaults
    to 1e-2): ``mu ← (1−b1)·g + b1·mu``, ``nu ← (1−b2)·g² + b2·nu``,
    ``p ← p − lr·(mu/(1−b1^t) / (√(nu/(1−b2^t)) + eps) + weight_decay·p)``
    with ``t`` the post-increment step count and ``lr`` read at the
    pre-increment one.

    :param learning_rate: a float, or a schedule called with the step count.
    :param weight_decay: decoupled weight decay (``optax.adamw``'s 1e-4).
    """

    learning_rate: LearningRate
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def init(self, params: Dict[str, Any]) -> Dict[str, Any]:
        return {
            "count": torch.zeros((), dtype=torch.int32, device=_first_leaf(params).device),
            "mu": _tree_map(torch.zeros_like, params),
            "nu": _tree_map(torch.zeros_like, params),
        }

    def update_(
        self,
        grads: Dict[str, Any],
        state: Dict[str, Any],
        params: Dict[str, Any],
    ) -> Dict[str, Any]:
        """Update ``params`` and the moments in ``state`` in place, leaf by
        leaf of ``grads`` (nested dicts, as ConvE's trunk, whose moments
        mirror them as ``optax``'s ``mu``/``nu`` trees); returns the new
        state."""
        lr = _lr_at(self.learning_rate, state["count"])
        count = state["count"] + 1
        t = count.to(torch.float32)
        bc1 = 1 - torch.pow(self.b1, t)
        bc2 = 1 - torch.pow(self.b2, t)

        def leaf(g: torch.Tensor, p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor) -> None:
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps) + self.weight_decay * p
            p.sub_(lr * u)

        _tree_map(leaf, grads, params, state["mu"], state["nu"])
        return {**state, "count": count}


@dataclasses.dataclass
class FusedDenseAdamW:
    """Dense AdamW over the whole entity table through the fused in-place
    kernel (B10, :func:`~besskge_tpu_torch.ops.adamw_kernels.dense_adamw_update`):
    one pass reads grad, param, mu and nu and writes param, mu and nu
    (``besskge_tpu.optim.FusedDenseAdamW``). The gradient is dense; the
    trainer's dense step gives it. Unlike the JAX package, which leaves the
    kernel for a schedule, a schedule's learning rate runs the kernel too: it
    reads the value from device memory. The bias corrections multiply by
    reciprocals, as the Pallas kernel does, where the JAX package's
    non-kernel path divides.

    :param learning_rate: a float, or a schedule called with the step count.
    """

    learning_rate: LearningRate
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, table: torch.Tensor, n_logical: Optional[int] = None) -> Dict[str, Any]:
        return {
            "mu": torch.zeros(table.shape, dtype=torch.float32, device=table.device),
            "nu": torch.zeros(table.shape, dtype=torch.float32, device=table.device),
            "count": torch.zeros((), dtype=torch.int32, device=table.device),
        }

    def apply_dense(
        self, table: torch.Tensor, state: Dict[str, Any], grad: torch.Tensor
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One step from a dense table gradient, in place; returns
        ``(table, state)``."""
        count = state["count"] + 1
        lr = _lr_at(self.learning_rate, state["count"])
        if torch.is_tensor(lr):
            lr = lr.to(device=table.device, dtype=torch.float32)
        adamw_kernels.dense_adamw_update(
            table, state["mu"], state["nu"], grad, count, lr,
            b1=self.b1, b2=self.b2, eps=self.eps, wd=self.weight_decay,
        )
        return table, {"mu": state["mu"], "nu": state["nu"], "count": count}
