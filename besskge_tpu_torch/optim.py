"""Sparse row-wise optimizers for the entity table, and the dense SGD of the
replicated params (torch).

Counterpart of ``besskge_tpu/optim.py``. A BESS step only uses the gathered
rows (heads, tails, negatives), so the entity table is updated sparsely:

1. the trainer differentiates the loss w.r.t. the gathered rows;
2. :func:`_dedup_row_grads` sorts the touched rows and sums duplicate-row
   gradients with the JAX package's cumsum-difference segment sums;
3. the optimizer updates parameters and fp32 moments only at touched rows,
   in place, writing each row once.

Ported so far: :class:`RowSGDM` in its interleaved form, the momentum stored
pair-major in one ``(2N, D)`` fp32 table (:func:`interleave_momentum`), whose
write on a card is the hand-written ``scatter_rows`` kernel (B3) or, with
``fused_variant="fused"``, the fused ``fused_pair_sgdm`` kernel (B4). The
separate-buffer form waits on the multi-table scatter (ROADMAP B8), the
``"pallas_gather"`` variant on the row-gather kernel (B9), 16-bit tables on
ROADMAP A9 and ``RowAdamW``/``RowAdagrad`` on A13.

:class:`SGD` is the dense SGD with momentum of the replicated params (the
relation table): the update rule of ``optax.sgd(lr, momentum)`` and of
``torch.optim.SGD`` with ``dampening=0``, applied in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from besskge_tpu_torch.ops import row_kernels

__all__ = [
    "EntityRowOptimizer",
    "RowSGDM",
    "SGD",
    "interleave_momentum",
    "split_interleaved",
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


def interleave_momentum(
    table: torch.Tensor, momentum: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Interleave a plain fp32 ``(N, D)`` table with its momentum into one
    pair-major ``(2N, D)`` table — param row ``i`` at physical row ``2i``,
    momentum at ``2i+1`` — the storage of :class:`RowSGDM`
    ``interleaved=True``: a touched row's param and momentum are one
    contiguous 1 KB block at D = 128. A leading unit axis is kept."""
    t = _flat(table)
    if not t.is_floating_point():
        raise ValueError("interleaved momentum requires a plain fp32 table")
    m = torch.zeros_like(t) if momentum is None else momentum.to(t.dtype)
    n, d = t.shape
    paired = torch.stack([t, m], dim=1).reshape(2 * n, d)
    return paired[None] if table.dim() == 3 else paired


def split_interleaved(table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`interleave_momentum`: ``(2N, D) -> ((N, D) params,
    (N, D) momentum)``, as views."""
    t = _flat(table)
    pairs = t.reshape(t.shape[0] // 2, 2, t.shape[-1])
    p, m = pairs[:, 0], pairs[:, 1]
    if table.dim() == 3:
        return p[None], m[None]
    return p, m


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


class EntityRowOptimizer:
    """Interface: sparse per-row optimizer for the local entity table."""

    #: True when optimizer state lives inside the widened param table.
    interleaved: bool = False

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


def _apply_row_slices(
    table: torch.Tensor, phys: torch.Tensor, rows: torch.Tensor, h: int,
    sorted_dedup: bool = False,
) -> torch.Tensor:
    """In-place ``(h, D)`` block writes at physical rows ``phys`` (``rows`` is
    ``(h·R, D)`` stacked slices): the ``scatter_rows`` kernel (B3) on a card,
    its plain version on the CPU. ``sorted_dedup``: ``phys`` is sorted and
    only the first slot of each run is written."""
    return row_kernels.scatter_rows(table, phys, rows, slice_rows=h, skip_dups=sorted_dedup)


#: RowSGDM update variants: "xla" gathers the pairs with PyTorch indexing,
#: updates them and writes them with B3; "fused" runs B4.
_VARIANTS = ("xla", "fused")


@dataclasses.dataclass
class RowSGDM(EntityRowOptimizer):
    """Lazy SGD with momentum on touched rows (the reference wikikg2 recipe,
    notebook 3 cell 14), the fp32 momentum interleaved pair-major with the
    params.

    :param learning_rate: a float, or a schedule called with the step count
        (a 0-dim tensor on the table's device).
    :param momentum: momentum coefficient (not 0: the momentum is stored).
    :param weight_decay: L2 term added to the gradient.
    :param interleaved: must be True: the separate momentum buffer waits on
        ROADMAP B8.
    :param fused_variant: ``"xla"`` (the default): PyTorch gathers and
        updates the pairs and B3 writes them; ``"fused"``: B4 does all three.
        ``"pallas_gather"`` waits on ROADMAP B9.
    """

    learning_rate: LearningRate
    momentum: float = 0.9
    weight_decay: float = 0.0
    interleaved: bool = False
    fused_variant: Optional[str] = None

    def __post_init__(self) -> None:
        if not self.interleaved:
            raise NotImplementedError(
                "RowSGDM with a separate momentum buffer is not ported yet: its"
                " write is the multi-table scatter (ROADMAP B8); use interleaved=True"
            )
        if self.fused_variant == "pallas_gather":
            raise NotImplementedError(
                "the 'pallas_gather' variant needs the row-gather kernel, not ported"
                " yet (ROADMAP B9)"
            )
        if self.fused_variant not in (None, *_VARIANTS):
            raise ValueError(f"unknown fused_variant {self.fused_variant!r}")
        if self.momentum == 0.0:
            raise ValueError("interleaved=True requires momentum != 0")

    def widen_table(self, table: torch.Tensor) -> torch.Tensor:
        return interleave_momentum(table)

    def init(self, table: torch.Tensor, n_logical: Optional[int] = None) -> Dict[str, Any]:
        t = _flat(table)
        if t.dtype != torch.float32:
            raise NotImplementedError(
                f"interleaved momentum needs an fp32 table, got {t.dtype}"
                " (16-bit tables: ROADMAP A9)"
            )
        if n_logical is not None and t.shape[0] != 2 * n_logical:
            raise ValueError(
                f"interleaved table must be (2*{n_logical}, D) — got {tuple(t.shape)};"
                " widen it with interleave_momentum()"
            )
        if t.shape[0] % 2:
            raise ValueError(
                "interleaved table must be pair-major (2N, D) — widen it with"
                " interleave_momentum()"
            )
        return {"count": torch.zeros((), dtype=torch.int32, device=t.device)}

    def update_rows(self, table, state, idx, grad_rows):
        idx, g = _dedup_row_grads(idx, grad_rows)
        phys = 2 * idx
        lr = _lr_at(self.learning_rate, state["count"])
        new_state = {"count": state["count"] + 1}
        if (self.fused_variant or "xla") == "fused":
            row_kernels.fused_pair_sgdm(
                table, phys, g, lr, momentum=self.momentum, weight_decay=self.weight_decay
            )
            return table, new_state
        t = _flat(table)
        d = g.shape[-1]
        flat_idx = (phys[:, None] + torch.arange(2, device=phys.device)).reshape(-1)
        pairs = t[flat_idx].reshape(-1, 2, d)
        p_rows, m_prev = pairs[:, 0], pairs[:, 1]
        if self.weight_decay:
            g = g + self.weight_decay * p_rows
        m_rows = self.momentum * m_prev + g
        new_p = p_rows - lr * m_rows
        new_pairs = torch.stack([new_p, m_rows], dim=1).reshape(-1, d)
        _apply_row_slices(table, phys, new_pairs, 2, sorted_dedup=True)
        return table, new_state


@dataclasses.dataclass
class SGD:
    """Dense SGD with momentum for the replicated params, in place:
    ``m ← momentum·m + g``, ``p ← p − lr·m`` (``optax.sgd(lr, momentum)``;
    ``torch.optim.SGD`` with ``dampening=0``, no Nesterov).

    :param learning_rate: a float, or a schedule called with the step count.
    :param momentum: 0 for plain SGD.
    """

    learning_rate: LearningRate
    momentum: float = 0.0

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        device = next(iter(params.values())).device
        state: Dict[str, Any] = {"count": torch.zeros((), dtype=torch.int32, device=device)}
        if self.momentum:
            state["trace"] = {k: torch.zeros_like(v) for k, v in params.items()}
        return state

    def update_(
        self,
        grads: Dict[str, torch.Tensor],
        state: Dict[str, Any],
        params: Dict[str, torch.Tensor],
    ) -> Dict[str, Any]:
        """Update ``params`` (and the momentum in ``state``) in place;
        returns the new state."""
        lr = _lr_at(self.learning_rate, state["count"])
        for key, g in grads.items():
            if self.momentum:
                m = state["trace"][key]
                m.mul_(self.momentum).add_(g)
                g = m
            params[key].sub_(lr * g)
        return {**state, "count": state["count"] + 1}
