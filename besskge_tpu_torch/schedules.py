"""Learning-rate schedules: the ``optax.schedules`` that the example scripts
use, as functions of the step count.

A schedule is called with the optimizer's pre-increment step count, a 0-dim
int32 tensor on the step's device (or an int), and returns the learning
rate there: plain tensor arithmetic, no host synchronisation, so a schedule
runs inside a captured CUDA graph too. Every optimizer of
:mod:`besskge_tpu_torch.optim` takes one as its ``learning_rate``. The
formulas are ``optax``'s: ``linear_schedule``, ``cosine_decay_schedule``,
``warmup_cosine_decay_schedule``, ``warmup_constant_schedule`` and
``join_schedules``.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Union

import torch

__all__ = [
    "cosine_decay_schedule",
    "join_schedules",
    "linear_schedule",
    "warmup_constant_schedule",
    "warmup_cosine_decay_schedule",
]

Count = Union[torch.Tensor, int]
Schedule = Callable[[Count], Union[torch.Tensor, float]]


def _float(count: Count) -> torch.Tensor:
    return torch.as_tensor(count).to(torch.float32)


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """From ``init_value`` to ``end_value`` over ``transition_steps``, then
    constant (``transition_steps <= 0``: constant ``init_value``)."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: Count) -> torch.Tensor:
        frac = 1 - _float(count).clamp(0, transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0,
                          exponent: float = 1.0) -> Schedule:
    """``init_value · ((1 − alpha)·(½(1 + cos(π·t/T)))^exponent + alpha)``
    with ``t = min(count, decay_steps)``."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule requires positive decay_steps, got {decay_steps}")

    def schedule(count: Count) -> torch.Tensor:
        t = _float(count).clamp(max=float(decay_steps))
        cosine = 0.5 * (1 + torch.cos(math.pi * t / decay_steps))
        return init_value * ((1 - alpha) * cosine**exponent + alpha)

    return schedule


def join_schedules(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    """``schedules[i]`` from ``boundaries[i-1]`` on, called with the count
    less the boundary."""

    def schedule(count: Count) -> torch.Tensor:
        count = torch.as_tensor(count)
        ref = count.to(torch.float32)

        def value(v: Union[torch.Tensor, float]) -> torch.Tensor:
            # A constant is filled on the count's device (no host copy).
            return v.to(torch.float32) if torch.is_tensor(v) else torch.full_like(ref, v)

        out = value(schedules[0](count))
        for boundary, fn in zip(boundaries, schedules[1:]):
            out = torch.where(count < boundary, out, value(fn(count - boundary)))
        return out

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """Linear warm-up from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine decay to ``end_value`` at
    ``decay_steps`` (counted from 0)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules(
        [linear_schedule(init_value, peak_value, warmup_steps),
         cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha, exponent)],
        [warmup_steps],
    )


def warmup_constant_schedule(init_value: float, peak_value: float, warmup_steps: int) -> Schedule:
    """Linear warm-up from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then constant."""
    return join_schedules(
        [linear_schedule(init_value, peak_value, warmup_steps), lambda count: peak_value],
        [warmup_steps],
    )
