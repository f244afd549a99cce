"""Profiling and throughput observability (torch).

Counterpart of ``besskge_tpu/monitor.py``, with its public names and
contracts, on ``torch.profiler`` and the card's own clock:

* :class:`StepTimer` — wall-clock step timing with warm-up skipping and
  triples/s accounting (synchronizes by reading a device scalar, or with
  ``torch.cuda.synchronize()``);
* :func:`trace` — context manager around ``torch.profiler.profile`` (CPU
  and CUDA activities) that writes a Chrome trace into a directory;
* :func:`trace_breakdown` / :func:`parse_trace_events` — device busy share,
  collective time and its overlap with compute, and data movement, from
  the trace's device events;
* :func:`top_ops` — the device's kernels by summed time;
* :func:`device_memory_stats` — per-card allocator statistics.

The device track of a Kineto trace is its ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events. Collectives are NCCL's kernels (``nccl`` in the
name) or names holding the reference's collective keys; data movement is
the copies and memsets, and the kernels named for a copy, gather, scatter
or index (the port's row kernels ``scatter_rows`` B3, ``scatter_rows_multi``
B8 and ``gather_rows`` B9 among them; ``fused_pair_sgdm`` B4 and
``dense_adamw`` B10 compute, and count as compute). Host events never count.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

__all__ = [
    "StepTimer",
    "trace",
    "trace_breakdown",
    "parse_trace_events",
    "top_ops",
    "device_busy_us",
    "device_memory_stats",
]

#: Kineto's categories of the events on a card's timeline.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: Name keys of a collective: NCCL's kernels, and the reference's keys.
COLLECTIVE_KEYS = ("nccl", "all-to-all", "all-gather", "all-reduce", "collective-permute",
                   "reduce-scatter")
#: Name keys of data movement: the reference's, and the card's copies,
#: memsets and indexing kernels.
MOVE_KEYS = ("copy", "gather", "scatter", "dynamic-slice", "dynamic-update-slice", "memcpy",
             "memset", "index")
#: Traces tried on a card before an empty device track raises.
TRACE_TRIES = 3


class StepTimer:
    """Accumulates per-step wall times and derives throughput.

    :param triples_per_step: positives scored per step (all shards).
    :param warmup: steps to exclude (capture, allocator warming).
    """

    def __init__(self, triples_per_step: int, warmup: int = 2) -> None:
        self.triples_per_step = triples_per_step
        self.warmup = warmup
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        """Mark the start of a step."""
        self._t0 = time.perf_counter()

    def stop(self, sync_value: Any = None) -> float:
        """Mark the end of a step; pass a device scalar to synchronize on
        (reading it waits for the work that produced it). Without one, the
        card is synchronized, when there is one in use."""
        if sync_value is not None:
            float(torch.as_tensor(sync_value).reshape(-1)[0])
        elif torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        self.times.append(dt)
        return dt

    @property
    def steady_times(self) -> List[float]:
        return self.times[self.warmup:]

    def summary(self) -> Dict[str, float]:
        """Mean/median step time and triples/s over the steady-state steps."""
        ts = self.steady_times or self.times
        if not ts:
            return {}
        mean = float(np.mean(ts))
        return {
            "steps": float(len(ts)),
            "mean_step_s": mean,
            "median_step_s": float(np.median(ts)),
            "p95_step_s": float(np.percentile(ts, 95)),
            "triples_per_s": self.triples_per_step / mean,
        }


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[Any]:
    """Profile the block with ``torch.profiler`` (CPU activities, and CUDA
    ones where there is a card) and write its Chrome trace into ``log_dir``
    (``<ns>.trace.json``; open it in Perfetto or ``chrome://tracing``).
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if on_card:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"{time.time_ns()}.trace.json"))


def trace_breakdown(run: Callable[[], Any], log_dir: str) -> Dict[str, Any]:
    """Profile ``run()`` and return :func:`parse_trace_events` of its trace.

    On a card an empty device track is no answer: the profiler has handed
    back a window with no device events (``profiling.device_kernels`` meets
    the same), so ``run()`` is traced again, up to :data:`TRACE_TRIES`
    times, and then this raises. Without a card the trace has no device
    track and the result is ``{}``, as the reference's is without one.
    """
    for attempt in range(TRACE_TRIES):
        where = os.path.join(log_dir, f"try{attempt}")
        with trace(where):
            run()
        path = sorted(Path(where).glob("*.trace.json"))[-1]
        with open(path) as f:
            out = parse_trace_events(json.load(f)["traceEvents"])
        if out or not torch.cuda.is_available():
            return out
    raise RuntimeError(f"the profiler recorded no device event in {TRACE_TRIES} traces of run()")


def _device_ops(events) -> List[Dict[str, Any]]:
    """The trace's device events: complete events of a device category with
    a duration."""
    return [
        e for e in events
        if e.get("ph") == "X"
        and str(e.get("cat", "")).lower() in DEVICE_CATEGORIES
        and e.get("dur", 0) > 0
    ]


def _merged(ops) -> List[List[float]]:
    """The union of the events' [ts, ts + dur] intervals, as sorted
    disjoint intervals."""
    merged: List[List[float]] = []
    for s, t in sorted((e["ts"], e["ts"] + e["dur"]) for e in ops):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def _total(merged: List[List[float]]) -> float:
    return sum(t - s for s, t in merged)


def _is_collective(e: Dict[str, Any]) -> bool:
    name = str(e.get("name", "")).lower()
    return any(k in name for k in COLLECTIVE_KEYS)


def _is_move(e: Dict[str, Any]) -> bool:
    name = str(e.get("name", "")).lower()
    return str(e.get("cat", "")).lower() != "kernel" or any(k in name for k in MOVE_KEYS)


def parse_trace_events(events) -> Dict[str, Any]:
    """The pure parsing half of :func:`trace_breakdown`: over the span of
    the device events, the busy share, the collectives' share of busy time,
    the share of collective time that overlaps other device work, and the
    data movement's share of busy time, by the reference's interval
    arithmetic. ``{}`` when there is no device event."""
    ops = _device_ops(events)
    if not ops:
        return {}

    def intervals(pred):
        return _merged(e for e in ops if pred(e))

    def overlap(a, b):
        out, i, j = 0.0, 0, 0
        while i < len(a) and j < len(b):
            s = max(a[i][0], b[j][0])
            t = min(a[i][1], b[j][1])
            if t > s:
                out += t - s
            if a[i][1] < b[j][1]:
                i += 1
            else:
                j += 1
        return out

    lo = min(e["ts"] for e in ops)
    hi = max(e["ts"] + e["dur"] for e in ops)
    span = hi - lo
    coll_iv = intervals(_is_collective)
    comp_iv = intervals(lambda e: not _is_collective(e))
    move = _total(intervals(_is_move))
    busy = _total(intervals(lambda e: True))
    coll = _total(coll_iv)
    return {
        "device_busy_pct": round(100 * busy / span, 1) if span else 0.0,
        "collective_pct_of_busy": round(100 * coll / busy, 1) if busy else 0.0,
        "collective_overlap_pct": (
            round(100 * overlap(coll_iv, comp_iv) / coll, 1) if coll else 0.0
        ),
        "data_movement_pct_of_busy": round(100 * move / busy, 1) if busy else 0.0,
    }


def device_busy_us(events) -> float:
    """The time (µs) in which the card ran at least one device event: the
    total of :func:`parse_trace_events`' merged intervals, so that kernels
    that overlap count once."""
    return _total(_merged(_device_ops(events)))


def top_ops(events, n: int = 25) -> List[Dict[str, Any]]:
    """Top device kernels, copies and memsets by summed duration, from
    Chrome-trace events: ``[{"name", "total_us", "count", "mean_us"}, ...]``,
    largest first, over the same device filter as
    :func:`parse_trace_events`."""
    acc: Dict[str, List[float]] = {}
    for e in _device_ops(events):
        a = acc.setdefault(str(e["name"]), [0.0, 0])
        a[0] += e["dur"]
        a[1] += 1
    rows = [
        {
            "name": k,
            "total_us": round(v[0], 1),
            "count": v[1],
            "mean_us": round(v[0] / v[1], 2),
        }
        for k, v in acc.items()
    ]
    rows.sort(key=lambda r: -r["total_us"])
    return rows[:n]


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per-card allocator statistics (bytes and counts) of
    ``torch.cuda.memory_stats``, integer values only, keyed by
    ``str(torch.device("cuda", i))``; ``{}`` without a card."""
    out: Dict[str, Dict[str, int]] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if stats:
            out[str(torch.device("cuda", i))] = {
                k: int(v) for k, v in stats.items() if isinstance(v, (int, np.integer))
            }
    return out
