"""The CUDA kernels that a call launches, by name, from ``torch.profiler``.

Shared by ``chip_smoke.py``, which times the port's kernels with it, and
by the card-only tests, which count the launches of one call.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Tuple

__all__ = ["device_kernels"]


def device_kernels(fn: Callable[[], object], reps: int) -> Dict[str, Tuple[float, float]]:
    """The CUDA kernels that ``fn`` launches, by name: (mean device ms per
    call, launches per call) over ``reps`` calls, after one warm-up call in
    the profiler's own warm-up step. The tracer can drop a kernel that runs
    at an edge of the window (its device clock converted to the host's may
    fall outside), so the calls keep 5 ms clear of both. Raises when the
    profiler recorded no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(0.005)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.005)
        prof.step()
    kernels = {e.key: (e.self_device_time_total / reps / 1e3, e.count / reps)
               for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    if sum(ms for ms, _ in kernels.values()) <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return kernels
