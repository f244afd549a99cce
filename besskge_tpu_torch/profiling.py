"""What ``chip_smoke.py`` and the card-only tests share: the CUDA kernels
that a call launches, by name, from ``torch.profiler`` (the script times the
port's kernels with it, the tests count the launches of one call), and the
shapes at the edges of the distance kernel's tiles.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Tuple

__all__ = ["DISTANCE_EDGES", "device_kernels"]

#: Shapes (G, B, N, d, elements the base lies off a 16-byte boundary) at the
#: edges of the distance kernel's tiles (B1, and B5 for one group: 32 rows, or
#: 16 where the 32-row grid would leave SMs without a block, x 48 columns;
#: the depth staged in slices of 128): the sparse step's (8, 256, 288, 128);
#: a row and a column under and over whole tiles; depth one under and over a
#: slice, and two slices; 200-byte bf16 rows (d = 100); rows that are not runs
#: of 4 values; an unaligned base; one group on 16-row tiles; one ragged group
#: on 32-row tiles.
DISTANCE_EDGES = (
    (8, 256, 288, 128, 0), (8, 255, 287, 128, 0), (8, 257, 289, 128, 0),
    (8, 31, 47, 127, 0), (8, 33, 49, 129, 0), (8, 32, 48, 256, 0),
    (8, 256, 288, 100, 0), (2, 33, 49, 100, 0),
    (8, 256, 288, 130, 0), (3, 37, 211, 33, 0),
    (8, 256, 288, 128, 1), (1, 15, 47, 3, 1),
    (1, 256, 288, 128, 0), (1, 17, 49, 100, 0), (1, 97, 2017, 128, 1),
)


#: Profiler windows tried before an empty trace counts as no device time.
_WINDOWS = 3


def device_kernels(fn: Callable[[], object], reps: int) -> Dict[str, Tuple[float, float]]:
    """The CUDA kernels that ``fn`` launches, by name: (mean device ms per
    call, launches per call) over ``reps`` calls, after one warm-up call in
    the profiler's own warm-up step. The tracer can drop a kernel that runs
    at an edge of the window (its device clock converted to the host's may
    fall outside), so the calls keep 5 ms clear of both. On the H100 the
    tracer has also handed back a whole window empty (once in a few hundred
    windows): an empty window is run again, up to :data:`_WINDOWS` in all.
    Raises when none recorded device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for _attempt in range(_WINDOWS):
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
        if sum(ms for ms, _ in kernels.values()) > 0:
            return kernels
    raise RuntimeError(f"the profiler recorded no device time in {_WINDOWS} windows")
