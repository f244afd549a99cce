"""Host allocator tuning for the CPU side of the data pipeline.

Counterpart of ``besskge_tpu/_hostmem.py``, which imports no JAX; the port
keeps its own copy all the same, as it keeps its other numpy-only modules.

The batch-sampling hot loop churns large short-lived numpy buffers. glibc by
default mmap()s big allocations and returns them to the OS on free, so every
batch pays fresh page faults — catastrophic on demand-paged VMs (lazily
restored snapshots fetch pages from the host on first touch, ~1000x slower
than a warm page) and still measurable on bare metal.

``configure_host_allocator`` raises M_MMAP_THRESHOLD and disables trimming so
large buffers live on the (already warm) heap and are reused. Called once at
package import; a no-op on non-glibc platforms.
"""

from __future__ import annotations

import ctypes
import os

__all__ = ["configure_host_allocator", "prewarm_host_memory"]

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3

_done = False


def configure_host_allocator() -> None:
    """Keep large allocations on the reusable heap (glibc mallopt), and
    optionally pre-touch memory (``BESSKGE_PREWARM_GB``)."""
    global _done
    if _done:
        return
    _done = True
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.mallopt(_M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(_M_TRIM_THRESHOLD, 1 << 30)
    except (OSError, AttributeError):  # pragma: no cover - non-glibc platforms
        pass
    gb = float(os.environ.get("BESSKGE_PREWARM_GB", "0") or 0)
    if gb > 0:
        prewarm_host_memory(gb)


def prewarm_host_memory(gb: float) -> None:
    """Touch ``gb`` gigabytes of heap up front.

    On demand-paged VMs (lazily restored snapshots) first-touch page faults
    can stall a thread for tens of seconds per GB; if that thread is one rank
    of a collective, the others may give up waiting on it. Pre-touching moves
    the cost to startup. Enable via ``BESSKGE_PREWARM_GB=<n>`` or call
    directly.
    """
    import numpy as np

    chunk = 256 * 1024 * 1024
    n = max(1, int(gb * (1 << 30)) // chunk)
    keep = []
    for _ in range(n):
        buf = np.empty(chunk, np.uint8)
        buf[::4096] = 1
        keep.append(buf)
    del keep  # freed, but the (warm) pages stay in the malloc pool
