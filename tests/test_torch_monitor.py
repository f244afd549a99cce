"""The port's ``monitor`` and ``_hostmem`` against the JAX package's.

Each case of ``tests/test_monitor.py`` is written once as a list of neutral
events, ``(kind, label, ts, dur)``, and rendered twice: as the TPU-style
Chrome trace that ``besskge_tpu.monitor`` reads (a ``/device:TPU:0`` process,
ops named ``fusion.*``, ``all-to-all.*``, ``copy.*``, a ``jit_*`` meta-span)
and as the Kineto trace that ``torch.profiler`` writes on a card (``kernel``,
``gpu_memcpy`` and ``gpu_memset`` events; NCCL kernels; the port's row
kernels; host ``cpu_op`` events; a ``gpu_user_annotation`` span on the
device track). ``parse_trace_events`` and ``top_ops`` must give equal
results on the two renderings of the same intervals.
"""

import pytest
import torch

from besskge_tpu import monitor as jax_monitor
from besskge_tpu_torch import _hostmem
from besskge_tpu_torch import monitor as port_monitor

# What each label is on a card: compute kernels (B2, B4, B10 among them),
# NCCL collectives, and data movement (copies, memsets, the port's row
# kernels B3/B8/B9, PyTorch's indexing kernels).
KINETO = {
    "fusion.1": ("kernel", "void (anonymous namespace)::l1_grads_kernel<float, 4, true>(...)"),
    "fusion.2": ("kernel", "void (anonymous namespace)::fused_pair_sgdm_kernel(...)"),
    "fusion.3": ("kernel", "void (anonymous namespace)::dense_adamw_kernel<float, false>(...)"),
    "sort.5": ("kernel", "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<...>(...)"),
    "all-to-all.3": ("kernel", "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)"),
    "all-reduce.4": ("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL(...)"),
    "copy.7": ("gpu_memcpy", "Memcpy DtoD (Device -> Device)"),
    "copy.8": ("gpu_memset", "Memset (Device)"),
    "scatter.9": ("kernel", "void (anonymous namespace)::scatter_rows_kernel<uint4>(...)"),
    "gather.10": ("kernel", "void (anonymous namespace)::gather_rows_kernel<uint4>(...)"),
    "copy.11": ("kernel", "void at::native::index_elementwise_kernel<128, 4, ...>(...)"),
}


def _tpu(events):
    """The TPU-style rendering (``tests/test_monitor.py``'s)."""
    out = [{"ph": "M", "pid": 1, "name": "process_name", "args": {"name": "/device:TPU:0 ops"}},
           {"ph": "M", "pid": 2, "name": "process_name", "args": {"name": "host python"}}]
    for kind, label, ts, dur in events:
        pid = 2 if kind == "host" else 1
        name = {"host": "np.sum", "meta": "jit_train_step"}.get(kind, label)
        out.append({"ph": "X", "pid": pid, "tid": 0, "name": name, "ts": ts, "dur": dur})
    return out


def _kineto(events):
    """The Kineto rendering: device events on the card's process (pid 0,
    a stream's tid), host events on the host's."""
    out = [{"ph": "M", "pid": 0, "name": "process_name", "args": {"name": "python3"}}]
    for kind, label, ts, dur in events:
        if kind == "host":
            out.append({"ph": "X", "cat": "cpu_op", "pid": 4242, "tid": 4242,
                        "name": "aten::sum", "ts": ts, "dur": dur})
        elif kind == "meta":
            out.append({"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 7,
                        "name": "ProfilerStep#1", "ts": ts, "dur": dur})
        else:
            cat, name = KINETO[label]
            out.append({"ph": "X", "cat": cat, "pid": 0, "tid": 7, "name": name, "ts": ts,
                        "dur": dur})
    return out


CASES = {
    # tests/test_monitor.py's first case: fusions 0-40 and 60-90, an
    # all-to-all 30-70 (20 us over compute), a copy 90-95; a host event and
    # a meta-span over everything, both dropped.
    "buckets_and_overlap": [
        ("op", "fusion.1", 0, 40), ("op", "all-to-all.3", 30, 40), ("op", "fusion.2", 60, 30),
        ("op", "copy.7", 90, 5), ("host", "", 0, 1000), ("meta", "", 0, 100),
    ],
    "no_collectives": [("op", "fusion.1", 0, 50), ("op", "fusion.2", 70, 10)],
    # The port's own kernels: row kernels and memsets move data, B4 and B10
    # compute; an all-reduce overlaps a scatter.
    "row_kernels_and_memsets": [
        ("op", "fusion.2", 0, 10), ("op", "scatter.9", 10, 4), ("op", "gather.10", 20, 3),
        ("op", "fusion.3", 25, 20), ("op", "copy.8", 46, 1), ("op", "copy.11", 47, 2),
        ("op", "all-reduce.4", 12, 6), ("op", "sort.5", 60, 7), ("host", "", 0, 70),
    ],
    # tests/test_monitor.py's top_ops case: one op twice, aggregated.
    "top_ops": [
        ("op", "fusion.1", 0, 40), ("op", "fusion.1", 100, 20), ("op", "sort.5", 50, 45),
        ("op", "copy.7", 95, 5), ("host", "", 0, 1000), ("meta", "", 0, 120),
    ],
    "empty": [],
    "meta_only": [("meta", "", 0, 100), ("host", "", 0, 10)],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_parse_trace_events_matches_jax(case):
    events = CASES[case]
    want = jax_monitor.parse_trace_events(_tpu(events))
    got = port_monitor.parse_trace_events(_kineto(events))
    assert got == want
    assert (got == {}) == (case in ("empty", "meta_only"))


def test_parse_trace_events_known_values():
    """The reference test's numbers, on the Kineto rendering."""
    out = port_monitor.parse_trace_events(_kineto(CASES["buckets_and_overlap"]))
    assert out["device_busy_pct"] == 100.0
    assert abs(out["collective_pct_of_busy"] - 100 * 40 / 95) < 0.11
    assert abs(out["collective_overlap_pct"] - 50.0) < 0.11
    assert abs(out["data_movement_pct_of_busy"] - 100 * 5 / 95) < 0.11
    assert port_monitor.parse_trace_events([]) == {}
    # Overlapping events count once: their union is 95 us, their sum 115.
    assert port_monitor.device_busy_us(_kineto(CASES["buckets_and_overlap"])) == 95


@pytest.mark.parametrize("n", [2, 25])
@pytest.mark.parametrize("case", ["top_ops", "row_kernels_and_memsets"])
def test_top_ops_matches_jax(case, n):
    events = CASES[case]
    want = jax_monitor.top_ops(_tpu(events), n=n)
    got = port_monitor.top_ops(_kineto(events), n=n)
    by_name = {KINETO[label][1]: label for label in KINETO}
    assert [{**r, "name": by_name[r["name"]]} for r in got] == want
    assert port_monitor.top_ops([]) == jax_monitor.top_ops([]) == []


@pytest.mark.parametrize("times, warmup", [
    ([0.5, 0.4, 0.1, 0.12, 0.11, 0.3], 2),  # warm-up steps dropped
    ([0.2, 0.3], 5),  # fewer steps than the warm-up: all of them
    ([], 2),  # nothing timed: {}
])
def test_step_timer_summary_matches_jax(times, warmup):
    want_t = jax_monitor.StepTimer(4096, warmup=warmup)
    got_t = port_monitor.StepTimer(4096, warmup=warmup)
    want_t.times, got_t.times = list(times), list(times)
    assert got_t.summary() == want_t.summary()
    assert got_t.steady_times == want_t.steady_times


def test_step_timer_stop_reads_a_scalar():
    timer = port_monitor.StepTimer(10, warmup=0)
    timer.start()
    dt = timer.stop(torch.ones(()) * 3)
    timer.start()
    timer.stop()
    assert len(timer.times) == 2 and dt >= 0
    assert timer.summary()["steps"] == 2.0


def test_trace_breakdown_on_the_cpu(tmp_path):
    """Without a card the trace has no device track: ``{}``, as the
    reference's without one; the trace file is written all the same."""
    out = port_monitor.trace_breakdown(lambda: torch.ones(64).sum(), str(tmp_path))
    assert out == {}
    assert list(tmp_path.rglob("*.trace.json"))
    assert port_monitor.device_memory_stats() == {}


def test_hostmem_is_idempotent_and_prewarms():
    assert _hostmem._done  # besskge_tpu_torch's import configured it
    _hostmem.configure_host_allocator()
    _hostmem.configure_host_allocator()
    assert _hostmem._done
    _hostmem.prewarm_host_memory(0.01)
