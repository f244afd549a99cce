"""Blocked device-resident evaluation loop (torch).

Counterpart of ``besskge_tpu/eval_loop.py``. :func:`run_device_eval` keeps
the semantics of looping a ``RigidShardedBatchSampler`` through
:func:`besskge_tpu_torch.bess.build_bess_forward` (the same batches, masks
and metric sums) but copies a BLOCK of steps to the device at once and runs
it step by step with no host synchronisation inside it: the metric sums stay
on the device until the block ends. The ragged final block is padded with
steps whose ``triple_mask`` is all False, so every block has the same shape.
Over a mesh every rank runs the same blocks on its params and its column of
each step, and the metric sums leave the mesh as global sums, equal on every
rank (the JAX package's ``shard_map`` of the block with ``out_specs=P()``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from besskge_tpu_torch.bess import (
    BessKGE,
    _FORWARD_KEYS,
    _check_device,
    _device_step,
    _format_outputs,
    _step_device,
)
from besskge_tpu_torch.parallel.mesh import ShardMesh

__all__ = ["run_device_eval", "make_block_runner"]

Device = Optional[Union[str, torch.device]]


def make_block_runner(
    bess: BessKGE, mesh: Any = None, device: Device = None
) -> Callable[[Dict[str, torch.Tensor], Dict[str, torch.Tensor]], torch.Tensor]:
    """The evaluator of one device-resident block of steps.

    ``run_block(params, block) -> (n_metric,)`` fp32 metric sums on the
    device, where ``block`` stacks ``steps_per_block`` forward batches
    (``(bps, 1, ...)`` each) on a leading axis, as tensors on ``device``
    (default ``cuda``). The steps run one after another through
    :func:`besskge_tpu_torch.bess._device_step`, and nothing in the loop
    waits for the device. Exposed apart from :func:`run_device_eval` so
    that callers can stage blocks beforehand and time the device alone.

    Over a ``mesh`` each rank calls it with its params and its own
    ``(steps, bps, 1, ...)`` column of the block (as :func:`_stack_block`
    stages it for the rank), on the mesh's device. Each step's metric sums go through the step's one all-reduce
    (:func:`~besskge_tpu_torch.bess._format_outputs`), so the sums are
    global and equal on every rank. With NCCL the loop still holds no host
    synchronisation; on gloo every collective copies its CUDA tensors
    through the host and the calling thread waits for it, so the loop waits
    for the card at each AllGather, AllToAll and metric sum.
    """
    device = _step_device(bess, mesh, device)
    n_metric = len(bess.evaluation.metrics)

    def run_block(params: Dict[str, torch.Tensor], block: Dict[str, torch.Tensor]) -> torch.Tensor:
        _check_device(params, device)
        n_steps = next(iter(block.values())).shape[0]
        acc = torch.zeros((n_metric,), dtype=torch.float32, device=device)
        with torch.no_grad():
            for i in range(n_steps):
                outs = _device_step(bess, params, {k: v[i] for k, v in block.items()})
                m = _format_outputs(bess, outs)["metrics"]  # (bps, 1, n_metric)
                acc = acc + m.sum(dim=(0, 1))
        return acc

    return run_block


def _stack_block(steps: list, steps_per_block: int, device: torch.device,
                 mesh: Optional[ShardMesh] = None) -> Dict[str, torch.Tensor]:
    """One block of forward batches (dicts of numpy arrays) as tensors on
    ``device``, stacked on a leading axis and padded to ``steps_per_block``
    with copies of the last step whose ``triple_mask`` is all False; one
    copy per array, of the rank's ``(steps, bps, 1, ...)`` column over a
    ``mesh`` (the JAX package shards a block on axis 2)."""
    pad = steps_per_block - len(steps)
    steps = steps + [
        {k: (np.zeros_like(v) if k == "triple_mask" else v) for k, v in steps[-1].items()}
    ] * pad
    block = {k: np.stack([s[k] for s in steps]) for k in steps[0]}
    if mesh is not None:
        block = {k: v[:, :, mesh.rank : mesh.rank + 1] for k, v in block.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in block.items()}


def run_device_eval(
    bess: BessKGE,
    params: Dict[str, torch.Tensor],
    batch_sampler,
    mesh: Any = None,
    steps_per_block: int = 16,
    device: Device = None,
) -> Tuple[Dict[str, float], int]:
    """Evaluate one full pass of ``batch_sampler`` in device-resident blocks.

    :param bess: an inference BESS module with an ``evaluation`` whose
        reduction is ``"sum"`` (metrics leave the device as sums).
    :param params: model params on ``device`` (default ``cuda``).
    :param batch_sampler: a host batch sampler with a deterministic pass
        and a ``triple_mask`` output (``RigidShardedBatchSampler``).
    :param mesh: ``None`` (one device), or the rank's
        :class:`~besskge_tpu_torch.parallel.mesh.ShardMesh`: every rank
        calls it with its params (its block of the entity table), and
        copies only its column of each block to its device. Every rank
        returns the same global metrics.
    :param steps_per_block: steps per copy to the device (bounds the
        device-resident block to ``steps_per_block`` × per-step bytes).
    :return: ``(metrics dict averaged per query, n_queries)``.
    """
    ev = bess.evaluation
    if ev is None:
        raise ValueError("bess.evaluation is required for run_device_eval")
    if ev.reduction(torch.zeros((2,))).dim() != 0:
        raise ValueError('run_device_eval needs reduction="sum"')
    device = _step_device(bess, mesh, device)
    run_block = make_block_runner(bess, mesh, device)
    totals = np.zeros(len(ev.metrics), np.float64)
    n_queries = 0
    buf = []

    def flush():
        nonlocal totals
        if buf:
            block = _stack_block(buf, steps_per_block, device, mesh)
            totals += run_block(params, block).cpu().numpy().astype(np.float64)
            buf.clear()

    for batch in batch_sampler.get_dataloader(shuffle=False):
        fwd = {k: v for k, v in batch.items() if k in _FORWARD_KEYS}
        if "triple_mask" not in fwd:
            raise ValueError(
                "run_device_eval needs triple_mask (use RigidShardedBatchSampler)"
            )
        n_queries += int(fwd["triple_mask"].sum())
        buf.append(fwd)
        if len(buf) == steps_per_block:
            flush()
    flush()

    metrics = {
        name: float(t / max(n_queries, 1)) for name, t in zip(ev.metrics.keys(), totals)
    }
    return metrics, n_queries
