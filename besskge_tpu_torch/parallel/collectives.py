"""The three collectives of the BESS scheme over a :class:`ShardMesh`.

The port's home for ``besskge_tpu/bess.py:164-180``, where the JAX package
calls ``jax.lax.all_to_all``, ``all_gather`` and ``psum`` inside
``shard_map``:

* :func:`all_to_all`: tiled, split and concatenated on axis 0 (rank ``i``'s
  block ``j`` becomes rank ``j``'s block ``i``), as ``jax.lax.all_to_all(...,
  split_axis=0, concat_axis=0, tiled=True)``. A
  ``torch.autograd.Function`` whose backward is the same all-to-all of the
  gradient: the transpose of a tiled axis-0 all-to-all is itself, so an
  entity row's gradient goes back to the rank that gathered it;
* :func:`all_gather`: ``tiled=False``, stacking a new axis 0 of the ranks'
  tensors. Differentiable: its backward is a reduce-scatter over the
  stacked axis, each rank taking the sum over ranks of the cotangent's
  slice at its own index (ScoreMoving gathers the queries' rows, whose
  gradient comes back so). That is the transpose that ``jax.lax.all_gather``
  has under ``shard_map(check_vma=False)``;
* :func:`pmean`: the mean over ranks of a tensor (ConvE's SyncBN moments),
  differentiable: its backward is the mean over ranks of the cotangent, as
  ``jax.lax.pmean``'s transpose under ``check_vma=False``;
* :func:`psum`: the sum over ranks of a tree of tensors, flattened into one
  buffer per dtype, so that a tree of one dtype costs one ``all_reduce``
  (no gradient: the steps sum only gradients and metrics with it).

Each goes through ``torch.distributed`` on the mesh's group, on the tensors'
own device: NCCL on a card, gloo on the CPU or on a card (gloo takes CUDA
tensors in all three on torch 2.11 on the H100, so nothing is staged through
the host). While :attr:`ShardMesh.recording` is a list, each call appends its
kind, payload bytes (the bytes of its result on this rank, as the JAX
package's census counts an HLO collective's result) and
elements for :mod:`~besskge_tpu_torch.parallel.census`; a backward records
its own collective (``"all-to-all"``, ``"reduce-scatter"`` or
``"all-reduce"``) when it runs. Top-k and the forwards run without a
gradient and record none.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.distributed as dist

from besskge_tpu_torch.parallel.mesh import ShardMesh

__all__ = ["all_to_all", "all_gather", "pmean", "psum"]


def _record(mesh: ShardMesh, kind: str, result: torch.Tensor) -> None:
    if mesh.recording is not None:
        mesh.recording.append((kind, result.numel() * result.element_size(), result.numel()))


def _all_to_all(x: torch.Tensor, mesh: ShardMesh) -> torch.Tensor:
    if x.shape[0] % mesh.n_shard:
        raise ValueError(f"all_to_all splits axis 0 ({x.shape[0]}) into {mesh.n_shard} blocks")
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.group)
    _record(mesh, "all-to-all", out)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(x: torch.Tensor, mesh: ShardMesh) -> torch.Tensor:
        return _all_to_all(x, mesh)

    @staticmethod
    def setup_context(ctx: Any, inputs: Tuple, output: torch.Tensor) -> None:
        ctx.mesh = inputs[1]

    @staticmethod
    def backward(ctx: Any, g: torch.Tensor) -> Tuple[torch.Tensor, None]:
        return _all_to_all(g, ctx.mesh), None


def all_to_all(x: torch.Tensor, mesh: ShardMesh) -> torch.Tensor:
    """Tiled all-to-all of ``x`` over axis 0, differentiable."""
    return _AllToAll.apply(x, mesh)


def _all_gather(x: torch.Tensor, mesh: ShardMesh) -> torch.Tensor:
    x = x.contiguous()
    out = x.new_empty(mesh.n_shard * x.numel())
    dist.all_gather_into_tensor(out, x.reshape(-1), group=mesh.group)
    _record(mesh, "all-gather", out)
    return out.view(mesh.n_shard, *x.shape)


def _reduce_scatter(g: torch.Tensor, mesh: ShardMesh) -> torch.Tensor:
    """``(n_shard, *shape)`` -> ``shape``: the sum over ranks of slice
    ``rank`` of every rank's ``g``. Computed as an all-to-all of the slices
    and their sum in rank order (the same bits on every backend):
    ``reduce_scatter_tensor`` on gloo copies into its output with
    ``copy_``, which ``torch.func``'s transforms refuse inside a backward."""
    g = g.contiguous()
    parts = torch.empty_like(g)
    dist.all_to_all_single(parts, g, group=mesh.group)
    out = parts.sum(0)
    _record(mesh, "reduce-scatter", out)
    return out


def _all_reduce(x: torch.Tensor, mesh: ShardMesh) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    _record(mesh, "all-reduce", out)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(x: torch.Tensor, mesh: ShardMesh) -> torch.Tensor:
        return _all_gather(x, mesh)

    @staticmethod
    def setup_context(ctx: Any, inputs: Tuple, output: torch.Tensor) -> None:
        ctx.mesh = inputs[1]

    @staticmethod
    def backward(ctx: Any, g: torch.Tensor) -> Tuple[torch.Tensor, None]:
        return _reduce_scatter(g, ctx.mesh), None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(x: torch.Tensor, mesh: ShardMesh) -> torch.Tensor:
        return _all_reduce(x, mesh) / mesh.n_shard

    @staticmethod
    def setup_context(ctx: Any, inputs: Tuple, output: torch.Tensor) -> None:
        ctx.mesh = inputs[1]

    @staticmethod
    def backward(ctx: Any, g: torch.Tensor) -> Tuple[torch.Tensor, None]:
        return _all_reduce(g, ctx.mesh) / ctx.mesh.n_shard, None


def all_gather(x: torch.Tensor, mesh: ShardMesh) -> torch.Tensor:
    """``(n_shard, *x.shape)``: every rank's ``x``, in rank order;
    differentiable (a reduce-scatter of the cotangent)."""
    return _AllGather.apply(x, mesh)


def pmean(x: torch.Tensor, mesh: ShardMesh) -> torch.Tensor:
    """The mean over ranks of ``x``, on every rank; differentiable (the mean
    over ranks of the cotangent)."""
    return _PMean.apply(x, mesh)


def _leaves(tree: Any, path: Tuple = ()) -> List[Tuple[Tuple, torch.Tensor]]:
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items() for leaf in _leaves(v, path + (k,))]
    return [(path, tree)]


def _rebuild(tree: Any, new: Dict[Tuple, torch.Tensor], path: Tuple = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(v, new, path + (k,)) for k, v in tree.items()}
    return new[path]


def psum(tree: Any, mesh: ShardMesh) -> Any:
    """The sum over the mesh of a tensor or a nested dict of tensors: new
    tensors, each leaf's own shape and dtype. The leaves of one dtype go
    through one ``all_reduce`` of their concatenation."""
    leaves = _leaves(tree)
    new: Dict[Tuple, torch.Tensor] = {}
    for dtype in dict.fromkeys(t.dtype for _, t in leaves):
        group = [(p, t) for p, t in leaves if t.dtype == dtype]
        flat = torch.cat([t.detach().reshape(-1) for _, t in group])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        _record(mesh, "all-reduce", flat)
        for (p, t), part in zip(group, flat.split([t.numel() for _, t in group])):
            new[p] = part.view(t.shape)
    return _rebuild(tree, new)
