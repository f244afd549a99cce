"""The 1-D ``"shard"`` mesh over ``torch.distributed`` ranks, and where
params and batches lie on it.

Counterpart of ``besskge_tpu/parallel/mesh.py``. The JAX package runs one
process with an ``n``-device mesh under ``shard_map``; the port runs one
process per shard (SPMD by process, PyTorch's idiom). So a mesh here is one
rank's view of it, a :class:`ShardMesh`: the process group, this rank, the
number of shards and the rank's device.

On the mesh each rank holds

* its block of the entity table: rows ``[rank·H/n, (rank+1)·H/n)`` of the
  global ``(H, row)`` table, in the port's one-device layout (plain,
  interleaved or packed), so that the row optimizers, the packed stores and
  every kernel run on a rank unchanged;
* a full copy of every other param (replicated);
* its column ``[:, rank]`` of each ``(bps, n_shard, ...)`` batch array.

The default backend is NCCL on a card and gloo on the CPU; gloo also runs on
a card (several ranks sharing one card, as no NCCL communicator can), and
NCCL on the CPU raises.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from besskge_tpu_torch.utils import _tree_map, resolve_device

__all__ = [
    "ShardMesh",
    "make_shard_mesh",
    "param_partition_specs",
    "batch_partition_specs",
    "shard_params",
    "shard_batch",
    "replicate_tree",
]

AXIS = "shard"

#: The backends a mesh runs on, and the device types each takes.
_BACKEND_DEVICES = {"nccl": ("cuda",), "gloo": ("cpu", "cuda")}


class ShardMesh:
    """One rank's view of the 1-D ``"shard"`` mesh.

    :param group: the process group of the mesh's ranks.
    :param rank: this rank's shard index in the group.
    :param n_shard: the number of ranks (shards).
    :param device: this rank's device.
    :param backend: ``"nccl"`` or ``"gloo"``.

    :attr:`recording` is ``None``, or a list to which every collective of
    :mod:`besskge_tpu_torch.parallel.collectives` over this mesh appends
    ``(kind, payload bytes, payload elements)``
    (:mod:`~besskge_tpu_torch.parallel.census`).
    """

    def __init__(self, group: Any, rank: int, n_shard: int, device: torch.device,
                 backend: str) -> None:
        self.group = group
        self.rank = rank
        self.n_shard = n_shard
        self.device = device
        self.backend = backend
        self.recording: Optional[List[Tuple[str, int, int]]] = None

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture the mesh's collectives: NCCL's
        can, gloo's run on the host and cannot."""
        return self.backend == "nccl" and self.device.type == "cuda"

    def __repr__(self) -> str:
        return (f"ShardMesh(rank={self.rank}, n_shard={self.n_shard}, device={self.device},"
                f" backend={self.backend!r})")


def _default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _check_backend(backend: str, device: torch.device) -> None:
    if device.type not in _BACKEND_DEVICES.get(backend, ()):
        raise ValueError(
            f"a {backend!r} mesh cannot run on {device.type}: supported pairs are"
            f" {sorted((b, t) for b, ts in _BACKEND_DEVICES.items() for t in ts)}"
        )


def _rank_device(device: Optional[Union[str, torch.device]], rank: int) -> torch.device:
    """The rank's device: ``device`` (default ``cuda``); a card without an
    index is card ``rank`` modulo the cards this host has, so that ranks
    share cards when there are fewer cards than ranks."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def make_shard_mesh(
    n_shard: int,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
    backend: Optional[str] = None,
) -> ShardMesh:
    """The ``("shard",)`` mesh of the ``n_shard`` ranks of the initialised
    default process group (:func:`~besskge_tpu_torch.parallel.multihost.initialize`).

    :param devices: the device of each rank, indexed by rank; default
        ``cuda`` (card ``rank`` modulo the host's cards).
    :param backend: default NCCL on a card, gloo on the CPU. The default
        group is the mesh's group when its backend is this one; else a new
        group is made, a collective call of every rank.
    """
    if not dist.is_initialized():
        raise RuntimeError(
            "make_shard_mesh needs an initialised process group"
            " (besskge_tpu_torch.parallel.multihost.initialize)"
        )
    if dist.get_world_size() != n_shard:
        raise ValueError(
            f"Requested {n_shard} shards but the process group has {dist.get_world_size()} ranks"
        )
    rank = dist.get_rank()
    if devices is not None and len(devices) != n_shard:
        raise ValueError(f"Requested {n_shard} shards but got {len(devices)} devices")
    device = _rank_device(devices[rank] if devices is not None else None, rank)
    backend = backend or _default_backend(device)
    _check_backend(backend, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.get_backend() == backend:
        group = dist.group.WORLD
    else:
        group = dist.new_group(list(range(n_shard)), backend=backend)
    return ShardMesh(group, rank, n_shard, device, backend)


def param_partition_specs(params: Dict[str, Any]) -> Dict[str, Any]:
    """The entity table is split by rows over ``"shard"``; every other param
    (the relation table, ConvE's trunk) is replicated: ``None``."""
    return {
        k: (AXIS if k == "entity_embedding" else _tree_map(lambda _: None, v))
        for k, v in params.items()
    }


def batch_partition_specs(batch: Dict[str, Any]) -> Dict[str, Any]:
    """Every batch array is ``(bps, shard, ...)``, axis 1 over the ranks."""
    return {k: (None, AXIS) for k in batch}


def _tensor(x: Any) -> torch.Tensor:
    return x.detach() if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))


def _row_block(x: Any, mesh: ShardMesh) -> torch.Tensor:
    """The rank's block of rows of a global table-shaped array."""
    rows = x.shape[0]
    if rows % mesh.n_shard:
        raise ValueError(f"a table of {rows} rows does not split into {mesh.n_shard} blocks")
    block = rows // mesh.n_shard
    return _tensor(x[mesh.rank * block : (mesh.rank + 1) * block])


def shard_params(params: Dict[str, Any], mesh: ShardMesh) -> Dict[str, Any]:
    """This rank's params on its device, as copies (the steps update them in
    place): its block of the global entity table (numpy or tensors, any
    layout) and every other param whole."""
    out = {k: _tree_map(lambda v: _tensor(v).to(mesh.device, copy=True), v)
           for k, v in params.items() if k != "entity_embedding"}
    out["entity_embedding"] = _row_block(params["entity_embedding"], mesh).to(mesh.device,
                                                                              copy=True)
    return out


def shard_batch(batch: Dict[str, Any], mesh: ShardMesh) -> Dict[str, torch.Tensor]:
    """This rank's ``(bps, 1, ...)`` column of a global host batch, on its
    device."""
    return {k: _tensor(v[:, mesh.rank : mesh.rank + 1]).to(mesh.device) for k, v in batch.items()}


def replicate_tree(tree: Any, mesh: ShardMesh) -> Any:
    """A copy of every leaf of a tree on the rank's device (e.g. the
    :class:`~besskge_tpu_torch.device_sampler.DeviceBatchSampler` state)."""
    return _tree_map(lambda v: _tensor(v).to(mesh.device, copy=True), tree)
