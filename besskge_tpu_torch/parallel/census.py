"""The collectives of one call over a mesh, counted.

Counterpart of ``besskge_tpu/parallel/hlo_check.py``, which reads the
collectives of the compiled HLO of a ``shard_map`` program. PyTorch compiles
no program to read, so these functions run ``fn(*args)`` once, eagerly or as
the first call of a step that captures a CUDA graph, with the mesh's
:attr:`~besskge_tpu_torch.parallel.mesh.ShardMesh.recording` on: every
collective of :mod:`~besskge_tpu_torch.parallel.collectives` notes its kind
and payload. A graph's replay calls no wrapper, so, as with the kernels'
launch counts, a replay records nothing; a capturing first call records its
eager warm-up and its capture.

The contract they pin is the JAX package's: per training step one
all-to-all of the tail and negative rows per micro-batch and its transpose
in the backward, no all-gather, and one all-reduce of the replicated params'
gradients and the loss, never one the size of the entity table's block (on
IPUs the reference deleted such an all-reduce with a PopART pattern).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np

from besskge_tpu_torch.parallel.mesh import ShardMesh

__all__ = [
    "collective_summary",
    "collective_census",
    "assert_no_entity_allreduce",
]

_COLLECTIVES = ("all-reduce", "all-gather", "all-to-all", "reduce-scatter",
                "collective-permute")


def _records(fn: Callable, args: Sequence[Any], mesh: ShardMesh) -> List[Tuple[str, int, int]]:
    if mesh.recording is not None:
        raise RuntimeError("a census is already recording on this mesh")
    mesh.recording = []
    try:
        fn(*args)
    finally:
        records, mesh.recording = mesh.recording, None
    return records


def _census(records: List[Tuple[str, int, int]]) -> Dict[str, Any]:
    census: Dict[str, Any] = {name: [] for name in _COLLECTIVES}
    for kind, n_bytes, _ in records:
        census[kind].append(n_bytes)
    census["order"] = [kind for kind, _, _ in records]
    return census


def collective_census(fn: Callable, *args: Any, mesh: ShardMesh) -> Dict[str, Any]:
    """The payload bytes of each collective of ``fn(*args)`` on this rank,
    by kind, in call order: ``{kind: [bytes, ...]}`` for each kind of
    ``hlo_check``, plus ``"order"``, the kinds in call order."""
    return _census(_records(fn, args, mesh))


def collective_summary(fn: Callable, *args: Any, mesh: ShardMesh) -> Dict[str, int]:
    """The number of collectives of each kind that ``fn(*args)`` calls."""
    records = _records(fn, args, mesh)
    return {name: sum(kind == name for kind, _, _ in records) for name in _COLLECTIVES}


def assert_no_entity_allreduce(
    fn: Callable,
    entity_table_shape: Sequence[int],
    *args: Any,
    mesh: ShardMesh,
) -> Dict[str, Any]:
    """Raise if ``fn(*args)`` all-reduces a payload of as many elements as a
    block of the entity table, or more.

    :param entity_table_shape: the global table shape, ``(n_shard ·
        max_entity_per_shard, row)`` or ``(n_shard, max_entity_per_shard,
        row)``.
    :return: the census of the call (:func:`collective_census`).
    """
    block = int(np.prod(entity_table_shape)) // mesh.n_shard
    records = _records(fn, args, mesh)
    offending = [n for kind, _, n in records if kind == "all-reduce" and n >= block]
    if offending:
        raise AssertionError(
            "Found an all-reduce of at least the entity table block's"
            f" {block} elements ({offending[:5]}): the table gradient/update must stay"
            " shard-local"
        )
    return _census(records)
