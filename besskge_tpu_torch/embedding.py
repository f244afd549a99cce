"""Embedding-table initialization (host-side numpy, and on the device).

The numpy initializers are copied from ``besskge_tpu/embedding.py`` so that
the port never imports the JAX package: for the same seed they give the same
bits. :func:`device_table_init` draws a table directly on the device with a
``torch.Generator``; its values differ from the numpy stream.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Union

import numpy as np
import torch
from numpy.typing import NDArray

from besskge_tpu_torch.sharding import Sharding
from besskge_tpu_torch.utils import resolve_device

__all__ = [
    "init_uniform",
    "init_zeros",
    "init_uniform_norm",
    "init_xavier_norm",
    "init_uniform_rotation",
    "init_KGE_uniform",
    "init_KGE_normal",
    "initialize_entity_embedding",
    "initialize_relation_embedding",
    "refactor_embedding_sharding",
    "device_table_init",
]

#: An initializer fills a shape using the provided RNG.
Initializer = Callable[[Sequence[int], np.random.Generator], NDArray[np.float32]]


def init_uniform(
    shape: Sequence[int], rng: np.random.Generator
) -> NDArray[np.float32]:
    """Plain uniform [0, 1) (the reference's ``torch.nn.init.uniform_``
    default, used by BoxE)."""
    return rng.random(size=tuple(shape), dtype=np.float32)


def init_zeros(
    shape: Sequence[int], rng: np.random.Generator
) -> NDArray[np.float32]:
    """All-zero initializer (ConvE tail biases)."""
    return np.zeros(shape, dtype=np.float32)


def init_uniform_norm(
    shape: Sequence[int], rng: np.random.Generator
) -> NDArray[np.float32]:
    """Uniform [0,1) rows normalized to unit L2 norm
    (reference ``besskge/embedding.py:15-28``)."""
    x = rng.random(size=tuple(shape), dtype=np.float32)
    norm = np.linalg.norm(x, axis=-1, keepdims=True).astype(np.float32)
    return x / np.maximum(norm, np.float32(1e-12))


def init_xavier_norm(
    shape: Sequence[int], rng: np.random.Generator, gain: float = 1.0
) -> NDArray[np.float32]:
    """Xavier/Glorot normal over the last dimension
    (reference ``besskge/embedding.py:31-47``)."""
    std = gain * float(np.sqrt(2.0 / (shape[-1] + 1)))
    return rng.standard_normal(tuple(shape), dtype=np.float32) * np.float32(std)


def init_KGE_uniform(
    shape: Sequence[int], rng: np.random.Generator, b: float = 1.0,
    divide_by_embedding_size: bool = True,
) -> NDArray[np.float32]:
    """Uniform in ±b (optionally ±b/row_size)
    (reference ``besskge/embedding.py:65-84``)."""
    if divide_by_embedding_size:
        b = b / shape[-1]
    x = rng.random(size=tuple(shape), dtype=np.float32)
    return (2.0 * x - 1.0) * np.float32(b)


def init_uniform_rotation(
    shape: Sequence[int], rng: np.random.Generator
) -> NDArray[np.float32]:
    """Uniform rotation phases in [0, 2π)
    (reference ``besskge/embedding.py:50-62``)."""
    return rng.random(size=tuple(shape), dtype=np.float32) * np.float32(2.0 * np.pi)


def init_KGE_normal(
    shape: Sequence[int], rng: np.random.Generator, std: float = 1.0,
    divide_by_embedding_size: bool = True,
) -> NDArray[np.float32]:
    """Normal with σ=std (optionally std/row_size)
    (reference ``besskge/embedding.py:87-104``)."""
    if divide_by_embedding_size:
        std = std / shape[-1]
    return rng.standard_normal(tuple(shape), dtype=np.float32) * np.float32(std)


def _build_sliced(
    shape: Sequence[int],
    initializers: List[Initializer],
    row_sizes: List[int],
    rng: np.random.Generator,
) -> NDArray[np.float32]:
    if len(initializers) != len(row_sizes):
        raise ValueError(
            f"Got {len(initializers)} initializers for {len(row_sizes)} row slices"
        )
    if len(initializers) == 1:
        return initializers[0](tuple(shape), rng)
    slices = [
        fn(tuple(shape[:-1]) + (size,), rng)
        for fn, size in zip(initializers, row_sizes)
    ]
    return np.concatenate(slices, axis=-1)


def initialize_entity_embedding(
    sharding: Sharding,
    initializer: Union[NDArray[np.float32], List[Initializer]],
    row_size: List[int],
    seed: int = 0,
) -> NDArray[np.float32]:
    """Build the sharded entity table ``(n_shard, max_entity_per_shard, Σrow)``.

    ``initializer`` is a list of initializer functions, one per row slice in
    ``row_size``, or a pre-trained table: 2-D ``(n_entity, row)`` (rows are
    permuted into shards through ``shard_and_idx_to_entity``, padding rows
    are zero) or 3-D (already sharded, shape-checked).
    """
    total = int(sum(row_size))
    shape = (sharding.n_shard, sharding.max_entity_per_shard, total)
    if isinstance(initializer, np.ndarray):
        if initializer.ndim == 3:
            if initializer.shape != shape:
                raise ValueError(
                    f"Pre-sharded table has shape {initializer.shape},"
                    f" expected {shape}"
                )
            return np.ascontiguousarray(initializer, dtype=np.float32)
        if initializer.ndim == 2:
            if initializer.shape[0] != sharding.n_entity:
                raise ValueError(
                    f"Table has {initializer.shape[0]} rows for"
                    f" {sharding.n_entity} entities"
                )
            if initializer.shape[1] != total:
                raise ValueError(
                    f"Table row size {initializer.shape[1]} != sum(row_size)={total}"
                )
            ids = sharding.shard_and_idx_to_entity  # (S, rows)
            safe = np.minimum(ids, sharding.n_entity - 1)
            table = initializer[safe].astype(np.float32)
            table[ids >= sharding.n_entity] = 0.0
            return table
        raise ValueError("Entity table must be 2-D or 3-D")

    rng = np.random.default_rng(seed)
    return _build_sliced(shape, initializer, row_size, rng)


def initialize_relation_embedding(
    n_relation_type: int,
    inverse_relations: bool,
    initializer: Union[NDArray[np.float32], List[Initializer]],
    row_size: List[int],
    seed: int = 0,
) -> NDArray[np.float32]:
    """Build the replicated relation table ``(n_relation, Σrow)``; with
    ``inverse_relations`` the row count doubles (relation ``r + n`` is the
    inverse of ``r``)."""
    n_rows = n_relation_type * 2 if inverse_relations else n_relation_type
    total = int(sum(row_size))
    if isinstance(initializer, np.ndarray):
        if initializer.ndim != 2:
            raise ValueError("Relation table must be 2-D")
        if initializer.shape != (n_rows, total):
            raise ValueError(
                f"Relation table has shape {initializer.shape},"
                f" expected {(n_rows, total)}"
            )
        return np.ascontiguousarray(initializer, dtype=np.float32)
    rng = np.random.default_rng(seed)
    return _build_sliced((n_rows, total), initializer, row_size, rng)


def refactor_embedding_sharding(
    entity_embedding: NDArray[np.float32],
    old_sharding: Sharding,
    new_sharding: Sharding,
) -> NDArray[np.float32]:
    """Move a trained sharded ``(n_shard, max_entity_per_shard, row)`` table
    to another sharding: unshard through ``(entity_to_shard, entity_to_idx)``,
    then shard under ``new_sharding``, padding rows zero (reference
    ``besskge/embedding.py:262-290``)."""
    flat = entity_embedding[old_sharding.entity_to_shard, old_sharding.entity_to_idx]
    return initialize_entity_embedding(new_sharding, flat, [entity_embedding.shape[-1]])


def device_table_init(
    initializer: Union[NDArray[np.float32], List[Initializer]],
    row_sizes: List[int],
    shape: Sequence[int],
    seed: int,
    dtype: torch.dtype,
    sharding: Any = None,
    device: Optional[Union[str, torch.device]] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Draw a table of ``shape`` directly on ``device`` (default ``cuda``): no
    host-side copy of a multi-GB table and no host-to-device transfer.

    Each slice of ``row_sizes`` is drawn with the torch counterpart of its
    numpy initializer from ``generator`` (a generator on ``device``; default
    one seeded with ``seed``). Array initializers must already have the target
    shape.

    ``sharding``: ``None`` for the whole table, or a
    :class:`~besskge_tpu_torch.parallel.mesh.ShardMesh`, for the rank's block
    of ``shape[0] / n_shard`` rows on the mesh's device. A mesh's table is
    drawn block by block (:func:`_device_blocks`): every rank draws the
    whole stream through one block's memory and keeps its own block, so that
    the blocks are those of the one-process draw of the global table, and
    the generator ends where that draw ends it.
    """
    if sharding is not None:
        device = sharding.device
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(seed)
    if isinstance(initializer, np.ndarray):
        if tuple(initializer.shape) != tuple(shape):
            raise ValueError(
                f"Array initializer shape {initializer.shape} != {tuple(shape)}"
            )
        if sharding is not None:
            block = shape[0] // sharding.n_shard
            initializer = initializer[sharding.rank * block : (sharding.rank + 1) * block]
        return torch.from_numpy(np.ascontiguousarray(initializer)).to(device, dtype)
    if len(initializer) != len(row_sizes):
        raise ValueError(
            f"Got {len(initializer)} initializers for {len(row_sizes)} slices"
        )
    if sharding is not None:
        return _device_blocks(initializer, row_sizes, shape, sharding.n_shard, sharding.rank,
                              dtype, device, generator)[0]
    return _draw(initializer, row_sizes, shape, dtype, device, generator)


def _device_blocks(
    initializer: List[Initializer], row_sizes: List[int], shape: Sequence[int], n_block: int,
    keep: Optional[int], dtype: torch.dtype, device: torch.device, generator: torch.Generator,
) -> List[torch.Tensor]:
    """The ``n_block`` row blocks of a table of ``shape`` drawn one after
    another from ``generator``: the block ``keep``, or every block when
    ``keep`` is ``None``. One block is the whole table's draw."""
    if shape[0] % n_block:
        raise ValueError(f"{shape[0]} rows do not split into {n_block} blocks")
    block_shape = (shape[0] // n_block, *shape[1:])
    out = []
    for b in range(n_block):
        drawn = _draw(initializer, row_sizes, block_shape, dtype, device, generator)
        if keep is None or b == keep:
            out.append(drawn)
    return out


def _draw(initializer: List[Initializer], row_sizes: List[int], shape: Sequence[int],
          dtype: torch.dtype, device: torch.device, generator: torch.Generator) -> torch.Tensor:
    out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    start = 0
    for fn, size in zip(initializer, row_sizes):
        part = out[..., start : start + size]
        # The JAX package's device formulas, each slice scaled by its own
        # width ``size``.
        if fn is init_KGE_uniform:
            part.uniform_(-1.0 / size, 1.0 / size, generator=generator)
        elif fn is init_uniform_rotation:
            part.uniform_(0.0, 2.0 * np.pi, generator=generator)
        elif fn is init_uniform:
            part.uniform_(0.0, 1.0, generator=generator)
        elif fn is init_zeros:
            part.zero_()
        elif fn is init_uniform_norm:
            part.uniform_(0.0, 1.0, generator=generator)
            part.div_(torch.linalg.vector_norm(part, dim=-1, keepdim=True).clamp_min(1e-12))
        elif fn is init_xavier_norm:
            part.normal_(0.0, float(np.sqrt(2.0 / (size + 1))), generator=generator)
        elif fn is init_KGE_normal:
            part.normal_(0.0, 1.0 / size, generator=generator)
        else:
            raise ValueError(f"No device counterpart for initializer {fn}")
        start += size
    return out.to(dtype)
