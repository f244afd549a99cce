"""Sharded negative samplers (host-side numpy).

Copied from ``besskge_tpu/negative_sampler.py`` so that the port never
imports the JAX package. Ported: the base class, the uniform
:class:`RandomShardedNegativeSampler` of the training path (native pcg32 and
numpy streams, bit-equal to the JAX package's for the same seed), the
type-matched :class:`TypeBasedShardedNegativeSampler` on top of it, and the
placeholder of top-k serving. The triple-based sampler is not ported yet
(ROADMAP A14).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, Tuple, Union

import numpy as np
from numpy.typing import NDArray

from besskge_tpu_torch import native
from besskge_tpu_torch.sharding import Sharding

__all__ = [
    "ShardedNegativeSampler",
    "RandomShardedNegativeSampler",
    "TypeBasedShardedNegativeSampler",
    "PlaceholderNegativeSampler",
]

BatchArrays = Dict[str, Union[NDArray[np.int32], NDArray[np.bool_]]]


class ShardedNegativeSampler(ABC):
    """Base class; produces negatives in the layout
    ``(bps, shard_source, shard_dest, B, n_negative)`` of local ids."""

    #: Negatives are sampled per shard-pair partition rather than per triple.
    flat_negative_format: bool
    #: Score negatives on the shard that samples them (skip their AllToAll).
    local_sampling: bool
    #: Which side to corrupt: "h", "t", or "ht".
    corruption_scheme: str
    #: Host RNG.
    rng: np.random.Generator

    @abstractmethod
    def __call__(self, sample_idx: NDArray[np.int64]) -> BatchArrays:
        """Sample negatives for a step.

        :param sample_idx: shape (bps, n_shard, [n_shard,] triples_per_partition)
            Indices (into the partitioned triple array) of the positive
            triples of each batch in the step.
        :return: dict with at least ``negative_entities``, plus
            sampler-specific masks / sorting indices.
        """
        raise NotImplementedError


def _batch_geometry(
    sample_idx: NDArray[np.int64],
) -> Tuple[int, int, int]:
    """(bps, n_shard, shard_bs) from a (bps, n_shard, [n_shard,] ppp) index."""
    bps, n_shard = sample_idx.shape[:2]
    ppp = sample_idx.shape[-1]
    shard_bs = ppp if sample_idx.ndim == 3 else n_shard * ppp
    return bps, n_shard, shard_bs


class RandomShardedNegativeSampler(ShardedNegativeSampler):
    """Uniform random negatives.

    Drawing a local row id uniformly in ``[0, shard_counts[s])`` on every
    shard ``s`` is exactly uniform sampling over all entities *conditioned on
    balance* — the BESS trick that makes the exchange an equal-split AllToAll.

    :param use_native: draw with the C++ pcg32 loop (deterministic in
        (seed, call index); a different stream than the numpy path). Raises
        when the native library cannot be built; ``False`` draws from the
        numpy generator.
    """

    def __init__(
        self,
        n_negative: int,
        sharding: Sharding,
        seed: int,
        corruption_scheme: str,
        local_sampling: bool,
        flat_negative_format: bool = False,
        use_native: bool = True,
    ) -> None:
        self.n_negative = n_negative
        self.sharding = sharding
        self.shard_counts = sharding.shard_counts
        self.corruption_scheme = corruption_scheme
        self.local_sampling = local_sampling
        self.flat_negative_format = flat_negative_format
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.use_native = use_native
        self._native_calls = 0

    def __call__(self, sample_idx: NDArray[np.int64]) -> BatchArrays:
        bps, n_shard, shard_bs = _batch_geometry(sample_idx)
        if self.flat_negative_format:
            b = 2 if self.corruption_scheme == "ht" else 1
        else:
            b = shard_bs
        if self.use_native:
            call_seed = (self.seed * 0x9E3779B9 + self._native_calls) & (2**63 - 1)
            out = native.random_negatives(
                call_seed, self.shard_counts, bps, n_shard, b, self.n_negative
            )
            self._native_calls += 1
            return dict(negative_entities=out)
        draws = self.rng.integers(
            1 << 31, size=(bps, n_shard, n_shard, b, self.n_negative), dtype=np.int64
        )
        local = draws % self.shard_counts[None, :, None, None, None]
        return dict(negative_entities=local.astype(np.int32))


class TypeBasedShardedNegativeSampler(RandomShardedNegativeSampler):
    """Corrupt entities only with entities of the same type.

    Uses the per-shard type counts/offsets of the :class:`Sharding` (local
    IDs stay type-clustered) to remap a uniform draw into the local range of
    the corrupted entity's type.
    """

    def __init__(
        self,
        triple_types: NDArray[np.int32],
        n_negative: int,
        sharding: Sharding,
        corruption_scheme: str,
        local_sampling: bool,
        seed: int,
    ) -> None:
        super().__init__(
            n_negative,
            sharding,
            seed,
            corruption_scheme,
            local_sampling,
            flat_negative_format=False,
        )
        if sharding.entity_type_counts is None or sharding.entity_type_offsets is None:
            raise ValueError("Sharding has no entity-type information")
        self.triple_types = triple_types
        self.type_counts = sharding.entity_type_counts
        self.type_offsets = sharding.entity_type_offsets

    def __call__(self, sample_idx: NDArray[np.int64]) -> BatchArrays:
        bps, n_shard, shard_bs = _batch_geometry(sample_idx)
        ppp = sample_idx.shape[-1]

        types = self.triple_types[sample_idx]  # (bps, shard, [shard,] ppp, 2)
        head_type, tail_type = types[..., 0], types[..., 1]
        if self.corruption_scheme == "h":
            corrupt_type = head_type
        elif self.corruption_scheme == "t":
            corrupt_type = tail_type
        elif self.corruption_scheme == "ht":
            cut = ppp // 2
            corrupt_type = np.concatenate([head_type[..., :cut], tail_type[..., cut:]], axis=-1)
        else:
            raise ValueError(f"Corruption scheme {self.corruption_scheme} not supported")

        # Flatten per-device batch, then broadcast across the shard axis the
        # negatives travel over: local sampling keeps types on the sampling
        # shard (axis 1), otherwise each source shard sees the consumer's
        # (axis 2) types.
        flat = corrupt_type.reshape(bps, n_shard, shard_bs)
        if self.local_sampling:
            rel_type = np.broadcast_to(flat[:, :, None, :], (bps, n_shard, n_shard, shard_bs))
        else:
            rel_type = np.broadcast_to(flat[:, None, :, :], (bps, n_shard, n_shard, shard_bs))

        draws = super().__call__(sample_idx)["negative_entities"]
        src = np.arange(n_shard)[None, :, None, None]
        counts = self.type_counts[src, rel_type][..., None]
        offsets = self.type_offsets[src, rel_type][..., None]
        return dict(negative_entities=(draws % counts + offsets).astype(np.int32))


class PlaceholderNegativeSampler(ShardedNegativeSampler):
    """No-op sampler: signals 'score against every entity in the graph'.

    Used with the windowed top-k inference path, which streams over each
    shard's full local table instead of gathering negatives.
    """

    def __init__(self, corruption_scheme: str, seed: int = 0) -> None:
        self.corruption_scheme = corruption_scheme
        self.local_sampling = False
        self.flat_negative_format = True
        self.seed = seed
        self.rng = np.random.default_rng(seed)

    def __call__(self, sample_idx: NDArray[np.int64]) -> BatchArrays:
        return {}
