"""Sharded negative samplers (host-side numpy).

Copied from ``besskge_tpu/negative_sampler.py`` so that the port never
imports the JAX package. Only the base class and the placeholder that the
top-k serving path uses are ported; the random, type-based and triple-based
samplers follow with the training slice.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, Union

import numpy as np
from numpy.typing import NDArray

__all__ = ["ShardedNegativeSampler", "PlaceholderNegativeSampler"]

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
