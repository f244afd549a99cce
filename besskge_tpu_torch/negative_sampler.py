"""Sharded negative samplers (host-side numpy).

Copied from ``besskge_tpu/negative_sampler.py`` so that the port never
imports the JAX package. Ported: the base class, the uniform
:class:`RandomShardedNegativeSampler` of the training path (native pcg32 and
numpy streams, bit-equal to the JAX package's for the same seed), the
type-matched :class:`TypeBasedShardedNegativeSampler` on top of it, the
predefined candidate sets of evaluation
(:class:`TripleBasedShardedNegativeSampler`, whose batches equal the JAX
package's bit for bit), and the placeholder of all-entities inference.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, Optional, Tuple, Union

import numpy as np
from numpy.typing import NDArray

from besskge_tpu_torch import native
from besskge_tpu_torch.sharding import Sharding

__all__ = [
    "ShardedNegativeSampler",
    "RandomShardedNegativeSampler",
    "TypeBasedShardedNegativeSampler",
    "TripleBasedShardedNegativeSampler",
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


class TripleBasedShardedNegativeSampler(ShardedNegativeSampler):
    """Predefined (possibly per-triple) negative candidates.

    Candidates are pre-bucketed by their shard, each shard list padded to the
    global maximum, and a boolean mask marks real (non-padding) entries. The
    mask is emitted in either the processing-device layout
    ``(bps, shard, B, shard_source, pad)`` or, with ``mask_on_gather``, the
    gathering-device layout ``(bps, shard_source, shard, B, pad)`` (used by
    the windowed top-k path).
    """

    def __init__(
        self,
        negative_heads: Optional[NDArray[np.int32]],
        negative_tails: Optional[NDArray[np.int32]],
        sharding: Sharding,
        corruption_scheme: str,
        seed: int,
        mask_on_gather: bool = False,
        return_sort_idx: bool = False,
    ) -> None:
        if negative_heads is not None:
            negative_heads = negative_heads.reshape(-1, negative_heads.shape[-1])
        if negative_tails is not None:
            negative_tails = negative_tails.reshape(-1, negative_tails.shape[-1])

        if negative_heads is not None and negative_tails is not None:
            if negative_heads.shape != negative_tails.shape:
                raise ValueError(
                    "negative_heads and negative_tails must have the same shape"
                )
            self.N, self.n_negative = negative_heads.shape
        elif negative_tails is not None:
            if corruption_scheme != "t":
                raise ValueError(
                    f"Corruption scheme '{corruption_scheme}' requires negative_heads"
                )
            self.N, self.n_negative = negative_tails.shape
        elif negative_heads is not None:
            if corruption_scheme != "h":
                raise ValueError(
                    f"Corruption scheme '{corruption_scheme}' requires negative_tails"
                )
            self.N, self.n_negative = negative_heads.shape
        else:
            raise ValueError("Provide negative_heads and/or negative_tails")

        self.sharding = sharding
        self.shard_counts = sharding.shard_counts
        self.corruption_scheme = corruption_scheme
        self.local_sampling = False
        self.flat_negative_format = self.N == 1
        self.mask_on_gather = mask_on_gather
        self.return_sort_idx = return_sort_idx
        self.seed = seed
        self.rng = np.random.default_rng(seed)

        def _shard_ordered(negs, sort_idx):
            # sort_idx is the identity at n_shard == 1: skip the 20M-element
            # gather (page-fault-bound on demand-paged hosts).
            if sharding.n_shard == 1:
                return sharding.entity_to_idx[negs]
            return sharding.entity_to_idx[
                np.take_along_axis(negs, sort_idx, axis=-1)
            ]

        if corruption_scheme in ("h", "t"):
            negs = negative_heads if corruption_scheme == "h" else negative_tails
            counts, self.sort_neg_idx = self.shard_negatives(negs)
            self.padded_shard_length = int(counts.max())
            self.padded_negatives, self.mask = self.pad_negatives(
                _shard_ordered(negs, self.sort_neg_idx),
                counts,
                self.padded_shard_length,
            )
        elif corruption_scheme == "ht":
            counts_h, self.sort_neg_h_idx = self.shard_negatives(negative_heads)
            counts_t, self.sort_neg_t_idx = self.shard_negatives(negative_tails)
            self.padded_shard_length = int(max(counts_h.max(), counts_t.max()))
            self.padded_negatives_h, self.mask_h = self.pad_negatives(
                _shard_ordered(negative_heads, self.sort_neg_h_idx),
                counts_h,
                self.padded_shard_length,
            )
            self.padded_negatives_t, self.mask_t = self.pad_negatives(
                _shard_ordered(negative_tails, self.sort_neg_t_idx),
                counts_t,
                self.padded_shard_length,
            )
        else:
            raise ValueError(
                f"Corruption scheme {corruption_scheme} not supported"
            )

    # -- layout helpers ----------------------------------------------------
    @staticmethod
    def _to_gather_layout(x: np.ndarray) -> np.ndarray:
        """(bps, shard, [shard,] T, src, pad) -> (bps, src, shard, B, pad)."""
        bps = x.shape[0]
        n_shard = x.shape[1]
        src, pad = x.shape[-2], x.shape[-1]
        flat = x.reshape(bps, n_shard, -1, src, pad)  # B = prod(middle dims)
        return np.ascontiguousarray(flat.transpose(0, 3, 1, 2, 4))

    @staticmethod
    def _to_processing_layout(x: np.ndarray) -> np.ndarray:
        """(bps, shard, [shard,] T, src, pad) -> (bps, shard, B, src, pad)."""
        bps = x.shape[0]
        n_shard = x.shape[1]
        src, pad = x.shape[-2], x.shape[-1]
        return x.reshape(bps, n_shard, -1, src, pad)

    def _mask_layout(self, x: np.ndarray) -> np.ndarray:
        if self.mask_on_gather:
            return self._to_gather_layout(x)
        return self._to_processing_layout(x)

    def __call__(self, sample_idx: NDArray[np.int64]) -> BatchArrays:
        out: BatchArrays
        if self.corruption_scheme in ("h", "t"):
            orig_shape = sample_idx.shape
            if self.flat_negative_format:
                sample_idx = np.zeros(
                    (*sample_idx.shape[:2], 1), dtype=sample_idx.dtype
                )
            ent = self.padded_negatives[sample_idx]  # (..., src, pad)
            mask = self.mask[sample_idx]
            out = dict(
                negative_entities=self._to_gather_layout(ent),
                negative_mask=self._mask_layout(mask),
            )
            if self.return_sort_idx:
                idx = (
                    np.zeros(orig_shape, dtype=np.int64)
                    if self.flat_negative_format
                    else sample_idx
                )
                srt = self.sort_neg_idx[idx]
                out["negative_sort_idx"] = srt.reshape(
                    srt.shape[0], srt.shape[1], -1, srt.shape[-1]
                )
        else:  # "ht"
            cut = sample_idx.shape[-1] // 2
            if self.flat_negative_format:
                bps, n_shard = sample_idx.shape[:2]
                ent = np.concatenate(
                    [self.padded_negatives_h, self.padded_negatives_t], axis=0
                )  # (2, src, pad)
                mask = np.concatenate([self.mask_h, self.mask_t], axis=0)
                ent_b = np.broadcast_to(
                    ent[None, None], (bps, n_shard, 2, self.sharding.n_shard,
                                      self.padded_shard_length)
                )
                mask_b = np.broadcast_to(
                    mask[None, None], ent_b.shape
                )
                out = dict(
                    negative_entities=self._to_gather_layout(ent_b),
                    negative_mask=self._mask_layout(mask_b),
                )
                if self.return_sort_idx:
                    h_idx = np.zeros((*sample_idx.shape[:-1], cut), dtype=np.int64)
                    t_idx = np.zeros(
                        (*sample_idx.shape[:-1], sample_idx.shape[-1] - cut),
                        dtype=np.int64,
                    )
                    srt = np.concatenate(
                        [self.sort_neg_h_idx[h_idx], self.sort_neg_t_idx[t_idx]],
                        axis=-2,
                    )
                    out["negative_sort_idx"] = srt.reshape(
                        srt.shape[0], srt.shape[1], -1, srt.shape[-1]
                    )
            else:
                h_idx = sample_idx[..., :cut]
                t_idx = sample_idx[..., cut:]
                ent = np.concatenate(
                    [self.padded_negatives_h[h_idx], self.padded_negatives_t[t_idx]],
                    axis=-3,
                )
                mask = np.concatenate(
                    [self.mask_h[h_idx], self.mask_t[t_idx]], axis=-3
                )
                out = dict(
                    negative_entities=self._to_gather_layout(ent),
                    negative_mask=self._mask_layout(mask),
                )
                if self.return_sort_idx:
                    srt = np.concatenate(
                        [self.sort_neg_h_idx[h_idx], self.sort_neg_t_idx[t_idx]],
                        axis=-2,
                    )
                    out["negative_sort_idx"] = srt.reshape(
                        srt.shape[0], srt.shape[1], -1, srt.shape[-1]
                    )
        return out

    def shard_negatives(
        self, negatives: NDArray[np.int32]
    ) -> Tuple[NDArray[np.int64], NDArray[np.int32]]:
        """Bucket candidate entities by shard.

        :return: ``(counts (N, n_shard), sort_idx (N, n_negative))`` where
            ``sort_idx`` stably clusters each row in shard order.
        """
        n_shard = self.sharding.n_shard
        if n_shard == 1:
            # Identity bucketing: skip the argsort and the (N, n_neg)
            # key temps — they page-fault for seconds at OGB eval sizes
            # on demand-paged hosts.
            counts = np.full((self.N, 1), self.n_negative, np.int64)
            sort_idx = np.broadcast_to(
                np.arange(self.n_negative, dtype=np.int32),
                (self.N, self.n_negative),
            )
            return counts, sort_idx
        # int8 shard keys: numpy's stable sort radix-sorts small ints (vs a
        # mergesort on int32), and the per-shard counts come from n_shard
        # row-sum passes instead of a flattened (N·n_neg) int64 key temp —
        # both matter on demand-paged hosts where fresh-allocation page
        # faults dominate at OGB candidate-set sizes.
        shard_of = self.sharding.entity_to_shard.astype(np.int8)[
            negatives
        ]  # (N, n_neg)
        counts = np.empty((self.N, n_shard), np.int64)
        for s in range(n_shard):
            counts[:, s] = (shard_of == s).sum(axis=-1)
        sort_idx = np.argsort(shard_of, axis=-1, kind="stable")
        return counts, sort_idx.astype(np.int32, copy=False)

    def pad_negatives(
        self,
        negatives: NDArray[np.int32],
        shard_counts: NDArray[np.int64],
        padded_shard_length: int,
    ) -> Tuple[NDArray[np.int32], NDArray[np.bool_]]:
        """Split shard-ordered candidates into per-shard lists, cyclically
        padded to ``padded_shard_length``.

        :param negatives: (N, n_negative) shard-ordered candidate ids
            (already local).
        :return: ``(padded (N, n_shard, pad), mask (N, n_shard, pad))`` with
            ``mask`` True on real entries.
        """
        if (
            self.sharding.n_shard == 1
            and padded_shard_length == self.n_negative
        ):
            # Every row is full: padding and reindexing are identities.
            mask = np.ones((self.N, 1, padded_shard_length), np.bool_)
            return (
                negatives.reshape(self.N, 1, -1).astype(np.int32, copy=False),
                mask,
            )
        # int32 + in-place arithmetic throughout: the (N, n_shard, pad)
        # index temps page-fault for tens of seconds at OGB candidate-set
        # sizes if each op allocates a fresh int64 buffer.
        counts32 = shard_counts.astype(np.int32, copy=False)
        pos = np.arange(padded_shard_length, dtype=np.int32)[None, None, :]
        mask = pos < counts32[..., None]
        offsets = np.zeros_like(counts32)
        offsets[:, 1:] = np.cumsum(counts32, axis=-1, dtype=np.int32)[:, :-1]
        # Cyclic repetition within each shard list; clamp guards empty lists.
        idx = pos % np.maximum(counts32[..., None], np.int32(1))
        idx += offsets[..., None]
        np.minimum(idx, np.int32(self.n_negative - 1), out=idx)
        padded = negatives[np.arange(self.N)[:, None, None], idx]
        return padded.astype(np.int32, copy=False), mask

    @property
    def n_negative_per_shard(self) -> int:
        """Padded per-shard candidate-list length."""
        return self.padded_shard_length


class PlaceholderNegativeSampler(ShardedNegativeSampler):
    """No-op sampler: signals 'score against every entity in the graph'.

    Used with the windowed top-k / all-scores inference paths, which stream
    over each shard's full local table instead of gathering negatives.
    """

    def __init__(self, corruption_scheme: str, seed: int = 0) -> None:
        self.corruption_scheme = corruption_scheme
        self.local_sampling = False
        self.flat_negative_format = True
        self.seed = seed
        self.rng = np.random.default_rng(seed)

    def __call__(self, sample_idx: NDArray[np.int64]) -> BatchArrays:
        return {}
