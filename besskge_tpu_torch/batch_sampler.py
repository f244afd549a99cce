"""BESS batch construction (host-side, numpy).

Assembles per-step batches of positive triples and negative-entity ids in the
device layout expected by :mod:`besskge_tpu_torch.bess`: every array has a
leading ``(bps, n_shard, ...)`` prefix where axis 1 is the shard axis.

Key layout invariant (reference ``besskge/batch_sampler.py:163-167``): tails
are emitted pre-transposed ``(step, shard_t, shard_h, triple)`` so that after
the device's tiled AllToAll over the shard axis, the tail block of partition
``(h, t)`` lands on shard ``h`` next to its heads.

Batches are dicts of numpy arrays — no framework tensors. Copied from
``besskge_tpu/batch_sampler.py`` (with the C++ host loops of
:mod:`besskge_tpu_torch.native` and the threaded dataloader), so that the
port never imports the JAX package; for the same seed its batches, triple
weights included, equal the JAX package's.
"""

from __future__ import annotations

import warnings
from abc import ABC, abstractmethod
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from besskge_tpu_torch import native
from besskge_tpu_torch.negative_sampler import ShardedNegativeSampler
from besskge_tpu_torch.sharding import PartitionedTripleSet

__all__ = [
    "ShardedBatchSampler",
    "RigidShardedBatchSampler",
    "RandomShardedBatchSampler",
]

Batch = Dict[str, np.ndarray]


class ShardedBatchSampler(ABC):
    """Base class for BESS batch samplers.

    :param partitioned_triple_set: pre-partitioned triples.
    :param negative_sampler: sharded negative sampler.
    :param shard_bs: positive triples scored per shard per micro-batch.
    :param batches_per_step: micro-batches sampled per call (device loop).
    :param seed: RNG seed.
    :param hrt_freq_weighting: frequency-based triple weighting
        ``sqrt(1/(count(h,r) + count(r,t) + smoothing))``, normalized within
        each micro-batch (``triple_weight``).
    :param weight_smoothing: additive smoothing for the above.
    :param duplicate_batch: micro-batches have two identical halves along the
        triple axis (used with "ht" corruption at inference, so each triple is
        scored against both head and tail corruptions).
    :param return_triple_idx: also return positions (into
        ``partitioned_triple_set.triples``) of the sampled triples.
    :param use_native: assemble batches with the C++ host loops (the same
        arrays as the numpy path; raises when the library cannot be built).
    """

    def __init__(
        self,
        partitioned_triple_set: PartitionedTripleSet,
        negative_sampler: ShardedNegativeSampler,
        shard_bs: int,
        batches_per_step: int,
        seed: int,
        hrt_freq_weighting: bool = False,
        weight_smoothing: float = 0.0,
        duplicate_batch: bool = False,
        return_triple_idx: bool = False,
        use_native: bool = True,
    ) -> None:
        self.n_shard = partitioned_triple_set.sharding.n_shard
        self.triples = partitioned_triple_set.triples
        self.dummy = partitioned_triple_set.dummy
        self.triple_counts = partitioned_triple_set.triple_counts
        self.triple_offsets = partitioned_triple_set.triple_offsets
        self.triple_partition_mode = partitioned_triple_set.partition_mode
        self.negative_sampler = negative_sampler
        self.shard_bs = shard_bs
        self.batches_per_step = batches_per_step
        self.duplicate_batch = duplicate_batch
        self.use_native = use_native

        if self.triple_partition_mode == "ht_shardpair":
            # Micro-batch on shard h = n_shard partition blocks (h, 0..S-1).
            self.positive_per_partition = int(np.ceil(shard_bs / self.n_shard))
        else:
            self.positive_per_partition = shard_bs
        if duplicate_batch:
            self.positive_per_partition //= 2
        if negative_sampler.corruption_scheme == "ht":
            # "ht" splits each partition block in half -> must be even.
            self.positive_per_partition = 2 * (self.positive_per_partition // 2)

        #: Triples drawn from each partition per call.
        self.partition_sample_size = self.batches_per_step * self.positive_per_partition

        self.hrt_freq_weighting = hrt_freq_weighting
        self.return_triple_idx = return_triple_idx
        self.seed = seed
        self.rng = np.random.default_rng(seed)

        if hrt_freq_weighting:
            if self.dummy != "none":
                warnings.warn("hrt frequency weights are being computed on dummy entities")
            n_ent = partitioned_triple_set.sharding.n_entity
            _, hr_inv, hr_count = np.unique(
                self.triples[:, 0].astype(np.int64) + n_ent * self.triples[:, 1],
                return_inverse=True,
                return_counts=True,
            )
            _, rt_inv, rt_count = np.unique(
                self.triples[:, 2].astype(np.int64) + n_ent * self.triples[:, 1],
                return_inverse=True,
                return_counts=True,
            )
            self.hrt_weights = np.sqrt(
                1.0 / (hr_count[hr_inv] + rt_count[rt_inv] + weight_smoothing)
            )

    # ------------------------------------------------------------------
    @abstractmethod
    def sample_triples(self, idx: Sequence[int]) -> Dict[str, np.ndarray]:
        """Return at least ``sample_idx``
        (bps, n_shard, [n_shard,] positive_per_partition) positions into
        :attr:`triples`, plus sampler-specific extras (e.g. padding masks)."""
        raise NotImplementedError

    def __len__(self) -> int:
        """Indices per epoch: the longest partition, rounded up to a multiple
        of :attr:`partition_sample_size` (shorter partitions repeat)."""
        pss = self.partition_sample_size
        return int(np.ceil(self.triple_counts.max() / pss)) * pss

    def sample_batch(self, idx: Sequence[int]) -> Batch:
        """Assemble the batch dict for one step.

        :param idx: ``partition_sample_size`` positions in ``range(len(self))``.
        """
        parts = self.sample_triples(idx)
        if self.duplicate_batch:
            parts = {k: np.concatenate([v, v], axis=-1) for k, v in parts.items()}
        sample_idx = parts.pop("sample_idx")

        if self.use_native and (
            sample_idx.ndim == 4 or self.triple_partition_mode != "ht_shardpair"
        ):
            # C++ fused gather (+ tail pre-transpose for ht_shardpair).
            head, relation, tail = native.assemble_hrt(self.triples, sample_idx)
        else:
            hrt = self.triples[sample_idx]  # (..., 3)
            head = hrt[..., 0]
            relation = hrt[..., 1]
            tail = hrt[..., 2]
            if self.triple_partition_mode == "ht_shardpair":
                # Pre-transpose tails (shard_h <-> shard_t) for the AllToAll.
                tail = np.ascontiguousarray(tail.transpose(0, 2, 1, 3))

        batch: Batch = {
            "head": np.asarray(head, np.int32),
            "relation": np.asarray(relation, np.int32),
            "tail": np.asarray(tail, np.int32),
        }
        batch.update({k: v for k, v in parts.items()})

        negatives = self.negative_sampler(sample_idx)
        if "negative_entities" in negatives:
            batch["negative"] = negatives.pop("negative_entities").astype(np.int32)
        batch.update(negatives)

        if self.dummy in ("head", "tail"):
            batch.pop(self.dummy)

        if self.hrt_freq_weighting:
            w = self.hrt_weights[sample_idx].reshape(self.batches_per_step, self.n_shard, -1)
            w = w / w.sum(axis=-1, keepdims=True) * self.shard_bs
            batch["triple_weight"] = w.astype(np.float32)

        if self.return_triple_idx:
            batch["triple_idx"] = sample_idx

        return batch

    # Alias mirroring the reference's Dataset API.
    __getitem__ = sample_batch

    def epoch_index_blocks(
        self, shuffle: bool, rng: Optional[np.random.Generator] = None
    ) -> Iterator[np.ndarray]:
        """Yield index blocks of size :attr:`partition_sample_size` covering
        one epoch (the last block may be shorter and is dropped if empty)."""
        n = len(self)
        order = (rng or self.rng).permutation(n) if shuffle else np.arange(n)
        pss = self.partition_sample_size
        for i in range(0, n, pss):
            block = order[i : i + pss]
            if len(block):
                yield block

    def get_dataloader(
        self,
        shuffle: bool = True,
        prefetch: int = 2,
        repeat: bool = False,
        seed_offset: int = 0,
    ) -> Iterator[Batch]:
        """Iterate batches with background-thread prefetch.

        The numpy batch assembly (the CPU hot loop) runs in a worker thread so
        it overlaps device execution; ``prefetch`` bounds the queue depth.
        """
        import queue
        import threading

        rng = np.random.default_rng(self.seed + seed_offset)
        q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        stop = threading.Event()

        def worker() -> None:
            try:
                while True:
                    for block in self.epoch_index_blocks(shuffle, rng):
                        if stop.is_set():
                            return
                        q.put(self.sample_batch(block))
                    if not repeat:
                        break
            finally:
                q.put(None)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield item
        finally:
            stop.set()
            # Drain so the worker can exit.
            while not q.empty():
                q.get_nowait()


class RigidShardedBatchSampler(ShardedBatchSampler):
    """Deterministic epoch cover: every partition padded (by cyclic triple
    repetition) to the longest one; emits ``triple_mask`` flagging real
    triples. Used for evaluation and epoch-based training."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        padded_len = len(self)
        grid = np.arange(padded_len)
        expand = (0, 1) if self.triple_partition_mode == "ht_shardpair" else (0,)
        grid = np.expand_dims(grid, axis=expand)
        counts = self.triple_counts[..., None]
        self.triple_mask = grid < counts
        padded_idx = grid % np.maximum(counts, 1) + self.triple_offsets[..., None]
        # Clamp in case the last partition is empty.
        self.triple_padded_idx = np.minimum(padded_idx, self.triples.shape[0] - 1)

    def sample_triples(self, idx: Sequence[int]) -> Dict[str, np.ndarray]:
        idx = np.asarray(idx)
        if (
            self.use_native
            and self.triple_padded_idx.ndim == 3
            and idx.size % self.batches_per_step == 0
        ):
            # ht_shardpair fast path: the C++ loop writes the
            # (bps, S, S, t) layout directly (no numpy fancy-index temp).
            take, mask = native.rigid_take(
                self.triple_padded_idx,
                self.triple_counts.astype(np.int64),
                idx.astype(np.int64),
                self.batches_per_step,
                idx.size // self.batches_per_step,
            )
            return dict(sample_idx=take, triple_mask=mask)
        take = self.triple_padded_idx[..., idx]  # (shard, [shard,] bps*t)
        mask = self.triple_mask[..., idx]

        def split_steps(x: np.ndarray) -> np.ndarray:
            # (shard, [shard,] bps*t) -> (bps, shard, [shard,] t)
            lead = x.shape[:-1]
            x = x.reshape(*lead, self.batches_per_step, -1)
            return np.moveaxis(x, -2, 0)

        return dict(sample_idx=split_steps(take), triple_mask=split_steps(mask))


class RandomShardedBatchSampler(ShardedBatchSampler):
    """IID sampling with replacement from every partition (no padding mask)."""

    def __len__(self) -> int:
        return int(np.ceil(self.triple_counts.max() / self.partition_sample_size))

    def sample_triples(self, idx: Sequence[int]) -> Dict[str, np.ndarray]:
        if self.triple_partition_mode == "ht_shardpair":
            size = (
                self.batches_per_step,
                self.n_shard,
                self.n_shard,
                self.positive_per_partition,
            )
        else:
            size = (self.batches_per_step, self.n_shard, self.positive_per_partition)
        draws = self.rng.integers(1 << 62, size=size)
        sample_idx = (
            self.triple_offsets[None, ..., None]
            + draws % np.maximum(self.triple_counts[None, ..., None], 1)
        )
        return dict(sample_idx=sample_idx)

    def epoch_index_blocks(
        self, shuffle: bool = True, rng: Optional[np.random.Generator] = None
    ) -> Iterator[np.ndarray]:
        for i in range(len(self)):
            yield np.array([i])
