"""On-device batch sampling (torch): the whole training batch is drawn on the
device, from a key.

Counterpart of ``besskge_tpu/device_sampler.py``. The host samplers
(:mod:`besskge_tpu_torch.batch_sampler`) assemble numpy batches and ship them
to the device every step. Here the partitioned triple array lives on the
device (wikikg2's 16M triples are 192 MB), positives are drawn from it and
negatives from per-shard entity ranges by plain index ops, and a training
step consumes nothing but a key from the host. With
:func:`~besskge_tpu_torch.trainer.build_device_train_step` on a card, one
call of ``steps_per_call`` steps is one CUDA graph, replayed with a new key.

Semantics match :class:`~besskge_tpu_torch.batch_sampler.RandomShardedBatchSampler`
(sampling with replacement from every shard-pair partition, no epoch cover
or padding masks) combined with
:class:`~besskge_tpu_torch.negative_sampler.RandomShardedNegativeSampler` or
:class:`~besskge_tpu_torch.negative_sampler.TypeBasedShardedNegativeSampler`.
The batch dict has the host layout: ``head``/``relation`` (bps, S, S, ppp),
``tail`` pre-transposed (bps, S_t, S_h, ppp), ``negative``
(bps, S_src, S_dest, B, n).

Random numbers: a counter-based hash of (key, stream, draw index) in masked
int64 tensor arithmetic (the ``lowbias32`` finaliser, as the JAX package's
stochastic rounding hashes its counters). A call's draws depend only on its
key, so the CPU and the card draw the same batch, and a replayed CUDA graph
draws what an eager call with the same key draws, with no generator state
to register with the graph. The numbers differ from ``jax.random``'s; every
uniform of a call comes from :func:`_uniform`, where the tests put the JAX
package's draws. Uniforms map to indices in float32, exactly as the JAX
package maps them, so given its uniforms every index of the batch equals
its batch bit for bit. The one float sum, of the triple weights of a
micro-batch, runs in each device's own order, so ``triple_weight`` differs
between the CPU, the card and the JAX package by that sum's rounding.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from besskge_tpu_torch.negative_sampler import (
    RandomShardedNegativeSampler,
    TypeBasedShardedNegativeSampler,
)
from besskge_tpu_torch.sharding import PartitionedTripleSet
from besskge_tpu_torch.utils import _M32, _mix32, _mul32, resolve_device

__all__ = ["DeviceBatchSampler", "split_key"]

Batch = Dict[str, torch.Tensor]
#: A key: a 0-dim int64 tensor holding a 32-bit value (or, for the host-side
#: helpers, the same value as a Python int).
Key = Union[torch.Tensor, int]

_GOLDEN = 0x9E3779B9
#: Salts of the two draw streams of a step (positives, negatives) and of the
#: keys split from a call's key.
_STREAM_SALT = (0x243F6A88, 0x85A308D3)
_SPLIT_SALT = 0x13198A2E
_FOLD_SALT = 0x03707344


def split_key(key: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` keys derived from ``key``, as an ``(n,)`` int64 tensor on its
    device: the keys of the steps of one fused call (the counterpart of
    ``jax.random.split`` there)."""
    j = torch.arange(1, n + 1, dtype=torch.int64, device=key.device)
    return _mix32((_mix32(key ^ _SPLIT_SALT) + _mul32(j, _GOLDEN)) & _M32)


def _fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """A key derived from ``key`` and the integer ``data`` (a rank): the
    counterpart of ``jax.random.fold_in``, which gives each device of a mesh
    its own dropout stream. ``data`` stays a host int: no copy to the
    device, so it runs inside a CUDA graph's capture."""
    return _mix32((_mix32(key ^ _FOLD_SALT) + _mul32(data & _M32, _GOLDEN)) & _M32)


def _as_key(key: Optional[Key], device: torch.device) -> Optional[torch.Tensor]:
    """A key (an int or a 0-dim integer tensor) as a 0-dim int64 tensor on
    ``device``; ``None`` stays ``None``."""
    if key is None:
        return None
    return torch.as_tensor(key, dtype=torch.int64, device=device)


def _uniform(key: torch.Tensor, stream: int, shape) -> torch.Tensor:
    """float32 uniforms in [0, 1) of ``shape`` on the key's device: the
    draws ``i = 0, 1, ...`` of ``stream`` hash ``seed + i·golden`` (mod
    2^32), and the top 24 bits of each hash, times 2^-24, are exact in
    float32. Every random number of a call comes from here."""
    seed = _mix32(key ^ _STREAM_SALT[stream])
    i = torch.arange(int(np.prod(shape)), dtype=torch.int64, device=key.device)
    x = _mix32((seed + _mul32(i, _GOLDEN)) & _M32)
    return ((x >> 8).to(torch.float32) * 2.0**-24).reshape(shape)


class DeviceBatchSampler:
    """Draw BESS batches on the device, from a key.

    :param partitioned_triple_set: pre-partitioned triples ("ht_shardpair"
        or "h_shard" partition modes).
    :param negative_sampler: a :class:`RandomShardedNegativeSampler` or
        :class:`TypeBasedShardedNegativeSampler`, used for its configuration
        (n_negative, corruption scheme, type tables); its host RNG is never
        consumed.
    :param shard_bs: positive triples scored per shard per micro-batch.
    :param batches_per_step: micro-batches per training step.
    :param seed: base seed of :meth:`next_key`.
    :param hrt_freq_weighting: emit per-triple ``triple_weight`` =
        ``sqrt(1/(count(h,r)+count(r,t)+smoothing))``, micro-batch normalized.
    :param weight_smoothing: additive smoothing for the above.
    :param positive_mode: ``"iid"``: uniform with replacement per triple (the
        :class:`RandomShardedBatchSampler` semantics); ``"runs"``: one uniform
        start per (micro-batch, partition) and a contiguous run of
        ``positive_per_partition`` triples from it. Requires every partition
        to hold at least one run.
    """

    def __init__(
        self,
        partitioned_triple_set: PartitionedTripleSet,
        negative_sampler: Any,
        shard_bs: int,
        batches_per_step: int,
        seed: int = 0,
        hrt_freq_weighting: bool = False,
        weight_smoothing: float = 0.0,
        positive_mode: str = "iid",
    ) -> None:
        pts = partitioned_triple_set
        self.sharding = pts.sharding
        self.n_shard = self.sharding.n_shard
        self.triple_partition_mode = pts.partition_mode
        self.negative_sampler = negative_sampler
        self.shard_bs = shard_bs
        self.batches_per_step = batches_per_step
        self.seed = seed
        self.dummy = pts.dummy
        if pts.partition_mode not in ("ht_shardpair", "h_shard"):
            raise ValueError(f"Unsupported partition mode {pts.partition_mode!r}")
        if isinstance(negative_sampler, TypeBasedShardedNegativeSampler):
            self._negative_kind = "type"
        elif isinstance(negative_sampler, RandomShardedNegativeSampler):
            self._negative_kind = "random"
        else:
            raise ValueError(
                "DeviceBatchSampler supports Random/TypeBased sharded negative samplers,"
                f" got {type(negative_sampler).__name__}"
            )

        if pts.partition_mode == "ht_shardpair":
            self.positive_per_partition = int(np.ceil(shard_bs / self.n_shard))
        else:
            self.positive_per_partition = shard_bs
        if negative_sampler.corruption_scheme == "ht":
            self.positive_per_partition = 2 * (self.positive_per_partition // 2)
        self.partition_sample_size = self.batches_per_step * self.positive_per_partition

        self._triples = np.asarray(pts.triples, np.int32)
        self._counts = np.maximum(np.asarray(pts.triple_counts, np.int64), 1)
        self._offsets = np.asarray(pts.triple_offsets, np.int64)
        self._shard_counts = np.asarray(self.sharding.shard_counts, np.int32)

        if positive_mode not in ("iid", "runs"):
            raise ValueError(f"Unknown positive_mode {positive_mode!r}")
        if positive_mode == "runs" and (self._counts < self.positive_per_partition).any():
            raise ValueError(
                "positive_mode='runs' needs every partition to hold at least one run of"
                f" {self.positive_per_partition} triples (smallest partition:"
                f" {int(self._counts.min())})"
            )
        self.positive_mode = positive_mode

        self.hrt_freq_weighting = hrt_freq_weighting
        self._weights: Optional[np.ndarray] = None
        if hrt_freq_weighting:
            n_ent = self.sharding.n_entity
            tri = self._triples.astype(np.int64)
            _, hr_inv, hr_count = np.unique(
                tri[:, 0] + n_ent * tri[:, 1], return_inverse=True, return_counts=True
            )
            _, rt_inv, rt_count = np.unique(
                tri[:, 2] + n_ent * tri[:, 1], return_inverse=True, return_counts=True
            )
            self._weights = np.sqrt(
                1.0 / (hr_count[hr_inv] + rt_count[rt_inv] + weight_smoothing)
            ).astype(np.float32)
        #: The partition tables as device tensors, by device: made at the
        #: first draw on a device (before any CUDA graph captures one).
        self._tables: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        """Steps per nominal epoch (matches
        :class:`RandomShardedBatchSampler.__len__`)."""
        return int(np.ceil(self._counts.max() / self.partition_sample_size))

    def state(self, device: Optional[Union[str, torch.device]] = None) -> Dict[str, torch.Tensor]:
        """Device-resident sampling state (default device ``cuda``), passed
        to every draw: the triples as ONE 1-D triple-major column
        ``[h0, r0, t0, h1, ...]``, the triple weights, and for type-based
        negatives the pair-major ``[(h_type0, t_type0), ...]`` column with
        the per-shard type counts and offsets."""
        device = resolve_device(device)
        st = {"hrt": torch.from_numpy(self._triples.reshape(-1)).to(device)}
        if self._weights is not None:
            st["weights"] = torch.from_numpy(self._weights).to(device)
        if self._negative_kind == "type":
            ns = self.negative_sampler
            st["triple_types"] = torch.from_numpy(
                np.asarray(ns.triple_types, np.int32).reshape(-1)).to(device)
            st["type_counts"] = torch.from_numpy(np.asarray(ns.type_counts, np.int32)).to(device)
            st["type_offsets"] = torch.from_numpy(np.asarray(ns.type_offsets, np.int32)).to(device)
        return st

    def next_key(self, step: int) -> torch.Tensor:
        """Deterministic per-step key (host side, a 0-dim int64 tensor)."""
        return torch.tensor(_mix32(_mix32(self.seed & _M32) ^ (step & _M32)), dtype=torch.int64)

    def _device_tables(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """Partition counts and offsets, shard sizes: the constants that the
        JAX package bakes into its program, in its dtypes."""
        if device not in self._tables:
            self._tables[device] = {
                "counts": torch.from_numpy(self._counts.astype(np.float32)).to(device),
                "offsets": torch.from_numpy(self._offsets.astype(np.int32)).to(device),
                "shard_counts": torch.from_numpy(self._shard_counts.astype(np.float32)).to(device),
            }
        return self._tables[device]

    # ------------------------------------------------------------------
    def sample(self, state: Dict[str, torch.Tensor], key: torch.Tensor) -> Batch:
        """Draw one step's batch in the global host layout, on the device of
        ``state``; ``key`` is a 0-dim int64 tensor there. Makes no host
        synchronisation, so it runs inside a CUDA graph."""
        bps, S, ppp = self.batches_per_step, self.n_shard, self.positive_per_partition
        hrt = state["hrt"]
        tables = self._device_tables(hrt.device)
        counts, offsets = tables["counts"], tables["offsets"]
        if self.triple_partition_mode == "ht_shardpair":
            shape = (bps, S, S, ppp)
        else:
            shape = (bps, S, ppp)

        if self.positive_mode == "runs":
            # One uniform run start per (micro-batch, partition); the run is
            # ppp contiguous triples.
            u = _uniform(key, 0, (bps, *counts.shape))
            starts = offsets + (u * (counts - ppp + 1)).to(torch.int32)
            sample_idx = starts[..., None] + torch.arange(ppp, dtype=torch.int32, device=hrt.device)
        else:
            u = _uniform(key, 0, shape)
            sample_idx = offsets[None, ..., None] + (u * counts[None, ..., None]).to(torch.int32)
        trip = hrt.view(-1, 3)[sample_idx.long()]  # (*shape, 3)
        head, relation, tail = trip[..., 0], trip[..., 1], trip[..., 2]
        if self.triple_partition_mode == "ht_shardpair":
            # Pre-transpose tails (shard_h <-> shard_t) for the AllToAll.
            tail = tail.transpose(1, 2)

        batch = {
            "head": head,
            "relation": relation,
            "tail": tail,
            "negative": self._sample_negatives(state, key, sample_idx),
        }
        if self.dummy in ("head", "tail"):
            batch.pop(self.dummy)
        if self._weights is not None:
            w = state["weights"][sample_idx.long()].reshape(bps, S, -1)
            batch["triple_weight"] = w / w.sum(-1, keepdim=True) * self.shard_bs
        return batch

    def _sample_negatives(
        self, state: Dict[str, torch.Tensor], key: torch.Tensor, sample_idx: torch.Tensor
    ) -> torch.Tensor:
        ns = self.negative_sampler
        bps, S = self.batches_per_step, self.n_shard
        shard_bs = sample_idx.shape[-1] * (S if sample_idx.dim() == 4 else 1)
        if getattr(ns, "flat_negative_format", False):
            b = 2 if ns.corruption_scheme == "ht" else 1
        else:
            b = shard_bs
        u = _uniform(key, 1, (bps, S, S, b, ns.n_negative))
        shard_counts = self._device_tables(sample_idx.device)["shard_counts"]
        if self._negative_kind == "random":
            return (u * shard_counts[None, :, None, None, None]).to(torch.int32)

        # Type-based: remap each source shard's draw into the local range of
        # the consumer triple's corrupted-entity type.
        types = state["triple_types"].view(-1, 2)[sample_idx.long()]  # (*sample_idx.shape, 2)
        head_type, tail_type = types[..., 0], types[..., 1]
        if ns.corruption_scheme == "h":
            corrupt = head_type
        elif ns.corruption_scheme == "t":
            corrupt = tail_type
        else:  # "ht": first half of each partition corrupts heads
            cut = sample_idx.shape[-1] // 2
            corrupt = torch.cat([head_type[..., :cut], tail_type[..., cut:]], dim=-1)
        flat = corrupt.reshape(bps, S, shard_bs)
        if ns.local_sampling:
            rel_type = flat[:, :, None, :].expand(bps, S, S, shard_bs)
        else:
            rel_type = flat[:, None, :, :].expand(bps, S, S, shard_bs)
        src = torch.arange(S, dtype=torch.int64, device=sample_idx.device)[None, :, None, None]
        rel_type = rel_type.long()
        t_counts = state["type_counts"][src, rel_type][..., None]
        t_offsets = state["type_offsets"][src, rel_type][..., None]
        return (u * t_counts.to(torch.float32)).to(torch.int32) + t_offsets

    # ------------------------------------------------------------------
    def slice_local(self, batch: Batch, shard: Union[int, torch.Tensor]) -> Batch:
        """Shard ``shard``'s (bps, 1, ...) block of a global batch, as views."""
        return {k: v.narrow(1, shard, 1) for k, v in batch.items()}
