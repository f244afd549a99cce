"""Entity sharding and triple partitioning for the BESS distribution scheme.

BESS splits the entity embedding table into ``n_shard`` random, balanced row
shards — one per device — while the (small) relation table is replicated. Triples are bucketed by the shard pair
``(shard(head), shard(tail))`` so that every device can assemble its
micro-batch with a single balanced AllToAll of tail/negative embeddings.

This module is pure host-side numpy, copied from ``besskge_tpu/sharding.py``
so that the port never imports the JAX package; its arrays are identical to
the JAX package's for the same seed, and a :class:`Sharding` file written by
either package loads into the other.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
from numpy.typing import NDArray

from besskge_tpu_torch.dataset import KGDataset

__all__ = ["Sharding", "PartitionedTripleSet"]


@dataclasses.dataclass
class Sharding:
    """A random balanced assignment of entities to device shards.

    Entities keep their global-ID ordering *within* a shard, so type-clustered
    global IDs remain type-clustered locally (needed by the type-based
    negative sampler). Shards are padded to a common length
    ``max_entity_per_shard``; padding slots map to global IDs
    ``>= n_entity`` and are excluded from ``shard_counts``.
    """

    #: Number of shards (== number of devices on the "shard" mesh axis).
    n_shard: int
    #: int32[n_entity] — shard that stores each entity.
    entity_to_shard: NDArray[np.int32]
    #: int32[n_entity] — row of each entity within its shard.
    entity_to_idx: NDArray[np.int32]
    #: int32[n_shard, max_entity_per_shard] — global ID stored at (shard, row).
    shard_and_idx_to_entity: NDArray[np.int32]
    #: int64[n_shard] — number of real (non-padding) entities per shard.
    shard_counts: NDArray[np.int64]
    #: int64[n_shard, n_types] — per-shard count of entities of each type.
    entity_type_counts: Optional[NDArray[np.int64]] = None
    #: int64[n_shard, n_types] — local offset of each type block per shard.
    entity_type_offsets: Optional[NDArray[np.int64]] = None

    @property
    def n_entity(self) -> int:
        """Total number of entities in the graph."""
        return int(self.entity_to_shard.shape[0])

    @property
    def max_entity_per_shard(self) -> int:
        """Rows per shard, padding included."""
        return int(self.shard_and_idx_to_entity.shape[1])

    @classmethod
    def create(
        cls,
        n_entity: int,
        n_shard: int,
        seed: int,
        type_offsets: Optional[NDArray[np.int64]] = None,
    ) -> "Sharding":
        """Draw a uniformly random balanced sharding of ``n_entity`` entities.

        :param n_entity: number of entities in the graph.
        :param n_shard: number of shards / devices.
        :param seed: RNG seed.
        :param type_offsets: shape (n_types,) — global ID offsets of entity
            types, when entities are clustered by type. Enables per-shard
            type counts/offsets used for type-based negative sampling.
        """
        rng = np.random.default_rng(seed)
        rows = int(np.ceil(n_entity / n_shard))
        # Keep the per-shard row count even so row-pair-packed bf16 tables
        # (``besskge_tpu.packed``) tile shards without splitting a pair;
        # costs at most one extra padding slot per shard.
        rows += rows & 1
        # Random split: permute the padded ID range, one row of `rows` IDs per
        # shard, then sort each row so local order preserves global order
        # (keeps type clustering within shards).
        table = rng.permutation(n_shard * rows).reshape(n_shard, rows)
        table.sort(axis=1)

        # Invert the map for the real entities only (IDs >= n_entity are pads,
        # which always sort to the tail of each row).
        order = np.argsort(table.reshape(-1))[:n_entity]
        entity_to_shard = (order // rows).astype(np.int32)
        entity_to_idx = (order % rows).astype(np.int32)

        pad_per_shard = (table[:, -n_shard:] >= n_entity).sum(axis=-1)
        shard_counts = (rows - pad_per_shard).astype(np.int64)

        type_counts = type_offs = None
        if type_offsets is not None:
            n_types = len(type_offsets)
            local_type = np.digitize(table, bins=type_offsets) - 1  # [S, rows]
            flat = local_type + n_types * np.arange(n_shard)[:, None]
            type_counts = np.bincount(
                flat.reshape(-1), minlength=n_types * n_shard
            ).reshape(n_shard, n_types)
            type_offs = np.zeros_like(type_counts)
            type_offs[:, 1:] = np.cumsum(type_counts, axis=1)[:, :-1]
            # Padding IDs digitize into the last type bucket: remove them.
            type_counts[:, -1] -= pad_per_shard

        return cls(
            n_shard=n_shard,
            entity_to_shard=entity_to_shard,
            entity_to_idx=entity_to_idx,
            shard_and_idx_to_entity=table.astype(np.int32),
            shard_counts=shard_counts,
            entity_type_counts=type_counts,
            entity_type_offsets=type_offs,
        )

    def save(self, out_file: Path) -> None:
        """Serialize to ``.npz`` (None-valued optional fields are omitted)."""
        fields = {k: v for k, v in dataclasses.asdict(self).items() if v is not None}
        np.savez(out_file, **fields)

    @classmethod
    def load(cls, path: Path) -> "Sharding":
        """Load a sharding saved with :meth:`save`."""
        data = dict(np.load(path, allow_pickle=False))
        n_shard = int(data.pop("n_shard"))
        return cls(n_shard=n_shard, **data)


def _partition_triples(
    triples: NDArray[np.int32],
    sharding: Sharding,
    partition_mode: str,
) -> Tuple[NDArray[np.int32], NDArray[np.int64], NDArray[np.int64], NDArray[np.int64]]:
    """Sort triples into shard(-pair) buckets and localize sharded columns.

    Returns ``(sorted_triples, counts, offsets, sort_idx)`` where the sharded
    head/tail columns of ``sorted_triples`` hold LOCAL ids.
    Mirrors reference ``besskge/sharding.py:226-265``.
    """
    n_shard = sharding.n_shard
    if partition_mode == "h_shard":
        bucket = sharding.entity_to_shard[triples[:, 0]]
        counts = np.bincount(bucket, minlength=n_shard).astype(np.int64)
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    elif partition_mode == "t_shard":
        bucket = sharding.entity_to_shard[triples[:, 2]]
        counts = np.bincount(bucket, minlength=n_shard).astype(np.int64)
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    elif partition_mode == "ht_shardpair":
        sh = sharding.entity_to_shard[triples[:, 0]]
        st = sharding.entity_to_shard[triples[:, 2]]
        bucket = sh * n_shard + st
        counts = (
            np.bincount(bucket, minlength=n_shard * n_shard)
            .reshape(n_shard, n_shard)
            .astype(np.int64)
        )
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).reshape(
            n_shard, n_shard
        )
    else:
        raise ValueError(f"Unsupported partition mode: {partition_mode}")

    sort_idx = np.argsort(bucket, kind="stable")
    out = triples[sort_idx].copy()
    if partition_mode in ("h_shard", "ht_shardpair"):
        out[:, 0] = sharding.entity_to_idx[out[:, 0]]
    if partition_mode in ("t_shard", "ht_shardpair"):
        out[:, 2] = sharding.entity_to_idx[out[:, 2]]
    return out, counts, offsets, sort_idx


@dataclasses.dataclass
class PartitionedTripleSet:
    """Triples sorted into shard / shard-pair partitions.

    ``partition_mode``:
      * ``"h_shard"`` — one bucket per head shard (query completion (h,r,?)).
      * ``"t_shard"`` — one bucket per tail shard (query completion (?,r,t)).
      * ``"ht_shardpair"`` — ``n_shard**2`` buckets ordered
        ``(0,0), (0,1), ..., (n_shard-1, n_shard-1)`` — used for training.

    Sharded head/tail columns of :attr:`triples` hold local (on-shard) IDs;
    the other columns hold global IDs.
    """

    sharding: Sharding
    #: Whether inverse triples (t, r+n_rel, h) were appended.
    inverse_triples: bool
    partition_mode: str
    #: For query-derived sets: which column is a dummy ("head"/"tail"/"none").
    dummy: Optional[str]
    #: int32[n_triple, 3] — (h, r, t), sorted by partition.
    triples: NDArray[np.int32]
    #: int64[n_shard(, n_shard)] — triples per partition.
    triple_counts: NDArray[np.int64]
    #: int64[n_shard(, n_shard)] — start of each partition in `triples`.
    triple_offsets: NDArray[np.int64]
    #: int64[n_triple] — original position of each sorted triple.
    triple_sort_idx: NDArray[np.int64]
    #: int32[n_triple, 2] — head/tail type IDs (optional).
    types: Optional[NDArray[np.int32]] = None
    #: int32[n_triple or 1, n_neg] — global IDs of predefined negative heads.
    neg_heads: Optional[NDArray[np.int32]] = None
    #: int32[n_triple or 1, n_neg] — global IDs of predefined negative tails.
    neg_tails: Optional[NDArray[np.int32]] = None

    # Kept as a class member, as in the JAX package.
    partition_triples = staticmethod(_partition_triples)

    @classmethod
    def create_from_dataset(
        cls,
        dataset: KGDataset,
        part: str,
        sharding: Sharding,
        partition_mode: str = "ht_shardpair",
        add_inverse_triples: bool = False,
    ) -> "PartitionedTripleSet":
        """Partition one split of a :class:`KGDataset`.

        With ``add_inverse_triples``, every triple (h, r, t) is doubled by
        (t, r + n_relation_type, h); per-triple negative heads/tails are
        swapped accordingly (reference ``besskge/sharding.py:267-376``).
        """
        triples = dataset.triples[part]
        n_orig = triples.shape[0]
        if add_inverse_triples:
            inv = triples[:, ::-1].copy()
            inv[:, 1] += dataset.n_relation_type
            triples = np.concatenate([triples, inv], axis=0)

        sorted_triples, counts, offsets, sort_idx = _partition_triples(
            triples, sharding, partition_mode
        )

        types = None
        ht_types = dataset.ht_types
        if ht_types and part in ht_types:
            types = ht_types[part]
            if add_inverse_triples:
                types = np.concatenate([types, types[:, ::-1]], axis=0)
            types = types[sort_idx]

        neg_h = dataset.neg_heads.get(part) if dataset.neg_heads else None
        neg_t = dataset.neg_tails.get(part) if dataset.neg_tails else None
        if add_inverse_triples and (neg_h is None) != (neg_t is None):
            raise ValueError(
                "Inverse triples require both or neither of negative heads"
                f" and tails for part '{part}'"
            )
        if neg_h is not None:
            neg_h = neg_h.reshape(-1, neg_h.shape[-1])
        if neg_t is not None:
            neg_t = neg_t.reshape(-1, neg_t.shape[-1])
        if add_inverse_triples and neg_h is not None and neg_t is not None:
            n_neg = neg_h.shape[-1]
            h_broad = np.broadcast_to(neg_h, (n_orig, n_neg))
            t_broad = np.broadcast_to(neg_t, (n_orig, n_neg))
            # Corrupting the head of an inverse triple corrupts the original
            # tail, so the candidate sets swap roles on the inverse half.
            neg_h = np.concatenate([h_broad, t_broad], axis=0)
            neg_t = np.concatenate([t_broad, h_broad], axis=0)
        if neg_h is not None and neg_h.shape[0] != 1:
            neg_h = neg_h[sort_idx]
        if neg_t is not None and neg_t.shape[0] != 1:
            neg_t = neg_t[sort_idx]

        return cls(
            sharding=sharding,
            inverse_triples=add_inverse_triples,
            partition_mode=partition_mode,
            dummy="none",
            triples=sorted_triples,
            triple_counts=counts,
            triple_offsets=offsets,
            triple_sort_idx=sort_idx,
            types=types,
            neg_heads=neg_h,
            neg_tails=neg_t,
        )

    @classmethod
    def create_from_queries(
        cls,
        dataset: KGDataset,
        sharding: Sharding,
        queries: NDArray[np.int32],
        query_mode: str,
        ground_truth: Optional[NDArray[np.int32]] = None,
        negative: Optional[NDArray[np.int32]] = None,
        negative_type: Optional[str] = None,
    ) -> "PartitionedTripleSet":
        """Partition a set of (h,r,?) / (?,r,t) queries.

        Queries are completed to triples with the ground truth (if given) or a
        dummy entity, then partitioned by the shard of the known entity.
        ``negative`` restricts the candidate completions (global IDs, shared
        N=1 or per-query N=n_query); ``negative_type`` restricts candidates to
        one entity type. Mirrors reference ``besskge/sharding.py:378-511``.
        """
        import warnings

        n_query = queries.shape[0]

        type_range = None
        if negative_type is not None:
            if not dataset.type_offsets or negative_type not in dataset.type_offsets:
                raise ValueError(
                    f"'{negative_type}' is not an entity type of the dataset"
                )
            starts = list(dataset.type_offsets.values())
            labels = list(dataset.type_offsets.keys())
            ends = starts[1:] + [dataset.n_entity]
            i = labels.index(negative_type)
            type_range = (starts[i], ends[i])
            if negative is not None and (
                np.any(negative < type_range[0]) or np.any(negative >= type_range[1])
            ):
                warnings.warn(
                    "Provided negative entities are not all of the requested"
                    " negative_type"
                )

        if ground_truth is not None:
            fill = ground_truth.reshape(n_query, 1)
        else:
            fill = np.full(
                (n_query, 1), type_range[0] if type_range else 0, dtype=queries.dtype
            )

        if negative is not None:
            negative = negative.reshape(-1, negative.shape[-1])
        elif type_range is not None:
            negative = np.arange(type_range[0], type_range[1])[None]
        else:
            negative = np.arange(sharding.n_entity)[None]

        if query_mode == "hr":
            triples = np.concatenate([queries, fill], axis=-1)
            partition_mode = "h_shard"
            dummy = "tail" if ground_truth is None else None
            neg_heads, neg_tails = None, negative
        elif query_mode == "rt":
            triples = np.concatenate([fill, queries], axis=-1)
            partition_mode = "t_shard"
            dummy = "head" if ground_truth is None else None
            neg_heads, neg_tails = negative, None
        else:
            raise ValueError(f"Unsupported query mode: {query_mode}")

        sorted_triples, counts, offsets, sort_idx = _partition_triples(
            triples, sharding, partition_mode
        )

        types = None
        if negative_type is not None:
            bins = np.fromiter(dataset.type_offsets.values(), dtype=np.int32)
            types = (np.digitize(sorted_triples[:, [0, 2]], bins) - 1).astype(np.int32)

        if neg_heads is not None and neg_heads.shape[0] != 1:
            neg_heads = neg_heads[sort_idx]
        if neg_tails is not None and neg_tails.shape[0] != 1:
            neg_tails = neg_tails[sort_idx]

        return cls(
            sharding=sharding,
            inverse_triples=False,
            partition_mode=partition_mode,
            dummy=dummy,
            triples=sorted_triples,
            triple_counts=counts,
            triple_offsets=offsets,
            triple_sort_idx=sort_idx,
            types=types,
            neg_heads=neg_heads,
            neg_tails=neg_tails,
        )
