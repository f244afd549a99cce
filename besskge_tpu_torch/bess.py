"""BESS modules (torch): training and evaluation forwards, top-k serving and
all-scores inference, on one device or over a mesh of ranks.

Counterpart of ``besskge_tpu/bess.py``:

* :class:`BessKGE` scores one micro-batch of positives against their
  negatives and returns the loss, the scores and, with an ``evaluation``,
  ranks and metrics. :class:`EmbeddingMovingBessKGE` scores the negatives
  where the queries are (the training forward,
  :func:`besskge_tpu_torch.trainer.build_train_step`);
  :class:`ScoreMovingBessKGE` where the negatives are, with the positives of
  the home-scored halves riding back in an extra score column (candidate-set
  evaluation); :func:`build_bess_forward` runs either over the
  ``(bps, n_shard, ...)`` batches of the batch sampler, its micro-batches
  fused with ``torch.func.vmap``;
* :class:`TopKQueryBessKGE` completes (h, r, ?) / (?, r, t) queries against
  every entity, or against candidate sets, by sliding a window over the
  local entity table (or the candidates), keeping a running top-(k+1), and
  :func:`build_topk_forward` runs it over the batches;
* :class:`AllScoresBESS` scores queries against one window of the entity
  table, and :func:`build_allscores_forward` runs it over the batches
  (:class:`besskge_tpu_torch.pipeline.AllScoresPipeline` stitches the
  windows).

With ``axis_name=None`` (one device, ``n_shard == 1``) every collective is
the identity. With ``axis_name="shard"`` a module runs on each rank of a
:class:`~besskge_tpu_torch.parallel.mesh.ShardMesh` (one process per
shard), bound to it by the functions that build its steps (``mesh=``): the
rank holds its block of the entity table and its column of each batch, and
the collectives of :mod:`besskge_tpu_torch.parallel.collectives` cross the
mesh, as ``shard_map`` runs the JAX package's modules. Over a mesh the micro-batches
of a step run one after another (collectives cannot sit under
``torch.func.vmap``), as the JAX package scans them. Every module runs over a
mesh: the two :class:`BessKGE` forms (training and
:func:`build_bess_forward`), :class:`TopKQueryBessKGE` and
:class:`AllScoresBESS`.

The entity table may be in any layout the optimizers keep: plain, pair- or
treble-major fp32, row-pair-packed 16-bit, or its triplet or quintuplet
store (:mod:`besskge_tpu_torch.packed`); every read of it goes through
``packed.take_rows``/``take_contiguous_rows``, and a window over a packed
table starts and ends on even rows (an odd window gathers).

For TransE with L1 scoring the default chunk merge scores each window with
one launch of the fused L1 kernel (scores + mask + 128-column chunk maxima,
:func:`besskge_tpu_torch.ops.distance.l1_scores_chunkmax`); the sort merge,
candidate sets shared by all queries and the all-scores windows score
through ``score_tails``/``score_heads`` and the L1 distance kernel. DistMult
and ComplEx score a window with one product. The scorers that broadcast each
query against the pool (``score_fn.broadcasts_pool``: PairRE, TripleRE,
BoxE, InterHT, TranS) would materialise (queries, window, row)
intermediates, which XLA fuses away and eager PyTorch does not: a top-k
window is scored in blocks of queries, each intermediate at most
:data:`BROADCAST_BUDGET` elements, with the same scores as one call.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from besskge_tpu_torch.device_sampler import _as_key, _fold_in, split_key
from besskge_tpu_torch.loss import BaseLossFunction
from besskge_tpu_torch.metric import Evaluation
from besskge_tpu_torch.negative_sampler import (
    PlaceholderNegativeSampler,
    ShardedNegativeSampler,
    TripleBasedShardedNegativeSampler,
)
from besskge_tpu_torch.ops.distance import l1_scores_chunkmax as ops_l1_scores_chunkmax
from besskge_tpu_torch.parallel import collectives
from besskge_tpu_torch.parallel.mesh import ShardMesh
from besskge_tpu_torch.packed import (
    is_packed,
    is_paired,
    is_quintupled,
    is_trebled,
    is_tripled,
    take_contiguous_rows,
    take_rows,
)
from besskge_tpu_torch.scoring import BaseScoreFunction, DistanceBasedScoreFunction
from besskge_tpu_torch.utils import gather_indices, resolve_device

__all__ = [
    "BAD_NEGATIVE_SCORE",
    "BessKGE",
    "EmbeddingMovingBessKGE",
    "ScoreMovingBessKGE",
    "TopKQueryBessKGE",
    "AllScoresBESS",
    "build_bess_forward",
    "build_topk_forward",
    "build_allscores_forward",
]

#: Sentinel added to masked-out negative scores (reference ``bess.py:31``).
BAD_NEGATIVE_SCORE = -50000.0
#: Column chunk of the hierarchical merge: one block of the fused L1 kernel.
CHUNK = 128
#: Elements of one broadcast intermediate of a top-k window, for a scorer
#: that broadcasts queries against the pool: 2^27 (512 MiB in fp32). BoxE
#: holds about ten at once; one unblocked 512-query window of 32768 rows at
#: d = 128 would take 8.6 GB (PairRE) to 17.2 GB (BoxE) per intermediate.
BROADCAST_BUDGET = 2**27


def _cast_gathered(emb: torch.Tensor, cd: Optional[torch.dtype]) -> torch.Tensor:
    """Cast gathered rows to the compute dtype (the table keeps its own)."""
    if cd is None or emb.dtype == cd:
        return emb
    return emb.to(cd)


def _row_cap(t_flat: torch.Tensor, n_rows: int) -> int:
    """Logical rows that a table of this layout backs: 2 per physical row of
    a packed table (2 per 3 in the triplet store, 2 per 5 in the quintuplet
    one), 1 per 2 or 3 of a pair- or treble-major one, else 1 per row."""
    if is_tripled(t_flat, n_rows):
        return 2 * (t_flat.shape[0] // 3)
    if is_quintupled(t_flat, n_rows):
        return 2 * (t_flat.shape[0] // 5)
    if is_packed(t_flat):
        return 2 * t_flat.shape[0]
    if is_paired(t_flat, n_rows):
        return t_flat.shape[0] // 2
    if is_trebled(t_flat, n_rows):
        return t_flat.shape[0] // 3
    return t_flat.shape[0]


class _Collectives:
    """The collectives of a module (``besskge_tpu/bess.py:164-180``): the
    identity with ``axis_name=None``, else over :attr:`mesh`, the mesh the
    functions that build the steps bind (:func:`_bind_mesh`)."""

    axis_name: Optional[str]
    mesh: Optional[ShardMesh] = None

    def _bound_mesh(self) -> ShardMesh:
        if self.mesh is None:
            raise RuntimeError(
                f"axis_name={self.axis_name!r}: build the module's step over its mesh"
                " (mesh=) before calling it"
            )
        return self.mesh

    def _all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        if self.axis_name is None:
            return x
        return collectives.all_to_all(x, self._bound_mesh())

    def _all_gather(self, x: torch.Tensor) -> torch.Tensor:
        if self.axis_name is None:
            return x[None]
        return collectives.all_gather(x, self._bound_mesh())

    def _rank(self) -> int:
        """This rank's shard index: 0 on one device (``jax.lax.axis_index``)."""
        return 0 if self.axis_name is None else self._bound_mesh().rank

    def psum(self, x: Any) -> Any:
        """Sum a (tree of) per-rank value(s) over the mesh."""
        if self.axis_name is None:
            return x
        return collectives.psum(x, self._bound_mesh())


def _check_axis(module: Any, axis_name: Optional[str]) -> None:
    if axis_name is None and module.sharding.n_shard != 1:
        raise ValueError("axis_name=None requires n_shard == 1")


def _bind_mesh(module: Any, mesh: Optional[ShardMesh]) -> None:
    """Bind ``module`` to ``mesh`` for its collectives (as ``shard_map``
    binds an axis name), or check that a module without a mesh needs none.
    A module and its score function are bound to one mesh: binding either
    to another raises, since the steps built before would move their
    collectives to the new group."""
    if mesh is None:
        if module.axis_name is not None:
            raise ValueError("A mesh is required unless axis_name is None")
        return
    if not isinstance(mesh, ShardMesh):
        raise TypeError(
            f"mesh must be a besskge_tpu_torch.parallel.ShardMesh, got {type(mesh).__name__}")
    if module.axis_name is None:
        raise ValueError("a module over a mesh needs axis_name='shard'")
    if module.sharding.n_shard != mesh.n_shard:
        raise ValueError(
            f"the sharding has {module.sharding.n_shard} shards, the mesh {mesh.n_shard} ranks")
    if module.mesh is not None and module.mesh is not mesh:
        raise ValueError("the module is bound to another mesh: build one module per mesh")
    if module.score_fn.mesh is not None and module.score_fn.mesh is not mesh:
        raise ValueError(
            "the score function is bound to another mesh: build one score function per mesh")
    module.mesh = mesh
    # The score function's own collectives (ConvE's SyncBN) run over it too.
    module.score_fn.mesh = mesh


class BessKGE(_Collectives, ABC):
    """Base class for BESS distribution modules (reference
    ``besskge/bess.py:34-305``).

    :param negative_sampler: sharded negative sampler (defines layouts).
    :param score_fn: scoring function (owns table shapes).
    :param loss_fn: loss, required for training.
    :param evaluation: metrics of each micro-batch (ranks of the positive
        among its negatives, computed without a gradient).
    :param return_scores: return positive/negative scores.
    :param augment_negative: use in-batch heads/tails as extra negatives.
    :param axis_name: ``None`` for one device (requires ``n_shard == 1``),
        or ``"shard"`` to run on each rank of a mesh.
    """

    def __init__(
        self,
        negative_sampler: ShardedNegativeSampler,
        score_fn: BaseScoreFunction,
        loss_fn: Optional[BaseLossFunction] = None,
        evaluation: Optional[Evaluation] = None,
        return_scores: bool = False,
        augment_negative: bool = False,
        axis_name: Optional[str] = None,
    ) -> None:
        self.sharding = score_fn.sharding
        self.negative_sampler = negative_sampler
        self.score_fn = score_fn
        self.loss_fn = loss_fn
        self.evaluation = evaluation
        self.return_scores = return_scores
        self.augment_negative = augment_negative
        self.axis_name = axis_name
        if not (loss_fn or evaluation or return_scores):
            raise ValueError(
                "Nothing to return. At least one of loss_fn, evaluation or"
                " return_scores needs to be != None"
            )
        if augment_negative:
            if not score_fn.negative_sample_sharing:
                raise ValueError("Negative augmentation requires negative sample sharing")
            if isinstance(self, ScoreMovingBessKGE):
                raise ValueError("ScoreMovingBessKGE does not support negative augmentation")
        if negative_sampler.flat_negative_format:
            if not score_fn.negative_sample_sharing:
                raise ValueError("Using flat negative format requires negative sample sharing")
        elif score_fn.negative_sample_sharing and isinstance(
            negative_sampler, TripleBasedShardedNegativeSampler
        ):
            raise ValueError(
                "Negative sample sharing cannot be used with non-flat triple-specific negatives"
            )
        _check_axis(self, axis_name)
        # Let the score function reach mesh collectives (ConvE's SyncBN).
        score_fn.mesh_axis = axis_name
        self.entity_embedding_size: int = score_fn.entity_row_size

    @property
    def n_embedding_parameters(self) -> int:
        """Trainable parameters in the (global) embedding tables."""
        sh = self.score_fn.sharding
        n_rel = self.score_fn.n_relation_type * (2 if self.score_fn.inverse_relations else 1)
        return int(
            sh.n_shard * sh.max_entity_per_shard * self.score_fn.entity_row_size
            + n_rel * self.score_fn.relation_row_size
        )

    def forward(
        self,
        params: Dict[str, torch.Tensor],
        head: torch.Tensor,
        relation: torch.Tensor,
        tail: torch.Tensor,
        negative: torch.Tensor,
        triple_mask: Optional[torch.Tensor] = None,
        triple_weight: Optional[torch.Tensor] = None,
        negative_mask: Optional[torch.Tensor] = None,
        train: bool = False,
        rng: Any = None,
        gathered_emb: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """One micro-batch: gather → score → loss/metrics (reference
        ``bess.py:117-276``). Free of data-dependent Python branches, so it
        runs under ``torch.func.vmap`` over micro-batches.

        ``params["entity_embedding"]`` is the local table (plain or
        interleaved); ``gathered_emb`` optionally supplies the gathered
        entity rows (see :meth:`gather_plan`). ``triple_mask`` masks the
        metrics (padding triples count 0).
        ``train`` and ``rng`` (a dropout key, as the device sampler's keys)
        go to every score call of the micro-batch: ConvE's BatchNorm takes
        batch statistics with ``train``, and its dropout draws from ``rng``
        (the positive's query gets the same masks in ``score_triple`` and in
        ``score_tails``, as in the JAX package); the other scorers ignore
        both.
        """
        if triple_weight is None:
            triple_weight = torch.ones((), dtype=torch.float32, device=relation.device)
        positive_score, negative_score = self.score_batch(
            params, head, relation, tail, negative, train=train, rng=rng,
            gathered_emb=gathered_emb
        )
        n_shard, ppp = relation.shape
        bs = n_shard * ppp
        device = negative_score.device
        flat_ht = (
            self.negative_sampler.flat_negative_format
            and self.negative_sampler.corruption_scheme == "ht"
        )

        mask_flat = None
        if negative_mask is not None:
            # (B, n_shard_src, pad) -> (B, n_shard_src * pad)
            mask_flat = negative_mask.reshape(negative_mask.shape[0], -1)
            if flat_ht:
                cut = ppp // 2
                width = mask_flat.shape[-1]
                mask_h = mask_flat[0][None, None, :].expand(n_shard, cut, width)
                mask_t = mask_flat[1][None, None, :].expand(n_shard, ppp - cut, width)
                mask_flat = torch.cat([mask_h, mask_t], dim=1).reshape(bs, width)

        if self.augment_negative:
            # Kill the score of each triple's own true head/tail, which was
            # prepended to the candidate pool (reference ``bess.py:207-238``).
            n_col = negative_score.shape[1]
            cols = torch.arange(n_col, dtype=torch.int64, device=device)[None, :]
            rows = torch.arange(bs, dtype=torch.int64, device=device)
            if self.negative_sampler.flat_negative_format:
                if flat_ht:
                    cut = ppp // 2
                    target = (rows // ppp) * cut + (rows % ppp) % cut
                else:
                    target = rows
            else:
                target = rows * (1 + negative.shape[0] * negative.shape[2])
            aug_mask = cols == target[:, None]
            if mask_flat is not None:
                width = mask_flat.shape[-1]
                aug_mask = torch.cat([aug_mask[:, : n_col - width], ~mask_flat], dim=1)
            negative_score = negative_score + BAD_NEGATIVE_SCORE * aug_mask.to(
                negative_score.dtype
            )
        elif mask_flat is not None:
            negative_score = negative_score + BAD_NEGATIVE_SCORE * (~mask_flat).to(
                negative_score.dtype
            )

        out: Dict[str, torch.Tensor] = {}
        if self.return_scores:
            out["positive_score"] = positive_score
            out["negative_score"] = negative_score
        if self.loss_fn is not None:
            out["loss"] = self.loss_fn(
                positive_score.float(), negative_score.float(), triple_weight.float()
            )
        if self.evaluation is not None:
            t_mask = triple_mask.reshape(-1) if triple_mask is not None else None
            # Ranks take no gradient (the JAX package's stop_gradient).
            ranks = self.evaluation.ranks_from_scores(
                positive_score.detach(), negative_score.detach()
            )
            if self.evaluation.return_ranks:
                out["ranks"] = ranks
            out["metrics"] = self.evaluation.stacked_metrics_from_ranks(ranks, t_mask)
        return out

    @abstractmethod
    def score_batch(
        self,
        params: Dict[str, torch.Tensor],
        head: torch.Tensor,
        relation: torch.Tensor,
        tail: torch.Tensor,
        negative: torch.Tensor,
        train: bool = False,
        rng: Any = None,
        gathered_emb: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Positive (bs,) and negative (bs, n_neg_total) scores for the
        micro-batch."""
        raise NotImplementedError

    def gather_plan(
        self, head: torch.Tensor, tail: torch.Tensor, negative: torch.Tensor
    ) -> torch.Tensor:
        """Local row indices gathered by :meth:`score_batch`, shape (S, G)."""
        return torch.cat([head, tail, negative.reshape(negative.shape[0], -1)], dim=1)


class EmbeddingMovingBessKGE(BessKGE):
    """Score negatives on the head (processing) shard: one fused local gather
    of [head | tail | negative] rows, one AllToAll moving the tail and
    negative rows (reference ``besskge/bess.py:308-468``), the identity on
    one device."""

    def score_batch(self, params, head, relation, tail, negative, train=False, rng=None,
                    gathered_emb=None):
        n_shard, ppp = relation.shape
        bs = n_shard * ppp
        d = self.entity_embedding_size
        scheme = self.negative_sampler.corruption_scheme
        flat = self.negative_sampler.flat_negative_format
        b_neg, n_neg = negative.shape[1], negative.shape[2]

        if gathered_emb is None:
            gathered_emb = take_rows(
                params["entity_embedding"],
                self.gather_plan(head, tail, negative),
                n_logical=self.sharding.max_entity_per_shard,
            )
        emb = _cast_gathered(gathered_emb, self.score_fn.compute_dtype)
        head_emb = emb[:, :ppp]
        tail_and_neg = emb[:, ppp:]
        # One AllToAll over the shard axis (JAX package ``bess.py:358-365``).
        if self.negative_sampler.local_sampling:
            tail_emb = self._all_to_all(tail_and_neg[:, :ppp])
            neg_emb = tail_and_neg[:, ppp:]
        else:
            moved = self._all_to_all(tail_and_neg)
            tail_emb = moved[:, :ppp]
            neg_emb = moved[:, ppp:]
        # (S, B, n_neg, d) -> (B, S * n_neg, d): source-shard-major pool.
        neg_emb = (
            neg_emb.reshape(n_shard, b_neg, n_neg, d)
            .permute(1, 0, 2, 3)
            .reshape(b_neg, n_shard * n_neg, d)
        )

        kw = {"train": train, "rng": rng}
        positive_score = self.score_fn.score_triple(
            params, head_emb.reshape(bs, d), relation.reshape(bs), tail_emb.reshape(bs, d), **kw
        )

        if scheme == "h":
            if self.augment_negative:
                neg_emb = torch.cat([head_emb.reshape(neg_emb.shape[0], -1, d), neg_emb], dim=1)
            negative_score = self.score_fn.score_heads(
                params, neg_emb, relation.reshape(bs), tail_emb.reshape(bs, d), **kw
            )
        elif scheme == "t":
            if self.augment_negative:
                neg_emb = torch.cat([tail_emb.reshape(neg_emb.shape[0], -1, d), neg_emb], dim=1)
            negative_score = self.score_fn.score_tails(
                params, head_emb.reshape(bs, d), relation.reshape(bs), neg_emb, **kw
            )
        elif scheme == "ht":
            # First half of each partition: head-corrupted; second: tail-
            # corrupted (reference ``bess.py:400-466``).
            cut = ppp // 2
            rel1 = relation[:, :cut].reshape(-1)
            rel2 = relation[:, cut:].reshape(-1)
            h1, h2 = head_emb[:, :cut], head_emb[:, cut:]
            t1, t2 = tail_emb[:, :cut], tail_emb[:, cut:]
            if flat:
                neg_h, neg_t = neg_emb[0:1], neg_emb[1:2]
            else:
                ne = neg_emb.reshape(n_shard, ppp, -1, d)
                neg_h = ne[:, :cut].reshape(n_shard * cut, -1, d)
                neg_t = ne[:, cut:].reshape(n_shard * (ppp - cut), -1, d)
            if self.augment_negative:
                neg_h = torch.cat([h1.reshape(neg_h.shape[0], -1, d), neg_h], dim=1)
                neg_t = torch.cat([t2.reshape(neg_t.shape[0], -1, d), neg_t], dim=1)
            ns_h = self.score_fn.score_heads(params, neg_h, rel1, t1.reshape(-1, d), **kw)
            ns_t = self.score_fn.score_tails(params, h2.reshape(-1, d), rel2, neg_t, **kw)
            negative_score = torch.cat(
                [ns_h.reshape(n_shard, cut, -1), ns_t.reshape(n_shard, ppp - cut, -1)],
                dim=1,
            ).reshape(bs, -1)
        else:
            raise ValueError(f"Unsupported corruption scheme {scheme}")

        return positive_score, negative_score


class ScoreMovingBessKGE(BessKGE):
    """Score negatives on the shard that stores them: queries are replicated
    with AllGathers, each shard scores its local negatives against all
    queries, and an AllToAll returns the scores (reference
    ``besskge/bess.py:471-603``). The arithmetic is the JAX package's: the
    positives that it scores on the tail's home shard ("t", and the
    tail-corrupted half of "ht") are packed into a trailing column of the
    score block at this rank's rows, go through the AllToAll with it and
    are summed back out of it, so they are cast to the scores' dtype on the
    way, as there. On one device every collective is the identity and the
    rank is 0. The gathered rows' gradients come back through the
    AllGathers' backward (a reduce-scatter). No local sampling or
    augmentation.
    """

    def score_batch(self, params, head, relation, tail, negative, train=False, rng=None,
                    gathered_emb=None):
        n_shard, ppp = relation.shape
        bs = n_shard * ppp
        d = self.entity_embedding_size
        scheme = self.negative_sampler.corruption_scheme
        flat = self.negative_sampler.flat_negative_format
        b_neg, n_neg = negative.shape[1], negative.shape[2]

        if gathered_emb is None:
            gathered_emb = take_rows(
                params["entity_embedding"],
                self.gather_plan(head, tail, negative),
                n_logical=self.sharding.max_entity_per_shard,
            )
        emb = _cast_gathered(gathered_emb, self.score_fn.compute_dtype)
        head_emb = emb[:, :ppp]
        tail_emb = emb[:, ppp : 2 * ppp]
        neg_emb = emb[:, 2 * ppp :].reshape(n_shard, b_neg, n_neg, d)
        if isinstance(self.negative_sampler, TripleBasedShardedNegativeSampler) and flat:
            # Candidate sets are replicated along the destination axis;
            # score one copy only.
            neg_emb = neg_emb[0:1]

        relation_all = self._all_gather(relation)  # (S_q, S, ppp)
        my = self._rank()
        kw = {"train": train, "rng": rng}
        pos_local = None
        pos_col = None

        def home_pos_column(pos_home, col_offset, col_width):
            """Home-shard positives (S_dest, col_width) in the (S_dest, bs, 1)
            ride-along column, at this rank's block (rows ``my · ppp +
            col_offset`` on)."""
            zeros = pos_home.new_zeros
            start = my * ppp + col_offset
            return torch.cat([
                zeros((n_shard, start, 1)),
                pos_home.reshape(n_shard, col_width, 1),
                zeros((n_shard, bs - start - col_width, 1)),
            ], dim=1)

        if scheme == "h":
            # Tails are host-pre-transposed: the gathered axis is the tails'
            # home shard; swap to (query shard, home shard, ...) order.
            tail_all = self._all_gather(tail_emb).transpose(0, 1)
            negative_score = self.score_fn.score_heads(
                params, neg_emb.reshape(-1, n_neg, d), relation_all.reshape(-1),
                tail_all.reshape(-1, d), **kw
            )
            # This rank's own tails sit at row ``my`` of the gathered tensor.
            pos_local = self.score_fn.score_triple(
                params, head_emb.reshape(bs, d), relation.reshape(bs),
                tail_all[my].reshape(bs, d), **kw
            )
        elif scheme == "t":
            head_all = self._all_gather(head_emb)  # (S_q, S_home, ppp, d)
            negative_score = self.score_fn.score_tails(
                params, head_all.reshape(-1, d), relation_all.reshape(-1),
                neg_emb.reshape(-1, n_neg, d), **kw
            )
            # Tails of every query rank's block ``my`` live here; their heads
            # and relations arrived with the AllGathers.
            pos_home = self.score_fn.score_triple(
                params, head_all[:, my].reshape(bs, d), relation_all[:, my].reshape(bs),
                tail_emb.reshape(bs, d), **kw
            )
            pos_col = home_pos_column(pos_home.reshape(n_shard, ppp), 0, ppp)
        elif scheme == "ht":
            cut = ppp // 2
            rel1 = relation_all[:, :, :cut].reshape(-1)
            rel2 = relation_all[:, :, cut:].reshape(-1)
            tail_all = self._all_gather(tail_emb[:, :cut]).transpose(0, 1)  # (S_q, S_home, cut, d)
            head_all = self._all_gather(head_emb[:, cut:])  # (S_q, S_home, ppp - cut, d)
            if flat:
                neg_h = neg_emb[:, 0]
                neg_t = neg_emb[:, 1]
            else:
                ne = neg_emb.reshape(n_shard, n_shard, ppp, n_neg, d)
                neg_h = ne[:, :, :cut].reshape(-1, n_neg, d)
                neg_t = ne[:, :, cut:].reshape(-1, n_neg, d)
            ns_h = self.score_fn.score_heads(params, neg_h, rel1, tail_all.reshape(-1, d), **kw)
            ns_t = self.score_fn.score_tails(params, head_all.reshape(-1, d), rel2, neg_t, **kw)
            negative_score = torch.cat([
                ns_h.reshape(n_shard, n_shard, cut, -1),
                ns_t.reshape(n_shard, n_shard, ppp - cut, -1),
            ], dim=2).reshape(n_shard * bs, -1)
            # Head-corrupted half: own tails are in the gathered tensor.
            pos_local = self.score_fn.score_triple(
                params, head_emb[:, :cut].reshape(-1, d), relation[:, :cut].reshape(-1),
                tail_all[my].reshape(-1, d), **kw
            ).reshape(n_shard, cut)
            # Tail-corrupted half: scored here (the tails' home), shipped back.
            pos_home = self.score_fn.score_triple(
                params, head_all[:, my].reshape(-1, d), relation_all[:, my][:, cut:].reshape(-1),
                tail_emb[:, cut:].reshape(-1, d), **kw
            )
            pos_col = home_pos_column(pos_home.reshape(n_shard, ppp - cut), cut, ppp - cut)
        else:
            raise ValueError(f"Unsupported corruption scheme {scheme}")

        # Scores back to the queries' rank (source-shard-major columns), the
        # home-scored positives in a trailing column.
        negative_score = negative_score.reshape(n_shard, bs, -1)
        if pos_col is not None:
            negative_score = torch.cat([negative_score, pos_col.to(negative_score.dtype)], dim=2)
        negative_score = self._all_to_all(negative_score).transpose(0, 1)  # (bs, S_src, .)
        if pos_col is not None:
            # Each row's column is zero except at its tail's home shard.
            pos_recv = negative_score[..., -1].sum(dim=1)  # (bs,)
            negative_score = negative_score[..., :-1]
        negative_score = negative_score.reshape(bs, -1)

        if scheme == "h":
            positive_score = pos_local
        elif scheme == "t":
            positive_score = pos_recv
        else:  # "ht": the local head half and the received tail half
            positive_score = torch.cat(
                [pos_local, pos_recv.reshape(n_shard, ppp)[:, cut:].to(pos_local.dtype)], dim=1
            ).reshape(bs)
        return positive_score, negative_score


class TopKQueryBessKGE(_Collectives):
    """Top-k completion of (h, r, ?) / (?, r, t) queries against all
    entities or candidate sets (reference ``besskge/bess.py:606-921``).
    Inference only. Over a mesh the queries of every rank are gathered (two
    AllGathers: relations and known rows), each rank slides its window over
    its own block of the table, and two AllToAlls send each query's
    per-shard bests home, where they are merged.

    :param k: number of completions to return per query.
    :param candidate_sampler: :class:`PlaceholderNegativeSampler` to score
        against every entity, or a :class:`TripleBasedShardedNegativeSampler`
        with ``mask_on_gather=True`` for candidate sets (shared by all
        queries, ``N == 1``, with sample sharing; one per query without).
    :param score_fn: scoring function.
    :param evaluation: optional metrics (needs ground truth).
    :param return_scores: return the top-k scores too.
    :param window_size: entities scored per query per loop iteration, or
        ``None`` (default) to auto-size as the JAX package does:
        ``min(cap, local rows)`` rounded down to a 128-multiple, with
        ``cap`` 131072 for pure-cdist L1 models with sample sharing (TransE
        and RotatE: the fused window path) and 32768 for every other
        scorer. Over candidate sets the window is clamped to the candidate
        width rounded up to 128.
    :param merge_mode: ``"sort"`` takes the top-(k+1) of the whole window
        plus the running best; ``"chunk"`` first keeps only the k+1
        128-column chunks with the largest maxima (exact: a chunk holding a
        true top-(k+1) element has a maximum at least as large). ``"auto"``
        (default) picks ``"chunk"`` whenever the window is 128-divisible
        and wider than ``128·(k+1)``. Tied scores may resolve to different,
        equally ranked entity IDs in the two modes.
    :param axis_name: see :class:`BessKGE`.
    """

    def __init__(
        self,
        k: int,
        candidate_sampler: ShardedNegativeSampler,
        score_fn: BaseScoreFunction,
        evaluation: Optional[Evaluation] = None,
        return_scores: bool = False,
        window_size: Optional[int] = None,
        merge_mode: str = "auto",
        axis_name: Optional[str] = None,
    ) -> None:
        self.sharding = score_fn.sharding
        self.axis_name = axis_name
        _check_axis(self, axis_name)
        self.negative_sampler = candidate_sampler
        self.score_fn = score_fn
        self.evaluation = evaluation
        self.return_scores = return_scores
        self.k = k
        if window_size is None:
            rows = self.sharding.max_entity_per_shard
            fused_l1 = (
                getattr(score_fn, "scoring_norm", None) == 1
                and score_fn.negative_sample_sharing
                and type(score_fn).distance_query_vector
                is not DistanceBasedScoreFunction.distance_query_vector
            )
            cap = 131072 if fused_l1 else 32768
            window_size = max(min(cap, rows) // CHUNK * CHUNK, min(rows, CHUNK))
        self.window_size = window_size
        if merge_mode not in ("auto", "sort", "chunk"):
            raise ValueError(f"Unknown merge_mode {merge_mode!r}")
        self.merge_mode = merge_mode
        if candidate_sampler.flat_negative_format:
            if not score_fn.negative_sample_sharing:
                raise ValueError(
                    "Using flat negative format requires negative sample sharing"
                )
        elif score_fn.negative_sample_sharing:
            raise ValueError(
                "Negative sample sharing cannot be used with non-flat"
                " triple-specific negatives"
            )
        if candidate_sampler.corruption_scheme not in ("h", "t"):
            raise ValueError(
                "TopKQueryBessKGE only supports 'h', 't' corruption scheme"
            )
        if isinstance(candidate_sampler, TripleBasedShardedNegativeSampler):
            if not candidate_sampler.mask_on_gather:
                raise ValueError(
                    "TopKQueryBessKGE requires mask_on_gather=True in the"
                    " candidate_sampler"
                )
        self.entity_embedding_size = score_fn.entity_row_size
        self._maps: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def forward(
        self,
        params: Dict[str, torch.Tensor],
        relation: torch.Tensor,
        head: Optional[torch.Tensor] = None,
        tail: Optional[torch.Tensor] = None,
        negative: Optional[torch.Tensor] = None,
        triple_mask: Optional[torch.Tensor] = None,
        negative_mask: Optional[torch.Tensor] = None,
        train: bool = False,
        rng: Any = None,
    ) -> Dict[str, torch.Tensor]:
        """Top-k of one micro-batch of queries.

        :param relation: (shard_bs,) relation IDs of this rank's queries.
        :param head/tail: (shard_bs,) local ID of the known entity; the other
            is the ground truth (global IDs) or absent.
        :param negative: (n_shard_dest, B, pad) local candidate IDs (the
            gathering layout), or ``None`` to score every local entity.
        :param triple_mask: (shard_bs,) real (non-padding) queries.
        :param negative_mask: (n_shard_dest, B, pad) real candidates.
        :param train: accepted and unused, as ``rng``: the windows score
            with ``train=False`` (ConvE's BatchNorm on its running stats, no
            dropout), as the JAX package's.
        """
        sharding = self.sharding
        n_shard = sharding.n_shard
        n_rows = sharding.max_entity_per_shard
        table = params["entity_embedding"]
        t_flat = table[0] if table.dim() == 3 else table
        device = t_flat.device
        shard_bs = relation.shape[0]
        n_best = self.k + 1
        scheme = self.negative_sampler.corruption_scheme
        window = self.window_size

        candidate = mask_rows = None
        if negative is None:
            n_candidate = n_rows
        else:
            if negative_mask is None:
                raise ValueError("Candidate sets require a negative_mask")
            if self.negative_sampler.flat_negative_format:
                negative, negative_mask = negative[0], negative_mask[0]
            candidate = negative.reshape(-1, negative.shape[-1]).long()
            mask_rows = negative_mask.reshape(-1, negative_mask.shape[-1])
            n_candidate = candidate.shape[-1]
            # Candidate sets are far narrower than the all-entities window:
            # each iteration gathers and scores only real candidates.
            window = min(window, max(-(-n_candidate // CHUNK) * CHUNK, 1))

        # Every rank's queries (the identity on one device).
        relation = self._all_gather(relation).reshape(-1)
        known = self._all_gather(take_rows(table, tail if scheme == "h" else head, n_rows))
        cd = self.score_fn.compute_dtype
        known = _cast_gathered(known.reshape(-1, self.entity_embedding_size), cd)

        # All-entities mode slides over contiguous local rows. The final
        # window clamps its start to stay in range; rows it re-reads from the
        # previous window are masked invalid (idx < i*W), so the merge never
        # sees an entity twice. Candidate sets, a window wider than the
        # table, or an odd window over a packed table (whose windows start
        # and end on packed rows) gather instead.
        row_cap = _row_cap(t_flat, n_rows)
        contiguous = (
            candidate is None and window <= row_cap and not (is_packed(t_flat) and window % 2)
        )
        n_chunk = window // CHUNK
        use_chunk_merge = (
            self.merge_mode in ("auto", "chunk")
            and window % CHUNK == 0
            and n_chunk > n_best
        )
        fused_query = None
        if (use_chunk_merge and contiguous and self.score_fn.negative_sample_sharing
                and getattr(self.score_fn, "scoring_norm", None) == 1):
            fused_query = self.score_fn.distance_query_vector(params, known, relation, scheme)
            if fused_query is not None and cd is not None:
                fused_query = fused_query.to(cd)

        def merge(
            score: torch.Tensor, idx: torch.Tensor, chunk_max: Optional[torch.Tensor],
            best: Tuple[torch.Tensor, torch.Tensor],
        ) -> Tuple[torch.Tensor, torch.Tensor]:
            curr_score, curr_idx = best
            idx = idx.expand_as(score)  # a view where the window's IDs are shared
            if use_chunk_merge:
                rows = score.shape[0]
                s3 = score.reshape(rows, n_chunk, CHUNK)
                i3 = idx.reshape(rows, n_chunk, CHUNK)
                if chunk_max is None:
                    chunk_max = s3.amax(-1)
                chunk_pos = torch.topk(chunk_max, n_best, dim=1).indices
                pick = chunk_pos[:, :, None].expand(rows, n_best, CHUNK)
                score = torch.gather(s3, 1, pick).reshape(rows, n_best * CHUNK)
                idx = torch.gather(i3, 1, pick).reshape(rows, n_best * CHUNK)
            merged = torch.cat([score, curr_score], dim=1)
            top_scores, top_pos = torch.topk(merged, n_best, dim=1)
            # IDs of the winners without concatenating a (rows, W) ID tensor.
            width = score.shape[1]
            from_window = torch.gather(idx, 1, top_pos.clamp(max=width - 1))
            from_best = torch.gather(curr_idx, 1, (top_pos - width).clamp(min=0))
            return top_scores, torch.where(top_pos < width, from_window, from_best)

        best = (
            torch.full((n_shard * shard_bs, n_best), BAD_NEGATIVE_SCORE, dtype=torch.float32,
                       device=device),
            torch.full((n_shard * shard_bs, n_best), n_rows, dtype=torch.int64, device=device),
        )
        positions = torch.arange(window, dtype=torch.int64, device=device)
        for i in range(-(-n_candidate // window)):
            if contiguous:
                start = min(i * window, row_cap - window)
                idx = (start + positions)[None]
                valid = (idx >= i * window) & (idx < n_candidate)
                rows = take_contiguous_rows(table, start, window, n_rows)
                if fused_query is not None:
                    score, chunk_max = ops_l1_scores_chunkmax(
                        fused_query, _cast_gathered(rows, cd), valid[0],
                        chunk=CHUNK, bad=BAD_NEGATIVE_SCORE,
                    )
                    best = merge(score, idx, chunk_max, best)
                    continue
                rows = rows[None]
            else:
                slide = (i * window + positions)[None]
                valid = slide < n_candidate
                slide = torch.where(valid, slide, n_candidate - 1)
                if candidate is None:
                    idx = slide
                else:
                    # (1 or queries, window) candidates of this iteration
                    valid = valid & gather_indices(mask_rows, slide)
                    idx = gather_indices(candidate, slide)
                rows = take_rows(table, idx, n_rows)
            emb = _cast_gathered(rows, cd)
            score = self._score_window(params, relation, known, emb, scheme)
            # fp32 merge regardless of the score dtype.
            score = score.to(torch.float32) + BAD_NEGATIVE_SCORE * (~valid).to(torch.float32)
            best = merge(score, idx, None, best)
        best_score, best_idx = best

        # Each query's per-shard bests back to its home rank (source-shard
        # major).
        best_score = self._all_to_all(best_score.reshape(n_shard, shard_bs, n_best))
        best_idx = self._all_to_all(best_idx.reshape(n_shard, shard_bs, n_best))
        # Kill padding-entity scores (per source shard).
        counts, s2e = self._sharding_maps(device)
        best_score = best_score + BAD_NEGATIVE_SCORE * (best_idx >= counts).to(best_score.dtype)
        # Local -> global IDs through the sharding map.
        safe_idx = torch.clamp(best_idx, max=n_rows - 1)
        best_global = gather_indices(s2e, safe_idx.reshape(n_shard, -1)).reshape(
            n_shard, shard_bs, n_best)
        best_global = best_global.transpose(0, 1).reshape(shard_bs, -1)

        final_scores, final_pos = torch.topk(
            best_score.transpose(0, 1).reshape(shard_bs, -1), self.k, dim=1
        )
        topk_global_id = torch.gather(best_global, 1, final_pos).to(torch.int32)

        out: Dict[str, torch.Tensor] = {"topk_global_id": topk_global_id}
        if self.return_scores:
            out["topk_scores"] = final_scores
        if self.evaluation is not None:
            ground_truth = tail if scheme == "t" else head
            if ground_truth is None:
                raise ValueError("Evaluation requires providing ground truth entities")
            ranks = self.evaluation.ranks_from_indices(ground_truth, topk_global_id)
            if self.evaluation.return_ranks:
                out["ranks"] = ranks
            out["metrics"] = self.evaluation.stacked_metrics_from_ranks(ranks, triple_mask)
        return out

    def _sharding_maps(self, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The shard row counts (n_shard, 1, 1) and the local -> global ID map
        on ``device``, copied there once (the map has a row per entity:
        10 MB at wikikg2's 2.5M, whose copy from pageable host memory would
        otherwise wait on the device at every micro-batch)."""
        if device not in self._maps:
            self._maps[device] = (
                torch.as_tensor(self.sharding.shard_counts, device=device)[:, None, None],
                torch.as_tensor(self.sharding.shard_and_idx_to_entity, device=device),
            )
        return self._maps[device]

    def _score_window(
        self, params: Dict[str, torch.Tensor], relation: torch.Tensor, known: torch.Tensor,
        emb: torch.Tensor, scheme: str,
    ) -> torch.Tensor:
        """(queries, window) scores of the window's rows ``emb``: (1, W, row)
        shared by all queries, or (queries, W, row), one set per query. One
        call, or, for a scorer that broadcasts queries against the pool, one
        call per block of at most ``BROADCAST_BUDGET // (W · row)`` queries.
        Each (query, candidate) score is computed on its own, so the blocks
        give the scores of one call."""
        n_query = relation.shape[0]
        block = n_query
        if self.score_fn.broadcasts_pool:
            block = max(1, BROADCAST_BUDGET // (emb.shape[1] * self.entity_embedding_size))
        parts = []
        for q in range(0, n_query, block):
            rel, kn = relation[q : q + block], known[q : q + block]
            emb_q = emb[q : q + block] if emb.shape[0] > 1 else emb
            if scheme == "h":
                parts.append(self.score_fn.score_heads(params, emb_q, rel, kn, train=False))
            else:
                parts.append(self.score_fn.score_tails(params, kn, rel, emb_q, train=False))
        return parts[0] if len(parts) == 1 else torch.cat(parts)


class AllScoresBESS(_Collectives):
    """Scores of (h, r, ?) / (?, r, t) queries against one window of every
    shard's entities (reference ``besskge/bess.py:924-1062``);
    :class:`besskge_tpu_torch.pipeline.AllScoresPipeline` stitches the
    windows into the full score matrix. Inference only. Over a mesh the
    queries' relations and known rows are all-gathered, each rank scores
    every rank's queries against its window of its block, and one
    all-to-all of the ``(n_shard, shard_bs, window)`` scores returns each
    query's row of every shard's window.

    :param candidate_sampler: a :class:`PlaceholderNegativeSampler`.
    :param score_fn: scoring function, with sample sharing.
    :param window_size: entities scored per shard per call.
    :param axis_name: ``None`` (one device, ``n_shard == 1``) or ``"shard"``.
    """

    def __init__(
        self,
        candidate_sampler: PlaceholderNegativeSampler,
        score_fn: BaseScoreFunction,
        window_size: int = 1000,
        axis_name: Optional[str] = None,
    ) -> None:
        self.sharding = score_fn.sharding
        self.score_fn = score_fn
        self.negative_sampler = candidate_sampler
        self.window_size = window_size
        self.axis_name = axis_name
        if not score_fn.negative_sample_sharing:
            raise ValueError("AllScoresBESS requires negative sample sharing")
        if candidate_sampler.corruption_scheme not in ("h", "t"):
            raise ValueError("AllScoresBESS only supports 'h', 't' corruption")
        if not isinstance(candidate_sampler, PlaceholderNegativeSampler):
            raise ValueError("AllScoresBESS requires a PlaceholderNegativeSampler")
        _check_axis(self, axis_name)
        self.entity_embedding_size = score_fn.entity_row_size
        self.n_step = -(-self.sharding.max_entity_per_shard // window_size)

    def forward(
        self,
        params: Dict[str, torch.Tensor],
        step: int,
        relation: torch.Tensor,
        head: Optional[torch.Tensor] = None,
        tail: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Scores (shard_bs, n_shard · window) of this rank's queries against
        window ``step`` of every shard's local entities, the columns in
        (shard, window position) order.

        The window is one contiguous read wherever it fits: the final window
        clamps its start, re-scoring a prefix of the previous window (the
        pipeline's column map keeps first occurrences, and the duplicated
        columns carry identical scores). A window wider than the table, or
        an odd window over a packed table, gathers its rows, the indices
        past the table clamped to its last row.
        """
        table = params["entity_embedding"]
        n_rows = self.sharding.max_entity_per_shard
        n_shard = self.sharding.n_shard
        shard_bs = relation.shape[0]
        scheme = self.negative_sampler.corruption_scheme
        # Every rank's queries (the identity on one device).
        relation = self._all_gather(relation).reshape(-1)
        known = self._all_gather(take_rows(table, tail if scheme == "h" else head, n_rows))
        cd = self.score_fn.compute_dtype
        known = _cast_gathered(known.reshape(-1, self.entity_embedding_size), cd)

        t_flat = table[0] if table.dim() == 3 else table
        row_cap = _row_cap(t_flat, n_rows)
        w = self.window_size
        if w <= row_cap and not (is_packed(t_flat) and w % 2):
            start = min(step * w, row_cap - w)
            rows = take_contiguous_rows(table, start, w, n_rows)
        else:
            ent = torch.arange(step * w, (step + 1) * w, dtype=torch.int64, device=t_flat.device)
            rows = take_rows(table, ent.clamp(max=n_rows - 1), n_rows)
        emb = _cast_gathered(rows, cd)[None]
        if scheme == "h":
            scores = self.score_fn.score_heads(params, emb, relation, known, train=False)
        else:
            scores = self.score_fn.score_tails(params, known, relation, emb, train=False)
        scores = self._all_to_all(scores.reshape(n_shard, shard_bs, w))
        return scores.transpose(0, 1).reshape(shard_bs, n_shard * w)


#: Batch keys that :meth:`BessKGE.forward` takes.
_FORWARD_KEYS = (
    "head",
    "relation",
    "tail",
    "negative",
    "triple_mask",
    "triple_weight",
    "negative_mask",
)


def _batch_tensors(
    batch: Dict[str, Any], keys: Tuple[str, ...], device: torch.device,
    mesh: Optional[ShardMesh] = None,
) -> Dict[str, torch.Tensor]:
    """The batch's ``keys`` as tensors on ``device`` (numpy arrays or
    tensors; a tensor already there is not copied). Over a mesh, the rank's
    ``(bps, 1, ...)`` column of a global ``(bps, n_shard, ...)`` batch; a
    batch of one column is taken as the rank's own."""
    out = {}
    for k, v in batch.items():
        if k not in keys:
            continue
        if mesh is not None and v.shape[1] == mesh.n_shard > 1:
            v = v[:, mesh.rank : mesh.rank + 1]
        out[k] = (v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v))).to(device)
    return out


def _step_device(module: Any, mesh: Optional[ShardMesh],
                 device: Optional[Union[str, torch.device]]) -> torch.device:
    """Bind ``module`` to ``mesh`` (:func:`_bind_mesh`) and return the device
    its step runs on: the mesh's (``device`` must name the same), else
    ``device`` (default ``cuda``)."""
    _bind_mesh(module, mesh)
    if mesh is None:
        return resolve_device(device)
    if device is not None and torch.device(device).type != mesh.device.type:
        raise ValueError(f"device {device} for a mesh on {mesh.device}")
    return mesh.device


def _check_device(params: Dict[str, torch.Tensor], device: torch.device) -> None:
    where = params["entity_embedding"].device
    if where.type != device.type:
        raise ValueError(f"params on {where}, step built for {device}")


def _device_step(
    bess: BessKGE, params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
    train: bool = False, rng: Any = None,
) -> Dict[str, torch.Tensor]:
    """The ``bps`` micro-batches of a batch of ``(bps, 1, ...)`` tensors
    through :meth:`BessKGE.forward`: each output ``(bps, ...)``. On one
    device they are fused with ``torch.func.vmap``, as the JAX package fuses
    them with ``jax.vmap``; over a mesh (collectives in the body) they run
    one after another, as its ``lax.scan`` runs them. A dropout key ``rng``
    (a 0-dim int64 tensor on the batch's device) is split into one key per
    micro-batch (:func:`~besskge_tpu_torch.device_sampler.split_key`, as the
    JAX package splits its key), over a mesh after folding in the rank (the
    JAX package's ``fold_in`` of the axis index): every rank draws its own
    dropout stream."""
    mbs = {k: v[:, 0] for k, v in batch.items() if k in _FORWARD_KEYS}
    bps = next(iter(mbs.values())).shape[0]
    if bess.axis_name is None:
        if rng is None:
            return torch.func.vmap(lambda mb: bess.forward(params, train=train, **mb))(mbs)
        rngs = split_key(rng, bps)
        return torch.func.vmap(lambda mb, r: bess.forward(params, train=train, rng=r, **mb))(
            mbs, rngs)
    rngs = [None] * bps if rng is None else split_key(_fold_in(rng, bess.mesh.rank), bps)
    return _stack([bess.forward(params, train=train, rng=rngs[i],
                                **{k: v[i] for k, v in mbs.items()}) for i in range(bps)])


def _stack(outs: list) -> Dict[str, torch.Tensor]:
    """Per-micro-batch output dicts stacked on a leading ``bps`` axis."""
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def _format_outputs(bess: BessKGE, outs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Stacked per-micro-batch outputs ``(bps, ...)`` -> step outputs: the
    loss summed over micro-batches and over the mesh, a unit shard axis
    inserted after ``bps`` in the scores and ranks, and the metrics,
    ``(bps, 1, n_metric)`` sums over the mesh, or ``(bps, 1, n_metric, bs)``
    as they are (the sums over the mesh are the identity on one device)."""
    return _reduce_outputs(bess, outs, None)[0]


def _reduce_outputs(bess: BessKGE, outs: Dict[str, torch.Tensor],
                    grads: Any) -> Tuple[Dict[str, torch.Tensor], Any]:
    """:func:`_format_outputs`, and the tree ``grads`` (a training step's
    gradients of the replicated params) summed over the mesh in the same
    single psum as the loss and the summed metrics, as XLA fuses the JAX
    package's psums into one all-reduce."""
    formatted, summed = {}, {}
    if "loss" in outs:
        summed["loss"] = torch.sum(outs["loss"])
    for key in ("positive_score", "negative_score", "ranks"):
        if key in outs:
            formatted[key] = outs[key][:, None]
    if "metrics" in outs:
        m = outs["metrics"]
        (summed if m.dim() == 3 else formatted)["metrics"] = m
    if grads is not None:
        summed["grads"] = grads
    if summed:
        summed = bess.psum(summed)
    grads = summed.pop("grads", None)
    formatted.update(summed)
    return formatted, grads


def build_bess_forward(
    bess: BessKGE,
    mesh: Any = None,
    train: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build the forward step ``fn(params, batch, rng=None) -> outputs``,
    without gradients. ``train`` and a dropout key ``rng`` (an int or a
    0-dim int64 tensor) reach the scorer (ConvE) as in
    :meth:`BessKGE.forward`.

    ``batch`` is a batch-sampler dict of ``(bps, 1, ...)`` numpy arrays or
    tensors; ``params`` must already live on ``device`` (default ``cuda``).
    Over a ``mesh`` (a module with ``axis_name="shard"``) each rank calls the step with its params (its
    table block, :func:`~besskge_tpu_torch.parallel.mesh.shard_params`) and
    the global batch or its own column, on the mesh's device.

    Outputs: ``loss`` () sum (over the mesh); ``positive_score`` (bps, 1,
    bs); ``negative_score`` (bps, 1, bs, n_col); ``ranks`` as the positive
    scores; ``metrics`` (bps, 1, n_metric) sums (sum reduction, over the
    mesh) or (bps, 1, n_metric, bs).
    """
    device = _step_device(bess, mesh, device)

    def fn(params: Dict[str, torch.Tensor], batch: Dict[str, Any],
           rng: Any = None) -> Dict[str, torch.Tensor]:
        _check_device(params, device)
        with torch.no_grad():
            outs = _device_step(bess, params, _batch_tensors(batch, _FORWARD_KEYS, device, mesh),
                                train=train, rng=_as_key(rng, device))
            return _format_outputs(bess, outs)

    return fn


_TOPK_KEYS = ("head", "relation", "tail", "negative", "triple_mask", "negative_mask")


def build_topk_forward(
    topk: TopKQueryBessKGE,
    mesh: Any = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Callable[[Dict[str, torch.Tensor], Dict[str, Any]], Dict[str, torch.Tensor]]:
    """Build the top-k query step ``fn(params, batch) -> outputs``.

    ``batch`` is a batch-sampler dict of ``(bps, 1, ...)`` numpy arrays or
    tensors; ``params`` must already live on ``device`` (default ``cuda``).
    The micro-batches run one after another, as the JAX package's
    ``lax.scan`` runs them. Over a ``mesh`` each rank calls the step with its
    params and the global batch or its own column, as in
    :func:`build_bess_forward`.

    Outputs (this rank's queries): ``topk_global_id`` (bps, 1, shard_bs, k)
    int32 and optionally ``topk_scores`` (same, fp32), ``ranks`` (bps, 1,
    shard_bs) and ``metrics`` ((bps, 1, n_metric) sums over the mesh or
    (bps, 1, n_metric, shard_bs)).
    """
    device = _step_device(topk, mesh, device)

    def fn(params: Dict[str, torch.Tensor], batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        _check_device(params, device)
        mbs = {k: v[:, 0] for k, v in _batch_tensors(batch, _TOPK_KEYS, device, mesh).items()}
        bps = next(iter(mbs.values())).shape[0]
        with torch.inference_mode():
            outs = [topk.forward(params, **{key: v[i] for key, v in mbs.items()}) for i in range(bps)]
        formatted = {}
        for key in ("topk_global_id", "topk_scores", "ranks"):
            if key in outs[0]:
                formatted[key] = torch.stack([o[key] for o in outs])[:, None]
        if "metrics" in outs[0]:
            # (bps, 1, n_metric) sums, summed over the mesh, or (bps, 1,
            # n_metric, shard_bs).
            m = torch.stack([o["metrics"] for o in outs])
            formatted["metrics"] = topk.psum(m) if m.dim() == 3 else m
        return formatted

    return fn


_ALLSCORES_KEYS = ("relation", "head", "tail")


def build_allscores_forward(
    allscores: AllScoresBESS,
    mesh: Any = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Callable[[Dict[str, torch.Tensor], Dict[str, Any], int], torch.Tensor]:
    """Build ``fn(params, batch, step) -> scores`` of window ``step``:
    (bps, 1, shard_bs, n_shard · window), the micro-batches one after
    another. ``batch`` holds ``(bps, 1, ...)`` numpy arrays or tensors
    (over a ``mesh``, the global batch or the rank's column); ``params``
    must already live on ``device`` (default ``cuda``; over a mesh, the
    rank's params on the mesh's device)."""
    device = _step_device(allscores, mesh, device)

    def fn(params: Dict[str, torch.Tensor], batch: Dict[str, Any], step: int) -> torch.Tensor:
        _check_device(params, device)
        mbs = {k: v[:, 0]
               for k, v in _batch_tensors(batch, _ALLSCORES_KEYS, device, mesh).items()}
        bps = mbs["relation"].shape[0]
        with torch.no_grad():
            outs = [allscores.forward(params, step, **{k: v[i] for k, v in mbs.items()})
                    for i in range(bps)]
        return torch.stack(outs)[:, None]

    return fn
