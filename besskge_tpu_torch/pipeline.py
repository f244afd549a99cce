"""High-level pipeline of BESS inference (torch): filtered all-scores
evaluation.

Counterpart of ``besskge_tpu/pipeline.py`` (reference
``besskge/pipeline.py:23-320``): batched full-vocabulary scoring with triple
filtering, candidate restriction, top-k extraction and metrics, around the
window step of :class:`besskge_tpu_torch.bess.AllScoresBESS`. The JAX
package copies every window's scores to the host and stitches, filters and
ranks there; here the windows stay on the device, which stitches them,
masks the filtered and non-candidate entries, ranks and takes the top-k,
and only what the caller asked for is copied to the host. The filter pairs
are found on the host (:func:`besskge_tpu_torch.utils.get_entity_filter`)
and the outputs are numpy arrays, as the JAX package's.

Over a mesh each rank stitches, filters, ranks and takes the top-k of its
own queries on its device (the score matrix is not moved); the ranks, top-k
IDs and, when asked for, the scores of every rank's queries are then
all-gathered in the JAX package's row order (batch, ``bps``, shard,
``shard_bs``, under ``triple_mask``), and every rank returns the dict that
the JAX pipeline returns over the same mesh.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
from numpy.typing import NDArray

from besskge_tpu_torch.batch_sampler import ShardedBatchSampler
from besskge_tpu_torch.bess import (
    AllScoresBESS,
    _batch_tensors,
    _step_device,
    build_allscores_forward,
)
from besskge_tpu_torch.metric import Evaluation
from besskge_tpu_torch.negative_sampler import PlaceholderNegativeSampler
from besskge_tpu_torch.packed import is_packed
from besskge_tpu_torch.parallel import collectives
from besskge_tpu_torch.scoring import BaseScoreFunction
from besskge_tpu_torch.utils import _tree_map, get_entity_filter

__all__ = ["AllScoresPipeline"]


class AllScoresPipeline:
    """Score (h, r, ?) / (?, r, t) queries against all (or candidate)
    entities, with filtered evaluation.

    :param batch_sampler: based on an "h_shard"/"t_shard"-partitioned set,
        with ``return_triple_idx=True`` when filtering.
    :param corruption_scheme: "t" to complete (h, r, ?), "h" for (?, r, t).
    :param score_fn: the trained scoring function.
    :param mesh: ``None`` (one device), or the rank's
        :class:`~besskge_tpu_torch.parallel.mesh.ShardMesh`: every rank
        builds the pipeline and calls :meth:`forward` with its own params.
    :param evaluation: metrics module.
    :param filter_triples: list of triple arrays (GLOBAL IDs) whose
        completions must be filtered out of the rankings.
    :param candidate_ents: global IDs; restrict scoring to these entities.
    :param return_scores: return the full (filtered) score matrix.
    :param return_topk: return top-k most likely completions per query.
    :param k: how many completions when ``return_topk``.
    :param window_size: entities per shard scored per device call.
    :param device: where the scores are computed (default ``cuda``; over a
        mesh, the mesh's).
    """

    def __init__(
        self,
        batch_sampler: ShardedBatchSampler,
        corruption_scheme: str,
        score_fn: BaseScoreFunction,
        mesh: Any = None,
        evaluation: Optional[Evaluation] = None,
        filter_triples: Optional[List[NDArray[np.int32]]] = None,
        candidate_ents: Optional[NDArray[np.int32]] = None,
        return_scores: bool = False,
        return_topk: bool = False,
        k: int = 10,
        window_size: int = 1000,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        if not (evaluation or return_scores):
            raise ValueError(
                "Nothing to return. Provide `evaluation` or set"
                " `return_scores=True`"
            )
        if corruption_scheme not in ("h", "t"):
            raise ValueError("corruption_scheme needs to be either 'h' or 't'")
        expected_mode = "t_shard" if corruption_scheme == "h" else "h_shard"
        if batch_sampler.triple_partition_mode != expected_mode:
            raise ValueError(
                f"Corruption scheme '{corruption_scheme}' requires"
                f" '{expected_mode}'-partitioned triples"
            )
        self.batch_sampler = batch_sampler
        self.score_fn = score_fn
        self.evaluation = evaluation
        self.return_scores = return_scores
        self.return_topk = return_topk
        self.k = k
        self.corruption_scheme = corruption_scheme
        self.candidate_sampler = PlaceholderNegativeSampler(corruption_scheme=corruption_scheme)
        self.bess_module = AllScoresBESS(self.candidate_sampler, score_fn, window_size,
                                         axis_name=None if mesh is None else "shard")
        self.mesh = mesh
        self.device = _step_device(self.bess_module, mesh, device)
        self._fwd = build_allscores_forward(self.bess_module, mesh, self.device)
        sharding = self.bess_module.sharding

        # The stitched-column -> global-entity map: columns are ordered
        # (step, shard, window position); keep the first occurrence of each
        # global ID, drop padding IDs (reference ``pipeline.py:243-247``).
        # It mirrors AllScoresBESS.forward's window index math exactly: a
        # contiguous window clamps its start (re-reading a prefix of the
        # previous window: identical scores, deduplicated here), and a packed
        # table may expose one zero pad row past max_entity_per_shard (its
        # column aliases the last real index and loses the first-occurrence
        # race to the real column, so it is always dropped).
        ws = self.bess_module.window_size
        max_e = sharding.max_entity_per_shard
        packed_tab = bool(getattr(score_fn, "packed_entity_storage", False))
        self._packed_tab = packed_tab
        row_cap = max_e + (max_e % 2) if packed_tab else max_e
        contiguous = ws <= row_cap and not (packed_tab and ws % 2)
        col_ids = []
        for i in range(self.bess_module.n_step):
            if contiguous:
                ent_slice = np.minimum(min(i * ws, row_cap - ws) + np.arange(ws), max_e - 1)
            else:
                ent_slice = np.minimum(i * ws + np.arange(ws), max_e - 1)
            col_ids.append(sharding.shard_and_idx_to_entity[:, ent_slice].ravel())
        self._col_select = np.unique(np.concatenate(col_ids), return_index=True)[1][
            : sharding.n_entity
        ]
        self._col_select_t = torch.from_numpy(self._col_select).to(self.device)

        self.filter_triples: Optional[NDArray] = None
        if filter_triples:
            # Reconstruct global IDs of the partitioned column.
            local_col = 0 if batch_sampler.triple_partition_mode == "h_shard" else 2
            offsets = np.concatenate([[0], np.cumsum(batch_sampler.triple_counts)])
            parts = []
            for s in range(len(offsets) - 1):
                chunk = batch_sampler.triples[offsets[s] : offsets[s + 1]].copy()
                chunk[:, local_col] = sharding.shard_and_idx_to_entity[s][chunk[:, local_col]]
                parts.append(chunk)
            self.triples = np.concatenate(parts, axis=0)
            self.filter_triples = np.concatenate(
                [np.asarray(tr) for tr in filter_triples], axis=0
            )
        self.candidate_mask: Optional[NDArray] = None
        if candidate_ents is not None:
            self.candidate_mask = np.setdiff1d(np.arange(sharding.n_entity), candidate_ents)
            self._candidate_mask_t = torch.from_numpy(self.candidate_mask).to(self.device)

    def forward(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Run the full pipeline over one epoch of the batch sampler.

        ``params`` are tensors (or arrays) of the score function's tables,
        and nested dicts of them (ConvE's trunk); they are moved to the
        pipeline's device if they are not there. Over a mesh, the rank's
        params (its block of the entity table,
        :func:`~besskge_tpu_torch.parallel.mesh.shard_params`); every rank
        returns the outputs of every rank's queries.
        Returns numpy arrays: ``scores`` (queries, n_entity) fp32,
        ``topk_global_id``, ``triple_idx``, ``ranks``, ``metrics`` and
        ``metrics_avg``, each where asked for.
        """
        device = self.device
        params = _tree_map(
            lambda v: (v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))).to(device),
            params,
        )
        if is_packed(params["entity_embedding"]) != self._packed_tab:
            raise ValueError(
                "entity table packedness changed after pipeline "
                "construction — the stitched-column map was built for "
                f"packed={self._packed_tab}; rebuild the AllScoresPipeline"
            )
        scores, ids, metrics, ranks, topk_ids = [], [], [], [], []
        n_triple = 0
        n_step = self.bess_module.n_step
        gt_key = "head" if self.corruption_scheme == "h" else "tail"
        for batch in self.batch_sampler.get_dataloader(shuffle=False):
            mask_all = batch["triple_mask"]  # (bps, n_shard, shard_bs)
            mine = self._column(batch)
            triple_mask = mine["triple_mask"].reshape(-1)
            keep = torch.from_numpy(np.flatnonzero(triple_mask)).to(device)
            ground_truth = None
            if gt_key in batch:
                ground_truth = torch.from_numpy(
                    mine[gt_key].reshape(-1)[triple_mask].astype(np.int64)
                ).to(device)
            triple_id = None
            if self.batch_sampler.return_triple_idx:
                triple_id = mine["triple_idx"].reshape(-1)
                ids.append(batch["triple_idx"].reshape(-1)[mask_all.reshape(-1)])
            n_triple += int(mask_all.sum())

            dbatch = _batch_tensors(batch, ("relation", "head", "tail"), device, self.mesh)
            # (bps, 1, shard_bs, n_shard * ws) x n_step -> (rows, n_step *
            # n_shard * ws), then the real queries' rows and the map's
            # columns, in fp32.
            batch_scores = torch.cat(
                [self._fwd(params, dbatch, i).flatten(0, 2) for i in range(n_step)], dim=-1
            )
            filt = batch_scores[keep][:, self._col_select_t].float()
            del batch_scores
            if self.candidate_mask is not None:
                filt[:, self._candidate_mask_t] = -np.inf
            rows = torch.arange(filt.shape[0], device=device)
            true_scores = None
            if ground_truth is not None:
                true_scores = filt[rows, ground_truth]
            if self.filter_triples is not None:
                if triple_id is None:
                    raise ValueError(
                        "Filtering requires return_triple_idx=True in the batch sampler"
                    )
                if len(keep):  # a rank's column may hold padding only
                    batch_filter = torch.from_numpy(get_entity_filter(
                        self.triples[triple_id[triple_mask]],
                        self.filter_triples,
                        filter_mode=self.corruption_scheme,
                    )).to(device)
                    filt[batch_filter[:, 0], batch_filter[:, 1]] = -np.inf
            if self.evaluation is not None:
                if ground_truth is None:
                    raise ValueError("Evaluation requires ground truth entities")
                filt[rows, ground_truth] = -np.inf
                batch_ranks = self._all_rows(
                    self.evaluation.ranks_from_scores(true_scores, filt), keep, mask_all)
                metrics.append(self.evaluation.dict_metrics_from_ranks(batch_ranks))
                if self.evaluation.return_ranks:
                    ranks.append(batch_ranks)
            if ground_truth is not None:
                filt[rows, ground_truth] = true_scores
            if self.return_scores:
                scores.append(self._all_rows(filt, keep, mask_all).cpu().numpy())
            if self.return_topk:
                topk_ids.append(self._all_rows(torch.topk(filt, self.k, dim=-1).indices, keep,
                                               mask_all))

        out: Dict[str, Any] = {}
        if scores:
            out["scores"] = np.concatenate(scores, axis=0)
        if topk_ids:
            out["topk_global_id"] = torch.cat(topk_ids).cpu().numpy()
        if ids:
            out["triple_idx"] = np.concatenate(ids, axis=0)
        if self.evaluation is not None:
            final = {
                m: self.evaluation.reduction(torch.cat([met[m].reshape(-1) for met in metrics]))
                for m in metrics[0]
            }
            out["metrics"] = {k: v.cpu().numpy() for k, v in final.items()}
            out["metrics_avg"] = {
                m: float(np.sum(v)) / n_triple for m, v in out["metrics"].items()
            }
            if ranks:
                out["ranks"] = torch.cat(ranks).cpu().numpy()
        return out

    def _column(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """The rank's ``(bps, 1, shard_bs)`` column of each batch array (the
        whole batch on one device)."""
        if self.mesh is None:
            return batch
        rank = self.mesh.rank
        return {k: v[:, rank : rank + 1] for k, v in batch.items()}

    def _all_rows(self, local: torch.Tensor, keep: torch.Tensor,
                  mask_all: np.ndarray) -> torch.Tensor:
        """The rows of every rank's real queries, in the JAX package's order
        (``bps``, shard, ``shard_bs`` under the global ``mask_all``), from
        this rank's rows ``local`` of its real queries (at ``keep`` of its
        column): one all-gather over a mesh, ``local`` itself on one device."""
        if self.mesh is None:
            return local
        bps, n_shard, shard_bs = mask_all.shape
        tail = local.shape[1:]
        full = local.new_zeros((bps * shard_bs, *tail))
        full[keep] = local
        every = collectives.all_gather(full, self.mesh)  # (n_shard, bps * shard_bs, ...)
        every = every.reshape(n_shard, bps, shard_bs, *tail).transpose(0, 1)
        real = torch.from_numpy(mask_all.reshape(-1)).to(local.device)
        return every.reshape(bps * n_shard * shard_bs, *tail)[real]
