"""Link-prediction metrics (MRR, Hits@K) on the device.

Counterpart of ``besskge_tpu/metric.py``: the same rank conventions, tie
modes, metric order and output layouts, on torch tensors.
"""

from __future__ import annotations

import re
from abc import ABC, abstractmethod
from typing import Callable, Dict, List, Optional

import torch

__all__ = ["BaseMetric", "ReciprocalRank", "HitsAtK", "Evaluation"]


class BaseMetric(ABC):
    """Per-triple metric from prediction ranks."""

    @abstractmethod
    def __call__(self, prediction_rank: torch.Tensor) -> torch.Tensor:
        """(batch_size,) ranks -> (batch_size,) metric values."""
        raise NotImplementedError


class ReciprocalRank(BaseMetric):
    """Reciprocal rank (averaged over a dataset: MRR)."""

    def __call__(self, prediction_rank: torch.Tensor) -> torch.Tensor:
        return 1.0 / prediction_rank


class HitsAtK(BaseMetric):
    """1 if the ground truth ranks within the top K, else 0."""

    def __init__(self, k: int) -> None:
        self.K = k

    def __call__(self, prediction_rank: torch.Tensor) -> torch.Tensor:
        return (prediction_rank <= self.K).to(torch.float32)


METRICS_DICT = {"mrr": ReciprocalRank, "hits@k": HitsAtK}


class Evaluation:
    """Rank computation + metric reduction.

    :param metric_list: e.g. ``["mrr", "hits@1", "hits@10"]``.
    :param mode: tie-breaking — "optimistic" (rank above ties),
        "pessimistic", or "average".
    :param worst_rank_infty: rank is ∞ (instead of n_candidate+1) when the
        ground truth beats no candidate / is absent from the top-k.
    :param reduction: "none" or "sum" over the batch axis.
    :param return_ranks: also return raw ranks from the BESS forward.
    """

    def __init__(
        self,
        metric_list: List[str],
        mode: str = "average",
        worst_rank_infty: bool = False,
        reduction: str = "none",
        return_ranks: bool = False,
    ) -> None:
        if mode not in ("pessimistic", "optimistic", "average"):
            raise ValueError(f"Mode {mode} not supported for evaluation")
        self.mode = mode
        self.worst_rank_infty = worst_rank_infty
        self.return_ranks = return_ranks
        if reduction == "none":
            self.reduction: Callable[[torch.Tensor], torch.Tensor] = lambda x: x
        elif reduction == "sum":
            self.reduction = lambda x: torch.sum(x, dim=0)
        else:
            raise ValueError(f"Reduction {reduction} not supported for evaluation")

        hits = [re.search(r"hits@(\d+)", m) for m in metric_list]
        self.metrics: Dict[str, BaseMetric] = {
            m[0]: HitsAtK(k=int(m[1])) for m in hits if m
        }
        self.metrics.update(
            {
                name: METRICS_DICT[name]()
                for name in set(metric_list) - set(self.metrics)
            }
        )

    def ranks_from_scores(
        self, pos_score: torch.Tensor, candidate_score: torch.Tensor
    ) -> torch.Tensor:
        """Rank = 1 + number of strictly/weakly better candidates.

        :param pos_score: (batch_size,) ground-truth scores.
        :param candidate_score: (batch_size, n_candidate).
        :return: (batch_size,) float32 ranks.
        """
        n_candidate = candidate_score.shape[-1]
        pos = torch.nan_to_num(
            pos_score.reshape(-1, 1).to(torch.float32), nan=-float("inf")
        )
        cand = candidate_score.to(torch.float32)
        n_opt = torch.sum(cand > pos, dim=-1).to(torch.float32)
        n_pess = torch.sum(cand >= pos, dim=-1).to(torch.float32)
        if self.mode == "optimistic":
            n_better, mask = n_opt, n_opt == n_candidate
        elif self.mode == "pessimistic":
            n_better, mask = n_pess, n_pess == n_candidate
        else:
            n_better = 0.5 * (n_opt + n_pess)
            mask = torch.logical_or(n_opt == n_candidate, n_pess == n_candidate)
        rank = 1.0 + n_better
        if self.worst_rank_infty:
            rank = torch.where(mask, torch.full_like(rank, float("inf")), rank)
        return rank

    def ranks_from_indices(
        self, ground_truth: torch.Tensor, candidate_indices: torch.Tensor
    ) -> torch.Tensor:
        """Rank of the ground-truth ID within an ordered top-k ID list
        (rows assumed duplicate-free).

        :param ground_truth: (batch_size,) entity IDs.
        :param candidate_indices: (batch_size, n_candidate) ordered by
            decreasing likelihood.
        """
        n_candidate = candidate_indices.shape[-1]
        worst = float("inf") if self.worst_rank_infty else float(n_candidate + 1)
        positions = torch.arange(
            1, n_candidate + 1, dtype=torch.float32, device=candidate_indices.device
        )
        hit = ground_truth.reshape(-1, 1) == candidate_indices
        ranks = torch.where(hit, positions, torch.full_like(positions, worst))
        return torch.amin(ranks, dim=-1)

    def dict_metrics_from_ranks(
        self,
        batch_rank: torch.Tensor,
        triple_mask: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """Reduced metrics keyed by name; masked-out triples contribute 0."""
        out = {}
        for name, fn in self.metrics.items():
            val = fn(batch_rank)
            if triple_mask is not None:
                val = torch.where(triple_mask, val, torch.zeros_like(val))
            out[name] = self.reduction(val)
        return out

    def stacked_metrics_from_ranks(
        self,
        batch_rank: torch.Tensor,
        triple_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Metrics stacked along a leading axis, in :attr:`metrics` order:
        (1, n_metrics[, batch_size])."""
        return torch.stack(
            list(self.dict_metrics_from_ranks(batch_rank, triple_mask).values())
        )[None]
