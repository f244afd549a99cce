"""Loss functions on positive/negative triple scores (torch).

Counterpart of ``besskge_tpu/loss.py``. Losses are always computed in fp32 —
the inputs are upcast here — with an optional ``loss_scale`` for
low-precision training: the base classes,
:class:`SampledSoftmaxCrossEntropyLoss` (the sparse TransE recipe),
:class:`LogSigmoidLoss` (the dense RotatE and ComplEx recipes) and
:class:`MarginRankingLoss`.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np
import torch

__all__ = [
    "BaseLossFunction",
    "LogSigmoidLoss",
    "MarginBasedLossFunction",
    "MarginRankingLoss",
    "SampledSoftmaxCrossEntropyLoss",
]


class BaseLossFunction(ABC):
    """Base class; see reference ``besskge/loss.py:14-74``."""

    #: Use self-adversarial weighting of negative samples (:cite RotatE).
    negative_adversarial_sampling: bool
    #: Reciprocal temperature of self-adversarial weighting.
    negative_adversarial_scale: float
    #: Loss scaling factor (for fp16/bf16 training).
    loss_scale: float

    def get_negative_weights(self, negative_score: torch.Tensor) -> torch.Tensor:
        """Self-adversarial softmax weights (no gradient), or the uniform
        ``1/n_negative`` scalar."""
        if self.negative_adversarial_sampling:
            return torch.softmax(
                self.negative_adversarial_scale * negative_score, dim=-1
            ).detach()
        # A fill, not a host value copied to the device: it runs inside a
        # CUDA graph.
        return torch.full(
            (), 1.0 / negative_score.shape[-1], dtype=torch.float32, device=negative_score.device
        )

    @abstractmethod
    def __call__(
        self,
        positive_score: torch.Tensor,
        negative_score: torch.Tensor,
        triple_weight: torch.Tensor,
    ) -> torch.Tensor:
        """Compute the (summed) batch loss.

        :param positive_score: (batch_size,) scores of positive triples.
        :param negative_score: (batch_size, n_negative) scores of negatives.
        :param triple_weight: (batch_size,) or () positive-triple weights.
        :return: () the batch loss.
        """
        raise NotImplementedError


class MarginBasedLossFunction(BaseLossFunction, ABC):
    """Base for margin losses (reference ``besskge/loss.py:77-106``)."""

    def __init__(
        self,
        margin: float,
        negative_adversarial_sampling: bool,
        negative_adversarial_scale: float = 1.0,
        loss_scale: float = 1.0,
    ) -> None:
        self.margin = float(margin)
        self.negative_adversarial_sampling = negative_adversarial_sampling
        self.negative_adversarial_scale = float(negative_adversarial_scale)
        self.loss_scale = float(loss_scale)


class LogSigmoidLoss(MarginBasedLossFunction):
    """RotatE-style log-sigmoid loss (reference ``besskge/loss.py:109-134``):
    ``−½·Σ w·(log σ(pos + margin) + Σ_neg weight·log σ(−neg − margin))``,
    the negative weights taken without a gradient."""

    def __call__(self, positive_score, negative_score, triple_weight):
        pos = positive_score.float()
        neg = negative_score.float()
        w = triple_weight.float()
        neg_w = self.get_negative_weights(neg)
        # log σ(x) = −softplus(−x), as jax.nn.log_sigmoid computes it (and
        # without logsigmoid's buffer, which vmap of its backward resizes).
        pos_logs = -torch.nn.functional.softplus(-(pos + self.margin))
        neg_logs = -torch.nn.functional.softplus(neg + self.margin)
        neg_reduced = torch.sum(neg_w * neg_logs, dim=-1)
        return self.loss_scale * (-0.5) * torch.sum(w * (pos_logs + neg_reduced))


class MarginRankingLoss(MarginBasedLossFunction):
    """Pairwise hinge loss (reference ``besskge/loss.py:137-195``):
    ``Σ w·Σ_neg weight·relu(neg − pos + margin)``."""

    def __init__(
        self,
        margin: float,
        negative_adversarial_sampling: bool,
        negative_adversarial_scale: float = 1.0,
        loss_scale: float = 1.0,
        activation_function: str = "relu",
    ) -> None:
        super().__init__(
            margin, negative_adversarial_sampling, negative_adversarial_scale, loss_scale
        )
        if activation_function != "relu":
            raise ValueError(
                f"Activation function {activation_function} not supported"
                " for MarginRankingLoss"
            )

    def __call__(self, positive_score, negative_score, triple_weight):
        pos = positive_score.float()
        neg = negative_score.float()
        w = triple_weight.float()
        neg_w = self.get_negative_weights(neg)
        combined = torch.relu(neg - pos[:, None] + self.margin)
        reduced = torch.sum(neg_w * combined, dim=-1)
        return self.loss_scale * torch.sum(w * reduced)


class SampledSoftmaxCrossEntropyLoss(BaseLossFunction):
    """Sampled softmax cross-entropy with the candidate-count correction
    ``log((n_entity−1)/n_negative)`` (reference ``besskge/loss.py:198-251``)."""

    def __init__(self, n_entity: int, loss_scale: float = 1.0) -> None:
        self.negative_adversarial_sampling = False
        self.negative_adversarial_scale = 0.0
        self.loss_scale = float(loss_scale)
        self.n_entity = n_entity

    def __call__(self, positive_score, negative_score, triple_weight):
        pos = positive_score.float()
        neg = negative_score.float()
        w = triple_weight.float()
        # Correction is constant over negatives, zero for the target class.
        correction = np.float32(np.log(self.n_entity - 1) - np.log(negative_score.shape[1]))
        neg = neg + float(correction)
        logits = torch.cat([pos[:, None], neg], dim=-1)
        # Cross entropy with target class 0.
        xent = torch.logsumexp(logits, dim=-1) - logits[:, 0]
        return self.loss_scale * torch.sum(w * xent)
