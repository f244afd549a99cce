"""Distance matrices and the fused top-k window op, dispatched by device.

Counterpart of ``besskge_tpu/ops/distance.py``. On a CUDA tensor the p=1 ops
always launch the hand-written kernels of :mod:`.l1_kernels` (the JAX
package's size gate was measured on a TPU and does not carry over); on a CPU
tensor they compute the plain versions. p=2 is the ``|a|² + |b|² − 2ab``
decomposition through ``torch.matmul``, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import torch

from besskge_tpu_torch.ops import l1_kernels

#: The fused window op of the top-k chunk merge: masked negated-L1 scores
#: and their per-128-column maxima (inference only).
l1_scores_chunkmax = l1_kernels.l1_scores_chunkmax

__all__ = ["p_distance_matrix", "l1_scores_chunkmax"]

#: Softening for sqrt at zero distance.
_EPS = 1e-12


def p_distance_matrix(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    """All-pairs p-distance ``out[i, j] = ||a[i] - b[j]||_p``.

    :param a: (B, d) queries.
    :param b: (N, d) candidates.
    :param p: 1 or 2.
    :return: (B, N) distances, in the dtype of ``a``.
    """
    if p == 2:
        ab = torch.matmul(a.float(), b.float().T)
        a2 = torch.sum(a.float() ** 2, dim=-1, keepdim=True)
        b2 = torch.sum(b.float() ** 2, dim=-1)[None, :]
        sq = torch.clamp(a2 + b2 - 2.0 * ab, min=_EPS)
        return torch.sqrt(sq).to(a.dtype)
    if p == 1:
        return l1_kernels.l1_distance_matrix(a, b)
    raise ValueError(f"Unsupported distance order p={p}")
