"""Distance and dot-product matrices and the fused top-k window op,
dispatched by device.

Counterpart of ``besskge_tpu/ops/distance.py``. p=2 is the
``|a|² + |b|² − 2ab`` decomposition through ``torch.matmul``, as the JAX
package leaves it to XLA, in full fp32 in the forward and the backward
whatever the caller set for TF32 (:class:`_Fp32MatMul`): the decomposition
cancels badly when the distance is small against ``|a|² + |b|²``, and TF32's
10-bit mantissa would move such distances by a large relative amount. p=1 is a ``torch.autograd.Function`` whose forward
and backward are each another kernel, on every device: on a CUDA tensor they
launch the hand-written kernels of :mod:`.l1_kernels` (the JAX package's size
gate was measured on a TPU and does not carry over), on a CPU tensor they
compute the plain versions. Under ``torch.func.vmap`` (the trainer's
micro-batches) the Functions' ``vmap`` rules call the batched kernels, as the
JAX package's ``custom_vmap`` rules do:

=====================  ============  ============================
                       unbatched     under ``torch.func.vmap``
=====================  ============  ============================
forward (:class:`_L1`) B5            B1
backward (``_L1Grads``) B6           B2
=====================  ============  ============================
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, Optional, Sequence, Tuple

import torch

from besskge_tpu_torch.ops import l1_kernels

#: The fused window op of the top-k chunk merge: masked negated-L1 scores
#: and their per-128-column maxima (inference only).
l1_scores_chunkmax = l1_kernels.l1_scores_chunkmax

__all__ = ["dot_product_matrix", "p_distance_matrix", "l1_scores_chunkmax"]

#: Softening for sqrt at zero distance.
_EPS = 1e-12


def _batch_first(
    batch_size: int, in_dims: Sequence[Optional[int]], *tensors: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """Each tensor with its vmapped dimension first; an unbatched one
    (``in_dims`` entry ``None``) is expanded to the group count."""
    return tuple(
        t.expand(batch_size, *t.shape) if dim is None else t.movedim(dim, 0)
        for t, dim in zip(tensors, in_dims)
    )


class _L1Grads(torch.autograd.Function):
    """``(da, db)`` of the L1 distance matrix for a cotangent ``g``, in fp32
    (B6; B2 under vmap). First-order only."""

    @staticmethod
    def forward(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return l1_kernels.l1_distance_grads(a, b, g)

    @staticmethod
    def setup_context(ctx: Any, inputs: Tuple, output: Tuple) -> None:
        pass

    @staticmethod
    def backward(ctx: Any, *grads: torch.Tensor) -> None:
        raise NotImplementedError("the L1 distance has no second derivative here")

    @staticmethod
    def vmap(info: Any, in_dims: Tuple, a, b, g):
        a, b, g = _batch_first(info.batch_size, in_dims, a, b, g)
        return l1_kernels.l1_distance_grads_batched(a, b, g), (0, 0)


class _L1(torch.autograd.Function):
    """All-pairs L1 distance in the dtype of ``a`` (B5; B1 under vmap), with
    the sign-subgradient VJP of :class:`_L1Grads`: ``sign(0) = 0`` at exact
    ties, fp32 sums, cast back to the inputs' dtypes."""

    @staticmethod
    def forward(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return l1_kernels.l1_distance_matrix(a, b)

    @staticmethod
    def setup_context(ctx: Any, inputs: Tuple, output: torch.Tensor) -> None:
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx: Any, g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        a, b = ctx.saved_tensors
        da, db = _L1Grads.apply(a, b, g.float())
        return da.to(a.dtype), db.to(b.dtype)

    @staticmethod
    def vmap(info: Any, in_dims: Tuple, a, b):
        a, b = _batch_first(info.batch_size, in_dims, a, b)
        return l1_kernels.l1_distance_matrix_batched(a, b), 0


@contextlib.contextmanager
def _full_fp32() -> Iterator[None]:
    """Matrix products on the card accumulated in full fp32 inside the
    block: fp32 ones without TF32, bf16 and fp16 ones without
    reduced-precision (split-K) reductions. cuBLAS's own three flags are
    read and restored: the generic ``torch.get_float32_matmul_precision()``
    raises (torch 2.9 on) once the per-backend settings disagree, as after
    ``set_float32_matmul_precision("high")`` and ``allow_tf32 = False``, and
    its setter would write every backend's precision on the way out."""
    mm = torch.backends.cuda.matmul
    prev = (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction,
            mm.allow_fp16_reduced_precision_reduction)
    mm.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    mm.allow_fp16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction,
         mm.allow_fp16_reduced_precision_reduction) = prev


class _Fp32MatMul(torch.autograd.Function):
    """``a @ b.T`` accumulated in full fp32 (:func:`_full_fp32`), in the
    operands' dtype, in the forward and in the backward (which autograd runs
    outside the forward's scope)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        with _full_fp32():
            return torch.matmul(a, b.T)

    @staticmethod
    def setup_context(ctx: Any, inputs: Tuple, output: torch.Tensor) -> None:
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx: Any, g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        a, b = ctx.saved_tensors
        with _full_fp32():
            return torch.matmul(g, b), torch.matmul(g.T, a)


def p_distance_matrix(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    """All-pairs p-distance ``out[i, j] = ||a[i] - b[j]||_p``.

    :param a: (B, d) queries.
    :param b: (N, d) candidates.
    :param p: 1 or 2.
    :return: (B, N) distances, in the dtype of ``a``.
    """
    if p == 2:
        ab = _Fp32MatMul.apply(a.float(), b.float())
        a2 = torch.sum(a.float() ** 2, dim=-1, keepdim=True)
        b2 = torch.sum(b.float() ** 2, dim=-1)[None, :]
        sq = torch.clamp(a2 + b2 - 2.0 * ab, min=_EPS)
        return torch.sqrt(sq).to(a.dtype)
    if p == 1:
        return _L1.apply(a, b)
    raise ValueError(f"Unsupported distance order p={p}")


def dot_product_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs dot products ``out[i, j] = <a[i], b[j]>``, accumulated in
    fp32 and returned in the dtype of ``a``, as the JAX package's
    ``jnp.dot(a, b.T, preferred_element_type=float32).astype(a.dtype)``:
    fp32 operands without TF32 whatever the caller set, bf16 operands as a
    bf16 product with fp32 accumulation.

    :param a: (B, d) queries.
    :param b: (N, d) candidates.
    :return: (B, N).
    """
    return _Fp32MatMul.apply(a, b.to(a.dtype))
