"""``loss.MarginRankingLoss`` of the port against the JAX package's.

Value and gradient with respect to both score arrays, with self-adversarial
weighting on and off, a scalar and a vector triple weight, and a loss
scale. Tolerance: rtol 1e-6 for the value (fp32 sums of at most 12 x 9
terms in other orders) and rtol 1e-5, atol 1e-7 for the gradients. The
scores are drawn so that no hinge sits exactly at 0, where both libraries'
relu gradients are 0 anyway.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from besskge_tpu import loss as jax_loss
from besskge_tpu_torch import loss as port_loss


@pytest.mark.parametrize("scale", [1.0, 2.0])
@pytest.mark.parametrize("weight", ["scalar", "vector"])
@pytest.mark.parametrize("adversarial", [False, True])
def test_margin_ranking_loss_matches_jax(adversarial, weight, scale):
    rng = np.random.default_rng(6)
    pos = rng.normal(size=12).astype(np.float32)
    neg = rng.normal(size=(12, 9)).astype(np.float32)
    w = np.float32(0.7) if weight == "scalar" else rng.random(12).astype(np.float32)
    kw = dict(margin=0.8, negative_adversarial_sampling=adversarial,
              negative_adversarial_scale=0.5, loss_scale=scale)
    assert (np.abs(neg - pos[:, None] + 0.8) > 1e-4).all()
    jfn = jax_loss.MarginRankingLoss(**kw)
    want = jfn(jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(w))
    jgrads = jax.grad(lambda p, n: jfn(p, n, jnp.asarray(w)), argnums=(0, 1))(
        jnp.asarray(pos), jnp.asarray(neg))
    pos_t, neg_t = torch.from_numpy(pos).requires_grad_(), torch.from_numpy(neg).requires_grad_()
    got = port_loss.MarginRankingLoss(**kw)(pos_t, neg_t, torch.tensor(w))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    for g, j in zip(torch.autograd.grad(got, (pos_t, neg_t)), jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-5, atol=1e-7)


def test_margin_ranking_loss_upcasts_bf16_scores():
    rng = np.random.default_rng(1)
    pos = rng.normal(size=5).astype(np.float32)
    neg = rng.normal(size=(5, 3)).astype(np.float32)
    fn = port_loss.MarginRankingLoss(1.0, False)
    got = fn(torch.from_numpy(pos).bfloat16(), torch.from_numpy(neg).bfloat16(), torch.tensor(1.0))
    want = jax_loss.MarginRankingLoss(1.0, False)(
        jnp.asarray(pos, jnp.bfloat16), jnp.asarray(neg, jnp.bfloat16), jnp.asarray(1.0))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_margin_ranking_loss_takes_only_relu():
    for mod in (jax_loss, port_loss):
        with pytest.raises(ValueError, match="not supported"):
            mod.MarginRankingLoss(1.0, False, activation_function="softplus")
    fn = port_loss.MarginRankingLoss(2.0, True, 0.3, 4.0, "relu")
    assert (fn.margin, fn.negative_adversarial_sampling, fn.negative_adversarial_scale,
            fn.loss_scale) == (2.0, True, 0.3, 4.0)
