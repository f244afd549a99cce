"""The port's dense training slice against the JAX package's, end to end.

The configuration is ``bench.py``'s biokg recipe cut in size: RotatE with
p = 2 (``embedding_size`` 16, rows of 32 floats), shared "ht" negatives in
the flat format, ``LogSigmoidLoss(margin=12, negative_adversarial_sampling=
True)``, 512 entities and 8 relation types on one shard, ``shard_bs`` 16,
``bps`` 4. The optimizer is ``optax.adamw`` in the JAX package and
``optim.AdamW`` in the port, over every param (``entity_optimizer=None``),
or over the relation table beside ``FusedDenseAdamW`` on the entity table.
Params and optimizer state go over with ``convert``, and both packages draw
bit-equal batches from the same seeds.

Also here: ``utils.complex_multiplication``/``complex_rotation``,
``embedding.init_uniform_rotation``, ``scoring.RotatE`` (scores, both
sharing modes, p = 1 and 2, the distance query vector) and
``loss.LogSigmoidLoss`` against the JAX package.

Tolerances.

* Initial tables, samplers: bit for bit.
* Scores and losses: rtol 1e-5 (fp32 sums of up to 32 terms in other
  orders, through sin/cos of other libraries, and the p = 2 decomposition
  ``|a|² + |b|² − 2ab``, whose cancellation is bounded by ``|a|² + |b|²``:
  absolute 1e-5 of that for the distances).
* The step, each from the same state. The entity table's gradient sums
  duplicate rows in another order on each side, and the moments are held
  to ``1e-5·(|want| + max|want|)``. An AdamW update is
  ``lr·r`` with ``r = m̂/(√v̂ + eps)``, which follows ``g/|g|`` where ``|g|``
  nears ``eps``: there a gradient a few ulps apart moves the update by
  much more. So each param is held to the same tolerance plus
  ``lr·|r_port − r_jax|``, each ``r`` from that side's own moments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from besskge_tpu import batch_sampler as jax_bs
from besskge_tpu import bess as jax_bess
from besskge_tpu import dataset as jax_ds
from besskge_tpu import embedding as jax_emb
from besskge_tpu import loss as jax_loss
from besskge_tpu import negative_sampler as jax_ns
from besskge_tpu import optim as jax_optim
from besskge_tpu import scoring as jax_scoring
from besskge_tpu import sharding as jax_sh
from besskge_tpu import trainer as jax_trainer
from besskge_tpu import utils as jax_utils
from besskge_tpu_torch import batch_sampler as port_bs
from besskge_tpu_torch import bess as port_bess
from besskge_tpu_torch import convert
from besskge_tpu_torch import dataset as port_ds
from besskge_tpu_torch import embedding as port_emb
from besskge_tpu_torch import loss as port_loss
from besskge_tpu_torch import negative_sampler as port_ns
from besskge_tpu_torch import optim as port_optim
from besskge_tpu_torch import scoring as port_scoring
from besskge_tpu_torch import sharding as port_sh
from besskge_tpu_torch import trainer as port_trainer
from besskge_tpu_torch import utils as port_utils

N_ENTITY, N_RELATION, EMB, SHARD_BS, BPS = 512, 8, 16, 16, 4
LR = 1e-2

JAX = (jax_ds, jax_sh, jax_ns, jax_bs, jax_scoring, jax_bess, jax_loss)
PORT = (port_ds, port_sh, port_ns, port_bs, port_scoring, port_bess, port_loss)


def _triples(n_triple=3000, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([
        rng.integers(N_ENTITY, size=n_triple), rng.integers(N_RELATION, size=n_triple),
        rng.integers(N_ENTITY, size=n_triple),
    ], 1).astype(np.int32)


def _setup(pkg, triples=None, n_negative=1):
    ds_mod, sh_mod, ns_mod, bs_mod, sc_mod, bess_mod, loss_mod = pkg
    tri = _triples() if triples is None else triples
    ds = ds_mod.KGDataset(n_entity=N_ENTITY, n_relation_type=N_RELATION,
                          triples={"train": tri}, original_triple_ids={"train": np.arange(len(tri))})
    sharding = sh_mod.Sharding.create(N_ENTITY, 1, seed=0)
    pts = sh_mod.PartitionedTripleSet.create_from_dataset(ds, "train", sharding)
    score_fn = sc_mod.RotatE(negative_sample_sharing=True, scoring_norm=2, sharding=sharding,
                             n_relation_type=N_RELATION, embedding_size=EMB, seed=0)
    ns = ns_mod.RandomShardedNegativeSampler(n_negative, sharding, 0, "ht", local_sampling=False,
                                             flat_negative_format=True)
    module = bess_mod.EmbeddingMovingBessKGE(
        negative_sampler=ns, score_fn=score_fn,
        loss_fn=loss_mod.LogSigmoidLoss(margin=12.0, negative_adversarial_sampling=True),
        axis_name=None,
    )
    sampler = bs_mod.RandomShardedBatchSampler(pts, ns, shard_bs=SHARD_BS, batches_per_step=BPS,
                                               seed=0)
    return score_fn, module, sampler


def _batches(sampler, n):
    return [sampler.sample_batch(b) for b, _ in zip(sampler.epoch_index_blocks(), range(n))]


# --------------------------------------------------------------------------
# Building blocks


def test_complex_ops_match_jax():
    rng = np.random.default_rng(0)
    v1, v2 = rng.normal(size=(2, 5, 12)).astype(np.float32)
    r = rng.uniform(0, 2 * np.pi, size=(5, 6)).astype(np.float32)
    np.testing.assert_allclose(
        port_utils.complex_multiplication(torch.from_numpy(v1), torch.from_numpy(v2)).numpy(),
        np.asarray(jax_utils.complex_multiplication(jnp.asarray(v1), jnp.asarray(v2))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        port_utils.complex_rotation(torch.from_numpy(v1), torch.from_numpy(r)).numpy(),
        np.asarray(jax_utils.complex_rotation(jnp.asarray(v1), jnp.asarray(r))),
        rtol=1e-5, atol=1e-6)


def test_initial_tables_are_bit_equal():
    for shape in [(7, 9), (3, 4, 5)]:
        np.testing.assert_array_equal(
            port_emb.init_uniform_rotation(shape, np.random.default_rng(3)),
            jax_emb.init_uniform_rotation(shape, np.random.default_rng(3)))
    jfn, _, _ = _setup(JAX)
    pfn, _, _ = _setup(PORT)
    want = jfn.initial_params()
    got = pfn.initial_params(device="cpu")
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    dev = pfn.initial_params_device(device="cpu")
    assert dev["entity_embedding"].shape == got["entity_embedding"].shape
    rel = dev["relation_embedding"]
    assert rel.shape == (N_RELATION, EMB) and (rel >= 0).all() and (rel < 2 * np.pi).all()


def _rotate(pkg, sharing, p):
    sharding = pkg[1].Sharding.create(60, 1, seed=0)
    return pkg[4].RotatE(negative_sample_sharing=sharing, scoring_norm=p, sharding=sharding,
                         n_relation_type=7, embedding_size=8, seed=11)


@pytest.mark.parametrize("sharing", [False, True])
@pytest.mark.parametrize("p", [1, 2])
def test_rotate_scores_match_jax(sharing, p):
    jfn, pfn = _rotate(JAX, sharing, p), _rotate(PORT, sharing, p)
    params = jfn.initial_params()
    pparams = convert.params_from_jax({k: np.asarray(v) for k, v in params.items()}, "cpu")
    rng = np.random.default_rng(5)
    ent = np.asarray(params["entity_embedding"])
    h, t = ent[rng.integers(0, 60, 16)], ent[rng.integers(0, 60, 16)]
    r = rng.integers(0, 7, 16).astype(np.int32)
    cand = ent[rng.integers(0, 60, (1 if sharing else 16) * 5)].reshape(-1, 5, ent.shape[1])
    J = lambda x: jnp.asarray(x)  # noqa: E731
    T = torch.from_numpy  # noqa: E731
    pairs = [
        (jfn.score_triple(params, J(h), J(r), J(t)), pfn.score_triple(pparams, T(h), T(r), T(t))),
        (jfn.score_heads(params, J(cand), J(r), J(t)),
         pfn.score_heads(pparams, T(cand), T(r), T(t))),
        (jfn.score_tails(params, J(h), J(r), J(cand)),
         pfn.score_tails(pparams, T(h), T(r), T(cand))),
    ]
    for scheme in ("h", "t"):
        pairs.append((jfn.distance_query_vector(params, J(h), J(r), scheme),
                      pfn.distance_query_vector(pparams, T(h), T(r), scheme)))
    # The p = 2 decomposition cancels: its error is bounded by |a|² + |b|²,
    # here at most 2 · 16 · (1/16)² — 1e-5 of that absolute.
    for want, got in pairs:
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("adversarial", [False, True])
@pytest.mark.parametrize("weight", ["scalar", "vector"])
def test_log_sigmoid_loss_matches_jax(adversarial, weight):
    rng = np.random.default_rng(6)
    pos = rng.normal(size=12).astype(np.float32) - 5
    neg = rng.normal(size=(12, 9)).astype(np.float32) - 5
    w = np.float32(0.7) if weight == "scalar" else rng.random(12).astype(np.float32)
    kw = dict(margin=3.0, negative_adversarial_sampling=adversarial,
              negative_adversarial_scale=0.5, loss_scale=2.0)
    want = jax_loss.LogSigmoidLoss(**kw)(jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(w))
    neg_t = torch.from_numpy(neg).requires_grad_()
    got = port_loss.LogSigmoidLoss(**kw)(torch.from_numpy(pos), neg_t, torch.tensor(w))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    # The adversarial weights carry no gradient, as the JAX package's.
    jgrad = jax.grad(lambda n: jax_loss.LogSigmoidLoss(**kw)(jnp.asarray(pos), n, jnp.asarray(w)))(
        jnp.asarray(neg))
    (tgrad,) = torch.autograd.grad(got, neg_t)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-7)


# --------------------------------------------------------------------------
# The dense training step


def _forms(fused):
    """(JAX optimizer, JAX entity optimizer, port optimizer, port entity
    optimizer) of one dense form."""
    if fused:
        return (optax.adamw(LR), jax_optim.FusedDenseAdamW(LR, weight_decay=1e-4),
                port_optim.AdamW(LR), port_optim.FusedDenseAdamW(LR, weight_decay=1e-4))
    return optax.adamw(LR), None, port_optim.AdamW(LR), None


def _port_state(params, state):
    return (convert.params_from_jax({k: np.asarray(v) for k, v in params.items()}, "cpu"),
            convert.opt_state_from_jax(jax.tree.map(np.asarray, state), "cpu"))


def _flat_state(state):
    """Every moment of a state, by a stable name, as numpy: the JAX package's
    optax tuples and dicts, or the port's dicts."""
    if isinstance(state, dict) and set(state) == {"entity", "other"}:
        out = {f"entity.{k}": v for k, v in _flat_state(state["entity"]).items()}
        out.update({f"other.{k}": v for k, v in _flat_state(state["other"]).items()})
        return out
    if isinstance(state, (tuple, list)):  # optax.adamw: (ScaleByAdamState, ...)
        state = {"mu": state[0].mu, "nu": state[0].nu}
    out = {}
    for key in ("mu", "nu"):
        val = state.get(key)
        if isinstance(val, dict):
            out.update({f"{key}.{k}": v for k, v in val.items()})
        elif val is not None:
            out[key] = val
    return {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v)) for k, v in out.items()}


def _close(got, want, extra=0.0):
    tol = 1e-5 * (np.abs(want) + np.abs(want).max()) + extra
    err = np.abs(got - want)
    assert (err <= tol).all(), float((err - tol).max())


def _ratio(state, key, count, b1=0.9, b2=0.999, eps=1e-8):
    """``m̂/(√v̂ + eps)`` of param ``key``'s AdamW moments after step
    ``count``, from a JAX or a port state (``_flat_state`` names)."""
    flat = _flat_state(state)
    names = [n for n in (f"mu.{key}", f"other.mu.{key}") if n in flat]
    name = names[0] if names else "entity.mu"  # FusedDenseAdamW's table moments
    mu, nu = flat[name], flat[name.replace("mu", "nu", 1)]
    return (mu / (1 - b1**count)) / (np.sqrt(nu / (1 - b2**count)) + eps)


@pytest.mark.parametrize("fused", [False, True])
def test_two_dense_steps_match_jax(fused):
    jfn, jmod, jsampler = _setup(JAX, n_negative=3)
    _, pmod, _ = _setup(PORT, n_negative=3)
    opt, ent, popt, pent = _forms(fused)
    params = jfn.initial_params()
    state = jax_trainer.init_optimizer_state(opt, params, None, ent)
    jstep = jax_trainer.build_train_step(jmod, opt, None, ent, donate=False)
    pstep = port_trainer.build_train_step(pmod, popt, None, pent, device="cpu")
    for count, batch in enumerate(_batches(jsampler, 2), 1):
        pparams, pstate = _port_state(params, state)  # each step from the same state
        params, state, jout = jstep(params, state, batch)
        pparams, pstate, pout = pstep(pparams, pstate, batch)
        np.testing.assert_allclose(float(pout["loss"]), float(jout["loss"]), rtol=1e-5)
        for key in params:
            moved = LR * np.abs(_ratio(pstate, key, count) - _ratio(state, key, count))
            _close(pparams[key].numpy(), np.asarray(params[key]), moved)
        want_s, got_s = _flat_state(state), _flat_state(pstate)
        assert set(got_s) == set(want_s)
        for key in want_s:
            _close(got_s[key], want_s[key])
    if fused:
        assert int(pstate["entity"]["count"]) == int(state["entity"]["count"]) == 2
        assert int(pstate["other"]["count"]) == 2
    else:
        assert int(pstate["count"]) == int(state[0].count) == 2


def test_dense_step_with_sgd_matches_jax():
    """The dense step with the other dense optimizer: SGD with momentum."""
    jfn, jmod, jsampler = _setup(JAX)
    _, pmod, _ = _setup(PORT)
    params = jfn.initial_params()
    opt = optax.sgd(LR, momentum=0.9)
    state = jax_trainer.init_optimizer_state(opt, params, None)
    batch = _batches(jsampler, 1)[0]
    pparams, pstate = _port_state(params, state)
    params, state, jout = jax_trainer.build_train_step(jmod, opt, None, None, donate=False)(
        params, state, batch)
    pstep = port_trainer.build_train_step(pmod, port_optim.SGD(LR, 0.9), None, None,
                                          device="cpu")
    pparams, pstate, pout = pstep(pparams, pstate, batch)
    np.testing.assert_allclose(float(pout["loss"]), float(jout["loss"]), rtol=1e-5)
    for key in params:
        _close(pparams[key].numpy(), np.asarray(params[key]))
        _close(pstate["trace"][key].numpy(), np.asarray(state[0].trace[key]))


def test_dense_step_donate_false_leaves_the_inputs():
    jfn, _, jsampler = _setup(JAX)
    pfn, pmod, _ = _setup(PORT)
    batch = _batches(jsampler, 1)[0]
    for donate in (False, True):
        opt, ent = port_optim.AdamW(LR), port_optim.FusedDenseAdamW(LR)
        params = pfn.initial_params(device="cpu")
        state = port_trainer.init_optimizer_state(opt, params, None, ent)
        before = {k: v.clone() for k, v in params.items()}
        step = port_trainer.build_train_step(pmod, opt, None, ent, donate, "cpu")
        new_params, new_state, _ = step(params, state, batch)
        moved = not torch.equal(params["entity_embedding"], before["entity_embedding"])
        assert moved == donate
        assert bool(state["entity"]["mu"].any()) == donate  # the moments move in place
        assert not torch.equal(new_params["entity_embedding"], before["entity_embedding"])
        assert int(new_state["entity"]["count"]) == 1


# --------------------------------------------------------------------------
# Trainer


def test_dense_fit_matches_jax():
    triples = _triples(400)
    jfn, jmod, jsampler = _setup(JAX, triples=triples)
    _, pmod, psampler = _setup(PORT, triples=triples)
    params = jfn.initial_params()
    opt, ent, popt, pent = _forms(True)
    jtrainer = jax_trainer.Trainer(jmod, jsampler, opt, params=params, entity_optimizer=ent)
    ptrainer = port_trainer.Trainer(
        pmod, psampler, popt, None,
        convert.params_from_jax({k: np.asarray(v) for k, v in params.items()}, "cpu"), 0,
        pent, device="cpu",
    )
    want = jtrainer.fit(n_epochs=1, log_every=1)
    got = ptrainer.fit(n_epochs=1, log_every=1)
    assert got["steps"] == want["steps"] == 7
    np.testing.assert_allclose([r["loss"] for r in ptrainer.history],
                               [r["loss"] for r in jtrainer.history], rtol=1e-5)
    for key in ptrainer.params:
        _close(ptrainer.params[key].numpy(), np.asarray(jtrainer.params[key]))


def test_trainer_widens_for_interleaved_adamw():
    _, pmod, psampler = _setup(PORT, triples=_triples(200))
    row = port_optim.RowAdamW(LR, interleaved=True)
    trainer = port_trainer.Trainer(pmod, psampler, port_optim.AdamW(LR), entity_optimizer=row,
                                   device="cpu")
    assert trainer.params["entity_embedding"].shape == (3 * N_ENTITY, 2 * EMB)
    summary = trainer.fit(n_epochs=1)
    assert summary["steps"] == 4 and np.isfinite(summary["final_loss"])
    with pytest.raises(ValueError, match="rows"):
        port_trainer.Trainer(pmod, psampler, port_optim.AdamW(LR), entity_optimizer=row,
                             params={k: v[:-3] for k, v in trainer.params.items()}, device="cpu")
