"""The port's candidate-set evaluation against the JAX package's.

The same dataset, sharding, candidate sets and params (numpy, from a seed)
go through both packages on one shard: the JAX package with
``axis_name=None`` and ``mesh=None``, the port on the CPU. TransE-L1 and
DistMult, d = 32, 600 entities, fp32 scoring (bf16 scores on the JAX
package's CPU path are summed without an fp32 accumulator, ROADMAP §C; the
per-query candidate sets run no kernel on either side).

Tolerances:

* samplers, batches, masks and sort indices: bit for bit.
* scores: ``|got − want| ≤ 1e-5·(|want| + max|want|)``, fp32 sums of 32
  terms in another order.
* ranks and per-query metrics: equal for every query whose true score
  stands further than that tolerance from each candidate's (a candidate
  within it may fall on either side in either package). Metric sums: the
  same, plus for each near-tie query the most its metric can move (1), and
  the rounding of an fp32 sum (2·n·2^-24 relative).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from besskge_tpu import batch_sampler as jax_bs
from besskge_tpu import bess as jax_bess
from besskge_tpu import dataset as jax_ds
from besskge_tpu import eval_loop as jax_eval
from besskge_tpu import loss as jax_loss
from besskge_tpu import metric as jax_metric
from besskge_tpu import negative_sampler as jax_ns
from besskge_tpu import optim as jax_optim
from besskge_tpu import scoring as jax_scoring
from besskge_tpu import sharding as jax_sh
from besskge_tpu import trainer as jax_trainer
from besskge_tpu_torch import batch_sampler as port_bs
from besskge_tpu_torch import bess as port_bess
from besskge_tpu_torch import dataset as port_ds
from besskge_tpu_torch import eval_loop as port_eval
from besskge_tpu_torch import loss as port_loss
from besskge_tpu_torch import metric as port_metric
from besskge_tpu_torch import negative_sampler as port_ns
from besskge_tpu_torch import optim as port_optim
from besskge_tpu_torch import scoring as port_scoring
from besskge_tpu_torch import sharding as port_sh
from besskge_tpu_torch import trainer as port_trainer

N_ENTITY, N_RELATION, DIM, N_TRIPLE, N_NEG = 600, 7, 32, 500, 40
RTOL = 1e-5
U32 = 2.0**-24

JAX = (jax_ds, jax_sh, jax_ns, jax_bs, jax_scoring, jax_bess, jax_metric)
PORT = (port_ds, port_sh, port_ns, port_bs, port_scoring, port_bess, port_metric)

_rng = np.random.default_rng(0)
TRIPLES = np.stack([_rng.integers(N_ENTITY, size=N_TRIPLE), _rng.integers(N_RELATION, size=N_TRIPLE),
                    _rng.integers(N_ENTITY, size=N_TRIPLE)], 1).astype(np.int32)


def _candidates(outer, side, seed=1):
    """(outer, N_NEG) candidates; per-triple ones never hold the triple's own
    head (``side`` 0) or tail (2), so that no candidate ties the true score."""
    rng = np.random.default_rng(seed)
    if outer == 1:
        return rng.integers(N_ENTITY, size=(1, N_NEG)).astype(np.int32)
    shift = 1 + rng.integers(N_ENTITY - 1, size=(outer, N_NEG))
    return ((TRIPLES[:, side, None] + shift) % N_ENTITY).astype(np.int32)


def _params(scorer, sharing):
    """The JAX package's initial params (numpy)."""
    sharding = jax_sh.Sharding.create(N_ENTITY, 1, seed=0)
    return _score_fn(jax_scoring, scorer, sharing, sharding).initial_params()


def _score_fn(sc, scorer, sharing, sharding):
    if scorer == "TransE":
        return sc.TransE(negative_sample_sharing=sharing, scoring_norm=1, sharding=sharding,
                         n_relation_type=N_RELATION, embedding_size=DIM, seed=0)
    return sc.DistMult(negative_sample_sharing=sharing, sharding=sharding,
                       n_relation_type=N_RELATION, embedding_size=DIM, seed=0)


def _setup(pkg, scheme, flat, scorer="TransE", reduction="none", shard_bs=48, bps=3,
           mask_on_gather=False, n_shard=1):
    ds_mod, sh_mod, ns_mod, bs_mod, sc_mod, bess_mod, metric_mod = pkg
    outer = 1 if flat else N_TRIPLE
    ds = ds_mod.KGDataset(
        n_entity=N_ENTITY, n_relation_type=N_RELATION, triples={"valid": TRIPLES},
        original_triple_ids={"valid": np.arange(N_TRIPLE)},
        neg_heads={"valid": _candidates(outer, 0)}, neg_tails={"valid": _candidates(outer, 2, 2)},
    )
    sharding = sh_mod.Sharding.create(N_ENTITY, n_shard, seed=0)
    pts = sh_mod.PartitionedTripleSet.create_from_dataset(ds, "valid", sharding,
                                                         partition_mode="ht_shardpair")
    ns = ns_mod.TripleBasedShardedNegativeSampler(
        pts.neg_heads if scheme != "t" else None, pts.neg_tails if scheme != "h" else None,
        sharding, scheme, seed=0, mask_on_gather=mask_on_gather, return_sort_idx=True,
    )
    sampler = bs_mod.RigidShardedBatchSampler(
        pts, ns, shard_bs=shard_bs, batches_per_step=bps, seed=0,
        duplicate_batch=scheme == "ht", return_triple_idx=True,
    )
    if n_shard > 1:  # the sampler alone (host-side)
        return None, sampler, pts
    score_fn = _score_fn(sc_mod, scorer, flat, sharding)
    evaluation = metric_mod.Evaluation(["mrr", "hits@3"], reduction=reduction, return_ranks=True)
    kw = {"axis_name": None} if pkg is JAX else {}
    module = bess_mod.ScoreMovingBessKGE(ns, score_fn, evaluation=evaluation, return_scores=True,
                                         **kw)
    return module, sampler, pts


def _forward(pkg, module, params, batch):
    if pkg is JAX:
        fwd = jax_bess.build_bess_forward(module, None)
        out = fwd({k: jnp.asarray(v) for k, v in params.items()},
                  {k: jnp.asarray(v) for k, v in batch.items()})
    else:
        fwd = port_bess.build_bess_forward(module, device="cpu")
        out = fwd({k: torch.from_numpy(v) for k, v in params.items()}, batch)
    return {k: np.asarray(v, np.float64) for k, v in out.items()}


def _tol(want):
    return RTOL * (np.abs(want) + np.abs(want).max())


def _clear(pos, neg):
    """Queries whose true score stands further than the tolerance from
    every candidate's (masked candidates sit at the sentinel)."""
    real = neg[neg > port_bess.BAD_NEGATIVE_SCORE / 2]
    tol = _tol(np.concatenate([pos.reshape(-1), real])).max()
    return (np.abs(neg - pos[..., None]) > tol).all(-1)


def _hold_scores(got, want):
    for key in ("positive_score", "negative_score"):
        assert got[key].shape == want[key].shape, key
        assert (np.abs(got[key] - want[key]) <= _tol(want[key])).all(), key
    clear = _clear(want["positive_score"], want["negative_score"])
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got["ranks"][clear], want["ranks"][clear])
    return clear


# --------------------------------------------------------------------------
# TripleBasedShardedNegativeSampler


@pytest.mark.parametrize("n_shard", [1, 4])
@pytest.mark.parametrize("mask_on_gather", [False, True])
@pytest.mark.parametrize("flat", [True, False])
@pytest.mark.parametrize("scheme", ["h", "t", "ht"])
def test_triple_based_sampler_is_bit_equal(scheme, flat, mask_on_gather, n_shard):
    """Every array of the sampler and of the batches it gives, over one and
    four shards (shard bucketing, cyclic padding, both mask layouts)."""
    _, want_sampler, _ = _setup(JAX, scheme, flat, mask_on_gather=mask_on_gather,
                                n_shard=n_shard, shard_bs=24)
    _, got_sampler, _ = _setup(PORT, scheme, flat, mask_on_gather=mask_on_gather,
                               n_shard=n_shard, shard_bs=24)
    want, got = want_sampler.negative_sampler, got_sampler.negative_sampler
    assert got.flat_negative_format == want.flat_negative_format == flat
    assert got.n_negative_per_shard == want.n_negative_per_shard
    names = [n for n in vars(want) if isinstance(getattr(want, n), np.ndarray)]
    assert {"sort_neg_idx", "mask"} & set(names) or {"sort_neg_h_idx", "mask_h"} <= set(names)
    for name in names:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    n = 0
    for w_block, g_block in zip(want_sampler.epoch_index_blocks(False),
                                got_sampler.epoch_index_blocks(False)):
        w_batch, g_batch = want_sampler.sample_batch(w_block), got_sampler.sample_batch(g_block)
        assert w_batch.keys() == g_batch.keys()
        assert {"negative", "negative_mask", "negative_sort_idx"} <= set(g_batch)
        for key in w_batch:
            assert g_batch[key].dtype == w_batch[key].dtype, key
            np.testing.assert_array_equal(g_batch[key], w_batch[key], err_msg=key)
        n += 1
    assert n > 1 and len(want_sampler) == len(got_sampler)


def test_triple_based_sampler_checks_match():
    sharding = port_sh.Sharding.create(50, 1, seed=0)
    negs = np.zeros((3, 4), np.int32)
    for sh_mod, ns_mod in ((jax_sh, jax_ns), (port_sh, port_ns)):
        sh = sh_mod.Sharding.create(50, 1, seed=0)
        for heads, tails, scheme, match in [(negs, negs[:2], "ht", "same shape"),
                                            (None, negs, "h", "requires negative_heads"),
                                            (negs, None, "t", "requires negative_tails"),
                                            (None, None, "t", "Provide")]:
            with pytest.raises(ValueError, match=match):
                ns_mod.TripleBasedShardedNegativeSampler(heads, tails, sh, scheme, 0)
    assert sharding.n_shard == 1


# --------------------------------------------------------------------------
# ScoreMovingBessKGE, build_bess_forward, BessKGE.forward's metrics


@pytest.mark.parametrize("scorer", ["TransE", "DistMult"])
@pytest.mark.parametrize("flat", [True, False])
@pytest.mark.parametrize("scheme", ["h", "t", "ht"])
def test_score_moving_matches_jax(scheme, flat, scorer):
    """Positive and negative scores, the masks of padded candidates, ranks
    and per-query metrics over a whole pass, flat (one candidate set, sharing)
    and per-triple sets."""
    params = _params(scorer, flat)
    want_mod, want_sampler, _ = _setup(JAX, scheme, flat, scorer)
    got_mod, got_sampler, _ = _setup(PORT, scheme, flat, scorer)
    n_clear = 0
    for block in want_sampler.epoch_index_blocks(False):
        batch = want_sampler.sample_batch(block)
        want = _forward(JAX, want_mod, params, batch)
        got = _forward(PORT, got_mod, params, batch)
        assert got.keys() == want.keys() == {"positive_score", "negative_score", "ranks",
                                             "metrics"}
        clear = _hold_scores(got, want)
        # metrics (bps, 1, n_metric, bs): masked triples count 0.
        m_clear = np.broadcast_to(clear.reshape(clear.shape[0], 1, 1, -1),
                                  want["metrics"].shape)
        np.testing.assert_array_equal(got["metrics"][m_clear], want["metrics"][m_clear])
        n_clear += int(clear.sum())
    assert n_clear > 0


def test_score_moving_flat_scores_one_copy():
    """A flat candidate set is scored once: the columns of a query are its
    shared candidates, padded ones at the sentinel."""
    params = _params("TransE", True)
    module, sampler, pts = _setup(PORT, "t", True)
    batch = sampler.sample_batch(next(sampler.epoch_index_blocks(False)))
    got = _forward(PORT, module, params, batch)
    assert got["negative_score"].shape[-1] == sampler.negative_sampler.n_negative_per_shard
    ent = params["entity_embedding"][module.sharding.entity_to_idx]
    h, r = TRIPLES[pts.triple_sort_idx[batch["triple_idx"].reshape(-1)[0]], :2]
    want = -np.abs(ent[h] + params["relation_embedding"][r] - ent[pts.neg_tails[0]]).sum(-1)
    np.testing.assert_allclose(got["negative_score"][0, 0, 0], want, rtol=1e-5, atol=1e-5)


def _train_setup(pkg):
    ds_mod, sh_mod, ns_mod, bs_mod, sc_mod, bess_mod, metric_mod = pkg
    loss_mod = jax_loss if pkg is JAX else port_loss
    ds = ds_mod.KGDataset(n_entity=N_ENTITY, n_relation_type=N_RELATION,
                          triples={"train": TRIPLES},
                          original_triple_ids={"train": np.arange(N_TRIPLE)})
    sharding = sh_mod.Sharding.create(N_ENTITY, 1, seed=0)
    pts = sh_mod.PartitionedTripleSet.create_from_dataset(ds, "train", sharding)
    ns = ns_mod.RandomShardedNegativeSampler(8, sharding, 0, "ht", local_sampling=False,
                                             flat_negative_format=True)
    sampler = bs_mod.RandomShardedBatchSampler(pts, ns, shard_bs=32, batches_per_step=2, seed=0)
    score_fn = _score_fn(sc_mod, "TransE", True, sharding)
    evaluation = metric_mod.Evaluation(["mrr", "hits@1"], reduction="none", return_ranks=True)
    kw = {"axis_name": None} if pkg is JAX else {}
    module = bess_mod.EmbeddingMovingBessKGE(
        ns, score_fn, loss_fn=loss_mod.LogSigmoidLoss(6.0, True), evaluation=evaluation,
        return_scores=True, augment_negative=True, **kw)
    return module, sampler


def test_embedding_moving_metrics_match_jax():
    """BessKGE.forward's evaluation branch (with return_ranks), and the
    metrics a training step returns, from the same state and batch."""
    params = _params("TransE", True)
    want_mod, want_sampler = _train_setup(JAX)
    got_mod, got_sampler = _train_setup(PORT)
    batch = want_sampler.sample_batch(next(want_sampler.epoch_index_blocks(True)))
    batch2 = got_sampler.sample_batch(next(got_sampler.epoch_index_blocks(True)))
    for key in batch:
        np.testing.assert_array_equal(batch2[key], batch[key])
    want = _forward(JAX, want_mod, params, batch)
    got = _forward(PORT, got_mod, params, batch)
    clear = _hold_scores(got, want)
    m_clear = np.broadcast_to(clear.reshape(clear.shape[0], 1, 1, -1), want["metrics"].shape)
    np.testing.assert_array_equal(got["metrics"][m_clear], want["metrics"][m_clear])
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])

    # The training step's outputs carry the same metrics.
    jstep = jax_trainer.build_train_step(want_mod, optax.sgd(0.01), None, jax_optim.RowSGDM(0.01))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jax_trainer.init_optimizer_state(optax.sgd(0.01), jparams, None,
                                              jax_optim.RowSGDM(0.01))
    _, _, jout = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    pstep = port_trainer.build_train_step(got_mod, port_optim.SGD(0.01), None,
                                          port_optim.RowSGDM(0.01), device="cpu")
    pparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    pstate = port_trainer.init_optimizer_state(port_optim.SGD(0.01), pparams, None,
                                               port_optim.RowSGDM(0.01))
    _, _, pout = pstep(pparams, pstate, batch)
    for key in ("ranks", "metrics"):
        assert tuple(pout[key].shape) == np.asarray(jout[key]).shape, key
    np.testing.assert_array_equal(pout["ranks"].numpy()[clear], np.asarray(jout["ranks"])[clear])


def test_forward_checks_match_jax():
    """The constructors raise where the JAX package's do."""
    sharing, per_triple = (_score_fn(port_scoring, "TransE", s, port_sh.Sharding.create(
        N_ENTITY, 1, seed=0)) for s in (True, False))
    module, sampler, _ = _setup(PORT, "t", False)
    ns = sampler.negative_sampler
    ev = port_metric.Evaluation(["mrr"])
    with pytest.raises(ValueError, match="sharing cannot be used"):
        port_bess.ScoreMovingBessKGE(ns, sharing, evaluation=ev)
    with pytest.raises(ValueError, match="does not support negative augmentation"):
        port_bess.ScoreMovingBessKGE(ns, sharing, evaluation=ev, augment_negative=True)
    with pytest.raises(ValueError, match="Nothing to return"):
        port_bess.ScoreMovingBessKGE(ns, per_triple)
    with pytest.raises(TypeError, match="ShardMesh"):
        port_bess.build_bess_forward(module, mesh="shard", device="cpu")
    flat_ns = port_ns.RandomShardedNegativeSampler(4, per_triple.sharding, 0, "t", False, True)
    with pytest.raises(ValueError, match="flat negative format"):
        port_bess.ScoreMovingBessKGE(flat_ns, per_triple, evaluation=ev)


# --------------------------------------------------------------------------
# run_device_eval and make_block_runner


def _stepwise(pkg, module, sampler, params):
    """Metric sums and query count of the notebook loop: one forward call
    per batch."""
    totals, n_q = 0.0, 0
    for batch in sampler.get_dataloader(shuffle=False):
        out = _forward(pkg, module, params, batch)
        totals = totals + out["metrics"].reshape(-1, out["metrics"].shape[-1]).sum(0)
        n_q += int(batch["triple_mask"].sum())
    return totals, n_q


@pytest.mark.parametrize("spb", [1, 4, 8])
def test_run_device_eval_matches_stepwise_and_jax(spb):
    """Blocks of ``spb`` steps (a ragged last block for 4 and 8: 21 steps)
    give the stepwise loop's sums, and the JAX package's run_device_eval's
    averages up to near-tie queries."""
    params = _params("TransE", False)
    got_mod, got_sampler, _ = _setup(PORT, "ht", False, reduction="sum", shard_bs=24, bps=2)
    want_mod, want_sampler, _ = _setup(JAX, "ht", False, reduction="sum", shard_bs=24, bps=2)
    n_steps = sum(1 for _ in got_sampler.epoch_index_blocks(False))
    assert n_steps == 21 and (spb == 1 or n_steps % spb)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    got, n_q = port_eval.run_device_eval(got_mod, tparams, got_sampler, steps_per_block=spb,
                                         device="cpu")
    sums, n_q2 = _stepwise(PORT, got_mod, got_sampler, params)
    assert n_q == n_q2 == 2 * N_TRIPLE  # every triple twice: duplicate_batch
    for i, name in enumerate(got):
        assert abs(got[name] - sums[i] / n_q) <= 4 * n_q * U32 * max(sums[i] / n_q, 1e-30)
    want, n_q3 = jax_eval.run_device_eval(
        want_mod, {k: jnp.asarray(v) for k, v in params.items()}, want_sampler, mesh=None,
        steps_per_block=spb)
    assert n_q3 == n_q and got.keys() == want.keys()
    # near ties: per-query scores of the JAX package's pass
    ev_mod, ev_sampler, _ = _setup(JAX, "ht", False, shard_bs=24, bps=2)
    n_near = 0
    for batch in ev_sampler.get_dataloader(shuffle=False):
        out = _forward(JAX, ev_mod, params, batch)
        near = ~_clear(out["positive_score"], out["negative_score"])
        n_near += int(near[batch["triple_mask"].reshape(near.shape)].sum())
    assert n_near < n_q / 100
    for name in got:
        assert abs(got[name] - want[name]) <= n_near / n_q + 8 * n_q * U32, name


def test_block_runner_pads_with_masked_steps():
    """make_block_runner over a block whose padding steps have an all-False
    triple_mask gives the sums of the real steps alone."""
    params = {k: torch.from_numpy(v) for k, v in _params("TransE", False).items()}
    module, sampler, _ = _setup(PORT, "t", False, reduction="sum", shard_bs=24, bps=2)
    run_block = port_eval.make_block_runner(module, device="cpu")
    steps = [{k: v for k, v in b.items() if k in port_bess._FORWARD_KEYS}
             for b, _ in zip(sampler.get_dataloader(shuffle=False), range(2))]
    two = run_block(params, port_eval._stack_block(steps, 2, torch.device("cpu")))
    padded = run_block(params, port_eval._stack_block(steps, 5, torch.device("cpu")))
    assert two.shape == (2,) and two.dtype == torch.float32
    torch.testing.assert_close(padded, two, rtol=0, atol=0)
    one = run_block(params, port_eval._stack_block(steps[:1], 1, torch.device("cpu")))
    assert (one < two).all() and (one > 0).all()


def test_run_device_eval_requires_sum_reduction():
    params = {k: torch.from_numpy(v) for k, v in _params("TransE", False).items()}
    module, sampler, _ = _setup(PORT, "t", False, reduction="none")
    with pytest.raises(ValueError, match="sum"):
        port_eval.run_device_eval(module, params, sampler, device="cpu")
    module.evaluation = None
    with pytest.raises(ValueError, match="evaluation is required"):
        port_eval.run_device_eval(module, params, sampler, device="cpu")
