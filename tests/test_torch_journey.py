"""The evaluation half of ``examples/train_and_evaluate.py`` on one shard,
the port against the JAX package.

The example's user journey, cut to one shard and a smaller table: RotatE
(p = 2, 16 complex dimensions) trained for two epochs by the port's
``Trainer`` (``RowAdamW`` on the table, ``AdamW`` on the relations, the
training step's own metrics on), with ``Trainer.fit(valid_fn=...)`` running
``run_device_eval`` each epoch; then, on the trained params, candidate-set
validation through ``build_bess_forward``, top-10 against all entities and
the filtered all-scores pipeline. Each stage runs in both packages on the
same (trained) params, converted with ``convert.params_to_numpy``.

Tolerances: fp32 scores within ``1e-5·(|want| + max|want|)`` (sums of 32
terms in another order). A metric averaged over n queries is held to the
JAX package's within ``n_near / n + 1e-6``, where ``n_near`` counts the
queries whose true score (or, for top-k, whose listed scores) has another
score within that tolerance: only those may rank differently.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from besskge_tpu import batch_sampler as jax_bs
from besskge_tpu import bess as jax_bess
from besskge_tpu import eval_loop as jax_eval
from besskge_tpu import metric as jax_metric
from besskge_tpu import negative_sampler as jax_ns
from besskge_tpu import pipeline as jax_pipeline
from besskge_tpu import scoring as jax_scoring
from besskge_tpu import sharding as jax_sh
from besskge_tpu_torch import convert, trainer
from besskge_tpu_torch.batch_sampler import RandomShardedBatchSampler, RigidShardedBatchSampler
from besskge_tpu_torch.bess import (
    EmbeddingMovingBessKGE,
    ScoreMovingBessKGE,
    TopKQueryBessKGE,
    build_bess_forward,
    build_topk_forward,
)
from besskge_tpu_torch.dataset import KGDataset
from besskge_tpu_torch.eval_loop import run_device_eval
from besskge_tpu_torch.loss import LogSigmoidLoss
from besskge_tpu_torch.metric import Evaluation
from besskge_tpu_torch.negative_sampler import (
    PlaceholderNegativeSampler,
    RandomShardedNegativeSampler,
    TripleBasedShardedNegativeSampler,
)
from besskge_tpu_torch.optim import AdamW, RowAdamW
from besskge_tpu_torch.pipeline import AllScoresPipeline
from besskge_tpu_torch.scoring import RotatE
from besskge_tpu_torch.sharding import PartitionedTripleSet, Sharding

N_ENTITY, N_RELATION, EMB = 500, 8, 16
RTOL = 1e-5


@pytest.fixture(scope="module")
def journey():
    """Dataset, sharding and the port's trained params (two epochs)."""
    rng = np.random.default_rng(0)
    h = rng.integers(N_ENTITY, size=6000)
    r = rng.integers(N_RELATION, size=6000)
    t = (h * 7 + r * 13 + 1) % N_ENTITY  # structured, learnable
    ds = KGDataset.from_triples(np.stack([h, r, t], 1).astype(np.int32), split=(0.85, 0.1, 0.05))
    cand = rng.integers(N_ENTITY, size=(ds.triples["valid"].shape[0], 64)).astype(np.int32)
    ds.neg_heads = {"valid": cand}
    ds.neg_tails = {"valid": cand}
    sharding = Sharding.create(ds.n_entity, 1, seed=0)
    score_fn = RotatE(True, 2, sharding, ds.n_relation_type, EMB, seed=0)
    ns = RandomShardedNegativeSampler(8, sharding, 0, "ht", local_sampling=False,
                                      flat_negative_format=True)
    train_bs = RandomShardedBatchSampler(
        PartitionedTripleSet.create_from_dataset(ds, "train", sharding), ns, shard_bs=64,
        batches_per_step=4, seed=0)
    module = EmbeddingMovingBessKGE(ns, score_fn, LogSigmoidLoss(6.0, True),
                                    evaluation=Evaluation(["mrr"], reduction="sum"))
    val_module, valid_bs = _validation(ds, sharding)
    fit = trainer.Trainer(module, train_bs, AdamW(3e-3), entity_optimizer=RowAdamW(3e-3),
                          device="cpu")
    outs = []
    summary = fit.fit(n_epochs=2, log_every=1, callback=lambda step, rec: outs.append(rec),
                      valid_fn=lambda p: run_device_eval(val_module, p, valid_bs,
                                                         steps_per_block=4, device="cpu")[0])
    return dict(ds=ds, sharding=sharding, score_fn=score_fn, trainer=fit, summary=summary,
                params=fit.params, val_module=val_module, valid_bs=valid_bs)


def _validation(ds, sharding):
    valid_pts = PartitionedTripleSet.create_from_dataset(ds, "valid", sharding)
    valid_ns = TripleBasedShardedNegativeSampler(valid_pts.neg_heads, valid_pts.neg_tails,
                                                 sharding, corruption_scheme="ht", seed=0)
    valid_bs = RigidShardedBatchSampler(valid_pts, valid_ns, shard_bs=64, batches_per_step=1,
                                        seed=0, duplicate_batch=True)
    val_fn = RotatE(False, 2, sharding, ds.n_relation_type, EMB)
    module = ScoreMovingBessKGE(valid_ns, val_fn,
                                evaluation=Evaluation(["mrr", "hits@10"], reduction="sum"))
    return module, valid_bs


def _jax_side(ds):
    """The JAX package's sharding of the dataset (the port's, entity for entity)."""
    return jax_sh.Sharding.create(ds.n_entity, 1, seed=0)


def _near(pos, cand, tol):
    return (np.abs(cand - pos[:, None]) <= tol).any(1)


def test_training_with_validation(journey):
    """Trainer.fit trains (loss falls), and its valid_fn records run_device_eval's
    metrics each epoch; the last equal a direct run on the trained params."""
    fit = journey["trainer"]
    losses = [rec["loss"] for rec in fit.history if "loss" in rec]
    valid = [rec["valid"] for rec in fit.history if "valid" in rec]
    assert len(valid) == 2 and np.isfinite(losses).all() and losses[-1] < losses[0]
    again, n_q = run_device_eval(journey["val_module"], journey["params"], journey["valid_bs"],
                                 steps_per_block=3, device="cpu")
    assert n_q == 2 * journey["ds"].triples["valid"].shape[0]
    for name in again:
        assert abs(again[name] - valid[-1][name]) <= 1e-6
    assert valid[-1]["mrr"] > valid[0]["mrr"] * 0.5


def test_candidate_set_validation_matches_jax(journey):
    """The example's validation loop (build_bess_forward over a Rigid sampler,
    ScoreMoving, 64 random candidates per triple, "ht"), and run_device_eval,
    against the JAX package's on the trained params."""
    ds, params = journey["ds"], convert.params_to_numpy(journey["params"])
    module, valid_bs = journey["val_module"], journey["valid_bs"]
    jsh = _jax_side(ds)
    jpts = jax_sh.PartitionedTripleSet.create_from_dataset(
        _jax_dataset(ds), "valid", jsh)
    jns = jax_ns.TripleBasedShardedNegativeSampler(jpts.neg_heads, jpts.neg_tails, jsh, "ht", 0)
    jbs = jax_bs.RigidShardedBatchSampler(jpts, jns, shard_bs=64, batches_per_step=1, seed=0,
                                          duplicate_batch=True)
    jmod = jax_bess.ScoreMovingBessKGE(
        jns, jax_scoring.RotatE(False, 2, jsh, ds.n_relation_type, EMB),
        evaluation=jax_metric.Evaluation(["mrr", "hits@10"], reduction="sum"),
        return_scores=True, axis_name=None)
    jfwd = jax_bess.build_bess_forward(jmod, None)
    pfwd = build_bess_forward(module, device="cpu")
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    total_j, total_p, count, n_near = np.zeros(2), np.zeros(2), 0, 0
    for block in valid_bs.epoch_index_blocks(shuffle=False):
        batch = valid_bs.sample_batch(block)
        out_j = {k: np.asarray(v) for k, v in jfwd(jparams, {k: jnp.asarray(v)
                                                            for k, v in batch.items()}).items()}
        out_p = pfwd(journey["params"], batch)
        total_j += out_j["metrics"].reshape(-1)
        total_p += out_p["metrics"].numpy().reshape(-1)
        count += int(batch["triple_mask"].sum())
        pos = out_j["positive_score"].reshape(-1)
        neg = out_j["negative_score"].reshape(len(pos), -1)
        tol = RTOL * 2 * max(np.abs(pos).max(), np.abs(neg).max())
        n_near += int(_near(pos, neg, tol)[batch["triple_mask"].reshape(-1)].sum())
    # 64 random candidates of 500 hold the true entity for ~12 % of the
    # triples: its score ties the true score but for the sums' order.
    assert n_near < count / 5
    np.testing.assert_allclose(total_p / count, total_j / count, rtol=0, atol=n_near / count + 1e-6)
    metrics, n_q = run_device_eval(module, journey["params"], valid_bs, device="cpu")
    assert n_q == count
    np.testing.assert_allclose(list(metrics.values()), total_j / count, rtol=0,
                               atol=n_near / count + 1e-6)
    jmod.return_scores = False
    want, _ = jax_eval.run_device_eval(jmod, jparams, jbs, mesh=None)
    for name in want:
        assert abs(metrics[name] - want[name]) <= n_near / count + 1e-6, name


def _jax_dataset(ds):
    from besskge_tpu.dataset import KGDataset as JaxKGDataset

    return JaxKGDataset(n_entity=ds.n_entity, n_relation_type=ds.n_relation_type,
                        triples=ds.triples, original_triple_ids=ds.original_triple_ids,
                        neg_heads=ds.neg_heads, neg_tails=ds.neg_tails)


def test_topk_and_filtered_pipeline_match_jax(journey):
    """Top-10 (h, r, ?) completions of the test triples against all
    entities (window 100), and the pipeline over them with the training
    triples filtered out (window 128), on the trained params."""
    ds, score_fn, sharding = journey["ds"], journey["score_fn"], journey["sharding"]
    params = convert.params_to_numpy(journey["params"])
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    test = ds.triples["test"]
    # Known triples: the training set (whose tails are those of the test
    # queries: the graph is a function of (h, r)) and other completions of
    # half the test queries.
    other = test[::2].copy()
    other[:, 2] = (other[:, 2] + 1 + np.arange(len(other)) % 50) % N_ENTITY
    known = [ds.triples["train"], other]
    jsh = _jax_side(ds)
    jscore = jax_scoring.RotatE(True, 2, jsh, ds.n_relation_type, EMB)
    runs = {}
    for side in ("jax", "port"):
        if side == "jax":
            pts = jax_sh.PartitionedTripleSet.create_from_queries(
                _jax_dataset(ds), jsh, test[:, :2], "hr", ground_truth=test[:, 2])
            ns, fn = jax_ns.PlaceholderNegativeSampler("t"), jscore
        else:
            pts = PartitionedTripleSet.create_from_queries(ds, sharding, test[:, :2], "hr",
                                                           ground_truth=test[:, 2])
            ns, fn = PlaceholderNegativeSampler("t"), score_fn
        sampler_cls = jax_bs.RigidShardedBatchSampler if side == "jax" else RigidShardedBatchSampler
        ev = (jax_metric.Evaluation if side == "jax" else Evaluation)(
            ["mrr", "hits@10"], worst_rank_infty=True, reduction="sum", return_ranks=True)
        topk_bs = sampler_cls(pts, ns, shard_bs=32, batches_per_step=1, seed=0)
        if side == "jax":
            topk = jax_bess.TopKQueryBessKGE(10, ns, fn, evaluation=ev, return_scores=True,
                                             window_size=100, axis_name=None)
            fwd = jax_bess.build_topk_forward(topk, None)
            run = lambda b: {k: np.asarray(v) for k, v in fwd(
                jparams, {k: jnp.asarray(v) for k, v in b.items()}).items()}
        else:
            topk = TopKQueryBessKGE(10, ns, fn, evaluation=ev, return_scores=True,
                                    window_size=100)
            fwd = build_topk_forward(topk, device="cpu")
            run = lambda b: {k: v.numpy() for k, v in fwd(journey["params"], b).items()}
        outs = [run(topk_bs.sample_batch(b)) for b in topk_bs.epoch_index_blocks(shuffle=False)]
        pipe_bs = sampler_cls(pts, ns, shard_bs=32, batches_per_step=1, seed=0,
                              return_triple_idx=True)
        pev = (jax_metric.Evaluation if side == "jax" else Evaluation)(
            ["mrr", "hits@10"], reduction="none", return_ranks=True)
        if side == "jax":
            pipe = jax_pipeline.AllScoresPipeline(pipe_bs, "t", fn, evaluation=pev,
                                                  filter_triples=known,
                                                  return_scores=True, window_size=128)
            piped = pipe.forward(jparams)
        else:
            pipe = AllScoresPipeline(pipe_bs, "t", fn, evaluation=pev,
                                     filter_triples=known, return_scores=True,
                                     window_size=128, device="cpu")
            piped = pipe.forward(journey["params"])
        runs[side] = (outs, piped, pts)

    (j_outs, j_pipe, jpts), (p_outs, p_pipe, _) = runs["jax"], runs["port"]
    n_q = test.shape[0]
    # Top-k: sums over queries; near ties among the listed scores.
    scores = np.concatenate([o["topk_scores"].reshape(-1, 10) for o in j_outs])
    tol = RTOL * 2 * np.abs(scores).max()
    n_near = int((np.abs(np.diff(scores, axis=1)) <= tol).any(1).sum())
    sums_j = sum(o["metrics"].reshape(-1) for o in j_outs)
    sums_p = sum(o["metrics"].reshape(-1) for o in p_outs)
    assert n_near < n_q / 10
    np.testing.assert_allclose(sums_p / n_q, sums_j / n_q, rtol=0, atol=n_near / n_q + 1e-6)
    np.testing.assert_allclose(
        np.concatenate([o["topk_scores"].reshape(-1, 10) for o in p_outs]), scores,
        rtol=0, atol=tol)
    # Pipeline: the filtered matrix, its -inf, ranks and averages.
    want = j_pipe["scores"]
    inf = np.isneginf(want)
    np.testing.assert_array_equal(np.isneginf(p_pipe["scores"]), inf)
    mag = np.abs(np.where(inf, 0.0, want))
    assert (np.abs(p_pipe["scores"][~inf] - want[~inf]) <= RTOL * (mag + mag.max())[~inf]).all()
    np.testing.assert_array_equal(p_pipe["triple_idx"], j_pipe["triple_idx"])
    gt = test[jpts.triple_sort_idx[j_pipe["triple_idx"]], 2]
    rows = np.arange(len(gt))
    others = np.where(np.arange(want.shape[1])[None] == gt[:, None], -np.inf, want)
    near = _near(want[rows, gt], others, RTOL * 2 * mag.max())
    np.testing.assert_array_equal(p_pipe["ranks"][~near], j_pipe["ranks"][~near])
    for name, value in j_pipe["metrics_avg"].items():
        assert abs(p_pipe["metrics_avg"][name] - value) <= near.mean() + 1e-6, name
    assert inf.sum() > 0 and p_pipe["metrics_avg"]["mrr"] > 0
