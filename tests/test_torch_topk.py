"""The port's top-k serving slice against the JAX package's, end to end.

The same dataset, sharding, queries and batches go through
``besskge_tpu.bess.build_topk_forward(mesh=None)`` (``axis_name=None``) and
``besskge_tpu_torch.bess.build_topk_forward(device="cpu")``, with the JAX
package's params carried over by ``params_from_jax``. TransE-L1, d = 128,
3072 entities on one shard.

Tolerances:

* scores: rtol 1e-5, atol 1e-4 — fp32 sums of 128 terms in another order.
  With bf16 compute outside the fused window path (the sort merge, or a
  window wider than the table) the scores themselves are bf16 (B5 returns
  a's dtype): the JAX package on the CPU reduces the bf16
  differences without an fp32 accumulator while the port, like the TPU
  kernel, accumulates in fp32, so the two may land on neighbouring bf16
  values: one ulp, 2^-8 at |score| < 1.
* IDs and ranks: both packages order tied scores their own way
  (``bess.py:708-709``), so an ID is compared only where its score is
  further than the score tolerance from both neighbours in the list. The
  last position is not compared: its tie partner may be the (k+1)-th entity,
  which neither list shows.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from besskge_tpu import batch_sampler as jax_bs
from besskge_tpu import bess as jax_bess
from besskge_tpu import dataset as jax_ds
from besskge_tpu import metric as jax_metric
from besskge_tpu import negative_sampler as jax_ns
from besskge_tpu import scoring as jax_scoring
from besskge_tpu import sharding as jax_sh
from besskge_tpu_torch import batch_sampler as port_bs
from besskge_tpu_torch import bess as port_bess
from besskge_tpu_torch import dataset as port_ds
from besskge_tpu_torch import metric as port_metric
from besskge_tpu_torch import negative_sampler as port_ns
from besskge_tpu_torch import scoring as port_scoring
from besskge_tpu_torch import sharding as port_sh
from besskge_tpu_torch.convert import params_from_jax
from besskge_tpu_torch.ops import l1_kernels

N_ENTITY, N_RELATION, DIM, N_QUERY, K = 3072, 7, 128, 96, 10
RTOL, ATOL = 1e-5, 1e-4
BF16_ULP = 2.0**-8


def _queries(scheme):
    rng = np.random.default_rng(17)
    known = rng.integers(N_ENTITY, size=N_QUERY)
    rel = rng.integers(N_RELATION, size=N_QUERY)
    queries = np.stack([known, rel] if scheme == "t" else [rel, known], 1)
    return queries.astype(np.int32), known, rel


def _ground_truth(params, sharding, known, rel, scheme, bf16):
    """Entity at position i % 12 of each query's reference ranking: ranks 1
    to 10, and two positions just outside the top-10."""
    ent = params["entity_embedding"][sharding.entity_to_idx]  # global order
    r = params["relation_embedding"][rel]
    q = ent[known] - r if scheme == "h" else ent[known] + r
    if bf16:
        q = q.astype(ml_dtypes.bfloat16).astype(np.float32)
        ent = ent.astype(ml_dtypes.bfloat16).astype(np.float32)
    scores = -np.abs(q[:, None, :] - ent[None, :, :]).sum(-1)
    order = np.argsort(-scores, axis=1, kind="stable")
    return order[np.arange(N_QUERY), np.arange(N_QUERY) % 12].astype(np.int32)


def _run(pkg, scheme, merge, bf16, window):
    jax_side = pkg == "jax"
    sh, ds, ns, bs, sc, bess, metric = (
        (jax_sh, jax_ds, jax_ns, jax_bs, jax_scoring, jax_bess, jax_metric)
        if jax_side
        else (port_sh, port_ds, port_ns, port_bs, port_scoring, port_bess, port_metric)
    )
    sharding = sh.Sharding.create(N_ENTITY, 1, seed=3)
    dataset = ds.KGDataset(
        n_entity=N_ENTITY, n_relation_type=N_RELATION,
        triples={"test": np.zeros((1, 3), np.int32)},
        original_triple_ids={"test": np.arange(1)},
    )
    score_fn = sc.TransE(
        negative_sample_sharing=True, scoring_norm=1, sharding=sharding,
        n_relation_type=N_RELATION, embedding_size=DIM, seed=5,
    )
    np_params = jax_scoring.TransE(
        True, 1, jax_sh.Sharding.create(N_ENTITY, 1, seed=3), N_RELATION, DIM, seed=5
    ).initial_params()
    queries, known, rel = _queries(scheme)
    gt = _ground_truth(np_params, sharding, known, rel, scheme, bf16)
    pts = sh.PartitionedTripleSet.create_from_queries(
        dataset, sharding, queries, "hr" if scheme == "t" else "rt", ground_truth=gt
    )
    sampler_ns = ns.PlaceholderNegativeSampler(corruption_scheme=scheme, seed=0)
    extra = {"use_native": False} if jax_side else {}
    sampler = bs.RigidShardedBatchSampler(
        pts, sampler_ns, shard_bs=32, batches_per_step=2, seed=0, **extra
    )
    evaluation = metric.Evaluation(
        ["mrr", "hits@1", "hits@10"], worst_rank_infty=True, return_ranks=True
    )
    kw = dict(
        k=K, candidate_sampler=sampler_ns, score_fn=score_fn, evaluation=evaluation,
        return_scores=True, window_size=window, merge_mode=merge,
    )
    if jax_side:
        if bf16:
            score_fn.compute_dtype = jnp.bfloat16
        fwd = bess.build_topk_forward(bess.TopKQueryBessKGE(axis_name=None, **kw), mesh=None)
        params = {k: jnp.asarray(v) for k, v in np_params.items()}
    else:
        if bf16:
            score_fn.compute_dtype = torch.bfloat16
        fwd = bess.build_topk_forward(bess.TopKQueryBessKGE(**kw), device="cpu")
        params = params_from_jax(np_params, "cpu")
    outs = []
    for block in sampler.epoch_index_blocks(shuffle=False):
        batch = sampler.sample_batch(block)
        if jax_side:
            batch = {k: jnp.asarray(v) for k, v in batch.items()}
        outs.append({k: np.asarray(v) for k, v in fwd(params, batch).items()})
    return outs


def _checked_positions(scores, tol):
    """(n, k) mask of list positions whose score is further than ``tol``
    from both neighbours; the last position is never checked."""
    gap = np.abs(np.diff(scores, axis=1)) > tol  # gap between j and j+1
    ok = np.zeros_like(scores, dtype=bool)
    ok[:, 0] = gap[:, 0]
    ok[:, 1:-1] = gap[:, :-1] & gap[:, 1:]
    return ok


@pytest.mark.parametrize("window", [1536, 1664, 4096], ids=["divides", "clamped", "gather"])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("scheme", ["t", "h"])
@pytest.mark.parametrize("merge", ["chunk", "sort"])
def test_topk_matches_jax(merge, scheme, bf16, window):
    want = _run("jax", scheme, merge, bf16, window)
    got = _run("port", scheme, merge, bf16, window)
    fused = merge == "chunk" and window <= N_ENTITY
    atol = ATOL if fused or not bf16 else BF16_ULP
    n_checked = 0
    assert len(want) == len(got) == 2
    for w, g in zip(want, got):
        assert w.keys() == g.keys() == {"topk_global_id", "topk_scores", "ranks", "metrics"}
        for key in w:
            assert w[key].shape == g[key].shape, key
            assert w[key].dtype == g[key].dtype, key
        assert w["topk_global_id"].shape == (2, 1, 32, K)
        assert w["metrics"].shape == (2, 1, 3, 32)
        np.testing.assert_allclose(g["topk_scores"], w["topk_scores"], rtol=RTOL, atol=atol)
        w_ids = w["topk_global_id"].reshape(-1, K)
        g_ids = g["topk_global_id"].reshape(-1, K)
        checked = _checked_positions(w["topk_scores"].reshape(-1, K), atol)
        np.testing.assert_array_equal(g_ids[checked], w_ids[checked])
        # Ranks: compare where the ground truth sits at a checked position
        # of the reference list, or in neither list.
        w_rank = w["ranks"].reshape(-1)
        g_rank = g["ranks"].reshape(-1)
        pos = np.where(np.isfinite(w_rank), w_rank - 1, 0).astype(int)
        sure = np.where(
            np.isfinite(w_rank), checked[np.arange(len(pos)), pos],
            ~np.isfinite(g_rank),
        )
        np.testing.assert_array_equal(g_rank[sure], w_rank[sure])
        w_met = np.moveaxis(w["metrics"], 3, 2).reshape(-1, 3)
        g_met = np.moveaxis(g["metrics"], 3, 2).reshape(-1, 3)
        np.testing.assert_allclose(g_met[sure], w_met[sure], rtol=1e-6)
        n_checked += int(sure.sum())
    # The comparison is not vacuous: a good share of the ranks was compared.
    assert n_checked >= N_QUERY // 4
    assert l1_kernels.l1_scores_chunkmax.launches == 0  # CPU: plain versions


def test_evaluation_matches_jax():
    rng = np.random.default_rng(1)
    ids = np.stack([rng.permutation(50)[:K] for _ in range(40)]).astype(np.int32)
    gt = np.where(rng.random(40) < 0.7, ids[np.arange(40), rng.integers(K, size=40)], 99)
    mask = rng.random(40) < 0.8
    pos = rng.normal(size=40).astype(np.float32)
    cand = rng.normal(size=(40, 30)).astype(np.float32)
    cand[:5, 3] = pos[:5]  # ties
    for mode in ("optimistic", "pessimistic", "average"):
        for infty in (False, True):
            for reduction in ("none", "sum"):
                args = (["mrr", "hits@1", "hits@3"], mode, infty, reduction)
                je, pe = jax_metric.Evaluation(*args), port_metric.Evaluation(*args)
                jr = je.ranks_from_indices(jnp.asarray(gt), jnp.asarray(ids))
                pr = pe.ranks_from_indices(torch.from_numpy(gt), torch.from_numpy(ids))
                np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
                np.testing.assert_allclose(
                    pe.stacked_metrics_from_ranks(pr, torch.from_numpy(mask)).numpy(),
                    np.asarray(je.stacked_metrics_from_ranks(jr, jnp.asarray(mask))),
                    rtol=1e-6,
                )
                np.testing.assert_array_equal(
                    pe.ranks_from_scores(torch.from_numpy(pos), torch.from_numpy(cand)).numpy(),
                    np.asarray(je.ranks_from_scores(jnp.asarray(pos), jnp.asarray(cand))),
                )


def test_entry_points_default_to_cuda_and_refuse_a_mesh(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sharding = port_sh.Sharding.create(300, 1, seed=0)
    fn = port_scoring.TransE(True, 1, sharding, 3, 16)
    ns = port_ns.PlaceholderNegativeSampler("t")
    topk = port_bess.TopKQueryBessKGE(k=5, candidate_sampler=ns, score_fn=fn)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_bess.build_topk_forward(topk)
    with pytest.raises(RuntimeError, match="CUDA"):
        fn.initial_params()
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"x": np.zeros(3, np.float32)})
    # Top-k over a mesh is ported (tests/test_torch_mesh.py): a mesh must be
    # a ShardMesh, a module over one needs it, and one without needs one shard.
    with pytest.raises(TypeError, match="ShardMesh"):
        port_bess.build_topk_forward(topk, mesh=object(), device="cpu")
    over_mesh = port_bess.TopKQueryBessKGE(k=5, candidate_sampler=ns, score_fn=fn,
                                           axis_name="shard")
    with pytest.raises(ValueError, match="mesh is required"):
        port_bess.build_topk_forward(over_mesh, device="cpu")
    with pytest.raises(ValueError, match="n_shard == 1"):
        port_bess.TopKQueryBessKGE(
            k=5, candidate_sampler=ns,
            score_fn=port_scoring.TransE(True, 1, port_sh.Sharding.create(300, 2, seed=0), 3, 16),
        )


def test_params_from_jax_keeps_bf16_bits():
    x = np.random.default_rng(0).normal(size=(5, 3)).astype(ml_dtypes.bfloat16)
    got = params_from_jax({"t": x}, "cpu")["t"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), x.astype(np.float32))
