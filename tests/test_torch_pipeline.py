"""The port's all-scores pipeline, its window step and candidate-set top-k
against the JAX package's.

The same dataset, sharding, queries, candidate sets and params (numpy, from
a seed) go through both packages on one shard: the JAX package with
``axis_name=None`` and ``mesh=None``, the port on the CPU. 600 entities,
d = 32 (128 where a table is packed), TransE-L1, DistMult and ComplEx.

Tolerances:

* filter pairs, column maps, the positions of filtered (``-inf``) entries
  and the port's table layouts against each other: bit for bit.
* fp32 scores: ``|got − want| ≤ 1e-5·(|want| + max|want|)``, fp32 sums of
  32 terms in another order. bf16 scores (the packed tables):
  ``2^-8·(|want| + max|want|)``: the two packages round the bf16 math at
  other places (XLA on the CPU keeps DistMult's ``h·r`` in fp32 inside its
  fusion, the port rounds it to bf16, as the card does), which moves a
  score by up to a bf16 ulp of its terms, and the fp32 sum of the products
  may then round to the neighbouring bf16 value.
* ranks and per-query metrics: equal for every query whose true score
  stands further than the score tolerance from every other entry of its
  row. Top-k IDs: equal as sets wherever the k-th and (k+1)-th scores stand
  further apart than twice the tolerance (``np.argsort`` is not stable, and
  the port takes the top-k with ``torch.topk``), each returned ID's own
  score among the k best.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from besskge_tpu import batch_sampler as jax_bs
from besskge_tpu import bess as jax_bess
from besskge_tpu import dataset as jax_ds
from besskge_tpu import metric as jax_metric
from besskge_tpu import negative_sampler as jax_ns
from besskge_tpu import packed as jax_packed
from besskge_tpu import pipeline as jax_pipeline
from besskge_tpu import scoring as jax_scoring
from besskge_tpu import sharding as jax_sh
from besskge_tpu import utils as jax_utils
from besskge_tpu_torch import batch_sampler as port_bs
from besskge_tpu_torch import bess as port_bess
from besskge_tpu_torch import dataset as port_ds
from besskge_tpu_torch import eval_loop as port_eval
from besskge_tpu_torch import metric as port_metric
from besskge_tpu_torch import negative_sampler as port_ns
from besskge_tpu_torch import optim as port_optim
from besskge_tpu_torch import packed as port_packed
from besskge_tpu_torch import pipeline as port_pipeline
from besskge_tpu_torch import scoring as port_scoring
from besskge_tpu_torch import sharding as port_sh
from besskge_tpu_torch import utils as port_utils

N_ENTITY, N_RELATION, DIM, N_QUERY, K = 600, 5, 32, 200, 7
RTOL = 1e-5
BF16 = 2.0**-8

JAX = (jax_ds, jax_sh, jax_ns, jax_bs, jax_scoring, jax_bess, jax_metric)
PORT = (port_ds, port_sh, port_ns, port_bs, port_scoring, port_bess, port_metric)

_rng = np.random.default_rng(7)
TRIPLES = np.stack([_rng.integers(N_ENTITY, size=N_QUERY), _rng.integers(N_RELATION, size=N_QUERY),
                    _rng.integers(N_ENTITY, size=N_QUERY)], 1).astype(np.int32)
# Known triples: each query's own, and 3 more tails and 3 more heads for half
# of them.
_extra = np.repeat(TRIPLES[: N_QUERY // 2], 3, axis=0)
_extra[:, 2] = _rng.integers(N_ENTITY, size=len(_extra))
_extra_h = np.repeat(TRIPLES[: N_QUERY // 2], 3, axis=0)
_extra_h[:, 0] = _rng.integers(N_ENTITY, size=len(_extra_h))
FILTER = np.concatenate([TRIPLES, _extra, _extra_h]).astype(np.int32)


def _tol(want, bf16=False):
    """The score tolerance of each entry (0 at the -inf of filtered ones)."""
    mag = np.where(np.isfinite(want), np.abs(want), 0.0)
    return (BF16 if bf16 else RTOL) * (mag + mag.max())


def _dataset(ds_mod):
    return ds_mod.KGDataset(n_entity=N_ENTITY, n_relation_type=N_RELATION,
                            triples={"test": TRIPLES},
                            original_triple_ids={"test": np.arange(N_QUERY)})


def _score_fn(sc, scorer, sharding, sharing=True, dim=DIM):
    if scorer == "TransE":
        return sc.TransE(sharing, 1, sharding, N_RELATION, dim, seed=0)
    if scorer == "ComplEx":
        return sc.ComplEx(sharing, sharding, N_RELATION, dim // 2, seed=0)
    return sc.DistMult(sharing, sharding, N_RELATION, dim, seed=0)


def _to(pkg, params):
    if pkg is JAX:
        return {k: jnp.asarray(v) for k, v in params.items()}
    return {k: v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
            for k, v in params.items()}


# --------------------------------------------------------------------------
# get_entity_filter


@pytest.mark.parametrize("mode", ["h", "t"])
def test_get_entity_filter_is_bit_equal(mode):
    rng = np.random.default_rng(3)
    tri = TRIPLES[rng.permutation(N_QUERY)[:80]]
    want = jax_utils.get_entity_filter(tri, FILTER, mode)
    got = port_utils.get_entity_filter(tri, FILTER, mode)
    assert got.dtype == want.dtype == np.int64 and got.shape[1] == 2 and len(got) > 80
    np.testing.assert_array_equal(got, want)
    unknown = FILTER + np.array([0, N_RELATION, 0], np.int32)  # no query matches
    none = port_utils.get_entity_filter(tri, unknown, mode)
    assert none.shape == (0, 2) and none.dtype == np.int64
    with pytest.raises(ValueError, match="filter_mode"):
        port_utils.get_entity_filter(tri, FILTER, "ht")


# --------------------------------------------------------------------------
# AllScoresBESS and build_allscores_forward

LAYOUTS = ("plain", "paired", "trebled", "packed", "tripled", "quintupled")


def _layout(table, layout):
    """The plain fp32 (N, D) table in another of the port's layouts; the
    packed ones hold its bf16 values."""
    if layout == "plain":
        return table
    if layout == "paired":
        return port_optim.interleave_momentum(table, torch.full_like(table, 7.0))
    if layout == "trebled":
        return port_optim.interleave_adamw(table, torch.full_like(table, 7.0))
    packed = port_packed.pack_table(table.to(torch.bfloat16))
    if layout == "tripled":
        return port_packed.interleave_packed_momentum(packed)
    if layout == "quintupled":
        return port_packed.interleave_packed_adamw(packed)
    return packed


def _allscores(pkg, params, scheme, window, dtype=None, dim=DIM, scorer="DistMult"):
    _, sh_mod, ns_mod, bs_mod, sc_mod, bess_mod, _ = pkg
    sharding = sh_mod.Sharding.create(N_ENTITY, 1, seed=0)
    pts = sh_mod.PartitionedTripleSet.create_from_dataset(
        _dataset(pkg[0]), "test", sharding, partition_mode="h_shard" if scheme == "t" else "t_shard")
    ns = ns_mod.PlaceholderNegativeSampler(scheme)
    sampler = bs_mod.RigidShardedBatchSampler(pts, ns, shard_bs=32, batches_per_step=2, seed=0)
    score_fn = _score_fn(sc_mod, scorer, sharding, dim=dim)
    if dtype is not None:
        score_fn.dtype = dtype
    if pkg is JAX:
        module = bess_mod.AllScoresBESS(ns, score_fn, window, axis_name=None)
        fwd = bess_mod.build_allscores_forward(module, None)
        run = lambda b, i: np.asarray(fwd(_to(JAX, params), _to(JAX, b), jnp.asarray(i)))
    else:
        module = bess_mod.AllScoresBESS(ns, score_fn, window)
        fwd = bess_mod.build_allscores_forward(module, device="cpu")
        run = lambda b, i: fwd(params, b, i).float().numpy()
    batch = sampler.sample_batch(next(sampler.epoch_index_blocks(False)))
    return [run(batch, i) for i in range(module.n_step)], module


def _stitch(chunks, window, gathered):
    """The windows (bps, 1, shard_bs, window) as one (queries, entities)
    matrix of local rows, by the window index math: a contiguous window
    clamps its start, a gathered one clamps its rows."""
    full = np.full((chunks[0].shape[0] * chunks[0].shape[2], N_ENTITY), np.nan, np.float32)
    for i, c in enumerate(chunks):
        if gathered:
            rows = np.minimum(i * window + np.arange(window), N_ENTITY - 1)
        else:
            rows = min(i * window, N_ENTITY - window) + np.arange(window)
        full[:, rows] = c.reshape(-1, window)
    assert not np.isnan(full).any()
    return full


@pytest.mark.parametrize("window", [37, 38, 600, 700], ids=["odd", "clamped", "whole", "wider"])
@pytest.mark.parametrize("scheme", ["t", "h"])
def test_allscores_windows_match_jax_in_every_layout(scheme, window):
    """Each window (bps, 1, shard_bs, window) against the JAX package's over a
    plain table, and the port's six layouts against each other, window by
    window where both read the same rows and stitched where an odd window
    over a packed table gathers (the plain table's is one contiguous read):
    the fp32 layouts equal to the plain table's bits, the packed ones to a
    plain bf16 table's."""
    params = _score_fn(jax_scoring, "DistMult", jax_sh.Sharding.create(N_ENTITY, 1, seed=0)
                       ).initial_params()
    want, jmod = _allscores(JAX, params, scheme, window)
    tparams = _to(PORT, params)
    got, pmod = _allscores(PORT, tparams, scheme, window)
    assert pmod.n_step == jmod.n_step == -(-N_ENTITY // window)
    for w, g in zip(want, got):
        assert g.shape == w.shape == (2, 1, 32, window)
        assert (np.abs(g - w) <= _tol(w)).all()
    table = tparams["entity_embedding"]
    bf16 = {**tparams, "entity_embedding": table.to(torch.bfloat16)}
    plain16, _ = _allscores(PORT, bf16, scheme, window, dtype=torch.bfloat16)
    wider = window > N_ENTITY
    for layout in LAYOUTS[1:]:
        lparams = {**tparams, "entity_embedding": _layout(table, layout)}
        packed = layout in ("packed", "tripled", "quintupled")
        got_l, _ = _allscores(PORT, lparams, scheme, window,
                              dtype=torch.bfloat16 if packed else None)
        ref = plain16 if packed else got
        if packed and window % 2 and not wider:
            np.testing.assert_array_equal(_stitch(got_l, window, True),
                                          _stitch(ref, window, False), err_msg=layout)
            continue
        for g, r in zip(got_l, ref):
            np.testing.assert_array_equal(g, r, err_msg=layout)


def test_allscores_packed_matches_jax_packed():
    """bf16 DistMult over row-pair-packed tables of both packages, windows
    contiguous (64), odd (37: gathered) and clamped (160)."""
    rng = np.random.default_rng(5)
    table = (rng.normal(size=(N_ENTITY, 128)) / 8).astype(np.float32)
    rel = (rng.normal(size=(N_RELATION, 128)) / 8).astype(np.float32)
    jtab = jax_packed.pack_table(jnp.asarray(table).astype(jnp.bfloat16))
    ptab = port_packed.pack_table(torch.from_numpy(table).to(torch.bfloat16))
    np.testing.assert_array_equal(ptab.view(torch.int32).numpy(),
                                  np.asarray(jtab).view(np.int32))
    for window in (64, 37, 160):
        want, _ = _allscores(JAX, {"entity_embedding": jtab,
                                   "relation_embedding": jnp.asarray(rel).astype(jnp.bfloat16)},
                             "t", window, dtype=jnp.bfloat16, dim=128)
        got, _ = _allscores(PORT, {"entity_embedding": ptab,
                                   "relation_embedding": torch.from_numpy(rel).to(torch.bfloat16)},
                            "t", window, dtype=torch.bfloat16, dim=128)
        for w, g in zip(want, got):
            w = w.astype(np.float32)
            assert (np.abs(g - w) <= _tol(w, bf16=True)).all(), window


# --------------------------------------------------------------------------
# AllScoresPipeline


def _pipeline(pkg, params, scheme, scorer="TransE", filters=True, candidates=None,
              reduction="none", window=29, packed=False, k=K):
    _, sh_mod, ns_mod, bs_mod, sc_mod, _, metric_mod = pkg
    sharding = sh_mod.Sharding.create(N_ENTITY, 1, seed=0)
    pts = sh_mod.PartitionedTripleSet.create_from_dataset(
        _dataset(pkg[0]), "test", sharding, partition_mode="h_shard" if scheme == "t" else "t_shard")
    ns = ns_mod.PlaceholderNegativeSampler(scheme)
    sampler = bs_mod.RigidShardedBatchSampler(pts, ns, shard_bs=24, batches_per_step=2, seed=0,
                                              return_triple_idx=True)
    score_fn = _score_fn(sc_mod, scorer, sharding, dim=128 if packed else DIM)
    if packed:
        score_fn.dtype = jnp.bfloat16 if pkg is JAX else torch.bfloat16
        score_fn.packed_entity_storage = True
    mod = jax_pipeline if pkg is JAX else port_pipeline
    kw = {} if pkg is JAX else {"device": "cpu"}
    pipe = mod.AllScoresPipeline(
        sampler, scheme, score_fn,
        evaluation=metric_mod.Evaluation(["mrr", "hits@3"], reduction=reduction,
                                         return_ranks=True),
        filter_triples=[FILTER] if filters else None, candidate_ents=candidates,
        return_scores=True, return_topk=True, k=k, window_size=window, **kw)
    out = pipe.forward(_to(pkg, params))
    return out, pts, pipe


def _hold_pipeline(got, want, bf16=False):
    assert got.keys() == want.keys() == {"scores", "topk_global_id", "triple_idx", "ranks",
                                         "metrics", "metrics_avg"}
    for key in ("scores", "topk_global_id", "triple_idx", "ranks"):
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
    np.testing.assert_array_equal(got["triple_idx"], want["triple_idx"])
    s_got, s_want = got["scores"], want["scores"]
    inf = np.isneginf(s_want)
    np.testing.assert_array_equal(np.isneginf(s_got), inf)
    tol = _tol(s_want, bf16)
    assert (np.abs(s_got[~inf] - s_want[~inf]) <= tol[~inf]).all()
    return tol


def _clear_ranks(scores, gt, tol):
    rows = np.arange(len(scores))
    true = scores[rows, gt]
    others = scores.copy()
    others[rows, gt] = np.nan
    with np.errstate(invalid="ignore"):
        near = np.abs(others - true[:, None]) <= tol.max()
    return ~near.any(1)


def _hold_topk_sets(ids, scores, k, tol):
    """Top-k IDs against the score matrix: each ID's score among the k best,
    and the IDs equal to the k best as sets where the k-th and (k+1)-th
    scores stand apart."""
    order = np.sort(scores, axis=1)[:, ::-1]
    own = np.take_along_axis(scores, ids, axis=1)
    assert (own >= order[:, k - 1:k] - 2 * tol.max()).all()
    sure = order[:, k - 1] - order[:, k] > 2 * tol.max()
    want = np.sort(np.argsort(-scores, axis=1, kind="stable")[:, :k], axis=1)
    np.testing.assert_array_equal(np.sort(ids, axis=1)[sure], want[sure])
    return int(sure.sum())


@pytest.mark.parametrize("reduction", ["none", "sum"])
@pytest.mark.parametrize("filters", [True, False])
@pytest.mark.parametrize("scheme", ["t", "h"])
def test_pipeline_matches_jax(scheme, filters, reduction):
    """Scores (filtered entries at -inf exactly where the JAX package puts
    them, the true score restored), ranks, metrics and top-k."""
    params = _score_fn(jax_scoring, "TransE", jax_sh.Sharding.create(N_ENTITY, 1, seed=0)
                       ).initial_params()
    want, pts, _ = _pipeline(JAX, params, scheme, filters=filters, reduction=reduction)
    got, _, pipe = _pipeline(PORT, params, scheme, filters=filters, reduction=reduction)
    tol = _hold_pipeline(got, want)
    orig = TRIPLES[pts.triple_sort_idx[got["triple_idx"]]]
    gt = orig[:, 0 if scheme == "h" else 2]
    scores = want["scores"]
    # The true score is restored; with filters, exactly the pairs of
    # get_entity_filter (but the true entity) are -inf.
    np.testing.assert_array_equal(np.isneginf(scores[np.arange(len(gt)), gt]), False)
    pairs = port_utils.get_entity_filter(orig, FILTER, scheme) if filters else np.zeros((0, 2), int)
    expect = np.zeros_like(scores, dtype=bool)
    expect[pairs[:, 0], pairs[:, 1]] = True
    expect[np.arange(len(gt)), gt] = False
    np.testing.assert_array_equal(np.isneginf(got["scores"]), expect)
    assert expect.sum() > (N_QUERY if filters else -1)
    clear = _clear_ranks(scores, gt, tol)
    assert clear.mean() > 0.75
    np.testing.assert_array_equal(got["ranks"][clear], want["ranks"][clear])
    if reduction == "none":
        for name in want["metrics"]:
            np.testing.assert_array_equal(got["metrics"][name][clear], want["metrics"][name][clear])
    for name, value in want["metrics_avg"].items():
        assert abs(got["metrics_avg"][name] - value) <= (~clear).mean() + 1e-6, name
    assert _hold_topk_sets(got["topk_global_id"], scores, K, tol) > N_QUERY // 2
    assert pipe.bess_module.n_step == -(-N_ENTITY // 29)


def test_pipeline_candidate_restriction_matches_jax():
    """candidate_ents: every other entity at -inf but the restored true
    scores; ranks, metrics and top-k among the candidates."""
    params = _score_fn(jax_scoring, "DistMult", jax_sh.Sharding.create(N_ENTITY, 1, seed=0)
                       ).initial_params()
    cands = np.unique(np.random.default_rng(4).integers(N_ENTITY, size=150)).astype(np.int32)
    want, pts, _ = _pipeline(JAX, params, "t", "DistMult", candidates=cands, window=50)
    got, _, _ = _pipeline(PORT, params, "t", "DistMult", candidates=cands, window=50)
    tol = _hold_pipeline(got, want)
    gt = TRIPLES[pts.triple_sort_idx[got["triple_idx"]], 2]
    non = np.setdiff1d(np.arange(N_ENTITY), cands)
    masked = np.isneginf(got["scores"][:, non])
    assert (masked | (non[None, :] == gt[:, None])).all()
    clear = _clear_ranks(want["scores"], gt, tol)
    np.testing.assert_array_equal(got["ranks"][clear], want["ranks"][clear])
    assert np.isin(got["topk_global_id"], np.union1d(cands, gt)).all()
    _hold_topk_sets(got["topk_global_id"], want["scores"], K, tol)


def test_pipeline_packed_table():
    """Over a row-pair-packed bf16 table: the port's pipeline equals its
    own over the plain bf16 table bit for bit, and the JAX package's packed
    pipeline within the bf16 tolerance."""
    rng = np.random.default_rng(6)
    table = (rng.normal(size=(N_ENTITY, 128)) / 8).astype(np.float32)
    rel = (rng.normal(size=(N_RELATION, 128)) / 8).astype(np.float32)
    tparams = {"entity_embedding": port_packed.pack_table(torch.from_numpy(table).to(torch.bfloat16)),
               "relation_embedding": torch.from_numpy(rel).to(torch.bfloat16)}
    got, pts, _ = _pipeline(PORT, tparams, "t", "DistMult", window=16, packed=True)
    plain = {"entity_embedding": torch.from_numpy(table).to(torch.bfloat16),
             "relation_embedding": tparams["relation_embedding"]}
    sharding = port_sh.Sharding.create(N_ENTITY, 1, seed=0)
    fn = _score_fn(port_scoring, "DistMult", sharding, dim=128)
    fn.dtype = torch.bfloat16
    sampler = port_bs.RigidShardedBatchSampler(
        pts, port_ns.PlaceholderNegativeSampler("t"), shard_bs=24, batches_per_step=2, seed=0,
        return_triple_idx=True)
    ref = port_pipeline.AllScoresPipeline(
        sampler, "t", fn, evaluation=port_metric.Evaluation(["mrr", "hits@3"], return_ranks=True),
        filter_triples=[FILTER], return_scores=True, return_topk=True, k=K, window_size=16,
        device="cpu").forward(plain)
    for key in ("scores", "ranks", "topk_global_id", "triple_idx"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    jparams = {"entity_embedding": jax_packed.pack_table(jnp.asarray(table).astype(jnp.bfloat16)),
               "relation_embedding": jnp.asarray(rel).astype(jnp.bfloat16)}
    want, _, _ = _pipeline(JAX, jparams, "t", "DistMult", window=16, packed=True)
    tol = _hold_pipeline(got, want, bf16=True)
    _hold_topk_sets(got["topk_global_id"], want["scores"], K, tol)
    with pytest.raises(ValueError, match="packedness"):
        _pipeline(PORT, plain, "t", "DistMult", window=16, packed=True)


def test_pipeline_checks_match_jax():
    params = _score_fn(jax_scoring, "TransE", jax_sh.Sharding.create(N_ENTITY, 1, seed=0)
                       ).initial_params()
    sharding = port_sh.Sharding.create(N_ENTITY, 1, seed=0)
    pts = port_sh.PartitionedTripleSet.create_from_dataset(_dataset(port_ds), "test", sharding,
                                                          partition_mode="h_shard")
    sampler = port_bs.RigidShardedBatchSampler(
        pts, port_ns.PlaceholderNegativeSampler("t"), shard_bs=24, batches_per_step=2, seed=0)
    fn = _score_fn(port_scoring, "TransE", sharding)
    with pytest.raises(ValueError, match="Nothing to return"):
        port_pipeline.AllScoresPipeline(sampler, "t", fn, device="cpu")
    with pytest.raises(ValueError, match="'t_shard'"):
        port_pipeline.AllScoresPipeline(sampler, "h", fn, return_scores=True, device="cpu")
    with pytest.raises(TypeError, match="ShardMesh"):
        port_pipeline.AllScoresPipeline(sampler, "t", fn, mesh="shard", return_scores=True,
                                        device="cpu")
    pipe = port_pipeline.AllScoresPipeline(sampler, "t", fn, filter_triples=[FILTER],
                                           return_scores=True, device="cpu")
    with pytest.raises(ValueError, match="return_triple_idx"):
        pipe.forward(_to(PORT, params))


# --------------------------------------------------------------------------
# Candidate-set top-k


def _topk(pkg, params, scorer, flat, window=None):
    ds_mod, sh_mod, ns_mod, bs_mod, sc_mod, bess_mod, metric_mod = pkg
    sharding = sh_mod.Sharding.create(N_ENTITY, 1, seed=0)
    rng = np.random.default_rng(8)
    if flat:
        cands = rng.permutation(N_ENTITY)[None, :300].astype(np.int32)
    else:  # duplicate-free rows (ranks_from_indices assumes distinct IDs)
        cands = np.argsort(rng.random((N_QUERY, N_ENTITY)), axis=1)[:, :45].astype(np.int32)
    # Ground truths: a candidate of the query's set for half the queries.
    pick = cands[np.arange(N_QUERY) % len(cands), rng.integers(cands.shape[1], size=N_QUERY)]
    truth = np.where(np.arange(N_QUERY) % 2 == 0, pick, TRIPLES[:, 2]).astype(np.int32)
    pts = sh_mod.PartitionedTripleSet.create_from_queries(
        _dataset(ds_mod), sharding, TRIPLES[:, :2], "hr", ground_truth=truth, negative=cands)
    ns = ns_mod.TripleBasedShardedNegativeSampler(None, pts.neg_tails, sharding, "t", seed=0,
                                                  mask_on_gather=True)
    sampler = bs_mod.RigidShardedBatchSampler(pts, ns, shard_bs=32, batches_per_step=2, seed=0,
                                              return_triple_idx=True)
    score_fn = _score_fn(sc_mod, scorer, sharding, sharing=flat)
    evaluation = metric_mod.Evaluation(["mrr", "hits@3"], worst_rank_infty=True,
                                       return_ranks=True)
    kw = {"axis_name": None} if pkg is JAX else {}
    topk = bess_mod.TopKQueryBessKGE(K, ns, score_fn, evaluation=evaluation, return_scores=True,
                                     window_size=window, **kw)
    if pkg is JAX:
        fwd = bess_mod.build_topk_forward(topk, None)
    else:
        fwd = bess_mod.build_topk_forward(topk, device="cpu")
    outs = []
    for block in sampler.epoch_index_blocks(False):
        batch = sampler.sample_batch(block)
        out = fwd(_to(pkg, params), _to(pkg, batch) if pkg is JAX else batch)
        outs.append(({k: np.asarray(v) for k, v in out.items()}, batch))
    return outs, cands, pts, topk, truth


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("scorer,flat", [("ComplEx", False), ("TransE", False),
                                         ("TransE", True), ("DistMult", True)])
def test_topk_candidate_sets_match_jax(scorer, flat, window):
    """Per-query candidate sets (no sharing) and one set shared by all
    queries (sharing; TransE's is the L1 distance path): scores, IDs, ranks
    and metrics against the JAX package's, and each query's top-k against a
    plain ranking of its own candidates' scores."""
    params = _score_fn(jax_scoring, scorer, jax_sh.Sharding.create(N_ENTITY, 1, seed=0),
                       sharing=flat).initial_params()
    want, cands, pts, jtopk, truth = _topk(JAX, params, scorer, flat, window)
    got, _, _, ptopk, _ = _topk(PORT, params, scorer, flat, window)
    assert ptopk.window_size == jtopk.window_size
    ent = params["entity_embedding"][jax_sh.Sharding.create(N_ENTITY, 1, seed=0).entity_to_idx]
    sc = _score_fn(jax_scoring, scorer, jax_sh.Sharding.create(N_ENTITY, 1, seed=0), sharing=True)
    n_sure = n_ranked = 0
    for (w, batch), (g, _) in zip(want, got):
        assert w.keys() == g.keys() == {"topk_global_id", "topk_scores", "ranks", "metrics"}
        for key in w:
            assert w[key].shape == g[key].shape and w[key].dtype == g[key].dtype, key
        tol = _tol(w["topk_scores"])
        assert (np.abs(g["topk_scores"] - w["topk_scores"]) <= tol).all()
        mask = batch["triple_mask"].reshape(-1)
        q = pts.triple_sort_idx[batch["triple_idx"].reshape(-1)[mask]]
        h, r = TRIPLES[q, 0], TRIPLES[q, 1]
        ref = np.asarray(sc.score_tails({"relation_embedding": jnp.asarray(
            params["relation_embedding"])}, jnp.asarray(ent[h]), jnp.asarray(r),
            jnp.asarray(ent)[None]))
        own = cands[0 if flat else q]
        ref_c = np.take_along_axis(ref, np.broadcast_to(own, (len(q), own.shape[-1])), axis=1)
        ids = g["topk_global_id"].reshape(-1, K)[mask]
        pos = {int(e): j for j, e in enumerate(own)} if flat else None
        cols = np.array([[pos[int(e)] for e in row] for row in ids]) if flat else \
            np.array([[np.flatnonzero(own[i] == e)[0] for e in row] for i, row in enumerate(ids)])
        n_sure += _hold_topk_sets(cols, ref_c, K, _tol(ref_c))
        w_ids = w["topk_global_id"].reshape(-1, K)[mask]
        sure = (np.sort(ref_c, 1)[:, -K] - np.sort(ref_c, 1)[:, -K - 1]) > 2 * _tol(ref_c).max()
        np.testing.assert_array_equal(np.sort(ids, 1)[sure], np.sort(w_ids, 1)[sure])
        # Ranks where the ground truth is no candidate (inf), or its score
        # stands clear of every other candidate's.
        gt = truth[q]
        own_b = np.broadcast_to(own, ref_c.shape)
        gt_score = ref[np.arange(len(q)), gt][:, None]
        clear = ((own_b == gt[:, None]) | (np.abs(ref_c - gt_score) > 2 * _tol(ref_c).max())).all(1)
        w_rank, g_rank = w["ranks"].reshape(-1)[mask], g["ranks"].reshape(-1)[mask]
        np.testing.assert_array_equal(g_rank[clear], w_rank[clear])
        n_ranked += int(np.isfinite(w_rank[clear]).sum())
    assert n_sure > N_QUERY // 2 and n_ranked > 0


def test_flat_candidate_set_scores_through_the_distance_matrix(monkeypatch):
    """A candidate set shared by all queries with TransE-L1 scores each
    window with one L1 distance matrix (B5 on a card; its plain version
    here), not the fused window op."""
    calls = []
    from besskge_tpu_torch.ops import l1_kernels

    orig = l1_kernels.l1_distance_matrix
    monkeypatch.setattr(l1_kernels, "l1_distance_matrix",
                        lambda a, b: calls.append(tuple(b.shape)) or orig(a, b))
    params = _score_fn(jax_scoring, "TransE", jax_sh.Sharding.create(N_ENTITY, 1, seed=0)
                       ).initial_params()
    outs, _, _, topk, _ = _topk(PORT, params, "TransE", True)
    assert topk.window_size == 512  # auto; clamped to the 300 candidates rounded up: 384
    assert calls == [(384, DIM)] * (2 * len(outs))


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sharding = port_sh.Sharding.create(300, 1, seed=0)
    fn = port_scoring.TransE(True, 1, sharding, 3, 16)
    ns = port_ns.PlaceholderNegativeSampler("t")
    module = port_bess.AllScoresBESS(ns, fn, 100)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_bess.build_allscores_forward(module)
    rnd = port_ns.RandomShardedNegativeSampler(3, sharding, 0, "t", False, True)
    sm = port_bess.ScoreMovingBessKGE(rnd, fn, evaluation=port_metric.Evaluation(["mrr"],
                                                                                 reduction="sum"))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_bess.build_bess_forward(sm)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_eval.make_block_runner(sm)
    pts = port_sh.PartitionedTripleSet.create_from_dataset(
        port_ds.KGDataset(n_entity=300, n_relation_type=3, triples={"test": TRIPLES % 3},
                          original_triple_ids={"test": np.arange(N_QUERY)}),
        "test", sharding, partition_mode="h_shard")
    sampler = port_bs.RigidShardedBatchSampler(pts, ns, shard_bs=8, batches_per_step=1, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_pipeline.AllScoresPipeline(sampler, "t", fn, return_scores=True)
