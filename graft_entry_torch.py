#!/usr/bin/env python3
"""Entry points of the PyTorch/CUDA port: a single-card forward
and a dry run of the whole BESS feature matrix over a mesh of ranks.

The port's twin of ``__graft_entry__.py``; it imports ``torch``, ``numpy``
and ``besskge_tpu_torch`` only.

* :func:`entry` returns ``(fn, example_args)``: the flagship RotatE +
  ``EmbeddingMovingBessKGE`` forward (``bess._device_step`` then
  ``bess._format_outputs``) and its params and batch on the card.
* :func:`dryrun_multichip` runs eleven sub-checks over an ``n``-rank
  ``"shard"`` mesh, each asserting golden parity against the unsharded
  model or an exact invariant, with ``__graft_entry__.py``'s set-ups and
  tolerances:

  1. EmbeddingMoving train step (dense AdamW) and a device-sampled step,
     which equals the host-fed step on the batch the sampler drew;
  2. ScoreMoving candidate eval: scores match the unsharded table;
  3. TopKQuery vs-all: top-k IDs and scores match the full unsharded matrix;
  4. AllScores windows: the stitched matrix matches the unsharded matrix;
  5. sparse RowSGDM: final tables match dense SGD on the same batches;
  6. packed-bf16 table (and a stochastic-rounding smoke): bit-identical to
     the plain-bf16 run;
  7. type-based sampling on the device: negatives match the consumer's type;
  8. interleaved RowSGDM: the pair-major (2N, D) table trained on the mesh
     (B4, ``fused_variant="fused"``) matches the separate-buffer run to fp32
     tolerance, and ``fused_pair_sgdm`` on each rank's own block matches
     the update formula;
  9. packed-fp16 table: bit-identical to the plain-fp16 run;
  10. triplet-interleaved packed table: RowSGDM ``interleaved=True`` over
      the (3P, D) store matches the separate-buffer packed run;
  11. quintuplet-interleaved packed AdamW: RowAdamW ``interleaved=True``
      over the (5P, D) store matches the separate-buffer packed run.

  The port runs one process per rank. Inside an initialised default group
  of ``n`` ranks the checks run there; outside one, ``n`` local ranks are
  started (``parallel.multihost._spawn``): gloo ranks on the CPU, or gloo
  ranks sharing the card, or NCCL ranks with a card each.

Usage::

    python3 graft_entry_torch.py                 # entry() on the card
    python3 graft_entry_torch.py --dryrun 4      # 4 NCCL ranks, a card each
    python3 graft_entry_torch.py --dryrun 4 --gloo   # 4 gloo ranks on the cards
    python3 graft_entry_torch.py --dryrun 4 --cpu    # 4 gloo ranks on the CPU
    torchrun --nproc_per_node=4 graft_entry_torch.py --dryrun 4   # NCCL

Without a card, and without ``--cpu``, it exits 1.
"""

from __future__ import annotations

import os
import sys
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from besskge_tpu_torch import packed as pk
from besskge_tpu_torch.batch_sampler import RigidShardedBatchSampler
from besskge_tpu_torch.bess import (
    BAD_NEGATIVE_SCORE,
    AllScoresBESS,
    EmbeddingMovingBessKGE,
    ScoreMovingBessKGE,
    TopKQueryBessKGE,
    _device_step,
    _format_outputs,
    build_allscores_forward,
    build_bess_forward,
    build_topk_forward,
)
from besskge_tpu_torch.dataset import KGDataset
from besskge_tpu_torch.device_sampler import DeviceBatchSampler
from besskge_tpu_torch.loss import LogSigmoidLoss
from besskge_tpu_torch.metric import Evaluation
from besskge_tpu_torch.negative_sampler import (
    PlaceholderNegativeSampler,
    RandomShardedNegativeSampler,
    TripleBasedShardedNegativeSampler,
    TypeBasedShardedNegativeSampler,
)
from besskge_tpu_torch.ops import adamw_kernels, l1_kernels, row_kernels
from besskge_tpu_torch.optim import (
    SGD,
    AdamW,
    RowAdamW,
    RowSGDM,
    interleave_momentum,
    split_interleaved,
)
from besskge_tpu_torch.parallel import collectives, make_shard_mesh, shard_params
from besskge_tpu_torch.parallel.mesh import ShardMesh, replicate_tree
from besskge_tpu_torch.parallel.multihost import _spawn, initialize
from besskge_tpu_torch.scoring import ComplEx, RotatE, TransE
from besskge_tpu_torch.sharding import PartitionedTripleSet, Sharding
from besskge_tpu_torch.trainer import (
    build_device_train_step,
    build_train_step,
    init_optimizer_state,
)
from besskge_tpu_torch.utils import resolve_device

Device = Optional[Union[str, torch.device]]

#: Seconds the ranks of a spawned dry run may take, their start included.
DRYRUN_TIMEOUT_S = 600.0

#: The kernel wrappers, by name, whose launches each sub-check counts.
KERNEL_WRAPPERS = {w.__name__: w for w in (
    *l1_kernels._WRAPPERS, row_kernels.scatter_rows, row_kernels.fused_pair_sgdm,
    row_kernels.scatter_rows_multi, row_kernels.gather_rows, adamw_kernels.dense_adamw_update)}


def _build(n_shard, n_entity=2000, n_relation=12, emb=64, shard_bs=64, n_negative=16, bps=2,
           seed=0, device="cuda", mesh=None):
    """A RotatE + EmbeddingMoving BESS set-up on synthetic data: (module,
    batch sampler, global params on ``device``, first batch, partitioned
    triples). Over a ``mesh`` the module runs over its ``"shard"`` axis and
    the params lie on the mesh's device."""
    rng = np.random.default_rng(seed)
    triples = np.stack(
        [rng.integers(n_entity, size=20000), rng.integers(n_relation, size=20000),
         rng.integers(n_entity, size=20000)], axis=1).astype(np.int32)
    ds = KGDataset(
        n_entity=n_entity, n_relation_type=n_relation, entity_dict=None, relation_dict=None,
        type_offsets=None, triples={"train": triples},
        original_triple_ids={"train": np.arange(triples.shape[0])}, neg_heads=None,
        neg_tails=None)
    sharding = Sharding.create(n_entity, n_shard, seed=seed)
    pts = PartitionedTripleSet.create_from_dataset(ds, "train", sharding)
    score_fn = RotatE(negative_sample_sharing=True, scoring_norm=2, sharding=sharding,
                      n_relation_type=n_relation, embedding_size=emb, seed=seed)
    ns = RandomShardedNegativeSampler(n_negative, sharding, seed, "ht", local_sampling=False,
                                      flat_negative_format=True)
    bs = RigidShardedBatchSampler(pts, ns, shard_bs=shard_bs, batches_per_step=bps, seed=seed)
    bess = EmbeddingMovingBessKGE(
        negative_sampler=ns, score_fn=score_fn,
        loss_fn=LogSigmoidLoss(margin=9.0, negative_adversarial_sampling=True),
        evaluation=Evaluation(["mrr", "hits@10"], reduction="sum"),
        # Over a mesh the "shard" axis stays at one rank too, so that its
        # collectives run.
        axis_name="shard" if mesh is not None or n_shard != 1 else None)
    batch = bs.sample_batch(next(bs.epoch_index_blocks(shuffle=False)))
    params = score_fn.initial_params(mesh.device if mesh is not None else device)
    return bess, bs, params, batch, pts


def entry(device: Device = "cuda") -> Tuple[Callable, Tuple[Dict[str, torch.Tensor], Dict]]:
    """(fn, example_args): the single-device forward of the flagship model,
    its params and batch on ``device`` (default the card)."""
    device = resolve_device(device)
    bess, _, params, batch, _ = _build(n_shard=1, device=device)
    tbatch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}

    def forward(params, batch):
        outs = _device_step(bess, params, batch)
        return _format_outputs(bess, outs)

    return forward, (params, tbatch)


# ----------------------------------------------------------------------
# dryrun_multichip sub-checks. Each takes (n, mesh) and returns (detail,
# arrays): the rank's final arrays, as numpy, for the tests to hold.


def _mini(n_shard, seed=7):
    """Sharded synthetic KG + fp32 tables + their unsharded (flat) view."""
    n_entity = 16 * n_shard + 3
    n_relation = 5
    emb = 16
    rng = np.random.default_rng(seed)
    sharding = Sharding.create(n_entity, n_shard, seed=seed)
    ent = rng.normal(size=(n_shard, sharding.max_entity_per_shard, 2 * emb)).astype(np.float32)
    rel = rng.normal(size=(n_relation, 2 * emb)).astype(np.float32)
    flat = ent[sharding.entity_to_shard, sharding.entity_to_idx]
    n_q = 8 * n_shard
    ds = KGDataset(n_entity=n_entity, n_relation_type=n_relation,
                   triples={"test": np.zeros((1, 3), np.int32)},
                   original_triple_ids={"test": np.arange(1)})
    return dict(
        sharding=sharding, n_entity=n_entity, n_relation=n_relation, emb=emb, ent=ent, rel=rel,
        flat=flat, rng=rng, ds=ds, q_h=rng.integers(n_entity, size=n_q),
        q_r=rng.integers(n_relation, size=n_q), q_truth=rng.integers(n_entity, size=n_q))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _col(x: np.ndarray, mesh: ShardMesh) -> np.ndarray:
    """The rank's ``(bps, 1, ...)`` column of a global batch array."""
    return x[:, mesh.rank:mesh.rank + 1]


def _small(n: int, mesh: ShardMesh, seed: int = 0):
    """The tiny training set-up of sub-checks 1 and 5-11."""
    return _build(n_shard=n, n_entity=16 * n + 3, emb=16, shard_bs=4 * n, n_negative=4, bps=1,
                  seed=seed, mesh=mesh)


def _mesh_sum(count: int, mesh: ShardMesh) -> int:
    """An integer summed over the mesh (a sub-check's global count)."""
    return int(collectives.psum(torch.tensor(count, device=mesh.device), mesh))


def _hold_fp32(what: str, got: torch.Tensor, want: torch.Tensor, rtol: float = 1e-5) -> float:
    """``|got − want| ≤ rtol·(|want| + max|want|)``; the largest error."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    tol = rtol * (want.abs() + want.abs().max())
    if not bool((err <= tol).all()):
        raise AssertionError(f"{what}: max|err| {float(err.max()):.3g} beyond rtol {rtol}")
    return float(err.max())


def _check_embedding_moving(n, mesh):
    """A dense AdamW step over the mesh, then a device-sampled step from its
    result, which equals the host-fed step on the batch the sampler drew
    (from the same state, within fp32 tolerance)."""
    bess, bs, params, batch, pts = _small(n, mesh)
    params = shard_params(params, mesh)
    optimizer = AdamW(1e-3)
    opt_state = init_optimizer_state(optimizer, params, mesh)
    step = build_train_step(bess, optimizer, mesh)
    new_params, new_state, out = step(params, opt_state, batch)
    loss = float(out["loss"])
    assert np.isfinite(loss), loss

    dev = DeviceBatchSampler(pts, bs.negative_sampler, shard_bs=4 * n, batches_per_step=1, seed=0)
    dstep = build_device_train_step(bess, optimizer, dev, mesh, donate=False)
    dstate = replicate_tree(dev.state("cpu"), mesh)
    key = dev.next_key(0)
    dparams, dopt, dout = dstep(new_params, new_state, dstate, key)
    dloss = float(dout["loss"])
    assert np.isfinite(dloss), dloss
    whole = dev.sample(dstate, key.to(mesh.device))
    host = build_train_step(bess, optimizer, mesh, donate=False)
    hparams, _, hout = host(new_params, new_state, whole)
    _hold_fp32("device-sampled vs host-fed loss", dout["loss"], hout["loss"])
    for k in dparams:
        _hold_fp32(f"device-sampled vs host-fed {k}", dparams[k], hparams[k])
    return (f"loss={loss:.4f}, device-sampled loss={dloss:.4f} == host-fed on its batch",
            {"loss": loss, "device_loss": dloss,
             "entity_embedding": _np(dparams["entity_embedding"])})


def _check_score_moving(n, mesh):
    """ScoreMoving eval vs golden scores from the unsharded table (rtol =
    atol = 1e-4)."""
    m = _mini(n)
    sharding, rng = m["sharding"], m["rng"]
    n_tri, n_neg, bps = 12 * n, 20, 2
    h = rng.integers(m["n_entity"], size=n_tri)
    r = rng.integers(m["n_relation"], size=n_tri)
    t = rng.integers(m["n_entity"], size=n_tri)
    neg_tails = rng.integers(m["n_entity"], size=(1, n_neg)).astype(np.int32)
    ds = KGDataset(n_entity=m["n_entity"], n_relation_type=m["n_relation"],
                   triples={"test": np.stack([h, r, t], 1).astype(np.int32)},
                   original_triple_ids={"test": np.arange(n_tri)},
                   neg_tails={"test": neg_tails})
    pts = PartitionedTripleSet.create_from_dataset(ds, "test", sharding)
    score_fn = TransE(negative_sample_sharing=True, scoring_norm=1, sharding=sharding,
                      n_relation_type=m["n_relation"], embedding_size=2 * m["emb"],
                      entity_initializer=m["ent"], relation_initializer=m["rel"])
    ns = TripleBasedShardedNegativeSampler(None, pts.neg_tails, sharding, corruption_scheme="t",
                                           seed=7, return_sort_idx=True, mask_on_gather=False)
    bs = RigidShardedBatchSampler(pts, ns, shard_bs=4, batches_per_step=bps, seed=7,
                                  return_triple_idx=True)
    bess = ScoreMovingBessKGE(negative_sampler=ns, score_fn=score_fn, return_scores=True,
                              axis_name="shard")
    fwd = build_bess_forward(bess, mesh)
    params = shard_params(score_fn.initial_params("cpu"), mesh)

    # The golden scores on the host, from the unsharded table.
    g = {"relation_embedding": _t(m["rel"])}
    rel = _t(r.astype(np.int32))
    true_pos = _np(score_fn.score_triple(g, _t(m["flat"][h]), rel, _t(m["flat"][t])))
    true_neg = _np(score_fn.score_tails(g, _t(m["flat"][h]), rel, _t(m["flat"][neg_tails])))

    batch = bs.sample_batch(next(bs.epoch_index_blocks(shuffle=False)))
    res = {k: _np(v) for k, v in fwd(params, batch).items()}
    pos = res["positive_score"].reshape(bps, 1, n, -1)
    neg = res["negative_score"]
    keep = neg > 0.95 * BAD_NEGATIVE_SCORE
    assert keep.sum() == neg.shape[0] * neg.shape[1] * neg.shape[2] * n_neg
    neg = neg[keep].reshape(bps, 1, n, -1, n_neg)
    nsi = _col(batch["negative_sort_idx"], mesh).reshape(bps, 1, n, -1, n_neg)
    mask = _col(batch["triple_mask"], mesh)
    gidx = _col(batch["triple_idx"], mesh)[mask]
    sort_idx = pts.triple_sort_idx
    np.testing.assert_allclose(true_pos[sort_idx][gidx], pos[mask], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        np.take_along_axis(true_neg[sort_idx][gidx], nsi[mask], axis=-1), neg[mask],
        rtol=1e-4, atol=1e-4)
    return (f"{_mesh_sum(int(mask.sum()), mesh)} triples x {n_neg} candidates",
            {"positive": pos[mask], "negative": neg[mask]})


def _query_setup(m, mesh):
    """Shared (h, r, ?) query fixture for TopK / AllScores: (score function,
    partitioned queries, sampler, batch sampler, golden full matrix, the
    rank's params)."""
    sharding = m["sharding"]
    score_fn = ComplEx(negative_sample_sharing=True, sharding=sharding,
                       n_relation_type=m["n_relation"], embedding_size=m["emb"],
                       entity_initializer=m["ent"], relation_initializer=m["rel"])
    queries = np.stack([m["q_h"], m["q_r"]], 1).astype(np.int32)
    pts = PartitionedTripleSet.create_from_queries(m["ds"], sharding, queries, "hr",
                                                   ground_truth=m["q_truth"].astype(np.int32))
    ns = PlaceholderNegativeSampler(corruption_scheme="t", seed=3)
    bs = RigidShardedBatchSampler(pts, ns, shard_bs=8, batches_per_step=1, seed=3,
                                  return_triple_idx=True)
    g = {"relation_embedding": _t(m["rel"])}
    golden = _np(score_fn.score_tails(g, _t(m["flat"][m["q_h"]]),
                                      _t(m["q_r"].astype(np.int32)), _t(m["flat"])[None]))
    return score_fn, pts, ns, bs, golden, shard_params(score_fn.initial_params("cpu"), mesh)


def _check_topk(n, mesh):
    """TopKQuery vs-all: distributed top-k == unsharded-matrix top-k (IDs
    exactly, scores at rtol = atol = 1e-4)."""
    m = _mini(n)
    k = 5
    score_fn, pts, ns, bs, golden, params = _query_setup(m, mesh)
    topk = TopKQueryBessKGE(k=k, candidate_sampler=ns, score_fn=score_fn, return_scores=True,
                            window_size=16, axis_name="shard")
    fwd = build_topk_forward(topk, mesh)
    golden_topk = np.argsort(-golden, axis=1)[:, :k]
    checked, got = 0, []
    for block in bs.epoch_index_blocks(shuffle=False):
        batch = bs.sample_batch(block)
        out = fwd(params, batch)
        ids = _np(out["topk_global_id"]).reshape(-1, k)
        scores = _np(out["topk_scores"]).reshape(-1, k)
        mask = _col(batch["triple_mask"], mesh).reshape(-1)
        orig = pts.triple_sort_idx[_col(batch["triple_idx"], mesh).reshape(-1)[mask]]
        np.testing.assert_array_equal(ids[mask], golden_topk[orig])
        np.testing.assert_allclose(
            scores[mask], np.take_along_axis(golden[orig], golden_topk[orig], axis=1),
            rtol=1e-4, atol=1e-4)
        checked += int(mask.sum())
        got.append(ids[mask])
    return (f"{_mesh_sum(checked, mesh)} queries, k={k}, exact ID match",
            {"ids": np.concatenate(got)})


def _check_allscores(n, mesh):
    """AllScores windows: stitched full matrix == unsharded matrix (rtol =
    atol = 1e-4)."""
    m = _mini(n)
    sharding = m["sharding"]
    score_fn, pts, ns, bs, golden, params = _query_setup(m, mesh)
    allsc = AllScoresBESS(ns, score_fn, window_size=7, axis_name="shard")
    fwd = build_allscores_forward(allsc, mesh)
    ws, n_step = allsc.window_size, allsc.n_step
    max_e = sharding.max_entity_per_shard

    batch = bs.sample_batch(next(bs.epoch_index_blocks(shuffle=False)))
    chunks = [_np(fwd(params, batch, i)) for i in range(n_step)]
    stitched = np.stack(chunks, axis=3).reshape(-1, n_step, n, ws)
    mask = _col(batch["triple_mask"], mesh).reshape(-1)
    orig = pts.triple_sort_idx[_col(batch["triple_idx"], mesh).reshape(-1)]
    full = np.full((stitched.shape[0], m["n_entity"]), np.nan, np.float32)
    for s in range(n):
        for w in range(n_step):
            idx = min(w * ws, max_e - ws) + np.arange(ws)
            use = idx < sharding.shard_counts[s]
            cols = sharding.shard_and_idx_to_entity[s, idx[use]]
            full[:, cols] = stitched[:, w, s, use]
    assert not np.isnan(full[mask]).any()
    np.testing.assert_allclose(full[mask], golden[orig[mask]], rtol=1e-4, atol=1e-4)
    return (f"{_mesh_sum(int(mask.sum()), mesh)} queries x {m['n_entity']} entities stitched",
            {"scores": full[mask]})


def _check_sparse_row_sgdm(n, mesh):
    """Sparse RowSGDM on the mesh == dense SGD, same batches (losses at rtol
    1e-5, tables at rtol 1e-5, atol 1e-6)."""
    bess, bs, params, _, _ = _small(n, mesh)
    params0 = shard_params(params, mesh)
    blocks = bs.epoch_index_blocks(shuffle=False)
    batches = [bs.sample_batch(next(blocks)) for _ in range(2)]
    dense_opt = SGD(0.05)

    p_d, s_d = params0, init_optimizer_state(dense_opt, params0, mesh)
    step_d = build_train_step(bess, dense_opt, mesh, donate=False)
    row = RowSGDM(learning_rate=0.05, momentum=0.0)
    p_s, s_s = params0, init_optimizer_state(dense_opt, params0, mesh, row)
    step_s = build_train_step(bess, dense_opt, mesh, row, donate=False)
    for b in batches:
        p_d, s_d, out_d = step_d(p_d, s_d, b)
        p_s, s_s, out_s = step_s(p_s, s_s, b)
        np.testing.assert_allclose(float(out_d["loss"]), float(out_s["loss"]), rtol=1e-5)
    for key in ("entity_embedding", "relation_embedding"):
        np.testing.assert_allclose(_np(p_d[key]), _np(p_s[key]), rtol=1e-5, atol=1e-6)
    return "2 steps, dense==sparse tables", {
        "dense": _np(p_d["entity_embedding"]), "sparse": _np(p_s["entity_embedding"])}


def _logical(table: torch.Tensor) -> np.ndarray:
    """A rank's entity block as fp32 logical rows: a packed block unpacked
    (bf16 or fp16 values, exactly), a 16-bit one widened."""
    if pk.is_packed(table):
        words = _np(table.view(torch.int32))
        if pk.half_dtype(table) == torch.float16:
            words = words.view(np.uint32)
        return pk.unpack_table_host(words, 2 * words.shape[0]).astype(np.float32)
    return _np(table.float())


def _packed_run(n, mesh, half, pack, row, interleave=None, steps=2):
    """Train the tiny set-up ``steps`` host-fed steps over the mesh with the
    entity table in ``half`` (packed, or plain 16-bit) under the row
    optimizer ``row``: (the rank's params, state, losses)."""
    bess, bs, params, _, _ = _small(n, mesh)
    tab = params["entity_embedding"]
    params["entity_embedding"] = pk.pack_table(tab.to(half)) if pack else tab.to(half)
    if interleave is not None:
        params["entity_embedding"] = interleave(params["entity_embedding"])
    bess.score_fn.dtype = half
    bess.score_fn.packed_entity_storage = pack
    params = shard_params(params, mesh)
    n_logical = bess.sharding.n_shard * bess.sharding.max_entity_per_shard
    opt = SGD(0.05)
    st = init_optimizer_state(opt, params, mesh, row,
                              n_logical=n_logical if interleave is not None else None)
    step = build_train_step(bess, opt, mesh, row, donate=False)
    blocks = bs.epoch_index_blocks(shuffle=False)
    losses = []
    for _ in range(steps):
        params, st, out = step(params, st, bs.sample_batch(next(blocks)))
        losses.append(float(out["loss"]))
    assert np.isfinite(losses[-1]), losses
    return params, st, losses


def _check_packed_bf16(n, mesh):
    """Packed-bf16 entity table on the mesh: bit-identical trajectory to the
    plain-bf16 table; one stochastic-rounding run stays finite."""
    runs = {}
    for name, pack, sr in (("plain", False, False), ("packed", True, False),
                           ("packed_sr", True, True)):
        row = RowSGDM(learning_rate=0.05, momentum=0.9, stochastic_rounding=sr)
        params, _, losses = _packed_run(n, mesh, torch.bfloat16, pack, row)
        runs[name] = _logical(params["entity_embedding"])
        runs[f"{name}_losses"] = losses
    np.testing.assert_array_equal(runs["packed"], runs["plain"])
    assert np.isfinite(runs["packed_sr"]).all()
    return "2 steps bit-identical (packed == plain bf16); SR steps finite", runs


def _check_type_device_sampling(n, mesh):
    """Type-based sampling on the device over the mesh: every rank draws the
    global batch from the replicated key and keeps its column; the columns,
    gathered over the mesh, hold only negatives of the consumer triple's
    corrupted-slot entity type."""
    n_entity = 24 * n
    type_offsets = np.asarray([0, n_entity // 3, 2 * (n_entity // 3)])
    rng = np.random.default_rng(5)
    trip = np.stack([rng.integers(n_entity, size=4000), rng.integers(4, size=4000),
                     rng.integers(n_entity, size=4000)], 1).astype(np.int32)
    ds = KGDataset(n_entity=n_entity, n_relation_type=4,
                   type_offsets={"a": 0, "b": int(type_offsets[1]), "c": int(type_offsets[2])},
                   triples={"train": trip}, original_triple_ids={"train": np.arange(4000)})
    sharding = Sharding.create(n_entity, n, seed=5, type_offsets=type_offsets)
    pts = PartitionedTripleSet.create_from_dataset(ds, "train", sharding)
    ns = TypeBasedShardedNegativeSampler(pts.types, 6, sharding, "t", local_sampling=False, seed=5)
    dev = DeviceBatchSampler(pts, ns, shard_bs=4 * n, batches_per_step=1, seed=5)
    state = dev.state(mesh.device)
    key = dev.next_key(0).to(mesh.device)
    local = dev.slice_local(dev.sample(state, key), mesh.rank)
    # Every rank's column, in rank order: the global (bps, S, ...) layout.
    batch = {k: _np(collectives.all_gather(v.contiguous(), mesh)[:, :, 0].transpose(0, 1))
             for k, v in local.items()}

    neg = np.swapaxes(batch["negative"], 1, 2)  # (bps, S_dest, S_src, B, n)
    tail = np.swapaxes(batch["tail"], 1, 2)  # (bps, S_h, S_t, ppp)
    ent_of = sharding.shard_and_idx_to_entity
    ent_type = np.searchsorted(type_offsets, np.arange(n_entity), "right") - 1
    bps, S = neg.shape[0], n
    for b in range(bps):
        for dest in range(S):
            gtails = ent_of[np.arange(S)[:, None], tail[b, dest]].ravel()
            want = ent_type[gtails]
            for src in range(S):
                got = ent_type[ent_of[src, neg[b, dest, src]]]
                assert (got == want[:, None]).all(), (b, dest, src)
    return f"{neg.size} typed negatives validated", {
        "local": {k: _np(v) for k, v in local.items()}, "global": batch}


def _check_interleaved_sgdm(n, mesh):
    """Interleaved RowSGDM on the mesh (``fused_variant="fused"``: B4 on the
    rank's pair-major block) == separate-buffer RowSGDM (losses at rtol
    1e-6, tables at rtol 1e-6 atol 1e-9, momenta at rtol 1e-5 atol 1e-8);
    and ``fused_pair_sgdm`` on each rank's own (2N/n, D) block matches the
    update formula (rtol = atol = 1e-6)."""
    bess, bs, params, _, _ = _small(n, mesh)
    blocks = bs.epoch_index_blocks(shuffle=False)
    batches = [bs.sample_batch(next(blocks)) for _ in range(2)]
    opt = SGD(0.05)
    n_logical = bess.sharding.n_shard * bess.sharding.max_entity_per_shard

    def run(interleaved):
        p = shard_params(params, mesh)
        if interleaved:
            p["entity_embedding"] = interleave_momentum(p["entity_embedding"])
        row = RowSGDM(learning_rate=0.05, momentum=0.9, weight_decay=0.01,
                      interleaved=interleaved, fused_variant="fused" if interleaved else None)
        st = init_optimizer_state(opt, p, mesh, row, n_logical=n_logical)
        step = build_train_step(bess, opt, mesh, row, donate=False)
        losses = []
        for b in batches:
            p, st, out = step(p, st, b)
            losses.append(float(out["loss"]))
        return p, st, losses

    p_sep, s_sep, l_sep = run(False)
    p_int, _, l_int = run(True)
    np.testing.assert_allclose(l_sep, l_int, rtol=1e-6)
    tab_int, mom_int = (_np(x) for x in split_interleaved(p_int["entity_embedding"]))
    np.testing.assert_allclose(tab_int, _np(p_sep["entity_embedding"]), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(mom_int, _np(s_sep["entity"]["m"]), rtol=1e-5, atol=1e-8)

    # fused_pair_sgdm on the rank's own block of a sharded pair-major
    # table (B4 on a card, its plain version on the CPU), checked against
    # the SGDM formula row by row.
    rng = np.random.default_rng(11)
    n_rows, d = 32, 128
    tab = rng.normal(size=(n, 2 * n_rows, d)).astype(np.float32)
    idx = np.sort(rng.choice(n_rows, size=8, replace=False)).astype(np.int32)
    g = rng.normal(size=(8, d)).astype(np.float32)
    lr, mom, wd = 0.1, 0.9, 0.01
    block = _t(tab[mesh.rank]).to(mesh.device, copy=True)
    phys, grads = _t(2 * idx).to(mesh.device), _t(g).to(mesh.device)
    plain = row_kernels.fused_pair_sgdm_plain(block.clone(), phys, grads, lr, momentum=mom,
                                              weight_decay=wd)
    out = _np(row_kernels.fused_pair_sgdm(block, phys, grads, lr, momentum=mom,
                                          weight_decay=wd))
    want = tab[mesh.rank].copy()
    p_rows, m_rows = want[2 * idx], want[2 * idx + 1]
    m_new = mom * m_rows + (g + wd * p_rows)
    want[2 * idx] = p_rows - lr * m_new
    want[2 * idx + 1] = m_new
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6)
    return (f"2 steps interleaved==separate (fp32 tol); fused_pair_sgdm parity on {n} rank"
            f" blocks", {"losses": l_int, "table": tab_int, "momentum": mom_int, "b4_block": out,
                         "b4_vs_plain": float(np.abs(out - _np(plain)).max())})


def _check_packed_fp16(n, mesh):
    """Packed-fp16 entity table on the mesh: bit-identical trajectory to the
    plain-fp16 table."""
    runs = {}
    for name, pack in (("plain", False), ("packed", True)):
        row = RowSGDM(learning_rate=0.05, momentum=0.9, stochastic_rounding=False)
        params, _, losses = _packed_run(n, mesh, torch.float16, pack, row)
        runs[name] = _logical(params["entity_embedding"])
        runs[f"{name}_losses"] = losses
    np.testing.assert_array_equal(runs["packed"], runs["plain"])
    return "2 steps bit-identical (packed == plain fp16)", runs


def _halfword_ulps(a: np.ndarray, b: np.ndarray) -> int:
    """The largest difference of two packed tables' 16-bit halves, as
    unsigned patterns (``__graft_entry__.py``'s bound)."""
    a, b = a.view(np.uint32), b.view(np.uint32)
    lo = np.abs((a & 0xFFFF).astype(np.int64) - (b & 0xFFFF).astype(np.int64))
    hi = np.abs((a >> 16).astype(np.int64) - (b >> 16).astype(np.int64))
    return int(max(lo.max(), hi.max()))


def _check_packed_triplet(n, mesh):
    """Triplet-interleaved packed fp16 table on the mesh: RowSGDM
    ``interleaved=True`` over the (3P, D) store matches the separate-buffer
    packed run (losses at rtol 1e-6, params within 4 halfword ulps,
    momentum at rtol 1e-5 atol 1e-7)."""
    out = {}
    for inter in (False, True):
        row = RowSGDM(learning_rate=0.05, momentum=0.9, interleaved=inter)
        params, st, losses = _packed_run(n, mesh, torch.float16, True, row,
                                         pk.interleave_packed_momentum if inter else None)
        ent = params["entity_embedding"]
        if inter:
            ent, mom = pk.split_packed_interleaved(ent)
        else:
            mom = st["entity"]["m"]
        out["interleaved" if inter else "separate"] = {
            "params": _np(ent.view(torch.int32)), "momentum": _np(mom), "losses": losses}
    sep, inter = out["separate"], out["interleaved"]
    np.testing.assert_allclose(inter["losses"], sep["losses"], rtol=1e-6)
    ulps = _halfword_ulps(inter["params"], sep["params"])
    assert ulps <= 4, ulps
    np.testing.assert_allclose(inter["momentum"], sep["momentum"], rtol=1e-5, atol=1e-7)
    return "2 steps triplet-interleaved == separate buffers (packed fp16)", out


def _check_packed_quint_adamw(n, mesh):
    """Quintuplet-interleaved packed fp16 AdamW on the mesh: RowAdamW
    ``interleaved=True`` over the (5P, D) store matches the separate-buffer
    packed run (losses at rtol 1e-6, params within 4 halfword ulps, moments
    at rtol 1e-5 atol 1e-7)."""
    out = {}
    for inter in (False, True):
        row = RowAdamW(learning_rate=0.05, weight_decay=0.01, interleaved=inter)
        params, st, losses = _packed_run(n, mesh, torch.float16, True, row,
                                         pk.interleave_packed_adamw if inter else None)
        ent = params["entity_embedding"]
        if inter:
            ent, mu, nu = pk.split_packed_adamw(ent)
        else:
            mu, nu = st["entity"]["mu"], st["entity"]["nu"]
        out["interleaved" if inter else "separate"] = {
            "params": _np(ent.view(torch.int32)), "mu": _np(mu).reshape(-1, ent.shape[-1]),
            "nu": _np(nu).reshape(-1, ent.shape[-1]), "losses": losses}
    sep, inter = out["separate"], out["interleaved"]
    np.testing.assert_allclose(inter["losses"], sep["losses"], rtol=1e-6)
    ulps = _halfword_ulps(inter["params"], sep["params"])
    assert ulps <= 4, ulps
    for k in ("mu", "nu"):
        np.testing.assert_allclose(inter[k], sep[k], rtol=1e-5, atol=1e-7)
    return "2 steps quint-interleaved == separate buffers (packed AdamW)", out


#: The sub-checks in ``__graft_entry__.py``'s order, by their names there.
CHECKS = (
    ("embedding_moving_train", "_check_embedding_moving"),
    ("score_moving_eval", "_check_score_moving"),
    ("topk_vs_all", "_check_topk"),
    ("allscores_windows", "_check_allscores"),
    ("sparse_row_sgdm", "_check_sparse_row_sgdm"),
    ("packed_bf16_table", "_check_packed_bf16"),
    ("type_device_sampling", "_check_type_device_sampling"),
    ("interleaved_row_sgdm", "_check_interleaved_sgdm"),
    ("packed_fp16_table", "_check_packed_fp16"),
    ("packed_triplet_interleave", "_check_packed_triplet"),
    ("packed_quint_adamw", "_check_packed_quint_adamw"),
)


def _launches() -> Dict[str, int]:
    return {name: w.launches for name, w in KERNEL_WRAPPERS.items()}


def _run_checks(n: int, mesh: ShardMesh) -> Dict[str, Any]:
    """The eleven sub-checks on this rank: {"rank", "lines" (what rank 0
    prints), "checks": {name: {"detail", "launches" (each kernel wrapper's
    launches in the sub-check), "arrays"}}}."""
    lines: List[str] = []

    def say(line: str) -> None:
        lines.append(line)
        if mesh.rank == 0:
            print(line, flush=True)

    checks = {}
    for i, (name, fn_name) in enumerate(CHECKS, start=1):
        before = _launches()
        detail, arrays = globals()[fn_name](n, mesh)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        after = _launches()
        checks[name] = {"detail": detail, "arrays": arrays,
                        "launches": {k: after[k] - before[k] for k in after}}
        say(f"  [{i}/{len(CHECKS)}] {name}: PARITY OK ({detail})")
    first = checks["embedding_moving_train"]["arrays"]
    say(f"dryrun_multichip({n}) OK, loss={first['loss']:.4f}, device-sampled"
        f" loss={first['device_loss']:.4f}, {len(CHECKS)}/{len(CHECKS)} golden sub-checks passed")
    return {"rank": mesh.rank, "lines": lines, "checks": checks}


def _rank(n: int, device: str, backend: str) -> Dict[str, Any]:
    """One rank of a dry run in an initialised default group of ``n``."""
    mesh = make_shard_mesh(n, devices=[device] * n, backend=backend)
    return _run_checks(n, mesh)


def dryrun_multichip(n_devices: int, backend: Optional[str] = None,
                     device: Device = None) -> Union[Dict[str, Any], List[Dict[str, Any]]]:
    """Run the eleven sub-checks over an ``n_devices``-rank ``"shard"`` mesh
    on tiny shapes, asserting golden parity throughout.

    :param backend: NCCL (one card per rank; the default on a card) or gloo
        (the CPU's; on a card, ranks sharing it). NCCL asked for more ranks
        than the host has cards raises.
    :param device: default the card.

    Inside an initialised default group of ``n_devices`` ranks each rank
    runs the checks there and returns its results (rank 0 prints); outside
    one, ``n_devices`` local ranks are started, rank 0's lines are printed
    and every rank's results are returned, by rank. A sub-check that fails
    raises."""
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    if backend == "nccl" and n_devices > torch.cuda.device_count():
        raise ValueError(
            f"NCCL takes one card per rank: {n_devices} ranks asked, this host has"
            f" {torch.cuda.device_count()} cards (backend='gloo' shares them)")
    device = resolve_device(device)
    if dist.is_initialized():
        return _rank(n_devices, str(device), backend)
    if device.type == "cuda":  # once here, not in every rank
        from besskge_tpu_torch import _build as kernels

        kernels.build()
    ranks = _spawn(_rank, n_devices, (n_devices, str(device), backend), backend=backend,
                   timeout=DRYRUN_TIMEOUT_S)
    for line in ranks[0]["lines"]:
        print(line, flush=True)
    return ranks


def main(argv: List[str]) -> int:
    cpu = "--cpu" in argv
    if not cpu and not torch.cuda.is_available():
        print("graft_entry_torch.py: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    device = "cpu" if cpu else "cuda"
    if "--dryrun" in argv:
        n = int(argv[argv.index("--dryrun") + 1])
        backend = "gloo" if cpu or "--gloo" in argv else "nccl"
        if "WORLD_SIZE" not in os.environ:
            dryrun_multichip(n, backend=backend, device=device)
            return 0
        initialize(backend=backend, device=device)  # torchrun: one process per rank
        try:
            dryrun_multichip(n, backend=backend, device=device)
        finally:
            dist.destroy_process_group()
        return 0
    if not cpu:
        from besskge_tpu_torch import _build as kernels

        kernels.build()
    fn, (p, b) = entry(device)
    with torch.no_grad():
        out = fn(p, b)
    print("entry OK, loss =", float(out["loss"]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
