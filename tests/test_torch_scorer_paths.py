"""The scorers but ConvE on the port's paths, against the JAX package's.

* The host-fed training step of each of DistMult, ComplEx, PairRE,
  TripleRE, BoxE, InterHT and TranS in ``bench.py``'s wikikg2 recipe cut in
  size (300 entities, 7 relation types, d = 16, 8 shared "ht" negatives with
  augmentation, ``SampledSoftmaxCrossEntropyLoss``, ``RowSGDM`` interleaved
  and SGD with momentum, ``bps`` 2, p = 1 for the distance scorers), and
  the dense step of ComplEx (and BoxE) in the YAGO recipe
  (``LogSigmoidLoss`` with adversarial weights, ``FusedDenseAdamW`` on the
  table, AdamW on the relations), each against
  ``besskge_tpu.trainer.build_train_step`` from the same state and batch.
* Top-k of each against the JAX package's ``TopKQueryBessKGE``, over a
  sort-merged window of 128 rows (three windows, the last clamped) and a
  chunk-merged one of 1024 (two, the last clamped).
* The blocked window scoring of the broadcast scorers against one unblocked
  call, with every block within the budget.
* BoxE's step over a bf16 row-pair-packed table in the triplet store.
* ``convert`` and checkpoint files of ComplEx and BoxE (d = 128: BoxE's
  relation rows are 514 wide), byte for byte against the JAX package's.

Tolerances:

* fp32 steps: loss rtol 1e-5; every array within 1e-5·(|want| + max|want|)
  (fp32 sums in other orders: the pool products and reductions, the
  duplicate-row sums). No L1 argument of these scorers is exactly 0 on
  random rows (``test_torch_scorers.py`` holds the tie rule), so no mask is
  needed. The AdamW params also get lr·|r_port − r_jax|, r = m̂/(√v̂ + eps)
  of each side's own moments (``test_torch_dense_train.py``).
* Top-k: scores within 1e-5·(|want| + max|want|); an ID is compared where
  its score stands further than that from both neighbours in the list (both
  packages order ties their own way), the last position excepted.
* Blocked against unblocked: bit for bit.
* The packed step: see :func:`test_packed_boxe_step_matches_jax`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from besskge_tpu import batch_sampler as jax_bs
from besskge_tpu import bess as jax_bess
from besskge_tpu import checkpoint as jax_ckpt
from besskge_tpu import dataset as jax_ds
from besskge_tpu import loss as jax_loss
from besskge_tpu import negative_sampler as jax_ns
from besskge_tpu import optim as jax_optim
from besskge_tpu import scoring as jax_scoring
from besskge_tpu import sharding as jax_sh
from besskge_tpu import trainer as jax_trainer
from besskge_tpu_torch import batch_sampler as port_bs
from besskge_tpu_torch import bess as port_bess
from besskge_tpu_torch import checkpoint as port_ckpt
from besskge_tpu_torch import convert
from besskge_tpu_torch import dataset as port_ds
from besskge_tpu_torch import loss as port_loss
from besskge_tpu_torch import negative_sampler as port_ns
from besskge_tpu_torch import optim as port_optim
from besskge_tpu_torch import packed as ppk
from besskge_tpu_torch import scoring as port_scoring
from besskge_tpu_torch import sharding as port_sh
from besskge_tpu_torch import trainer as port_trainer

N_ENTITY, N_RELATION, EMB, SHARD_BS, BPS = 300, 7, 16, 16, 2
LR = 0.1

JAX = (jax_ds, jax_sh, jax_ns, jax_bs, jax_scoring, jax_bess, jax_loss)
PORT = (port_ds, port_sh, port_ns, port_bs, port_scoring, port_bess, port_loss)

#: (class name, scoring_norm or None): each scorer at its own defaults.
SCORERS = [("DistMult", None), ("ComplEx", None), ("PairRE", 1), ("TripleRE", 1),
           ("BoxE", 1), ("InterHT", 1), ("TranS", 1)]
BROADCAST = [c for c in SCORERS if c[1] is not None]


def _score_fn(pkg, cls, norm, n_entity=N_ENTITY, emb=EMB, **kw):
    sharding = pkg[1].Sharding.create(n_entity, 1, seed=0)
    args = (True, norm) if norm else (True,)
    return getattr(pkg[4], cls)(*args, sharding, N_RELATION, emb, seed=3, **kw)


def _triples(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(N_ENTITY, size=n), rng.integers(N_RELATION, size=n),
                     rng.integers(N_ENTITY, size=n)], 1).astype(np.int32)


def _module(pkg, score_fn, dense=False):
    ds_mod, sh_mod, ns_mod, bs_mod, _, bess_mod, loss_mod = pkg
    tri = _triples()
    ds = ds_mod.KGDataset(n_entity=N_ENTITY, n_relation_type=N_RELATION, triples={"train": tri},
                          original_triple_ids={"train": np.arange(len(tri))})
    sharding = score_fn.sharding
    pts = sh_mod.PartitionedTripleSet.create_from_dataset(ds, "train", sharding)
    ns = ns_mod.RandomShardedNegativeSampler(8, sharding, 0, "ht", local_sampling=False,
                                             flat_negative_format=True)
    if dense:
        module = bess_mod.EmbeddingMovingBessKGE(
            ns, score_fn, loss_mod.LogSigmoidLoss(margin=12.0, negative_adversarial_sampling=True),
            axis_name=None)
    else:
        module = bess_mod.EmbeddingMovingBessKGE(
            ns, score_fn, loss_mod.SampledSoftmaxCrossEntropyLoss(N_ENTITY), augment_negative=True,
            axis_name=None)
    sampler = bs_mod.RandomShardedBatchSampler(pts, ns, shard_bs=SHARD_BS, batches_per_step=BPS,
                                               seed=0)
    return module, sampler


def _batch(sampler):
    return sampler.sample_batch(next(iter(sampler.epoch_index_blocks())))


def _port(params, state):
    return (convert.params_from_jax({k: np.asarray(v) for k, v in params.items()}, "cpu"),
            convert.opt_state_from_jax(jax.tree.map(np.asarray, state), "cpu"))


def _close(got, want, extra=0.0, rtol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want)
    tol = rtol * (np.abs(want) + np.abs(want).max()) + extra
    assert (err <= tol).all() and np.isfinite(got).all(), float((err - tol).max())


# --------------------------------------------------------------------------
# Training steps


@pytest.mark.parametrize("cls,norm", SCORERS, ids=[c for c, _ in SCORERS])
def test_sparse_step_matches_jax(cls, norm):
    jfn, pfn = _score_fn(JAX, cls, norm), _score_fn(PORT, cls, norm)
    jmod, jsampler = _module(JAX, jfn)
    pmod, _ = _module(PORT, pfn)
    params = jfn.initial_params()
    params["entity_embedding"] = jax_optim.interleave_momentum(params["entity_embedding"])
    row, opt = jax_optim.RowSGDM(LR, momentum=0.9, interleaved=True), optax.sgd(LR, momentum=0.9)
    state = jax_trainer.init_optimizer_state(opt, params, None, row, n_logical=N_ENTITY)
    pparams, pstate = _port(params, state)
    batch = _batch(jsampler)
    params, state, jout = jax_trainer.build_train_step(jmod, opt, None, row, donate=False)(
        params, state, batch)
    pstep = port_trainer.build_train_step(
        pmod, port_optim.SGD(LR, momentum=0.9), None,
        port_optim.RowSGDM(LR, momentum=0.9, interleaved=True), device="cpu")
    pparams, pstate, pout = pstep(pparams, pstate, batch)
    np.testing.assert_allclose(float(pout["loss"]), float(jout["loss"]), rtol=1e-5)
    ent = np.asarray(params["entity_embedding"])
    _close(pparams["entity_embedding"].numpy(), ent)  # param and momentum rows
    assert not np.array_equal(ent[0::2], np.asarray(jfn.initial_params()["entity_embedding"]))
    _close(pparams["relation_embedding"].numpy(), params["relation_embedding"])
    _close(pstate["other"]["trace"]["relation_embedding"].numpy(),
           state["other"][0].trace["relation_embedding"])


def _adam_ratio(mu, nu, count, b1=0.9, b2=0.999, eps=1e-8):
    return (mu / (1 - b1**count)) / (np.sqrt(nu / (1 - b2**count)) + eps)


@pytest.mark.parametrize("cls,norm", [("ComplEx", None), ("BoxE", 1)], ids=["ComplEx", "BoxE"])
def test_dense_step_matches_jax(cls, norm):
    """ComplEx as the YAGO example trains it: FusedDenseAdamW (B10 on a card)
    on the table, AdamW on the relations, LogSigmoidLoss(12, adversarial);
    and BoxE so, whose relation rows (4d + 2 = 66) are not a multiple of 4."""
    jfn, pfn = _score_fn(JAX, cls, norm), _score_fn(PORT, cls, norm)
    jmod, jsampler = _module(JAX, jfn, dense=True)
    pmod, _ = _module(PORT, pfn, dense=True)
    params = jfn.initial_params()
    opt, ent = optax.adamw(LR), jax_optim.FusedDenseAdamW(LR, weight_decay=1e-4)
    state = jax_trainer.init_optimizer_state(opt, params, None, ent)
    pparams, pstate = _port(params, state)
    batch = _batch(jsampler)
    params, state, jout = jax_trainer.build_train_step(jmod, opt, None, ent, donate=False)(
        params, state, batch)
    pstep = port_trainer.build_train_step(pmod, port_optim.AdamW(LR), None,
                                          port_optim.FusedDenseAdamW(LR, weight_decay=1e-4),
                                          device="cpu")
    pparams, pstate, pout = pstep(pparams, pstate, batch)
    np.testing.assert_allclose(float(pout["loss"]), float(jout["loss"]), rtol=1e-5)
    rel = "relation_embedding"
    moments = {
        "entity_embedding": ((pstate["entity"]["mu"].numpy(), pstate["entity"]["nu"].numpy()),
                             (np.asarray(state["entity"]["mu"]), np.asarray(state["entity"]["nu"]))),
        rel: ((pstate["other"]["mu"][rel].numpy(), pstate["other"]["nu"][rel].numpy()),
              (np.asarray(state["other"][0].mu[rel]), np.asarray(state["other"][0].nu[rel]))),
    }
    for key, ((pmu, pnu), (jmu, jnu)) in moments.items():
        _close(pmu, jmu)
        _close(pnu, jnu)
        moved = LR * np.abs(_adam_ratio(pmu, pnu, 1) - _adam_ratio(jmu, jnu, 1))
        _close(pparams[key].numpy(), params[key], moved)


def test_packed_boxe_step_matches_jax():
    """BoxE (entity rows 2d = 32) with both tables bf16 and the entity table
    row-pair-packed (int32 bf16 pairs) in RowSGDM's triplet store, scoring
    in fp32 (``compute_dtype``), one host-fed step. The 16-bit params are
    equal or one bf16 ulp apart (stochastic rounding of fp32 values that
    differ in their last bits may land on the other neighbour); rows the
    step did not touch, and the untouched sibling of a touched pair, are
    equal to the initial table bit for bit; the fp32 momentum and the bf16
    relation table and trace within one bf16 ulp of each value (at most
    2^-7 of it) plus 2^-12 of the largest."""
    fns = []
    for pkg, half, cd in ((JAX, jnp.bfloat16, jnp.float32), (PORT, torch.bfloat16, torch.float32)):
        fn = _score_fn(pkg, "BoxE", 1)
        fn.dtype, fn.compute_dtype, fn.packed_entity_storage = half, cd, True
        fns.append(fn)
    jfn, pfn = fns
    jmod, jsampler = _module(JAX, jfn)
    pmod, _ = _module(PORT, pfn)
    row = jax_optim.RowSGDM(LR, momentum=0.9, interleaved=True)
    opt = optax.sgd(LR, momentum=0.9)
    params = jfn.initial_params()
    params["entity_embedding"] = row.widen_table(jnp.asarray(params["entity_embedding"]))
    params = {k: jnp.asarray(v) for k, v in params.items()}
    state = jax_trainer.init_optimizer_state(opt, params, None, row, n_logical=N_ENTITY)
    pparams, pstate = _port(params, state)
    assert pparams["entity_embedding"].dtype == torch.int32
    assert pparams["entity_embedding"].shape == (3 * N_ENTITY // 2, 2 * EMB)
    before = ppk.unpack_table(ppk.split_packed_interleaved(pparams["entity_embedding"])[0],
                              N_ENTITY).clone()
    batch = _batch(jsampler)
    params, state, jout = jax_trainer.build_train_step(jmod, opt, None, row, donate=False)(
        params, state, batch)
    pstep = port_trainer.build_train_step(
        pmod, port_optim.SGD(LR, momentum=0.9), None,
        port_optim.RowSGDM(LR, momentum=0.9, interleaved=True), device="cpu")
    pparams, pstate, pout = pstep(pparams, pstate, batch)
    np.testing.assert_allclose(float(pout["loss"]), float(jout["loss"]), rtol=1e-5)
    jt = convert.params_from_jax({"t": np.asarray(params["entity_embedding"])}, "cpu")["t"]
    (got, got_m), (want, want_m) = (ppk.split_packed_interleaved(t)
                                    for t in (pparams["entity_embedding"], jt))
    got, want = ppk.unpack_table(got, N_ENTITY), ppk.unpack_table(want, N_ENTITY)
    touched = torch.zeros(N_ENTITY, dtype=torch.bool)
    touched[torch.from_numpy(np.concatenate([batch[k].reshape(-1) for k in
                                             ("head", "tail", "negative")]).astype(np.int64))] = True
    assert torch.equal(got[~touched], before[~touched]) and torch.equal(want[~touched],
                                                                         before[~touched])
    assert not torch.equal(got[touched], before[touched])
    ordinal = lambda x: x.view(torch.int16).int()  # noqa: E731  (same-sign values here)
    assert ((ordinal(got) - ordinal(want)).abs() <= 1).all()

    def bf16_close(g, w):
        g, w = g.float().numpy(), w.float().numpy()
        err, tol = np.abs(g - w), 2.0**-7 * np.abs(w) + 2.0**-12 * np.abs(w).max()
        assert (err <= tol).all(), (np.argwhere(err > tol)[:5], g[err > tol][:5], w[err > tol][:5])

    bf16_close(got_m, want_m)
    jp = convert.params_from_jax({k: np.asarray(v) for k, v in params.items()}, "cpu")
    bf16_close(pparams["relation_embedding"], jp["relation_embedding"])
    jtrace = convert.opt_state_from_jax(jax.tree.map(np.asarray, state), "cpu")
    bf16_close(pstate["other"]["trace"]["relation_embedding"],
               jtrace["other"]["trace"]["relation_embedding"])


# --------------------------------------------------------------------------
# Top-k


def _topk(pkg, cls, norm, scheme, window, merge, params, n_entity=1500, k=5):
    jax_side = pkg is JAX
    ds_mod, sh_mod, ns_mod, bs_mod, _, bess_mod, _ = pkg
    score_fn = _score_fn(pkg, cls, norm, n_entity=n_entity)
    sharding = score_fn.sharding
    rng = np.random.default_rng(8)
    known = rng.integers(n_entity, size=40)
    rel = rng.integers(N_RELATION, size=40)
    queries = np.stack([known, rel] if scheme == "t" else [rel, known], 1).astype(np.int32)
    dataset = ds_mod.KGDataset(n_entity=n_entity, n_relation_type=N_RELATION,
                               triples={"test": np.zeros((1, 3), np.int32)},
                               original_triple_ids={"test": np.arange(1)})
    pts = sh_mod.PartitionedTripleSet.create_from_queries(
        dataset, sharding, queries, "hr" if scheme == "t" else "rt")
    ns = ns_mod.PlaceholderNegativeSampler(corruption_scheme=scheme, seed=0)
    extra = {"use_native": False} if jax_side else {}
    sampler = bs_mod.RigidShardedBatchSampler(pts, ns, shard_bs=20, batches_per_step=2, seed=0,
                                              **extra)
    batch = sampler.sample_batch(next(iter(sampler.epoch_index_blocks(shuffle=False))))
    kw = dict(k=k, candidate_sampler=ns, score_fn=score_fn, return_scores=True,
              window_size=window, merge_mode=merge)
    if jax_side:
        topk = bess_mod.TopKQueryBessKGE(axis_name=None, **kw)
        out = bess_mod.build_topk_forward(topk, mesh=None)(
            {k_: jnp.asarray(v) for k_, v in params.items()}, batch)
    else:
        topk = bess_mod.TopKQueryBessKGE(**kw)
        out = bess_mod.build_topk_forward(topk, device="cpu")(convert.params_from_jax(params, "cpu"),
                                                              batch)
    return topk, np.asarray(out["topk_global_id"]), np.asarray(out["topk_scores"])


def _same_topk(got_ids, got_scores, want_ids, want_scores, rtol=1e-5):
    _close(got_scores, want_scores, rtol=rtol)
    tol = rtol * 2 * np.abs(want_scores).max()
    gap = np.abs(np.diff(want_scores, axis=-1))
    isolated = np.ones(want_scores.shape, bool)
    isolated[..., 1:] &= gap > tol
    isolated[..., :-1] &= gap > tol
    isolated[..., -1] = False
    assert isolated.sum() > 0.5 * isolated.size
    np.testing.assert_array_equal(got_ids[isolated], want_ids[isolated])


@pytest.mark.parametrize("window,merge,scheme", [(128, "sort", "h"), (1024, "auto", "t")],
                         ids=["sort-128-h", "chunk-1024-t"])
@pytest.mark.parametrize("cls,norm", SCORERS, ids=[c for c, _ in SCORERS])
def test_topk_matches_jax(cls, norm, window, merge, scheme):
    params = {k: np.asarray(v) for k, v in
              _score_fn(JAX, cls, norm, n_entity=1500).initial_params().items()}
    jtopk, want_ids, want_scores = _topk(JAX, cls, norm, scheme, window, merge, params)
    ptopk, got_ids, got_scores = _topk(PORT, cls, norm, scheme, window, merge, params)
    assert ptopk.window_size == jtopk.window_size == window
    _same_topk(got_ids, got_scores, want_ids, want_scores)


@pytest.mark.parametrize("cls,norm", SCORERS, ids=[c for c, _ in SCORERS])
def test_default_window_matches_jax(cls, norm):
    for n_entity, want in ((123_182, 32768), (300, 256), (100, 100)):
        jfn, pfn = (_score_fn(pkg, cls, norm, n_entity=n_entity) for pkg in (JAX, PORT))
        ns = port_ns.PlaceholderNegativeSampler("t")
        jtopk = jax_bess.TopKQueryBessKGE(10, jax_ns.PlaceholderNegativeSampler("t"), jfn,
                                          axis_name=None)
        assert port_bess.TopKQueryBessKGE(10, ns, pfn).window_size == jtopk.window_size == want


@pytest.mark.parametrize("scheme", ["h", "t"])
@pytest.mark.parametrize("cls,norm", BROADCAST, ids=[c for c, _ in BROADCAST])
def test_blocked_window_scoring_equals_one_call(monkeypatch, cls, norm, scheme):
    """With the budget cut to 3 queries' worth of a window, every scoring
    call of a broadcast scorer holds at most that many (query, candidate,
    row) elements, and the top-k is bit for bit that of one unblocked call
    per window. DistMult and ComplEx are never blocked."""
    params = {k: np.asarray(v) for k, v in
              _score_fn(JAX, cls, norm, n_entity=1500).initial_params().items()}
    want = _topk(PORT, cls, norm, scheme, 1024, "auto", params)
    row = want[0].entity_embedding_size
    monkeypatch.setattr(port_bess, "BROADCAST_BUDGET", 3 * 1024 * row + 7)
    calls = []
    method = "score_heads" if scheme == "h" else "score_tails"
    orig = getattr(getattr(port_scoring, cls), method)

    def spy(self, params, head_emb, relation_id, tail_emb, **kw):
        assert kw == {"train": False}  # windows score in eval mode
        pool = head_emb if scheme == "h" else tail_emb
        calls.append(relation_id.shape[0] * pool.shape[1] * pool.shape[2])
        return orig(self, params, head_emb, relation_id, tail_emb, **kw)

    monkeypatch.setattr(getattr(port_scoring, cls), method, spy)
    got = _topk(PORT, cls, norm, scheme, 1024, "auto", params)
    # 20 queries per batch, 2 batches, 2 windows: 7 blocks each (3 x 6 + 2)
    assert len(calls) == 2 * 2 * 7 and max(calls) <= port_bess.BROADCAST_BUDGET
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("cls", ["DistMult", "ComplEx"])
def test_products_score_a_window_in_one_call(monkeypatch, cls):
    params = {k: np.asarray(v) for k, v in
              _score_fn(JAX, cls, None, n_entity=1500).initial_params().items()}
    monkeypatch.setattr(port_bess, "BROADCAST_BUDGET", 1)
    calls = []
    orig = getattr(port_scoring, cls).score_tails
    monkeypatch.setattr(getattr(port_scoring, cls), "score_tails",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    _topk(PORT, cls, None, "t", 1024, "auto", params)
    assert len(calls) == 2 * 2  # one per window per batch


# --------------------------------------------------------------------------
# convert and checkpoints


def _state_to_save(cls, norm):
    """(params, optimizer state, sharding, layout) of the JAX package at
    d = 128 over 40 entities: the initial tables, BoxE's interleaved with a
    random momentum (RowSGDM beside SGD with momentum), ComplEx's beside
    FusedDenseAdamW and AdamW, every moment random and every count 7."""
    fn = _score_fn(JAX, cls, norm, n_entity=40, emb=128)
    params = {k: np.asarray(v) for k, v in fn.initial_params().items()}
    rng = np.random.default_rng(2)
    if cls == "BoxE":  # RowSGDM interleaved beside SGD with momentum
        params["entity_embedding"] = np.asarray(jax_optim.interleave_momentum(
            jnp.asarray(params["entity_embedding"]),
            jnp.asarray(rng.normal(size=params["entity_embedding"].shape), jnp.float32)))
        row, opt, layout = jax_optim.RowSGDM(LR, interleaved=True), optax.sgd(LR, 0.9), True
    else:  # FusedDenseAdamW beside AdamW
        row, opt, layout = jax_optim.FusedDenseAdamW(LR), optax.adamw(LR), False
    state = jax_trainer.init_optimizer_state(
        opt, {k: jnp.asarray(v) for k, v in params.items()}, None, row)
    state = jax.tree.map(lambda x: np.asarray(7, np.asarray(x).dtype) if np.ndim(x) == 0 else
                         rng.normal(size=np.shape(x)).astype(np.asarray(x).dtype), state)
    return params, state, fn.sharding, layout


@pytest.mark.parametrize("cls,norm", [("ComplEx", None), ("BoxE", 1)])
def test_checkpoint_files_equal_jax(cls, norm, tmp_path):
    params, state, jsh, layout = _state_to_save(cls, norm)
    if cls == "BoxE":
        assert params["relation_embedding"].shape == (N_RELATION, 514)
    pparams, pstate = _port(params, state)
    for key, value in convert.params_to_numpy(pparams).items():
        np.testing.assert_array_equal(value, params[key])
    psh = port_sh.Sharding.create(40, 1, seed=0)
    jpath, ppath = tmp_path / "jax.npz", tmp_path / "port.npz"
    jax_ckpt.save_checkpoint(jpath, params, state, jsh, step=4, interleaved_entity=layout)
    port_ckpt.save_checkpoint(ppath, pparams, pstate, psh, step=4, interleaved_entity=layout)
    with np.load(jpath) as a, np.load(ppath) as b:
        assert set(a.files) == set(b.files)
        for key in a.files:
            assert a[key].dtype.str == b[key].dtype.str and a[key].tobytes() == b[key].tobytes(), key
    got, got_state, _, meta = port_ckpt.load_checkpoint(jpath, like=pstate,
                                                        interleave_entity=layout)
    assert meta == {"step": 4}
    for key in pparams:
        assert torch.equal(got[key], pparams[key]), key
    for key, value in convert.opt_state_to_numpy(got_state).items():
        want = convert.opt_state_to_numpy(pstate)[key]
        flat = jax.tree.leaves(value), jax.tree.leaves(want)
        assert all(np.array_equal(g, w) for g, w in zip(*flat)), key
    # resharded 1 -> 3 -> 1 by the port equals the original table
    three = port_sh.Sharding.create(40, 3, seed=1)
    wide, _, _, _ = port_ckpt.load_checkpoint(ppath, new_sharding=three)
    port_ckpt.save_checkpoint(tmp_path / "three.npz", wide, None, three)
    back, _, _, _ = port_ckpt.load_checkpoint(tmp_path / "three.npz", new_sharding=psh)
    want = pparams["entity_embedding"][0::2] if layout else pparams["entity_embedding"]
    assert torch.equal(back["entity_embedding"], want)
    assert torch.equal(back["relation_embedding"], pparams["relation_embedding"])
