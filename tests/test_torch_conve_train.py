"""ConvE on the port's paths against the JAX package's.

The JAX goldens' configuration (``tests/test_conve_weighting.py``) on one
shard: 100 entities, 4 relation types with inverse triples, d = 32 as 4 x 8,
8 shared "t" negatives, ``SampledSoftmaxCrossEntropyLoss``, 2 x 32 positives
per step. The same params (numpy) and batches go through both packages:

* one sparse step (``RowSGDM`` interleaved on the table, SGD with momentum
  on the relations and the trunk) and one dense step (``AdamW`` over every
  param, or ``FusedDenseAdamW`` on the table), with and without dropout
  (the JAX package's masks put into the port, as ``test_torch_conve.py``
  does), including the in-step BatchNorm EMA;
* the EMA of the sparse, dense and device-sampled steps against
  ``update_bn_stats`` on the step's positives (the single-device twin of
  ``test_bn_ema_in_train_step_single_device``);
* a device-sampled call against its own steps one at a time, and run twice
  from the same state with the same keys, as a replayed graph runs;
* ``Trainer.fit`` lowering the loss (``test_conve_trains_end_to_end`` on one
  shard), host-fed and device-sampled, with the dropout stream split per
  step;
* checkpoint files and ``convert`` of the nested params and optimizer
  states, both ways, bit for bit;
* top-k against all entities, the all-scores pipeline, and the
  candidate-set forward (``ScoreMovingBessKGE``, "t") against the JAX
  package's.

Tolerances: fp32 arrays within 1e-5 x (|want| + max|want|) (sums in other
orders); a param also within lr x the difference of its update direction on
the two sides (SGD: the momenta; AdamW: ``m^/(sqrt(v^) + eps)``, which
follows ``g/|g|`` where ``|g|`` nears eps); BN running stats at rtol 1e-4,
atol 1e-5 (``test_conve_weighting.py``). Gradients that BatchNorm's batch
statistics make 0 (exactly for a per-channel shift before a BN; up to BN's
eps for bn0's scale with one input channel: :func:`invariant`) are rounding
noise of the cancellation of terms the size of the largest gradient: their
moments are held to 1e-5 of the largest moment of the tree instead. Scores
and top-k as ``test_torch_scorer_paths.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_conve import jax_masks, leaves

from besskge_tpu import batch_sampler as jax_bs
from besskge_tpu import bess as jax_bess
from besskge_tpu import checkpoint as jax_ckpt
from besskge_tpu import dataset as jax_ds
from besskge_tpu import loss as jax_loss
from besskge_tpu import metric as jax_metric
from besskge_tpu import negative_sampler as jax_ns
from besskge_tpu import optim as jax_optim
from besskge_tpu import pipeline as jax_pipeline
from besskge_tpu import scoring as jax_scoring
from besskge_tpu import sharding as jax_sh
from besskge_tpu import trainer as jax_trainer
from besskge_tpu_torch import batch_sampler as port_bs
from besskge_tpu_torch import bess as port_bess
from besskge_tpu_torch import checkpoint as port_ckpt
from besskge_tpu_torch import convert
from besskge_tpu_torch import dataset as port_ds
from besskge_tpu_torch import device_sampler as port_dev
from besskge_tpu_torch import loss as port_loss
from besskge_tpu_torch import metric as port_metric
from besskge_tpu_torch import negative_sampler as port_ns
from besskge_tpu_torch import optim as port_optim
from besskge_tpu_torch import pipeline as port_pipeline
from besskge_tpu_torch import scoring as port_scoring
from besskge_tpu_torch import sharding as port_sh
from besskge_tpu_torch import trainer as port_trainer

N_ENTITY, N_RELATION, EMB, HEIGHT, WIDTH, SEED = 100, 4, 32, 4, 8, 21
SHARD_BS, BPS, N_NEG = 32, 2, 8
LR_SPARSE, LR_DENSE = 1e-2, 3e-3
RTOL = 1e-5

JAX = (jax_ds, jax_sh, jax_ns, jax_bs, jax_scoring, jax_bess, jax_loss)
PORT = (port_ds, port_sh, port_ns, port_bs, port_scoring, port_bess, port_loss)


def _triples():
    rng = np.random.default_rng(SEED)
    h = rng.integers(N_ENTITY, size=1600)
    r = rng.integers(N_RELATION, size=1600)
    t = (h * (r + 2) + 1) % N_ENTITY
    return np.stack([h, r, t], 1).astype(np.int32)


def setup(pkg, shard_bs=SHARD_BS, bps=BPS):
    """(score_fn, module, host batch sampler, partitioned triples)."""
    ds_mod, sh_mod, ns_mod, bs_mod, sc_mod, bess_mod, loss_mod = pkg
    tri = _triples()
    ds = ds_mod.KGDataset(n_entity=N_ENTITY, n_relation_type=N_RELATION, triples={"train": tri},
                          original_triple_ids={"train": np.arange(len(tri))})
    sharding = sh_mod.Sharding.create(N_ENTITY, 1, seed=SEED)
    pts = sh_mod.PartitionedTripleSet.create_from_dataset(ds, "train", sharding,
                                                          add_inverse_triples=True)
    fn = sc_mod.ConvE(True, sharding, N_RELATION, EMB, HEIGHT, WIDTH, inverse_relations=True,
                      seed=SEED)
    ns = ns_mod.RandomShardedNegativeSampler(N_NEG, sharding, SEED, "t", local_sampling=False,
                                             flat_negative_format=True)
    module = bess_mod.EmbeddingMovingBessKGE(ns, fn, loss_mod.SampledSoftmaxCrossEntropyLoss(
        N_ENTITY), axis_name=None)
    sampler = bs_mod.RandomShardedBatchSampler(pts, ns, shard_bs=shard_bs, batches_per_step=bps,
                                               seed=SEED)
    return fn, module, sampler, pts


def first_batch(sampler):
    return sampler.sample_batch(next(iter(sampler.epoch_index_blocks(shuffle=False))))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_of(params, state):
    return (convert.params_from_jax(np_tree(params), "cpu"),
            convert.opt_state_from_jax(np_tree(state), "cpu"))


def invariant(path, dropout):
    """A param whose gradient BatchNorm's batch statistics make 0 at the
    first step: conv_b (a shift before bn1; exactly) and, with one input
    channel and bn0's bias at its initial 0, bn0's scale (up to the 1e-5 in
    bn1's rsqrt(var + 1e-5)); without dropout also bn0's bias and fc_b
    (dropout between them and the next BN makes their shifts uneven)."""
    names = ("conv_b", "bn0/scale") + (() if dropout else ("bn0/bias", "fc_b"))
    return any(path.endswith(n) for n in names)


def hold(got, want, extra=0.0, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = np.abs(got - want)
    tol = RTOL * (np.abs(want) + np.abs(want).max()) + extra
    assert np.isfinite(got).all() and (err <= tol).all(), (what, float((err - tol).max()))


def hold_moments(got, want, dropout, what):
    """Two trees of moments (a momentum trace, or an AdamW mu or nu) leaf by
    leaf; the invariant leaves to 1e-5 of the tree's largest (nu: its square
    root)."""
    g, w = dict(leaves(got)), dict(leaves(want))
    assert sorted(g) == sorted(w)
    root = "nu" in what
    largest = max(float(np.abs(np.asarray(v)).max()) for v in w.values())
    floor = (RTOL**2 if root else RTOL) * largest
    for path in w:
        gv, wv = g[path].numpy(), np.asarray(w[path])
        if invariant(path, dropout) and "entity" not in path:
            assert np.abs(gv).max() <= floor and np.abs(wv).max() <= floor, (what, path)
        else:
            hold(gv, wv, what=f"{what} {path}")


def hold_bn(got, want):
    for bn in ("bn0", "bn1", "bn2"):
        for f in ("mean", "var"):
            np.testing.assert_allclose(got[bn][f].numpy(), np.asarray(want[bn][f]),
                                       rtol=1e-4, atol=1e-5, err_msg=f"{bn}/{f}")


def keys_of(dropout):
    return (jax.random.PRNGKey(3), 77) if dropout else (None, None)


def run_jax(module, opt, ent, params, state, batch, jkey):
    return jax_trainer.build_train_step(module, opt, None, ent, donate=False)(
        jax.tree.map(jnp.asarray, params), state, batch, jkey)


# --------------------------------------------------------------------------
# Steps


@pytest.mark.parametrize("dropout", [False, True])
def test_sparse_step_matches_jax(dropout):
    jfn, jmod, jsampler, _ = setup(JAX)
    pfn, pmod, _, _ = setup(PORT)
    params = np_tree(jfn.initial_params())
    params["entity_embedding"] = np.asarray(
        jax_optim.interleave_momentum(params["entity_embedding"]))
    opt, row = optax.sgd(LR_SPARSE, momentum=0.9), jax_optim.RowSGDM(LR_SPARSE, 0.9,
                                                                      interleaved=True)
    state = jax_trainer.init_optimizer_state(opt, jax.tree.map(jnp.asarray, params), None, row,
                                             n_logical=N_ENTITY)
    pparams, pstate = port_of(params, state)
    batch = first_batch(jsampler)
    jkey, pkey = keys_of(dropout)
    want_p, want_s, jout = run_jax(jmod, opt, row, params, state, batch, jkey)
    step = port_trainer.build_train_step(pmod, port_optim.SGD(LR_SPARSE, momentum=0.9), None,
                                         port_optim.RowSGDM(LR_SPARSE, 0.9, interleaved=True),
                                         device="cpu")
    with jax_masks(pfn, [(jkey, pkey)] if dropout else [], SHARD_BS, BPS) as masks:
        got_p, got_s, pout = step(pparams, pstate, batch, pkey)
        assert masks.drawn == (2 * 3 if dropout else 0)  # vmap: one trace per site and call
    np.testing.assert_allclose(float(pout["loss"]), float(jout["loss"]), rtol=1e-5)
    want_p, want_s = port_of(want_p, want_s)
    trace_g, trace_w = got_s["other"]["trace"], want_s["other"]["trace"]
    hold_moments(trace_g, trace_w, dropout, "momentum")
    ent_g, ent_w = got_p["entity_embedding"].numpy(), want_p["entity_embedding"].numpy()
    hold(ent_g[1::2], ent_w[1::2], what="entity momentum")
    hold(ent_g[0::2], ent_w[0::2], LR_SPARSE * np.abs(ent_g[1::2] - ent_w[1::2]), "entity")
    for path, w in leaves(want_p):
        if path != "entity_embedding" and not path.endswith(("mean", "var")):
            moved = LR_SPARSE * np.abs(dict(leaves(trace_g))[path].numpy()
                                       - dict(leaves(trace_w))[path].numpy())
            hold(dict(leaves(got_p))[path], w, moved, path)
    hold_bn(got_p, want_p)
    assert float(got_p["bn1"]["mean"].abs().max()) > 1e-4  # the EMA moved them


def _adam_ratio(mu, nu, count=1, b1=0.9, b2=0.999, eps=1e-8):
    return (mu / (1 - b1**count)) / (np.sqrt(nu / (1 - b2**count)) + eps)


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_dense_step_matches_jax(fused, dropout):
    """AdamW (optax.adamw's rule and decay) over every param, or over the
    relations and the trunk beside FusedDenseAdamW on the table; the decay
    of the running stats is discarded by the EMA in both packages."""
    jfn, jmod, jsampler, _ = setup(JAX)
    pfn, pmod, _, _ = setup(PORT)
    params = np_tree(jfn.initial_params())
    opt = optax.adamw(LR_DENSE)
    ent = jax_optim.FusedDenseAdamW(LR_DENSE, weight_decay=1e-4) if fused else None
    state = jax_trainer.init_optimizer_state(opt, jax.tree.map(jnp.asarray, params), None, ent)
    pparams, pstate = port_of(params, state)
    batch = first_batch(jsampler)
    jkey, pkey = keys_of(dropout)
    want_p, want_s, jout = run_jax(jmod, opt, ent, params, state, batch, jkey)
    pent = port_optim.FusedDenseAdamW(LR_DENSE, weight_decay=1e-4) if fused else None
    step = port_trainer.build_train_step(pmod, port_optim.AdamW(LR_DENSE), None, pent,
                                         device="cpu")
    with jax_masks(pfn, [(jkey, pkey)] if dropout else [], SHARD_BS, BPS):
        got_p, got_s, pout = step(pparams, pstate, batch, pkey)
    np.testing.assert_allclose(float(pout["loss"]), float(jout["loss"]), rtol=1e-5)
    want_p, want_s = port_of(want_p, want_s)
    dense_g, dense_w = (got_s["other"], want_s["other"]) if fused else (got_s, want_s)
    hold_moments(dense_g["mu"], dense_w["mu"], dropout, "mu")
    hold_moments(dense_g["nu"], dense_w["nu"], dropout, "nu")
    mus = [dict(leaves(t)) for t in (dense_g["mu"], dense_w["mu"])]
    nus = [dict(leaves(t)) for t in (dense_g["nu"], dense_w["nu"])]
    if fused:
        for side, s in zip((mus, nus), ("mu", "nu")):
            side[0]["entity_embedding"] = got_s["entity"][s]
            side[1]["entity_embedding"] = want_s["entity"][s]
            hold(side[0]["entity_embedding"], side[1]["entity_embedding"], what=f"entity {s}")
    got_leaves = dict(leaves(got_p))
    for path, w in leaves(want_p):
        if path.endswith(("mean", "var")):
            continue
        r = [_adam_ratio(m[path].numpy(), n[path].numpy()) for m, n in zip(mus, nus)]
        hold(got_leaves[path], w, LR_DENSE * np.abs(r[0] - r[1]), path)
    hold_bn(got_p, want_p)


def _expected_stats(jfn, params, batch):
    """The JAX package's update_bn_stats on a step's positives, from the
    pre-step params: the EMA the step must write."""
    heads = np.asarray(batch["head"])[:, 0].reshape(-1)
    rels = np.asarray(batch["relation"])[:, 0].reshape(-1)
    table = np.asarray(params["entity_embedding"])
    jp = jax.tree.map(jnp.asarray, params)
    return jfn.update_bn_stats(jp, jnp.asarray(table[heads]), jnp.asarray(rels), momentum=0.1)


@pytest.mark.parametrize("form", ["sparse", "dense", "device"])
def test_bn_ema_in_train_step_single_device(form):
    """One step refreshes bn0/1/2 with the 0.1-momentum EMA of the step's
    positive (h, r) statistics, dropout-free, from the pre-step params,
    whatever the optimizer did to them; the scales and biases train."""
    jfn, _, jsampler, _ = setup(JAX)
    pfn, pmod, _, pts = setup(PORT)
    params = np_tree(jfn.initial_params())
    pparams = convert.params_from_jax(params, "cpu")
    opt = port_optim.AdamW(LR_DENSE)
    ent = port_optim.RowSGDM(LR_SPARSE, 0.9) if form == "sparse" else None
    state = port_trainer.init_optimizer_state(opt, pparams, None, ent, n_logical=N_ENTITY)
    key = torch.tensor(3, dtype=torch.int64)
    if form == "device":
        dev = port_dev.DeviceBatchSampler(pts, pmod.negative_sampler, shard_bs=SHARD_BS,
                                          batches_per_step=BPS, seed=SEED)
        batch = dev.sample(dev.state("cpu"), dev.next_key(0))
        port_trainer.build_device_train_step(pmod, opt, dev, device="cpu")(
            pparams, state, dev.state("cpu"), dev.next_key(0), key)
    else:
        batch = first_batch(jsampler)
        port_trainer.build_train_step(pmod, opt, None, ent, device="cpu")(
            pparams, state, batch, key)
    expected = _expected_stats(jfn, params, {k: np.asarray(v) for k, v in batch.items()})
    for bn in ("bn0", "bn1", "bn2"):
        assert float(pparams[bn]["mean"].abs().max()) > 1e-4
        assert not np.array_equal(pparams[bn]["scale"].numpy(), params[bn]["scale"])
    hold_bn(pparams, expected)


# --------------------------------------------------------------------------
# Device-sampled calls and Trainer.fit


def test_device_call_equals_its_steps_and_replays():
    """One call of 2 steps with a dropout key: its own steps one at a time
    (each step's batch from ``split_key(key, 2)``, its dropout key from
    ``split_key(rng, 2)``, the host-fed step) bit for bit; run again from
    the same state with the same keys, as a replayed graph runs, the same
    bits; a host int key the same as a tensor; another dropout key other
    params."""
    pfn, pmod, _, pts = setup(PORT)
    dev = port_dev.DeviceBatchSampler(pts, pmod.negative_sampler, shard_bs=SHARD_BS,
                                      batches_per_step=BPS, seed=SEED)
    st = dev.state("cpu")
    opt, ent = port_optim.SGD(LR_SPARSE, momentum=0.9), port_optim.RowSGDM(
        LR_SPARSE, 0.9, interleaved=True)
    params = pfn.initial_params(device="cpu")
    params["entity_embedding"] = port_optim.interleave_momentum(params["entity_embedding"])
    state = port_trainer.init_optimizer_state(opt, params, None, ent, n_logical=N_ENTITY)
    fn = port_trainer.build_device_train_step(pmod, opt, dev, None, ent, donate=False,
                                              steps_per_call=2, device="cpu")
    key, rng = dev.next_key(4), torch.tensor(1234, dtype=torch.int64)
    p1, s1, out1 = fn(params, state, st, key, rng)
    p2, s2, out2 = fn(params, state, st, key, 1234)
    step = port_trainer.build_train_step(pmod, opt, None, ent, donate=False, device="cpu")
    p3, s3 = params, state
    for k, r in zip(port_dev.split_key(key, 2), port_dev.split_key(rng, 2)):
        p3, s3, out3 = step(p3, s3, dev.sample(st, k), r)
    trees = [dict(port_trainer._leaves({"p": p, "s": s}))
             for p, s in ((p1, s1), (p2, s2), (p3, s3))]
    assert trees[0].keys() == trees[1].keys() == trees[2].keys()
    for path, a in trees[0].items():
        assert torch.equal(a, trees[1][path]) and torch.equal(a, trees[2][path]), path
    assert torch.equal(out1["loss"], out3["loss"])
    p4, _, _ = fn(params, state, st, key, 4321)
    assert not torch.equal(p4["fc_w"], p1["fc_w"])


@pytest.mark.parametrize("sampling", ["host", "device"])
def test_conve_trains_end_to_end(sampling):
    """The JAX golden on one shard: Trainer.fit with Adam (AdamW without
    decay) lowers the forward's loss on a fixed batch below 0.85 of its
    start; the Trainer threads a dropout stream (needs_rng), one key per
    step or call."""
    pfn, pmod, _, pts = setup(PORT, shard_bs=128, bps=1)
    if sampling == "host":
        sampler = port_bs.RandomShardedBatchSampler(pts, pmod.negative_sampler, shard_bs=128,
                                                    batches_per_step=1, seed=SEED)
        spc = 1
    else:
        sampler = port_dev.DeviceBatchSampler(pts, pmod.negative_sampler, shard_bs=128,
                                              batches_per_step=1, seed=SEED)
        spc = 5
    tr = port_trainer.Trainer(pmod, sampler, port_optim.AdamW(3e-3, weight_decay=0.0),
                              seed=SEED, steps_per_call=spc, device="cpu")
    assert tr.needs_rng
    rng0 = tr.rng.clone()
    fixed = port_bs.RandomShardedBatchSampler(pts, pmod.negative_sampler, shard_bs=128,
                                              batches_per_step=1, seed=SEED)
    fwd = port_bess.build_bess_forward(pmod, device="cpu")
    batch = first_batch(fixed)
    loss0 = float(fwd(tr.params, batch)["loss"])
    summary = tr.fit(n_epochs=12 if sampling == "host" else 60 // spc)
    loss1 = float(fwd(tr.params, batch)["loss"])
    assert np.isfinite(loss1) and loss1 < 0.85 * loss0, (loss0, loss1, summary)
    assert not torch.equal(tr.rng, rng0)


# --------------------------------------------------------------------------
# Checkpoints and convert


def _trained_state():
    """JAX params and AdamW state after one dense step with dropout."""
    jfn, jmod, jsampler, _ = setup(JAX)
    params = np_tree(jfn.initial_params())
    opt = optax.adamw(LR_DENSE)
    state = jax_trainer.init_optimizer_state(opt, jax.tree.map(jnp.asarray, params))
    p, s, _ = run_jax(jmod, opt, None, params, state, first_batch(jsampler),
                      jax.random.PRNGKey(5))
    return np_tree(p), np_tree(s), jfn


@pytest.mark.parametrize("sharded", [False, True])
def test_checkpoint_files_equal_jax(tmp_path, sharded):
    """The nested params and optimizer state written by the port and by the
    JAX package give the same files (keys, dtypes, bytes), and each package
    loads the other's."""
    params, state, jfn = _trained_state()
    pparams, pstate = port_of(params, state)
    psh = port_sh.Sharding.create(N_ENTITY, 1, seed=SEED)
    jpath, ppath = tmp_path / "jax", tmp_path / "port"
    if sharded:
        jax_ckpt.save_checkpoint_sharded(jpath, params, state, jfn.sharding, step=2)
        port_ckpt.save_checkpoint_sharded(ppath, pparams, pstate, psh, step=2)
        names = sorted(f.name for f in jpath.iterdir() if f.suffix == ".npz")
        assert names == sorted(f.name for f in ppath.iterdir() if f.suffix == ".npz")
        files = [(jpath / n, ppath / n) for n in names if n != "sharding.npz"]
    else:
        jpath, ppath = jpath.with_suffix(".npz"), ppath.with_suffix(".npz")
        jax_ckpt.save_checkpoint(jpath, params, state, jfn.sharding, step=2)
        port_ckpt.save_checkpoint(ppath, pparams, pstate, psh, step=2)
        files = [(jpath, ppath)]
    for a_path, b_path in files:
        with np.load(a_path) as a, np.load(b_path) as b:
            assert set(a.files) == set(b.files)
            assert {"params/bn2/var", "opt/#0/#1/fc_w", "opt/#0/#2/bn0/scale"} <= set(a.files) \
                or "shard" in a_path.name
            for key in a.files:
                assert a[key].dtype.str == b[key].dtype.str, key
                assert a[key].tobytes() == b[key].tobytes(), key
    load_port = port_ckpt.load_checkpoint_sharded if sharded else port_ckpt.load_checkpoint
    got, got_state, _, meta = load_port(jpath, like=pstate)
    assert meta["step"] == 2
    want = dict(leaves({"p": pparams, "s": pstate}))
    loaded = dict(leaves({"p": got, "s": got_state}))
    assert loaded.keys() == want.keys()
    for path, a in loaded.items():
        assert torch.equal(a, want[path]), path
    if not sharded:  # resharded 1 -> 3 -> 1: the table moves, the trunk stays as it is
        three = port_sh.Sharding.create(N_ENTITY, 3, seed=1)
        wide, wide_state, _, _ = port_ckpt.load_checkpoint(ppath, new_sharding=three)
        assert wide["entity_embedding"].shape[0] == 3 * three.max_entity_per_shard
        port_ckpt.save_checkpoint(tmp_path / "three.npz", wide, wide_state, three)
        back, back_state, _, _ = port_ckpt.load_checkpoint(tmp_path / "three.npz",
                                                           new_sharding=psh, like=pstate)
        for path, a in leaves({"p": back, "s": back_state}):
            assert torch.equal(a, want[path]), path
    load_jax = jax_ckpt.load_checkpoint_sharded if sharded else jax_ckpt.load_checkpoint
    back, back_state, _, _ = load_jax(ppath, like=jax.tree.map(jnp.asarray, state))
    for a, b in zip(jax.tree.leaves((back, back_state)), jax.tree.leaves((params, state))):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_convert_both_ways_bit_for_bit():
    params, state, _ = _trained_state()
    pparams, pstate = port_of(params, state)
    assert pstate["mu"]["bn1"]["scale"].shape == (32,)
    back = convert.params_to_numpy(pparams)
    for (path, a), (_, b) in zip(leaves(back), leaves(params)):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    moments = convert.opt_state_to_numpy(pstate)
    for name, field in (("mu", 1), ("nu", 2)):
        want = dict(leaves(state[0][field]))
        for path, a in leaves(moments[name]):
            assert np.array_equal(a, want[path]), (name, path)
    assert int(moments["count"]) == int(state[0][0])


# --------------------------------------------------------------------------
# Serving and evaluation (train=False: BatchNorm on its running stats)


def _served_params():
    params, _, _ = _trained_state()
    return params


def test_topk_matches_jax():
    """Top-5 tail completions against all 100 entities, windows of 32 with
    the sort merge (four, the last clamped) and of 100 (one)."""
    params = _served_params()
    jfn, _, jsampler, _ = setup(JAX)
    pfn, _, _, _ = setup(PORT)
    batch = first_batch(jsampler)
    rel = batch["relation"][0, 0].reshape(-1)
    head = batch["head"][0, 0].reshape(-1)
    for window in (32, 100):
        jtopk = jax_bess.TopKQueryBessKGE(5, jax_ns.PlaceholderNegativeSampler("t"), jfn,
                                          return_scores=True, window_size=window,
                                          axis_name=None)
        want = jtopk.forward(jax.tree.map(jnp.asarray, params), jnp.asarray(rel),
                             head=jnp.asarray(head))
        ptopk = port_bess.TopKQueryBessKGE(5, port_ns.PlaceholderNegativeSampler("t"), pfn,
                                           return_scores=True, window_size=window)
        got = ptopk.forward(convert.params_from_jax(params, "cpu"), torch.from_numpy(rel),
                            head=torch.from_numpy(head))
        w_scores = np.asarray(want["topk_scores"])
        hold(got["topk_scores"].numpy(), w_scores, what=f"top-k scores, window {window}")
        tol = RTOL * 2 * np.abs(w_scores).max()
        gap = np.abs(np.diff(w_scores, axis=1)) > 2 * tol
        alone = np.ones_like(w_scores, bool)
        alone[:, 1:] &= gap
        alone[:, :-1] &= gap
        np.testing.assert_array_equal(got["topk_global_id"].numpy()[alone],
                                      np.asarray(want["topk_global_id"])[alone])


def _allscores_parts(pkg):
    ds_mod, sh_mod, ns_mod, bs_mod, sc_mod, bess_mod, _ = pkg
    tri = _triples()[:48]
    ds = ds_mod.KGDataset(n_entity=N_ENTITY, n_relation_type=N_RELATION,
                          triples={"test": tri}, original_triple_ids={"test": np.arange(48)})
    sharding = sh_mod.Sharding.create(N_ENTITY, 1, seed=SEED)
    pts = sh_mod.PartitionedTripleSet.create_from_dataset(ds, "test", sharding,
                                                          partition_mode="h_shard")
    fn = sc_mod.ConvE(True, sharding, N_RELATION, EMB, HEIGHT, WIDTH, seed=SEED)
    sampler = bs_mod.RigidShardedBatchSampler(pts, ns_mod.PlaceholderNegativeSampler("t"),
                                              shard_bs=24, batches_per_step=2, seed=0,
                                              return_triple_idx=True)
    return fn, sampler, bess_mod.AllScoresBESS(ns_mod.PlaceholderNegativeSampler("t"), fn,
                                               window_size=29, axis_name=None)


def test_allscores_matches_jax():
    """The all-scores windows (29 entities, the last clamped) of the tail
    queries of 48 training triples against the JAX package's
    ``build_allscores_forward``; then the port's filtered
    ``AllScoresPipeline`` against the JAX package's full-table
    ``score_tails``: -inf exactly at the other known tails of each query.
    (The JAX package's ``AllScoresPipeline.forward`` casts each param with
    ``jnp.asarray``, which ConvE's nested trunk does not survive; the
    port's takes it.)"""
    params = _served_params()
    jfn, jsampler, jmod = _allscores_parts(JAX)
    pfn, psampler, pmod = _allscores_parts(PORT)
    batch = jsampler.sample_batch(next(iter(jsampler.epoch_index_blocks(shuffle=False))))
    jfwd = jax_bess.build_allscores_forward(jmod)
    pfwd = port_bess.build_allscores_forward(pmod, device="cpu")
    pparams = convert.params_from_jax(params, "cpu")
    for step in range(jmod.n_step):
        want = jfwd(jax.tree.map(jnp.asarray, params),
                    {k: jnp.asarray(v) for k, v in batch.items() if k in ("relation", "head")},
                    jnp.asarray(step))
        hold(pfwd(pparams, batch, step).numpy(), want, what=f"window {step}")
    extra = np.repeat(_triples()[:24], 3, axis=0)  # 3 more known tails of 24 queries
    extra[:, 2] = np.random.default_rng(3).integers(N_ENTITY, size=len(extra))
    known = np.concatenate([_triples(), extra])
    pipe = port_pipeline.AllScoresPipeline(psampler, "t", pfn, filter_triples=[known],
                                           return_scores=True, window_size=29, device="cpu")
    got = pipe.forward(pparams)["scores"]
    tri = _triples()[:48]
    full = np.asarray(jfn.score_tails(
        jax.tree.map(jnp.asarray, params), jnp.asarray(params["entity_embedding"][tri[:, 0]]),
        jnp.asarray(tri[:, 1]), jnp.asarray(params["entity_embedding"][None])))
    e2i = jfn.sharding.entity_to_idx
    want = full[:, e2i]  # local columns -> global entity order
    for q, (h, r, t) in enumerate(tri):
        other = known[(known[:, 0] == h) & (known[:, 1] == r) & (known[:, 2] != t), 2]
        want[q, other] = -np.inf
    inf = np.isneginf(want)
    np.testing.assert_array_equal(np.isneginf(got), inf)
    assert inf.any()
    hold(np.where(inf, 0, got), np.where(inf, 0, want), what="all-scores")


@pytest.mark.parametrize("train", [False, True])
def test_candidate_forward_matches_jax(train):
    """ScoreMovingBessKGE ("t", 16 candidates per triple, no sharing)
    through build_bess_forward, in eval mode and in train mode with the JAX
    package's masks."""
    params = _served_params()
    tri = _triples()[:64]
    rng = np.random.default_rng(2)
    cands = rng.integers(N_ENTITY, size=(64, 16)).astype(np.int32)
    outs = {}
    jkey, pkey = (jax.random.PRNGKey(9), 99) if train else (None, None)
    for pkg in (JAX, PORT):
        ds_mod, sh_mod, ns_mod, bs_mod, sc_mod, bess_mod, _ = pkg
        ds = ds_mod.KGDataset(n_entity=N_ENTITY, n_relation_type=N_RELATION,
                              triples={"valid": tri}, original_triple_ids={"valid": np.arange(64)})
        sharding = sh_mod.Sharding.create(N_ENTITY, 1, seed=SEED)
        pts = sh_mod.PartitionedTripleSet.create_from_dataset(ds, "valid", sharding)
        fn = sc_mod.ConvE(False, sharding, N_RELATION, EMB, HEIGHT, WIDTH, seed=SEED)
        ns = ns_mod.TripleBasedShardedNegativeSampler(None, cands, sharding, "t", SEED)
        sampler = bs_mod.RigidShardedBatchSampler(pts, ns, shard_bs=16, batches_per_step=2,
                                                  seed=0)
        mod = bess_mod.ScoreMovingBessKGE(ns, fn, return_scores=True, axis_name=None)
        batch = first_batch(sampler)
        if pkg is JAX:
            fwd = jax_bess.build_bess_forward(mod, None, train=train)
            outs["jax"] = fwd(jax.tree.map(jnp.asarray, params),
                              {k: jnp.asarray(v) for k, v in batch.items()}, jkey)
        else:
            fwd = port_bess.build_bess_forward(mod, None, train=train, device="cpu")
            with jax_masks(fn, [(jkey, pkey)] if train else [], 16, 2):
                outs["port"] = fwd(convert.params_from_jax(params, "cpu"), batch, pkey)
    for key in ("positive_score", "negative_score"):
        hold(outs["port"][key].numpy(), outs["jax"][key], what=key)


def test_run_device_eval_matches_jax():
    """The candidate-set pass of ``run_device_eval`` (ScoreMoving "t", MRR
    and hits@10 sums, blocks of 2 steps) equals the JAX package's: no score
    of a true tail stands within the score tolerance of another candidate's
    here, so the ranks agree."""
    from besskge_tpu import eval_loop as jax_eval
    from besskge_tpu_torch import eval_loop as port_eval

    params = _served_params()
    tri = _triples()[:96]
    cands = np.random.default_rng(4).integers(N_ENTITY, size=(96, 16)).astype(np.int32)
    got = {}
    for pkg in (JAX, PORT):
        ds_mod, sh_mod, ns_mod, bs_mod, sc_mod, bess_mod, _ = pkg
        metric_mod = jax_metric if pkg is JAX else port_metric
        ds = ds_mod.KGDataset(n_entity=N_ENTITY, n_relation_type=N_RELATION,
                              triples={"valid": tri}, original_triple_ids={"valid": np.arange(96)})
        sharding = sh_mod.Sharding.create(N_ENTITY, 1, seed=SEED)
        pts = sh_mod.PartitionedTripleSet.create_from_dataset(ds, "valid", sharding)
        fn = sc_mod.ConvE(False, sharding, N_RELATION, EMB, HEIGHT, WIDTH, seed=SEED)
        ns = ns_mod.TripleBasedShardedNegativeSampler(None, cands, sharding, "t", SEED)
        sampler = bs_mod.RigidShardedBatchSampler(pts, ns, shard_bs=16, batches_per_step=2,
                                                  seed=0)
        mod = bess_mod.ScoreMovingBessKGE(
            ns, fn, evaluation=metric_mod.Evaluation(["mrr", "hits@10"], reduction="sum"),
            axis_name=None)
        if pkg is JAX:
            got["jax"] = jax_eval.run_device_eval(mod, jax.tree.map(jnp.asarray, params),
                                                  sampler, mesh=None, steps_per_block=2)
        else:
            got["port"] = port_eval.run_device_eval(
                mod, convert.params_from_jax(params, "cpu"), sampler, steps_per_block=2,
                device="cpu")
    (want, n_want), (have, n_have) = got["jax"], got["port"]
    assert n_have == n_want == 96 and have.keys() == want.keys()
    for name, value in want.items():
        assert abs(have[name] - float(value)) <= 1e-6, name
