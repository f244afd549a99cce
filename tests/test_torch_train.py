"""The port's sparse training slice against the JAX package's, end to end.

The configuration is the wikikg2 TransE recipe cut in size: TransE-L1
(d = 128) with shared "ht" negatives, in-batch augmentation,
``SampledSoftmaxCrossEntropyLoss``, ``RowSGDM`` interleaved pair-major and
SGD with momentum on the relation table, 2,000 entities on one shard,
``bps = 2``. The JAX package's params and optimizer state are carried over
with ``convert.params_from_jax`` / ``opt_state_from_jax``, and both
packages draw bit-equal batches from the same seeds.

Tolerances:

* samplers, indices, layouts: bit for bit.
* Each step starts from the same state on both sides. The L1 subgradient
  jumps at a tie: once two trajectories differ by one fp32 ulp somewhere,
  a query coordinate within that ulp of a candidate's flips its sign and
  moves a gradient by up to ``2·|w|``. With ~10^6 (query, candidate,
  coordinate) terms per step such near-ties are certain within a few
  steps, so a chained trajectory is compared only over the few steps of
  ``Trainer.fit``.
* fp32 compute: rtol 1e-5 against each array's largest value
  (``|got − want| ≤ 1e-5·(|want| + max|want|)``), for fp32 sums taken in
  other orders (the distances, the cumsum-difference row sums, the sum over
  micro-batches).
* bf16 compute: the JAX package's default CPU path is not the reference
  here. It sums bf16 differences without an fp32 accumulator, and XLA's
  autodiff of ``abs`` gives ``+g`` at exact ties (PERF.md §6, ROADMAP B2).
  In bf16, ties between a query and a candidate coordinate are common.
  The reference is the JAX package's own kernel path instead, as it runs on
  a TPU: ``ops.distance._l1_tpu`` with the size gates at 0 and the Pallas
  kernels in the interpreter. That path accumulates in fp32 and takes
  ``sign(0) = 0``, like the port.
  One difference remains. The positive score ``−Σ|h + r − t|`` goes
  through ``jnp.abs`` on the TPU too, whose gradient is ``+g`` at a tie
  where torch's is 0. Each tie moves one coordinate of one head, tail and
  relation row by ``|∂loss/∂score|`` (up to 1). Those coordinates are
  computed from the step's inputs and left out. Every other value is held
  to one bf16 ulp (``2^-8·|want|``) plus ``2^-12·max|want|``: a distance's
  fp32 sum, rounded to bf16 on each side, may land on neighbouring values
  and move the softmax weights by that much.
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from besskge_tpu import batch_sampler as jax_bs
from besskge_tpu import bess as jax_bess
from besskge_tpu import dataset as jax_ds
from besskge_tpu import loss as jax_loss
from besskge_tpu import negative_sampler as jax_ns
from besskge_tpu import optim as jax_optim
from besskge_tpu import scoring as jax_scoring
from besskge_tpu import sharding as jax_sh
from besskge_tpu import trainer as jax_trainer
from besskge_tpu.ops import distance as jax_distance
from besskge_tpu.ops import pallas_distance as jax_pd
from besskge_tpu_torch import batch_sampler as port_bs
from besskge_tpu_torch import bess as port_bess
from besskge_tpu_torch import checkpoint as port_checkpoint
from besskge_tpu_torch import convert
from besskge_tpu_torch import dataset as port_ds
from besskge_tpu_torch import loss as port_loss
from besskge_tpu_torch import native as port_native
from besskge_tpu_torch import negative_sampler as port_ns
from besskge_tpu_torch import optim as port_optim
from besskge_tpu_torch import scoring as port_scoring
from besskge_tpu_torch import sharding as port_sh
from besskge_tpu_torch import trainer as port_trainer

N_ENTITY, N_RELATION, DIM, SHARD_BS, BPS = 2000, 11, 128, 64, 2
LR = 0.1  # large enough that the second step reads the first's update

JAX = (jax_ds, jax_sh, jax_ns, jax_bs, jax_scoring, jax_bess, jax_loss)
PORT = (port_ds, port_sh, port_ns, port_bs, port_scoring, port_bess, port_loss)


def _triples(n_triple=5000, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([
        rng.integers(N_ENTITY, size=n_triple), rng.integers(N_RELATION, size=n_triple),
        rng.integers(N_ENTITY, size=n_triple),
    ], 1).astype(np.int32)


def _setup(pkg, scheme="ht", augment=True, bf16=False, n_negative=32, triples=None,
           use_native=True, return_scores=False, fp16=False):
    ds_mod, sh_mod, ns_mod, bs_mod, sc_mod, bess_mod, loss_mod = pkg
    tri = _triples() if triples is None else triples
    ds = ds_mod.KGDataset(n_entity=N_ENTITY, n_relation_type=N_RELATION,
                          triples={"train": tri}, original_triple_ids={"train": np.arange(len(tri))})
    sharding = sh_mod.Sharding.create(N_ENTITY, 1, seed=0)
    pts = sh_mod.PartitionedTripleSet.create_from_dataset(ds, "train", sharding)
    score_fn = sc_mod.TransE(negative_sample_sharing=True, scoring_norm=1, sharding=sharding,
                             n_relation_type=N_RELATION, embedding_size=DIM, seed=0)
    if bf16:
        score_fn.compute_dtype = jnp.bfloat16 if pkg is JAX else torch.bfloat16
    if fp16:
        score_fn.compute_dtype = jnp.float16 if pkg is JAX else torch.float16
    ns = ns_mod.RandomShardedNegativeSampler(n_negative, sharding, 0, scheme, local_sampling=False,
                                             flat_negative_format=True, use_native=use_native)
    module = bess_mod.EmbeddingMovingBessKGE(
        negative_sampler=ns, score_fn=score_fn,
        loss_fn=loss_mod.SampledSoftmaxCrossEntropyLoss(N_ENTITY),
        return_scores=return_scores, augment_negative=augment, axis_name=None,
    )
    sampler = bs_mod.RandomShardedBatchSampler(pts, ns, shard_bs=SHARD_BS, batches_per_step=BPS,
                                               seed=0, use_native=use_native)
    return score_fn, module, sampler


@pytest.fixture
def jax_kernel_path(monkeypatch):
    """Route the JAX package's p=1 distances through its TPU entry point
    (custom VJP over the batching rules), with the Pallas kernels in the
    interpreter."""
    orig = jax_scoring.p_distance_matrix
    monkeypatch.setattr(
        jax_scoring, "p_distance_matrix",
        lambda a, b, p: jax_distance._l1_tpu(a, b) if p == 1 else orig(a, b, p),
    )
    monkeypatch.setattr(jax_distance, "_PALLAS_MIN_ELEMS", 0)
    monkeypatch.setattr(jax_distance, "_PALLAS_MIN_ELEMS_BATCHED", 0)
    for name in ("l1_distance_matrix", "l1_distance_matrix_batched",
                 "l1_distance_grads", "l1_distance_grads_batched"):
        monkeypatch.setattr(jax_pd, name, functools.partial(getattr(jax_pd, name), interpret=True))


def _batches(sampler, n):
    return [sampler.sample_batch(b) for b, _ in zip(sampler.epoch_index_blocks(), range(n))]


# --------------------------------------------------------------------------
# Samplers


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("scheme", ["h", "t", "ht"])
def test_samplers_are_bit_equal(use_native, scheme):
    _, _, jax_sampler = _setup(JAX, scheme=scheme, use_native=use_native)
    _, _, port_sampler = _setup(PORT, scheme=scheme, use_native=use_native)
    for want, got in zip(_batches(jax_sampler, 3), _batches(port_sampler, 3)):
        assert want.keys() == got.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert len(port_sampler) == len(jax_sampler)


def test_negative_sampler_streams_are_bit_equal():
    sharding = port_sh.Sharding.create(1000, 1, seed=3)
    idx = np.zeros((4, 1, 1, 10), np.int64)
    for flat, native in [(True, True), (False, True), (True, False), (False, False)]:
        want = jax_ns.RandomShardedNegativeSampler(
            7, jax_sh.Sharding.create(1000, 1, seed=3), 5, "t", False, flat, use_native=native)
        got = port_ns.RandomShardedNegativeSampler(7, sharding, 5, "t", False, flat,
                                                   use_native=native)
        for _ in range(2):
            np.testing.assert_array_equal(got(idx)["negative_entities"],
                                          want(idx)["negative_entities"])


def test_native_build_failure_raises(monkeypatch):
    """No quiet switch to the numpy stream when the host library is missing."""
    def fail(name, nvcc=None):
        raise RuntimeError("no compiler")

    monkeypatch.setattr(port_native, "_lib", None)
    monkeypatch.setattr(port_native._build, "load_library", fail)
    sampler = port_ns.RandomShardedNegativeSampler(
        4, port_sh.Sharding.create(100, 1, seed=0), 0, "t", False, True)
    with pytest.raises(RuntimeError, match="use_native=False"):
        sampler(np.zeros((1, 1, 1, 4), np.int64))


def test_dataloader_yields_the_epoch():
    _, _, sampler = _setup(PORT, triples=_triples(600))
    batches = list(sampler.get_dataloader(shuffle=True))
    assert len(batches) == len(sampler) == 5
    assert batches[0]["head"].shape == (BPS, 1, 1, SHARD_BS)


# --------------------------------------------------------------------------
# Forward


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("scheme", ["h", "t", "ht"])
def test_forward_matches_jax(jax_kernel_path, scheme, augment, bf16):
    jfn, jmod, jsampler = _setup(JAX, scheme, augment, bf16, return_scores=True)
    _, pmod, _ = _setup(PORT, scheme, augment, bf16, return_scores=True)
    params = jfn.initial_params()
    pparams = convert.params_from_jax({k: np.asarray(v) for k, v in params.items()}, "cpu")
    batch = _batches(jsampler, 1)[0]
    mb = {k: v[0, 0] for k, v in batch.items() if k in jax_bess._FORWARD_KEYS}
    want = jmod.forward(params, **{k: jnp.asarray(v) for k, v in mb.items()})
    got = pmod.forward(pparams, **_torch_batch(mb))
    ulp = 2.0**-8 if bf16 else 1e-6
    for key in ("positive_score", "negative_score"):
        w = np.asarray(jnp.asarray(want[key]).astype(jnp.float32))
        np.testing.assert_allclose(got[key].float().numpy(), w, rtol=ulp, atol=1e-5)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=ulp)


@pytest.mark.parametrize("augment", [False, True])
def test_forward_with_negative_mask_matches_jax(augment):
    jfn, jmod, jsampler = _setup(JAX, "ht", augment, return_scores=True)
    _, pmod, _ = _setup(PORT, "ht", augment, return_scores=True)
    params = jfn.initial_params()
    pparams = convert.params_from_jax({k: np.asarray(v) for k, v in params.items()}, "cpu")
    batch = _batches(jsampler, 1)[0]
    mb = {k: v[0, 0] for k, v in batch.items() if k in jax_bess._FORWARD_KEYS}
    mb["negative_mask"] = np.random.default_rng(3).random((2, 1, 32)) > 0.3
    want = jmod.forward(params, **{k: jnp.asarray(v) for k, v in mb.items()})
    got = pmod.forward(pparams, **_torch_batch(mb))
    np.testing.assert_allclose(got["negative_score"].numpy(), np.asarray(want["negative_score"]),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-6)


@pytest.mark.parametrize("adversarial", [False, True])
def test_negative_weights_match_jax(adversarial):
    scores = np.random.default_rng(4).normal(size=(6, 9)).astype(np.float32)
    want_loss = jax_loss.SampledSoftmaxCrossEntropyLoss(100)
    got_loss = port_loss.SampledSoftmaxCrossEntropyLoss(100)
    for loss_fn in (want_loss, got_loss):
        loss_fn.negative_adversarial_sampling = adversarial
        loss_fn.negative_adversarial_scale = 0.5
    want = want_loss.get_negative_weights(jnp.asarray(scores))
    got = got_loss.get_negative_weights(torch.from_numpy(scores))
    np.testing.assert_allclose(np.broadcast_to(got.numpy(), np.shape(want)), np.asarray(want),
                               rtol=1e-6)


# --------------------------------------------------------------------------
# The training step


def _states(score_fn):
    params = score_fn.initial_params()
    params["entity_embedding"] = jax_optim.interleave_momentum(params["entity_embedding"])
    row = jax_optim.RowSGDM(LR, momentum=0.9, interleaved=True)
    opt = optax.sgd(LR, momentum=0.9)
    state = jax_trainer.init_optimizer_state(opt, params, None, row, n_logical=N_ENTITY)
    return params, state, row, opt


def _port(params, state):
    return (convert.params_from_jax({k: np.asarray(v) for k, v in params.items()}, "cpu"),
            convert.opt_state_from_jax(jax.tree.map(np.asarray, state), "cpu"))


def _port_step(module, variant):
    row = port_optim.RowSGDM(LR, momentum=0.9, interleaved=True, fused_variant=variant)
    return port_trainer.build_train_step(module, port_optim.SGD(LR, momentum=0.9), None, row,
                                         device="cpu")


def _arrays(params, state):
    """Entity table, relation table and relation momentum, as numpy."""
    if torch.is_tensor(params["entity_embedding"]):
        params, state = convert.params_to_numpy(params), convert.opt_state_to_numpy(state)
        return (params["entity_embedding"], params["relation_embedding"],
                state["other"]["trace"]["relation_embedding"])
    return (np.asarray(params["entity_embedding"]), np.asarray(params["relation_embedding"]),
            np.asarray(state["other"][0].trace["relation_embedding"]))


def _fp32_close(got, want):
    assert (np.abs(got - want) <= 1e-5 * (np.abs(want) + np.abs(want).max())).all()


@pytest.mark.parametrize("variant", ["xla", "fused"])
def test_two_steps_match_jax_fp32(variant):
    jfn, jmod, jsampler = _setup(JAX)
    _, pmod, _ = _setup(PORT)
    params, state, row, opt = _states(jfn)
    jstep = jax_trainer.build_train_step(jmod, opt, None, row, donate=False)
    pstep = _port_step(pmod, variant)
    for batch in _batches(jsampler, 2):
        pparams, pstate = _port(params, state)  # each step from the same state
        params, state, jout = jstep(params, state, batch)
        pparams, pstate, pout = pstep(pparams, pstate, batch)
        np.testing.assert_allclose(float(pout["loss"]), float(jout["loss"]), rtol=1e-5)
        for got, want in zip(_arrays(pparams, pstate), _arrays(params, state)):
            _fp32_close(got, want)
    assert int(pstate["entity"]["count"]) == int(state["entity"]["count"]) == 2
    assert int(pstate["other"]["count"]) == 2


def _positive_ties(params, batch, bf=ml_dtypes.bfloat16):
    """Coordinates where the 16-bit (``bf``) positive score ``h + r − t`` is
    exactly 0: (entity mask (N, D), relation mask (R, D)) of the rows they
    touch."""
    table = np.asarray(params["entity_embedding"])[0::2]  # param rows of the pair table
    rel = np.asarray(params["relation_embedding"])
    heads = batch["head"].reshape(-1)
    tails = batch["tail"].reshape(-1)
    rels = batch["relation"].reshape(-1)
    hr = (table[heads].astype(bf).astype(np.float32) + rel[rels].astype(bf).astype(np.float32))
    tie = hr.astype(bf) == table[tails].astype(bf)
    ent = np.zeros(table.shape, bool)
    rel_mask = np.zeros(rel.shape, bool)
    for ids, mask in ((heads, ent), (tails, ent), (rels, rel_mask)):
        np.logical_or.at(mask, ids, tie)
    return ent, rel_mask


def _bf16_close(got, want, skip, ulp=2.0**-8, max_term=2.0**-12):
    err = np.abs(got - want)[~skip]
    tol = (ulp * np.abs(want) + max_term * np.abs(want).max())[~skip]
    assert (err <= tol).all(), float((err - tol).max())


@pytest.mark.parametrize("variant", ["xla", "fused"])
def test_two_steps_match_jax_bf16(jax_kernel_path, variant):
    jfn, jmod, jsampler = _setup(JAX, bf16=True)
    _, pmod, _ = _setup(PORT, bf16=True)
    params, state, row, opt = _states(jfn)
    jstep = jax_trainer.build_train_step(jmod, opt, None, row, donate=False)
    pstep = _port_step(pmod, variant)
    for batch in _batches(jsampler, 2):
        ent_tie, rel_tie = _positive_ties(params, batch)
        pparams, pstate = _port(params, state)  # each step from the same state
        params, state, jout = jstep(params, state, batch)
        pparams, pstate, pout = pstep(pparams, pstate, batch)
        np.testing.assert_allclose(float(pout["loss"]), float(jout["loss"]), rtol=2.0**-8)
        got_e, got_r, got_m = _arrays(pparams, pstate)
        want_e, want_r, want_m = _arrays(params, state)
        _bf16_close(got_e, want_e, np.repeat(ent_tie, 2, axis=0))  # param and momentum rows
        _bf16_close(got_r, want_r, rel_tie)
        _bf16_close(got_m, want_m, rel_tie)


def test_two_steps_match_jax_fp16(jax_kernel_path):
    """``compute_dtype=float16`` (ROADMAP A17): the JAX package's kernel path
    (fp16 operands widened at load in its Pallas kernels) against the
    port's B1/B2 plain versions, held as the bf16 step is with fp16's
    rounding: one fp16 ulp (``2^-10·|want|``) plus ``2^-12·max|want|``,
    the positive-score ties left out. Each side rounds every row gradient
    of the distance to fp16 (``da.to(a.dtype)``, as the JAX package's VJP
    does); an fp32 sum that differs in its last bits may round to the
    neighbouring fp16 value, one ulp of a gradient entry, and the entries
    reach the size of the largest momentum value (~2^-12·max|want| covers
    an ulp of entries up to 2^-2 of it, which the momentum rows hold)."""
    jfn, jmod, jsampler = _setup(JAX, fp16=True)
    _, pmod, _ = _setup(PORT, fp16=True)
    params, state, row, opt = _states(jfn)
    jstep = jax_trainer.build_train_step(jmod, opt, None, row, donate=False)
    pstep = _port_step(pmod, "xla")
    for batch in _batches(jsampler, 2):
        ent_tie, rel_tie = _positive_ties(params, batch, np.float16)
        pparams, pstate = _port(params, state)  # each step from the same state
        params, state, jout = jstep(params, state, batch)
        pparams, pstate, pout = pstep(pparams, pstate, batch)
        assert np.isfinite(float(pout["loss"]))
        np.testing.assert_allclose(float(pout["loss"]), float(jout["loss"]), rtol=2.0**-11)
        got_e, got_r, got_m = _arrays(pparams, pstate)
        want_e, want_r, want_m = _arrays(params, state)
        _bf16_close(got_e, want_e, np.repeat(ent_tie, 2, axis=0), 2.0**-10)
        _bf16_close(got_r, want_r, rel_tie, 2.0**-10)
        _bf16_close(got_m, want_m, rel_tie, 2.0**-10)


# --------------------------------------------------------------------------
# Trainer


def test_fit_matches_jax():
    triples = _triples(600)
    jfn, jmod, jsampler = _setup(JAX, triples=triples)
    _, pmod, psampler = _setup(PORT, triples=triples)
    params = jfn.initial_params()
    jtrainer = jax_trainer.Trainer(
        jmod, jsampler, optax.sgd(LR, momentum=0.9), params=params,
        entity_optimizer=jax_optim.RowSGDM(LR, momentum=0.9, interleaved=True),
    )
    ptrainer = port_trainer.Trainer(
        pmod, psampler, port_optim.SGD(LR, momentum=0.9),
        params=convert.params_from_jax({k: np.asarray(v) for k, v in params.items()}, "cpu"),
        entity_optimizer=port_optim.RowSGDM(LR, momentum=0.9, interleaved=True), device="cpu",
    )
    assert ptrainer.params["entity_embedding"].shape == (2 * N_ENTITY, DIM)
    want = jtrainer.fit(n_epochs=1, log_every=1)
    got = ptrainer.fit(n_epochs=1, log_every=1, valid_fn=lambda p: {"rows": len(p["entity_embedding"])})
    assert got["steps"] == want["steps"] == 5
    assert ptrainer.history[-1] == {"epoch": 0, "valid": {"rows": 2 * N_ENTITY}}
    np.testing.assert_allclose([r["loss"] for r in ptrainer.history[:-1]],
                               [r["loss"] for r in jtrainer.history], rtol=1e-5)
    for g, w in zip(_arrays(ptrainer.params, ptrainer.opt_state),
                    _arrays(jtrainer.params, jtrainer.opt_state)):
        _fp32_close(g, w)


def test_unported_training_paths_raise():
    jfn, _, _ = _setup(JAX)
    fn, module, sampler = _setup(PORT)
    sgd = port_optim.SGD(LR, momentum=0.9)
    row = port_optim.RowSGDM(LR, momentum=0.9, interleaved=True)
    # A mesh is ported (tests/test_torch_mesh.py); it must be a ShardMesh.
    with pytest.raises(TypeError, match="ShardMesh"):
        port_trainer.build_train_step(module, sgd, "mesh", row, device="cpu")
    # The dense step is ported (tests/test_torch_dense_train.py); a packed
    # table cannot take its dense gradient.
    dense = port_trainer.build_train_step(module, sgd, None, None, device="cpu")
    plain = fn.initial_params(device="cpu")
    packed = dict(plain, entity_embedding=plain["entity_embedding"].view(torch.int32))
    with pytest.raises(ValueError, match="packed"):
        dense(packed, port_trainer.init_optimizer_state(sgd, plain), _batches(sampler, 1)[0])
    # Checkpoints are ported (tests/test_torch_checkpoint.py), onto a mesh
    # too (tests/test_torch_mesh.py), which must be a ShardMesh.
    with pytest.raises(TypeError, match="ShardMesh"):
        port_checkpoint.load_checkpoint_sharded("ckpt", mesh="mesh")
    # Metrics in the forward are ported (tests/test_torch_eval.py): a module
    # with an evaluation no longer raises.
    from besskge_tpu_torch.metric import Evaluation

    evaluated = port_bess.EmbeddingMovingBessKGE(
        module.negative_sampler, fn, port_loss.SampledSoftmaxCrossEntropyLoss(N_ENTITY),
        evaluation=Evaluation(["mrr"], reduction="sum"))
    separate = port_optim.RowSGDM(LR, momentum=0.9)
    out = port_trainer.build_train_step(evaluated, sgd, None, separate, device="cpu")(
        dict(plain), port_trainer.init_optimizer_state(sgd, dict(plain), None, separate),
        _batches(sampler, 1)[0])[2]
    assert out["metrics"].shape == (BPS, 1, 1)
    with pytest.raises(TypeError, match="ShardedBatchSampler or a DeviceBatchSampler"):
        port_trainer.Trainer(module, object(), sgd, entity_optimizer=row, device="cpu")
    with pytest.raises(ValueError, match="steps_per_call requires a DeviceBatchSampler"):
        port_trainer.Trainer(module, sampler, sgd, entity_optimizer=row, steps_per_call=2,
                             device="cpu")
    params = fn.initial_params(device="cpu")
    params["entity_embedding"] = params["entity_embedding"][:-2]
    with pytest.raises(ValueError, match="rows"):
        port_trainer.Trainer(module, sampler, sgd, params=params, entity_optimizer=row,
                             device="cpu")
