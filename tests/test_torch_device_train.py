"""The port's device-sampled training step against the JAX package's.

``build_device_train_step`` draws each step's batch on the device from a key
(``DeviceBatchSampler``) and runs ``steps_per_call`` steps per call; the JAX
package runs them in one jitted ``lax.scan``, the port (on a card) in one
CUDA graph, and here on the CPU eagerly. The port's random numbers are its
own, so the JAX package's uniforms for the same key are put in their place
(``device_sampler._uniform``): with ``steps_per_call`` k > 1, the k keys of
``jax.random.split(key, k)``, each split into its positive and negative
streams. The two packages then draw the same batches (bit for bit, as
``tests/test_torch_device_sampler.py`` shows) and the steps are held to each
other as ``tests/test_torch_train.py`` and ``tests/test_torch_dense_train.py``
hold the host-sampled ones:

* the sparse wikikg2 form (TransE-L1, ``RowSGDM`` interleaved, SGD with
  momentum on the relations) and both dense biokg forms (RotatE, ``AdamW``
  over every param, or ``FusedDenseAdamW`` on the table), cut in size;
* fp32: ``|got − want| ≤ 1e-5·(|want| + max|want|)`` (fp32 sums in other
  orders), for the dense forms plus ``lr·|r_port − r_jax|`` per param,
  ``r = m̂/(√v̂ + eps)`` from each side's moments, which an AdamW update
  follows as ``g/|g|`` where ``|g|`` nears ``eps``; chained over the steps
  of a call (the L1 subgradient's near-ties do not arise in three steps at
  this size, as over the five of ``test_fit_matches_jax``);
* bf16 scoring: the JAX side through its Pallas kernels in the interpreter
  (fixture ``jax_kernel_path``), the positive score's exact ties left out,
  one bf16 ulp plus ``2^-12·max|want|`` elsewhere, as in
  ``test_two_steps_match_jax_bf16``;
* with triple weights, whose micro-batch sums differ by their rounding
  (``tests/test_torch_device_sampler.py``), within the fp32 tolerance.

The port's fused call equals its own steps one at a time bit for bit: the
same operations on the same keys (``split_key``).
"""

import functools

import jax
import numpy as np
import optax
import pytest
import torch

from besskge_tpu import dataset as jax_ds
from besskge_tpu import device_sampler as jax_dev
from besskge_tpu import bess as jax_bess
from besskge_tpu import loss as jax_loss
from besskge_tpu import negative_sampler as jax_ns
from besskge_tpu import optim as jax_optim
from besskge_tpu import scoring as jax_scoring
from besskge_tpu import sharding as jax_sh
from besskge_tpu import trainer as jax_trainer
from besskge_tpu.ops import distance as jax_distance
from besskge_tpu.ops import pallas_distance as jax_pd
from besskge_tpu_torch import bess as port_bess
from besskge_tpu_torch import convert
from besskge_tpu_torch import dataset as port_ds
from besskge_tpu_torch import device_sampler as port_dev
from besskge_tpu_torch import loss as port_loss
from besskge_tpu_torch import negative_sampler as port_ns
from besskge_tpu_torch import optim as port_optim
from besskge_tpu_torch import scoring as port_scoring
from besskge_tpu_torch import sharding as port_sh
from besskge_tpu_torch import trainer as port_trainer

N_ENTITY, N_RELATION = 600, 7
LR_SPARSE, LR_DENSE = 0.1, 1e-2

JAX = (jax_ds, jax_sh, jax_ns, jax_dev, jax_scoring, jax_bess, jax_loss)
PORT = (port_ds, port_sh, port_ns, port_dev, port_scoring, port_bess, port_loss)


@pytest.fixture
def jax_kernel_path(monkeypatch):
    """Route the JAX package's p=1 distances through its TPU entry point
    (custom VJP over the batching rules), with the Pallas kernels in the
    interpreter (as ``tests/test_torch_train.py`` does)."""
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


def _triples(n_triple=4000, structured=False, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.integers(N_ENTITY, size=n_triple)
    r = rng.integers(N_RELATION, size=n_triple)
    t = (h + 13 * (r + 1)) % N_ENTITY if structured else rng.integers(N_ENTITY, size=n_triple)
    return np.stack([h, r, t], 1).astype(np.int32)


def _setup(pkg, form, bf16=False, hrt=False, positive_mode="runs", triples=None):
    """(score_fn, module, device sampler) of a form: "sparse" is the wikikg2
    recipe (TransE-L1 d = 64, 16 shared "ht" negatives with augmentation,
    SSCE), "dense"/"fused" the biokg one (RotatE p = 2, one shared "ht"
    negative, adversarial LogSigmoidLoss)."""
    ds_mod, sh_mod, ns_mod, dev_mod, sc_mod, bess_mod, loss_mod = pkg
    tri = _triples() if triples is None else triples
    ds = ds_mod.KGDataset(n_entity=N_ENTITY, n_relation_type=N_RELATION, triples={"train": tri},
                          original_triple_ids={"train": np.arange(len(tri))})
    sharding = sh_mod.Sharding.create(N_ENTITY, 1, seed=0)
    pts = sh_mod.PartitionedTripleSet.create_from_dataset(ds, "train", sharding)
    sparse = form == "sparse"
    ns = ns_mod.RandomShardedNegativeSampler(16 if sparse else 1, sharding, 0, "ht",
                                             local_sampling=False, flat_negative_format=True)
    if sparse:
        score_fn = sc_mod.TransE(negative_sample_sharing=True, scoring_norm=1, sharding=sharding,
                                 n_relation_type=N_RELATION, embedding_size=64, seed=0)
        if bf16:
            score_fn.compute_dtype = jax.numpy.bfloat16 if pkg is JAX else torch.bfloat16
        loss_fn = loss_mod.SampledSoftmaxCrossEntropyLoss(N_ENTITY)
    else:
        score_fn = sc_mod.RotatE(negative_sample_sharing=True, scoring_norm=2, sharding=sharding,
                                 n_relation_type=N_RELATION, embedding_size=16, seed=0)
        loss_fn = loss_mod.LogSigmoidLoss(margin=12.0, negative_adversarial_sampling=True)
    module = bess_mod.EmbeddingMovingBessKGE(negative_sampler=ns, score_fn=score_fn,
                                             loss_fn=loss_fn, augment_negative=sparse,
                                             axis_name=None)
    dev = dev_mod.DeviceBatchSampler(pts, ns, shard_bs=32, batches_per_step=2, seed=0,
                                     hrt_freq_weighting=hrt, positive_mode=positive_mode)
    return score_fn, module, dev


def _optimizers(form):
    """(JAX optimizer, JAX entity optimizer, port optimizer, port entity
    optimizer, lr) of a form."""
    if form == "sparse":
        return (optax.sgd(LR_SPARSE, momentum=0.9),
                jax_optim.RowSGDM(LR_SPARSE, momentum=0.9, interleaved=True),
                port_optim.SGD(LR_SPARSE, momentum=0.9),
                port_optim.RowSGDM(LR_SPARSE, momentum=0.9, interleaved=True), LR_SPARSE)
    if form == "fused":
        return (optax.adamw(LR_DENSE), jax_optim.FusedDenseAdamW(LR_DENSE, weight_decay=1e-4),
                port_optim.AdamW(LR_DENSE), port_optim.FusedDenseAdamW(LR_DENSE, weight_decay=1e-4),
                LR_DENSE)
    return optax.adamw(LR_DENSE), None, port_optim.AdamW(LR_DENSE), None, LR_DENSE


def _jax_state(form, score_fn):
    opt, ent, _, _, _ = _optimizers(form)
    params = score_fn.initial_params()
    if form == "sparse":
        params["entity_embedding"] = jax_optim.interleave_momentum(params["entity_embedding"])
    return params, jax_trainer.init_optimizer_state(opt, params, None, ent, n_logical=N_ENTITY)


def _port_state(params, state):
    return (convert.params_from_jax({k: np.asarray(v) for k, v in params.items()}, "cpu"),
            convert.opt_state_from_jax(jax.tree.map(np.asarray, state), "cpu"))


def _uniforms(jdev, key, steps_per_call):
    """The JAX package's uniforms of one call, in the order the port draws
    them: per step, the positive then the negative stream."""
    keys = [key] if steps_per_call == 1 else list(jax.random.split(key, steps_per_call))
    bps, ppp = jdev.batches_per_step, jdev.positive_per_partition
    out = []
    for k in keys:
        k_pos, k_neg = jax.random.split(k)
        pos = (bps, 1, 1) if jdev.positive_mode == "runs" else (bps, 1, 1, ppp)
        out += [np.asarray(jax.random.uniform(k_pos, pos)),
                np.asarray(jax.random.uniform(k_neg, (bps, 1, 1, 2, jdev.negative_sampler.n_negative)))]
    return out


def _feed(monkeypatch, draws):
    """Put ``draws`` in place of the port's uniforms, one per draw."""
    queue = list(draws)

    def uniform(key, stream, shape):
        u = torch.from_numpy(np.array(queue.pop(0)))
        assert tuple(u.shape) == tuple(shape)
        return u

    monkeypatch.setattr(port_dev, "_uniform", uniform)
    return queue


def _flat(params, state):
    """Every param and optimizer-state array, by a stable name, as numpy,
    from a JAX package's or a port's (params, state)."""
    if not torch.is_tensor(params["entity_embedding"]):
        params, state = _port_state(params, state)
    params, state = convert.params_to_numpy(params), convert.opt_state_to_numpy(state)
    out = {f"param.{k}": v for k, v in params.items()}

    def walk(tree, prefix):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}.")
            else:
                out[f"{prefix}{key}"] = np.asarray(val)

    walk(state, "state.")
    return out


def _ratio(flat, name, count, b1=0.9, b2=0.999, eps=1e-8):
    """``m̂/(√v̂ + eps)`` of a param's AdamW moments after step ``count``."""
    key = name.split(".", 1)[1]
    mu_name = next(n for n in (f"state.mu.{key}", f"state.other.mu.{key}", "state.entity.mu")
                   if n in flat)
    mu, nu = flat[mu_name], flat[mu_name.replace("mu", "nu")]
    return (mu / (1 - b1**count)) / (np.sqrt(nu / (1 - b2**count)) + eps)


def _close(got, want, extra=0.0):
    tol = 1e-5 * (np.abs(want) + np.abs(want).max()) + extra
    err = np.abs(got - want)
    assert (err <= tol).all(), float((err - tol).max())


@pytest.mark.parametrize("steps_per_call", [1, 3])
@pytest.mark.parametrize("form", ["sparse", "dense", "fused", "sparse-weighted"])
def test_device_step_matches_jax(monkeypatch, form, steps_per_call):
    hrt = form == "sparse-weighted"
    form = "sparse" if hrt else form
    jfn, jmod, jdev = _setup(JAX, form, hrt=hrt)
    _, pmod, pdev = _setup(PORT, form, hrt=hrt)
    opt, ent, popt, pent, lr = _optimizers(form)
    params, state = _jax_state(form, jfn)
    pparams, pstate = _port_state(params, state)
    jstep = jax_trainer.build_device_train_step(jmod, opt, jdev, None, ent, donate=False,
                                                steps_per_call=steps_per_call)
    pstep = port_trainer.build_device_train_step(pmod, popt, pdev, None, pent,
                                                 steps_per_call=steps_per_call, device="cpu")
    jkey = jdev.next_key(4)
    queue = _feed(monkeypatch, _uniforms(jdev, jkey, steps_per_call))
    params, state, jout = jstep(params, state, jdev.state(), jkey)
    pparams, pstate, pout = pstep(pparams, pstate, pdev.state("cpu"), pdev.next_key(4))
    assert not queue
    assert pout.keys() == jout.keys() == {"loss"}
    np.testing.assert_allclose(float(pout["loss"]), float(jout["loss"]), rtol=1e-5)
    got, want = _flat(pparams, pstate), _flat(params, state)
    assert got.keys() == want.keys()
    for name in want:
        extra = 0.0
        if form != "sparse" and name.startswith("param."):
            extra = lr * np.abs(_ratio(got, name, steps_per_call)
                                - _ratio(want, name, steps_per_call))
        if name.endswith("count"):
            assert int(got[name]) == int(want[name]) == steps_per_call, name
        else:
            _close(got[name], want[name], extra)


def _positive_ties(params, batch):
    """Coordinates where the bf16 positive score ``h + r − t`` is exactly 0:
    (entity mask, relation mask) of the rows they touch."""
    import ml_dtypes

    table = np.asarray(params["entity_embedding"])[0::2]
    rel = np.asarray(params["relation_embedding"])
    bf = ml_dtypes.bfloat16
    heads, tails, rels = (np.asarray(batch[k]).reshape(-1) for k in ("head", "tail", "relation"))
    hr = table[heads].astype(bf).astype(np.float32) + rel[rels].astype(bf).astype(np.float32)
    tie = hr.astype(bf) == table[tails].astype(bf)
    ent, rel_mask = np.zeros(table.shape, bool), np.zeros(rel.shape, bool)
    for ids, mask in ((heads, ent), (tails, ent), (rels, rel_mask)):
        np.logical_or.at(mask, ids, tie)
    return ent, rel_mask


def test_device_step_matches_jax_bf16(monkeypatch, jax_kernel_path):
    jfn, jmod, jdev = _setup(JAX, "sparse", bf16=True)
    _, pmod, pdev = _setup(PORT, "sparse", bf16=True)
    opt, ent, popt, pent, _ = _optimizers("sparse")
    params, state = _jax_state("sparse", jfn)
    pparams, pstate = _port_state(params, state)
    jkey = jdev.next_key(1)
    ent_tie, rel_tie = _positive_ties(params, jdev.sample(jdev.state(), jkey))
    params, state, jout = jax_trainer.build_device_train_step(
        jmod, opt, jdev, None, ent, donate=False)(params, state, jdev.state(), jkey)
    _feed(monkeypatch, _uniforms(jdev, jkey, 1))
    pparams, pstate, pout = port_trainer.build_device_train_step(
        pmod, popt, pdev, None, pent, device="cpu")(pparams, pstate, pdev.state("cpu"),
                                                    pdev.next_key(1))
    np.testing.assert_allclose(float(pout["loss"]), float(jout["loss"]), rtol=2.0**-8)
    got, want = _flat(pparams, pstate), _flat(params, state)
    for name, skip in (("param.entity_embedding", np.repeat(ent_tie, 2, axis=0)),
                       ("param.relation_embedding", rel_tie),
                       ("state.other.trace.relation_embedding", rel_tie)):
        err = np.abs(got[name] - want[name])[~skip]
        tol = (2.0**-8 * np.abs(want[name]) + 2.0**-12 * np.abs(want[name]).max())[~skip]
        assert (err <= tol).all(), (name, float((err - tol).max()))


@pytest.mark.parametrize("form", ["sparse", "dense", "fused"])
def test_fused_steps_equal_stepwise(form):
    """k fused steps from one key land on the same bits as k calls of one
    step on the keys ``split_key`` derives from it."""
    score_fn, module, dev = _setup(PORT, form)
    _, _, popt, pent, _ = _optimizers(form)
    state_dev = dev.state("cpu")
    params, state = _port_state(*_jax_state(form, _setup(JAX, form)[0]))
    step1 = port_trainer.build_device_train_step(module, popt, dev, None, pent, device="cpu")
    step3 = port_trainer.build_device_train_step(module, popt, dev, None, pent, donate=False,
                                                 steps_per_call=3, device="cpu")
    base = dev.next_key(0)
    p3, s3, out = step3(params, state, state_dev, base)
    p1, s1 = convert.params_from_jax(convert.params_to_numpy(params), "cpu"), state
    for k in port_dev.split_key(base, 3):
        p1, s1, out1 = step1(p1, s1, state_dev, k)
    for name, got in _flat(p3, s3).items():
        assert np.array_equal(got, _flat(p1, s1)[name]), name
    assert torch.equal(out["loss"], out1["loss"])


def test_donate_and_outputs():
    """``donate=True`` updates the caller's tensors in place (step counts
    too) and returns them; ``donate=False`` leaves them as they were."""
    score_fn, module, dev = _setup(PORT, "fused")
    _, _, popt, pent, _ = _optimizers("fused")
    for donate in (False, True):
        params = score_fn.initial_params(device="cpu")
        state = port_trainer.init_optimizer_state(popt, params, None, pent)
        before = params["entity_embedding"].clone()
        step = port_trainer.build_device_train_step(module, popt, dev, None, pent, donate,
                                                    steps_per_call=2, device="cpu")
        new_params, new_state, out = step(params, state, dev.state("cpu"), dev.next_key(0))
        assert set(out) == {"loss"} and out["loss"].shape == ()
        assert (new_params is params) == donate
        assert (new_params["entity_embedding"] is params["entity_embedding"]) == donate
        assert torch.equal(params["entity_embedding"], before) != donate
        assert int(state["entity"]["count"]) == (2 if donate else 0)
        assert int(state["other"]["count"]) == (2 if donate else 0)
        assert int(new_state["entity"]["count"]) == 2


def test_unported_device_step_options_raise():
    """A mesh is ported (ROADMAP A15a, tests/test_torch_mesh.py): one that
    is not a ShardMesh raises, and so does a mesh for a module without
    ``axis_name``. A dropout key, ported with ConvE (A11), changes nothing
    for a scorer without dropout: the same bits as without one."""
    score_fn, module, dev = _setup(PORT, "dense")
    opt = port_optim.AdamW(LR_DENSE)
    with pytest.raises(TypeError, match="ShardMesh"):
        port_trainer.build_device_train_step(module, opt, dev, "mesh", device="cpu")
    step = port_trainer.build_device_train_step(module, opt, dev, device="cpu")
    params = score_fn.initial_params(device="cpu")
    state = port_trainer.init_optimizer_state(opt, params)
    with_rng = step(port_trainer._clone(params), port_trainer._clone(state), dev.state("cpu"),
                    dev.next_key(0), rng=5)
    without = step(port_trainer._clone(params), port_trainer._clone(state), dev.state("cpu"),
                   dev.next_key(0))
    for (path, a), (_, b) in zip(port_trainer._leaves({"p": with_rng[0], "s": with_rng[1]}),
                                 port_trainer._leaves({"p": without[0], "s": without[1]})):
        assert torch.equal(a, b), path
    with pytest.raises(ValueError, match="step built for"):
        port_trainer.build_device_train_step(module, opt, dev, device="meta")(
            params, state, dev.state("cpu"), dev.next_key(0))


# --------------------------------------------------------------------------
# Trainer


@pytest.mark.parametrize("form", ["sparse", "dense"])
def test_trainer_device_sampling_loss_falls(form):
    """``Trainer.fit`` over a device sampler with ``steps_per_call``: the
    loss of a learnable graph falls, and the summary counts every step."""
    triples = _triples(3000, structured=True)
    score_fn, module, dev = _setup(PORT, form, triples=triples)
    if form == "dense":
        popt, pent, fall = port_optim.AdamW(5e-2), None, 0.6
    else:  # SSCE over 16 shared negatives and the batch's own: a slower fall
        popt = port_optim.SGD(3e-3, momentum=0.9)
        pent, fall = port_optim.RowSGDM(3e-3, momentum=0.9, interleaved=True), 0.95
    tr = port_trainer.Trainer(module, dev, popt, entity_optimizer=pent, steps_per_call=4,
                              device="cpu")
    assert len(dev) == 47
    summary = tr.fit(n_epochs=3, log_every=1)
    losses = [r["loss"] for r in tr.history]
    assert summary["steps"] == len(losses) == 3 * 12  # ceil(47 / 4) calls per epoch
    assert np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < fall * np.mean(losses[:4]), losses
    counts = tr.opt_state["entity"]["count"] if pent else tr.opt_state["count"]
    assert int(counts) == 3 * 12 * 4


def test_trainer_fit_matches_jax(monkeypatch):
    """``Trainer.fit`` with a device sampler against the JAX package's, with
    its draws in place of the port's: the same calls on the same keys."""
    triples = _triples(1000)
    jfn, jmod, jdev = _setup(JAX, "fused", triples=triples)
    _, pmod, pdev = _setup(PORT, "fused", triples=triples)
    opt, ent, popt, pent, _ = _optimizers("fused")
    params = jfn.initial_params()
    jtr = jax_trainer.Trainer(jmod, jdev, opt, params=params, entity_optimizer=ent,
                              steps_per_call=2)
    ptr = port_trainer.Trainer(
        pmod, pdev, popt, None,
        convert.params_from_jax({k: np.asarray(v) for k, v in params.items()}, "cpu"), 0, pent, 2,
        device="cpu")
    n_calls = -(-len(jdev) // 2)
    draws = [u for i in range(n_calls) for u in _uniforms(jdev, jdev.next_key(i), 2)]
    queue = _feed(monkeypatch, draws)
    want = jtr.fit(n_epochs=1, log_every=1)
    got = ptr.fit(n_epochs=1, log_every=1)
    assert not queue
    assert got["steps"] == want["steps"] == n_calls == 8
    np.testing.assert_allclose([r["loss"] for r in ptr.history],
                               [r["loss"] for r in jtr.history], rtol=1e-5)
    for key in ptr.params:
        _close(ptr.params[key].numpy(), np.asarray(jtr.params[key]))
