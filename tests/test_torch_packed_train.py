"""The port's device-sampled training step over a row-pair-packed 16-bit
entity table against the JAX package's: the ``wikikg2_bf16`` and
``wikikg2_fp16`` recipes of ``bench.py`` cut in size.

TransE-L1 (d = 128, 600 entities, 7 relation types) with bf16 scoring math,
both tables in the 16-bit dtype (the entity table packed: int32 bf16 pairs
or uint32 fp16 pairs), 16 shared "ht" negatives with augmentation,
``SampledSoftmaxCrossEntropyLoss``, SGD with momentum 0.9 on the relation
table and ``RowSGDM(1e-3, 0.9)`` on the entity table, in the triplet store
(``interleaved=True``, bench.py's form) or with a separate momentum buffer
(its ``BENCH_INTERLEAVE=0`` form), two steps per call. The batches come from
the JAX package's uniforms (``tests/test_torch_device_train.py``), and the
JAX side runs its Pallas kernels in the interpreter (fixture
``jax_kernel_path``), which sum in fp32 as the port does.

Ties. The positive score ``−Σ|h + r − t|`` goes through ``jnp.abs``, whose
gradient is ``+g`` at an exact tie where torch's is 0; in bf16 such ties
are common, and once a call's first step differs there, its second step
differs everywhere the softmax couples. So the relation table is drawn with
every value at least 3/128 away from any entity value (``|r| ≥ 4/128``,
``|e| ≤ 1/128``, and bench.py's learning rate keeps the entity rows there
over two steps): no ``h + r`` (or ``t − r``) can equal a candidate row's
coordinate, and the comparison needs no masks.

Tolerances, over the chained two steps of one call:

* loss: rtol 1e-5;
* 16-bit entity params: equal or one 16-bit ulp apart (a stochastic
  rounding can land on the other neighbour after a last-bit fp32
  difference); rows no step touched, and the untouched sibling plane of a
  touched packed row, equal to the initial table bit for bit;
* fp32 momentum: one bf16 ulp of each value plus 2^-12 of the largest
  (a distance's fp32 sum, rounded to bf16 on each side, may land on
  neighbouring values and move the softmax weights by that much);
* the bf16/fp16 relation table and its momentum trace: the same bound.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from besskge_tpu import bess as jax_bess
from besskge_tpu import dataset as jax_ds
from besskge_tpu import device_sampler as jax_dev
from besskge_tpu import loss as jax_loss
from besskge_tpu import negative_sampler as jax_ns
from besskge_tpu import optim as jax_optim
from besskge_tpu import packed as jpk
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
from besskge_tpu_torch import packed as ppk
from besskge_tpu_torch import scoring as port_scoring
from besskge_tpu_torch import sharding as port_sh
from besskge_tpu_torch import trainer as port_trainer

N_ENTITY, N_RELATION, DIM, LR, SPC = 600, 7, 128, 1e-3, 2
HALF = {"bf16": (jnp.bfloat16, torch.bfloat16), "fp16": (jnp.float16, torch.float16)}

JAX = (jax_ds, jax_sh, jax_ns, jax_dev, jax_scoring, jax_bess, jax_loss)
PORT = (port_ds, port_sh, port_ns, port_dev, port_scoring, port_bess, port_loss)


@pytest.fixture
def jax_kernel_path(monkeypatch):
    """Route the JAX package's p=1 distances through its TPU entry point,
    with the Pallas kernels in the interpreter (as
    ``tests/test_torch_train.py`` does)."""
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


def _relations():
    """A relation table every value of which is at least 4/128 from 0."""
    rng = np.random.default_rng(1)
    sign = np.sign(rng.normal(size=(N_RELATION, DIM)))
    return (sign * (4 + rng.random((N_RELATION, DIM))) / 128).astype(np.float32)


def _setup(pkg, half, triples=None):
    """(score_fn, module, device sampler) of the wikikg2_bf16/_fp16 recipe."""
    ds_mod, sh_mod, ns_mod, dev_mod, sc_mod, bess_mod, loss_mod = pkg
    rng = np.random.default_rng(0)
    tri = triples if triples is not None else np.stack([
        rng.integers(N_ENTITY, size=4000), rng.integers(N_RELATION, size=4000),
        rng.integers(N_ENTITY, size=4000)], 1).astype(np.int32)
    ds = ds_mod.KGDataset(n_entity=N_ENTITY, n_relation_type=N_RELATION, triples={"train": tri},
                          original_triple_ids={"train": np.arange(len(tri))})
    sharding = sh_mod.Sharding.create(N_ENTITY, 1, seed=0)
    pts = sh_mod.PartitionedTripleSet.create_from_dataset(ds, "train", sharding)
    ns = ns_mod.RandomShardedNegativeSampler(16, sharding, 0, "ht", local_sampling=False,
                                             flat_negative_format=True)
    score_fn = sc_mod.TransE(negative_sample_sharing=True, scoring_norm=1, sharding=sharding,
                             n_relation_type=N_RELATION, embedding_size=DIM,
                             relation_initializer=_relations(), seed=0)
    jax_side = pkg is JAX
    score_fn.compute_dtype = jnp.bfloat16 if jax_side else torch.bfloat16
    score_fn.dtype = HALF[half][0 if jax_side else 1]
    score_fn.packed_entity_storage = True
    module = bess_mod.EmbeddingMovingBessKGE(
        negative_sampler=ns, score_fn=score_fn,
        loss_fn=loss_mod.SampledSoftmaxCrossEntropyLoss(N_ENTITY), augment_negative=True,
        axis_name=None)
    dev = dev_mod.DeviceBatchSampler(pts, ns, shard_bs=32, batches_per_step=2, seed=0,
                                     positive_mode="runs")
    return score_fn, module, dev


def _uniforms(jdev, key, steps_per_call):
    """The JAX package's uniforms of one call, in the order the port draws
    them: per step, the positive then the negative stream."""
    keys = [key] if steps_per_call == 1 else list(jax.random.split(key, steps_per_call))
    out = []
    for k in keys:
        k_pos, k_neg = jax.random.split(k)
        out += [np.asarray(jax.random.uniform(k_pos, (jdev.batches_per_step, 1, 1))),
                np.asarray(jax.random.uniform(
                    k_neg, (jdev.batches_per_step, 1, 1, 2, jdev.negative_sampler.n_negative)))]
    return out


def _feed(monkeypatch, draws):
    queue = list(draws)
    monkeypatch.setattr(port_dev, "_uniform",
                        lambda key, stream, shape: torch.from_numpy(np.array(queue.pop(0))))
    return queue


def _logical(table, interleaved):
    """The 16-bit entity params of a JAX or port packed table (or triplet
    store) as int16 bits, (N_ENTITY, DIM)."""
    if torch.is_tensor(table):
        table = table.view(torch.int32).numpy()
    words = np.ascontiguousarray(np.asarray(table)).view(np.uint32)
    if interleaved:
        words = words.reshape(-1, 3, DIM)[:, 0]
    out = np.empty((2 * words.shape[0], DIM), np.uint16)
    out[0::2], out[1::2] = words & 0xFFFF, words >> 16
    return out.view(np.int16)[:N_ENTITY]


def _ordinal(bits):
    """16-bit patterns as integers ordered like their values (±0 both 0)."""
    b = bits.astype(np.int32) & 0xFFFF
    return np.where(b & 0x8000, -(b & 0x7FFF), b)


def _momentum(table, state, interleaved):
    if not interleaved:
        return np.asarray(state["entity"]["m"]) if not torch.is_tensor(state["entity"]["m"]) \
            else state["entity"]["m"].numpy()
    if torch.is_tensor(table):
        return ppk.split_packed_interleaved(table)[1].numpy()
    return np.asarray(jpk.split_packed_interleaved(table)[1])


def _within_bf16(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = 2.0**-8 * np.abs(want) + 2.0**-12 * np.abs(want).max()
    assert (np.abs(got - want) <= tol).all(), (what, float(np.abs(got - want).max()))


@pytest.mark.parametrize("interleaved", [True, False])
@pytest.mark.parametrize("half", ["bf16", "fp16"])
def test_packed_device_step_matches_jax(monkeypatch, jax_kernel_path, half, interleaved):
    jfn, jmod, jdev = _setup(JAX, half)
    pfn, pmod, pdev = _setup(PORT, half)
    opt, ent = optax.sgd(LR, momentum=0.9), jax_optim.RowSGDM(LR, 0.9, interleaved=interleaved)
    popt, pent = port_optim.SGD(LR, momentum=0.9), port_optim.RowSGDM(LR, 0.9,
                                                                      interleaved=interleaved)
    params = jfn.initial_params()
    # the port packs its initial tables as the JAX package does, bit for bit
    pinit = pfn.initial_params("cpu")
    np.testing.assert_array_equal(pinit["entity_embedding"].view(torch.int32).numpy(),
                                  np.asarray(params["entity_embedding"]).view(np.int32))
    np.testing.assert_array_equal(pinit["relation_embedding"].view(torch.int16).numpy(),
                                  np.asarray(params["relation_embedding"]).view(np.int16))
    params["entity_embedding"] = ent.widen_table(jnp.asarray(params["entity_embedding"]))
    state = jax_trainer.init_optimizer_state(opt, params, None, ent, n_logical=N_ENTITY)
    pparams = convert.params_from_jax({k: np.asarray(v) for k, v in params.items()}, "cpu")
    pstate = convert.opt_state_from_jax(jax.tree.map(np.asarray, state), "cpu")
    assert torch.equal(pent.widen_table(pinit["entity_embedding"]).view(torch.int32),
                       pparams["entity_embedding"].view(torch.int32))
    initial = _logical(params["entity_embedding"], interleaved)

    jkey = jdev.next_key(3)
    queue = _feed(monkeypatch, _uniforms(jdev, jkey, SPC))
    params, state, jout = jax_trainer.build_device_train_step(
        jmod, opt, jdev, None, ent, donate=False, steps_per_call=SPC)(
            params, state, jdev.state(), jkey)
    pparams, pstate, pout = port_trainer.build_device_train_step(
        pmod, popt, pdev, None, pent, steps_per_call=SPC, device="cpu")(
            pparams, pstate, pdev.state("cpu"), pdev.next_key(3))
    assert not queue
    np.testing.assert_allclose(float(pout["loss"]), float(jout["loss"]), rtol=1e-5)
    assert int(pstate["entity"]["count"]) == int(state["entity"]["count"]) == SPC

    got = _logical(pparams["entity_embedding"], interleaved)
    want = _logical(params["entity_embedding"], interleaved)
    assert np.abs(_ordinal(got) - _ordinal(want)).max() <= 1
    # rows no step touched (among them untouched siblings of touched rows)
    moved = (want != initial).any(1) | (got != initial).any(1)
    assert moved.sum() > 100 and (~moved).sum() > 100
    batches = [jdev.sample(jdev.state(), k) for k in jax.random.split(jkey, SPC)]
    touched = np.zeros(N_ENTITY, bool)
    for b in batches:
        for name in ("head", "tail", "negative"):
            touched[np.asarray(b[name]).reshape(-1)] = True
    np.testing.assert_array_equal(got[~touched], initial[~touched])
    pairs = touched.reshape(-1, 2)
    lone = np.flatnonzero((pairs[:, 0] != pairs[:, 1]))
    assert len(lone) > 10  # packed rows with one plane touched
    _within_bf16(_momentum(pparams["entity_embedding"], pstate, interleaved),
                 _momentum(params["entity_embedding"], state, interleaved), "momentum")
    rel = "relation_embedding"
    assert pparams[rel].dtype == HALF[half][1]
    _within_bf16(pparams[rel].float().numpy(), np.asarray(params[rel]).astype(np.float32), rel)
    _within_bf16(pstate["other"]["trace"][rel].float().numpy(),
                 np.asarray(state["other"][0].trace[rel]).astype(np.float32), "trace")


def test_trainer_widens_a_packed_table_and_fits():
    """The Trainer widens a packed table (height (n + 1) // 2) into the
    triplet store as the JAX package's does, takes a widened one as it is,
    and trains it with device sampling; the dense step refuses it."""
    jfn, _, _ = _setup(JAX, "bf16")
    pfn, pmod, pdev = _setup(PORT, "bf16")
    row = port_optim.RowSGDM(LR, 0.9, interleaved=True)
    want = jax_optim.RowSGDM(LR, 0.9, interleaved=True).widen_table(
        jnp.asarray(jfn.initial_params()["entity_embedding"]))
    fit = port_trainer.Trainer(pmod, pdev, port_optim.SGD(LR, momentum=0.9),
                               entity_optimizer=row, steps_per_call=2, device="cpu")
    table = fit.params["entity_embedding"]
    assert ppk.is_tripled(table, N_ENTITY) and table.shape == (3 * N_ENTITY // 2, DIM)
    np.testing.assert_array_equal(table.view(torch.int32).numpy(), np.asarray(want))
    summary = fit.fit(n_epochs=1, log_every=1)
    assert summary["steps"] >= 2 and np.isfinite(summary["final_loss"])
    again = port_trainer.Trainer(pmod, pdev, port_optim.SGD(LR, momentum=0.9),
                                 params=fit.params, entity_optimizer=row, device="cpu")
    assert again.params["entity_embedding"].shape == table.shape
    with pytest.raises(ValueError, match="rows"):
        port_trainer.Trainer(pmod, pdev, port_optim.SGD(LR, momentum=0.9),
                             params={**fit.params,
                                     "entity_embedding": table[: N_ENTITY // 2 + 1]},
                             entity_optimizer=row, device="cpu")
    dense = port_trainer.build_device_train_step(pmod, port_optim.SGD(LR), pdev, device="cpu")
    with pytest.raises(ValueError, match="row-pair-packed"):
        dense(pfn.initial_params("cpu"), port_optim.SGD(LR).init(pfn.initial_params("cpu")),
              pdev.state("cpu"), pdev.next_key(0))


def test_packed_step_equals_plain_16bit_step():
    """The port's device step over a packed table and over the plain bf16
    table it holds (separate momentum) land on the same bits."""
    pfn, pmod, pdev = _setup(PORT, "bf16")
    out = []
    for packed in (True, False):
        pfn.packed_entity_storage = packed
        params = pfn.initial_params("cpu")
        row = port_optim.RowSGDM(LR, 0.9)
        sgd = port_optim.SGD(LR, momentum=0.9)
        state = port_trainer.init_optimizer_state(sgd, params, None, row)
        step = port_trainer.build_device_train_step(pmod, sgd, pdev, None, row,
                                                    steps_per_call=SPC, device="cpu")
        params, state, _ = step(params, state, pdev.state("cpu"), pdev.next_key(5))
        table = params["entity_embedding"]
        out.append((ppk.unpack_table(table, N_ENTITY) if packed else table, state["entity"]["m"],
                    params["relation_embedding"]))
    for got, want in zip(*out):
        assert torch.equal(got.view(torch.int16) if got.dtype != torch.float32 else got,
                           want.view(torch.int16) if want.dtype != torch.float32 else want)
