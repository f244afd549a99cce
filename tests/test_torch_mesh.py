"""The port over a mesh against the JAX package's ``shard_map`` program.

The port runs one process per shard: its ranks run over gloo on the CPU,
started by ``besskge_tpu_torch.parallel.multihost._spawn`` with the bodies of
``tests/torch_mesh_ranks.py`` (which import no JAX): one spawn of 4 ranks
runs every 4-rank scenario in turn, one of 2 ranks the 2-rank ones beside
it, each spawn with its own timeout. The JAX package runs in this process on
the 8-device CPU mesh of ``tests/conftest.py`` at the same ``n_shard``, from
the same numpy params and batches.

Scenarios, at 4 ranks unless named: the sparse wikikg2-shaped step
(TransE-L1, ``RowSGDM`` interleaved, 32 shared "ht" negatives with
augmentation, bps 2) in fp32 at 2 and 4 ranks and in bf16; the dense RotatE
step with ``AdamW`` and with ``FusedDenseAdamW`` on the table, at 2 and 4;
the forward with its scores; a device-sampled call; three host-fed steps of
``Trainer``; top-k over all entities and over a shared candidate set;
checkpoints both ways (sharded and ``.npz``) and a 4 -> 2 reshard; the
multihost views; the collective census of each. The rest of the mesh:
``ScoreMovingBessKGE``'s forward (``tests/test_bess.py``'s cases) and its
sparse and dense steps (also at 2 ranks), ``run_device_eval``,
``AllScoresPipeline`` (``tests/test_pipeline.py``'s cases), the gradients
of ``all_gather`` and ``pmean`` (also at 2 ranks) and ConvE's steps with and
without SyncBN.

Tolerances:

* fp32: ``|got − want| ≤ 1e-5·(|want| + max|want|)`` per array (fp32 sums
  in other orders: the distances, the sum over micro-batches and ranks);
* bf16 scoring: the JAX side through its Pallas kernels in interpret mode
  (the ``jax_kernel_path`` fixture, as ``tests/test_torch_train.py``), held
  to ``2^-7·(|want| + max|want|)``. The coordinates where a positive's bf16
  ``h + r − t`` is exactly 0 are left out, as there: ``jnp.abs`` gives the
  L1 subgradient ``+g`` at such a tie, torch 0;
* batches, checkpoints, replicated params across ranks: bit for bit;
* top-k: scores to 1e-5·(|want| + max|want|), IDs as sets wherever the
  10th and 11th scores of a full-table reference stand apart;
* ranks and per-query metrics where no other score lies within the
  tolerance of the true one; metric averages to the share of the queries
  that have such a near tie;
* ConvE: as ``tests/test_torch_conve_train.py`` (a param also within lr x
  the difference of its update direction; the moments of the params whose
  gradient BatchNorm makes 0 to 1e-5 of the largest).
"""

import functools
import importlib
import pkgutil
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import optax
import pytest
import torch

import torch_mesh_ranks as R
from besskge_tpu import batch_sampler as jax_bs
from besskge_tpu import bess as jax_bess
from besskge_tpu import checkpoint as jax_ckpt
from besskge_tpu import dataset as jax_ds
from besskge_tpu import device_sampler as jax_dev
from besskge_tpu import loss as jax_loss
from besskge_tpu import metric as jax_metric
from besskge_tpu import negative_sampler as jax_ns
from besskge_tpu import eval_loop as jax_eval
from besskge_tpu import optim as jax_optim
from besskge_tpu import pipeline as jax_pipeline
from besskge_tpu import scoring as jax_scoring
from besskge_tpu import sharding as jax_sh
from besskge_tpu import trainer as jax_trainer
from besskge_tpu.ops import distance as jax_distance
from besskge_tpu.ops import pallas_distance as jax_pd
from besskge_tpu.parallel import make_shard_mesh, shard_batch, shard_params
from besskge_tpu.parallel.hlo_check import collective_census, collective_summary
from besskge_tpu_torch import convert
from besskge_tpu_torch.parallel.multihost import _spawn
from test_torch_pipeline import _clear_ranks, _hold_topk_sets

JAX = {"ds": jax_ds, "sh": jax_sh, "ns": jax_ns, "bs": jax_bs, "dev": jax_dev, "sc": jax_scoring,
       "bess": jax_bess, "loss": jax_loss, "metric": jax_metric, "pipeline": jax_pipeline}
FP32, BF16 = 1e-5, 2.0**-7
TIMEOUT = 60


def _jax_optimizers(form):
    if form == "sparse":
        return (optax.sgd(R.LR_SPARSE, momentum=0.9),
                jax_optim.RowSGDM(R.LR_SPARSE, momentum=0.9, interleaved=True))
    if form == "fused":
        return optax.adamw(R.LR_DENSE), jax_optim.FusedDenseAdamW(R.LR_DENSE, weight_decay=1e-4)
    return optax.adamw(R.LR_DENSE), None


def _jax_mesh(n):
    return make_shard_mesh(n, devices=jax.devices("cpu")[:n])


def _jax_state(n, form, params, module):
    opt, ent = _jax_optimizers(form)
    params = dict(params)
    if form == "sparse":
        params["entity_embedding"] = jax_optim.interleave_momentum(params["entity_embedding"])
    mesh = _jax_mesh(n)
    params = shard_params({k: np.asarray(v) for k, v in params.items()}, mesh)
    sh = module.sharding
    state = jax_trainer.init_optimizer_state(opt, params, mesh, ent,
                                             n_logical=sh.n_shard * sh.max_entity_per_shard)
    return opt, ent, mesh, params, state


def _flat_jax(params, state):
    """The JAX package's arrays under the port's names (``R.flat_state``)."""
    return R.flat_state(convert.params_from_jax(jax.tree.map(np.asarray, params), "cpu"),
                        convert.opt_state_from_jax(jax.tree.map(np.asarray, state), "cpu"))


def _per_rank(name, value):
    return np.ndim(value) > 0 and ("entity_embedding" in name or name.startswith("state.entity."))


def _hold(ranks, want, rtol, n, skip=None):
    """Each rank's arrays against the JAX package's global ones: a rank's
    block of the entity table and its states, the whole of every other;
    ``skip`` maps a name to the global mask of values left out."""
    assert all(r.keys() == want.keys() for r in ranks), (ranks[0].keys(), want.keys())
    worst = 0.0
    for name, w in want.items():
        w = np.asarray(w)
        for rank, got in enumerate(ranks):
            g = np.asarray(got[name])
            keep = ~(skip or {}).get(name, np.zeros(w.shape, bool))
            if _per_rank(name, w):
                block = w.shape[0] // n
                w_r = w[rank * block:(rank + 1) * block]
                keep = keep[rank * block:(rank + 1) * block]
            else:
                w_r = w
            assert g.shape == w_r.shape and g.dtype == w_r.dtype, (name, g.shape, w_r.shape)
            if not np.issubdtype(w_r.dtype, np.floating):
                np.testing.assert_array_equal(g, w_r, err_msg=name)
                continue
            g32, w32 = g.astype(np.float32), w_r.astype(np.float32)
            tol = rtol * (np.abs(w32) + np.abs(w.astype(np.float32)).max())
            err = np.where(keep, np.abs(g32 - w32), 0.0)
            assert (err <= tol).all(), (name, rank, float(err.max()), float(tol.max()))
            worst = max(worst, float((err / np.maximum(tol, 1e-30)).max()))
    return worst


@pytest.fixture
def jax_kernel_path(monkeypatch):
    """Route the JAX package's p=1 distances through its TPU entry point,
    with the Pallas kernels in the interpreter (``tests/test_torch_train.py``)."""
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


def _inputs(n, form, n_batches=1):
    """(JAX module, numpy params, numpy batches) of a form on ``n`` shards."""
    score_fn, module, sampler, _ = R.setup(JAX, n, form)
    params = {k: np.asarray(v) for k, v in score_fn.initial_params().items()}
    blocks = sampler.epoch_index_blocks(True)
    return module, params, [sampler.sample_batch(next(blocks)) for _ in range(n_batches)]


#: The JAX package's runs, by their inputs' identities: several tests hold
#: the ranks' results of one run of the fixture to one JAX run.
_RUNS = {}


def _jax_train(n, form, params, batches, bf16=False):
    """One step per batch of the JAX package's ``shard_map`` step, from
    ``params``: (losses, arrays under the port's names, (step, params,
    state, mesh)). Memoised on the inputs' identities."""
    key = (n, form, bf16, id(params), tuple(id(b) for b in batches))
    if key not in _RUNS:
        _RUNS[key] = _jax_train_once(n, form, params, batches, bf16)
    return _RUNS[key]


def _jax_train_once(n, form, params, batches, bf16):
    score_fn, module, _, _ = R.setup(JAX, n, form, jax.numpy.bfloat16 if bf16 else None)
    opt, ent, mesh, p, s = _jax_state(n, form, params, module)
    step = jax_trainer.build_train_step(module, opt, mesh, ent, donate=False)
    losses = []
    for batch in batches:
        p, s, out = step(p, s, shard_batch(batch, mesh))
        losses.append(float(out["loss"]))
    return losses, _flat_jax(p, s), (step, p, s, mesh)


# --------------------------------------------------------------------------
# Four ranks


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """One spawn of 4 ranks for every 4-rank scenario and, beside it, one
    of 2 ranks; the JAX package's dense checkpoint saved first, for the
    ranks to load. Each rank runs on one thread: the ranks' work is small,
    and the test workers share the cores."""
    tmp = tmp_path_factory.mktemp("mesh4")
    sparse = _inputs(4, "sparse", n_batches=3)
    dense = _inputs(4, "dense")
    fused = _inputs(4, "fused")
    # The JAX package's dense state after one step, saved from its mesh.
    _, _, (_, jp, js, _) = _jax_train(4, "dense", dense[1], dense[2])
    jax_ckpt.save_checkpoint_sharded(tmp / "jax_dense", jp, js, dense[0].sharding, step=1)
    # The device sampler's uniforms for one call.
    _, jmod, _, jdev = R.setup(JAX, 4, "sparse")
    key = jdev.next_key(3)
    k_pos, k_neg = jax.random.split(key)
    draws = [np.asarray(jax.random.uniform(k_pos, (R.BPS, 4, 4, R.SHARD_BS // 4))),
             np.asarray(jax.random.uniform(k_neg, (R.BPS, 4, 4, 2, R.N_NEGATIVE)))]
    topk_in = {}
    for cand in (False, True):
        score_fn, _, sampler, _ = R.topk_setup(JAX, 4, cand)
        topk_in[cand] = ({k: np.asarray(v) for k, v in score_fn.initial_params().items()},
                         [sampler.sample_batch(b) for b in sampler.epoch_index_blocks(False)][:2])
    jobs = [
        ("train", (4, "sparse", False, sparse[1], sparse[2][:1])),
        ("train", (4, "sparse", True, sparse[1], sparse[2][:1])),
        ("train", (4, "dense", False, dense[1], dense[2], str(tmp / "port_dense"))),
        ("train", (4, "fused", False, fused[1], fused[2])),
        ("fit", (4, 3, sparse[1], str(tmp / "fit.npz"))),
        ("load_npz", (4, str(tmp / "fit.npz"))),
        ("device_step", (4, "sparse", sparse[1], draws * 2, 3)),
        ("topk", (4, False, *topk_in[False])),
        ("topk", (4, True, *topk_in[True])),
        ("load", (4, str(tmp / "jax_dense"))),
        ("planted", (4,)),
        ("multihost_views", (4, sparse[2][0], dense[1])),
        ("forward", (4, sparse[1], sparse[2][0])),
    ]
    two = {"sparse": _inputs(2, "sparse"), "dense": _inputs(2, "dense")}
    # The rest of the mesh: ScoreMoving, evaluation, all-scores, SyncBN.
    rest = _rest_inputs(4)
    jobs += [("sm_forward", (4, case, *rest["sm"][case])) for case in R.SM_CASES]
    jobs += [("sm_train", (4, scheme, *rest["smt"][scheme], 7)) for scheme in ("t", "ht")]
    jobs += [("device_eval", (4, rest["eval"])),
             *[("pipeline", (4, case, convert.params_from_jax(rest["pipe"][case], "cpu")))
               for case in PIPE_CASES],
             ("collective_grads", (4, *rest["grads"])),
             *[("conve_train", (4, form, sync, *rest["conve"][sync]))
               for form in ("fused", "sparse") for sync in (True, False)]]
    two["rest"] = _rest_inputs(2)
    jobs2 = [("train", (2, "sparse", False, two["sparse"][1], two["sparse"][2])),
             ("train", (2, "dense", False, two["dense"][1], two["dense"][2])),
             ("load", (2, str(tmp / "jax_dense"), 2)),
             ("resume", (2, two["sparse"][1], str(tmp / "resume.npz"))),
             ("sm_train", (2, "t", *two["rest"]["smt"]["t"], 7)),
             ("collective_grads", (2, *two["rest"]["grads"]))]
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(2) as pool:
        mp.setenv("OMP_NUM_THREADS", "1")
        spawns = [pool.submit(_spawn, R.run, n, (j,), timeout=TIMEOUT)
                  for n, j in ((4, jobs), (2, jobs2))]
        ranks, two["ranks"] = (f.result() for f in spawns)
    results = {}
    for i, (name, args) in enumerate(jobs):
        if name in ("train", "conve_train"):
            at = (name, *args[1:3])
        elif name in ("topk", "sm_forward", "sm_train", "pipeline"):
            at = (name, args[1])
        else:
            at = name
        results[at] = [r[i] for r in ranks]
    return {"res": results, "sparse": sparse, "dense": dense, "fused": fused, "tmp": tmp,
            "key": key, "topk_in": topk_in, "two": two, "rest": rest}


PIPE_CASES = ("filters", "candidates", "packed")


def _rest_inputs(n):
    """The numpy inputs of the ScoreMoving, evaluation, all-scores,
    collective-gradient and ConvE scenarios on ``n`` shards (``n`` 2: the
    ScoreMoving step and the gradients only)."""
    def first(sampler):
        return sampler.sample_batch(next(sampler.epoch_index_blocks(False)))

    def params_of(score_fn):
        return jax.tree.map(np.asarray, score_fn.initial_params())

    rest = {"smt": {}}
    for scheme in (("t", "ht") if n == 4 else ("t",)):
        score_fn, _, sampler, _ = R.smt_setup(JAX, n, scheme)
        rest["smt"][scheme] = (params_of(score_fn), first(sampler))
    rng = np.random.default_rng(n)
    rest["grads"] = (rng.normal(size=(n, 6, 5)).astype(np.float32),
                     rng.normal(size=(n, n, 6, 5)).astype(np.float32),
                     rng.normal(size=(n * 8, 5, 5, 3)).astype(np.float32),
                     rng.normal(size=(n, 6, 5)).astype(np.float32))
    if n == 2:
        return rest
    rest["sm"] = {}
    for case in R.SM_CASES:
        score_fn, _, sampler = R.sm_setup(JAX, n, case)
        rest["sm"][case] = (params_of(score_fn), first(sampler))
    rest["eval"] = params_of(R.eval_setup(JAX, n)[0])
    rest["pipe"] = {}
    for case in PIPE_CASES:
        kw = {"bf16": jax.numpy.bfloat16} if case == "packed" else {}
        score_fn = R.pipe_setup(JAX, n, case, _jax_mesh(n), **kw)[0]
        rest["pipe"][case] = params_of(score_fn)
    rest["conve"] = {}
    for sync in (True, False):
        score_fn, _, sampler = R.conve_setup(JAX, n, sync)
        rest["conve"][sync] = (params_of(score_fn), first(sampler))
    return rest


def test_sparse_step_matches_jax_at_4(four):
    module, params, batches = four["sparse"]
    losses, want, _ = _jax_train(4, "sparse", params, batches[:1])
    got = four["res"][("train", "sparse", False)]
    for rank in got:
        assert abs(rank["loss"][0] - losses[0]) <= FP32 * 2 * abs(losses[0])
    _hold([r["first"] for r in got], want, FP32, 4)


@pytest.mark.parametrize("form", ["dense", "fused"])
def test_dense_step_matches_jax_at_4(four, form):
    module, params, batches = four[form]
    losses, want, _ = _jax_train(4, form, params, batches)
    got = four["res"][("train", form, False)]
    assert all(abs(r["loss"][0] - losses[0]) <= FP32 * 2 * abs(losses[0]) for r in got)
    _hold([r["first"] for r in got], want, FP32, 4)


def test_sparse_step_bf16_matches_jax_kernel_path(four, jax_kernel_path):
    """bf16 scoring on 4 ranks against the JAX package's Pallas kernel path."""
    module, params, batches = four["sparse"]
    losses, want, _ = _jax_train(4, "sparse", params, batches[:1], bf16=True)
    got = four["res"][("train", "sparse", True)]
    assert all(abs(r["loss"][0] - losses[0]) <= BF16 * 2 * abs(losses[0]) for r in got)
    ent, rel = _positive_ties(params, batches[0], module.sharding)
    skip = {"param.entity_embedding": np.repeat(ent, 2, axis=0),  # param and momentum rows
            "param.relation_embedding": rel, "state.other.trace.relation_embedding": rel}
    _hold([r["first"] for r in got], want, BF16, 4, skip)


def _positive_ties(params, batch, sharding):
    """Coordinates where a positive's bf16 ``h + r − t`` is exactly 0:
    (global entity mask, relation mask) of the rows they touch. The batch
    is ``(bps, S_h, S_t, ppp)``, tails pre-transposed ``(bps, S_t, S_h,
    ppp)``, each ID local to its entity's shard."""
    import ml_dtypes

    bf = ml_dtypes.bfloat16
    table, rel = params["entity_embedding"], params["relation_embedding"]
    shards = np.arange(sharding.n_shard) * sharding.max_entity_per_shard
    heads = (shards[None, :, None, None] + batch["head"]).reshape(-1)
    tails = (shards[None, None, :, None] + batch["tail"].transpose(0, 2, 1, 3)).reshape(-1)
    rels = batch["relation"].reshape(-1)
    hr = table[heads].astype(bf).astype(np.float32) + rel[rels].astype(bf).astype(np.float32)
    tie = hr.astype(bf) == table[tails].astype(bf)
    ent, rel_mask = np.zeros(table.shape, bool), np.zeros(rel.shape, bool)
    for ids, mask in ((heads, ent), (tails, ent), (rels, rel_mask)):
        np.logical_or.at(mask, ids, tie)
    return ent, rel_mask


def test_replicated_params_equal_on_every_rank_after_3_steps(four):
    fits = four["res"]["fit"]
    assert len(fits[0]["losses"]) == 3 and all(np.isfinite(fits[0]["losses"]))
    # A rank's initial_params_device(mesh) is its block of the one-process
    # draw, and a Trainer takes it as the rank's own.
    rows = four["sparse"][0].sharding.max_entity_per_shard
    assert all(r["own_block_equal"] and r["own_block_rows"] == rows for r in fits)
    for rank in fits[1:]:
        assert rank["losses"] == fits[0]["losses"]
        for k, v in fits[0]["replicated"].items():
            np.testing.assert_array_equal(rank["replicated"][k], v, err_msg=k)
    # ... and their losses are the JAX package's over the same three batches
    # of the trainer's dataloader. (Its chained params are not compared: a
    # coordinate within an ulp of an L1 tie flips its subgradient's sign.)
    _, _, sampler, _ = R.setup(R.PORT, 4, "sparse")
    batches = [b for b, _ in zip(sampler.get_dataloader(shuffle=True, seed_offset=0), range(3))]
    losses, _, _ = _jax_train(4, "sparse", four["sparse"][1], batches)
    np.testing.assert_allclose(fits[0]["losses"], losses, rtol=1e-4)


def test_forward_matches_jax_at_4(four):
    """``build_bess_forward`` over the mesh (no gradient): the loss summed
    over the mesh and each rank's scores against the JAX package's, one
    all-to-all per micro-batch and one all-reduce of the loss."""
    _, params, batches = four["sparse"]
    _, module, _, _ = R.setup(JAX, 4, "sparse")
    module.return_scores = True
    mesh = _jax_mesh(4)
    want = jax_bess.build_bess_forward(module, mesh)(
        shard_params(params, mesh),
        shard_batch({k: v for k, v in batches[0].items() if k in jax_bess._FORWARD_KEYS}, mesh))
    want = {k: np.asarray(v) for k, v in want.items()}
    for rank, r in enumerate(four["res"]["forward"]):
        assert abs(r["loss"] - want["loss"]) <= FP32 * 2 * abs(want["loss"])
        for key in ("positive_score", "negative_score"):
            w = want[key][:, rank:rank + 1]
            assert r[key].shape == w.shape
            assert (np.abs(r[key] - w) <= FP32 * (np.abs(w) + np.abs(w).max())).all(), key
        c = r["census"]
        assert len(c["all-to-all"]) == R.BPS and len(c["all-reduce"]) == 1 and not c["all-gather"]


def test_dropout_keys_differ_by_rank():
    """Over a mesh a dropout key is folded with the rank (the JAX package's
    ``fold_in`` of the axis index): every rank draws its own stream, the
    same on every call."""
    from besskge_tpu_torch.device_sampler import _fold_in

    keys = [int(_fold_in(torch.tensor(12345), rank)) for rank in range(8)]
    assert len(set(keys)) == 8 and all(0 <= k < 2**32 for k in keys)
    assert keys == [int(_fold_in(torch.tensor(12345), rank)) for rank in range(8)]
    assert int(_fold_in(torch.tensor(12346), 0)) != keys[0]


def test_multihost_views_of_a_rank(four):
    """``make_global_mesh`` spans every rank; a rank owns shard ``rank``,
    takes its own batch column (a whole batch raises) and its block of the
    params, as the JAX package's multihost helpers place them."""
    batch, params = four["sparse"][2][0], four["dense"][1]
    for rank, r in enumerate(four["res"]["multihost_views"]):
        assert r["range"] == (rank, rank + 1) and r["n_shard"] == 4 and r["whole_batch_raised"]
        for k, v in batch.items():
            np.testing.assert_array_equal(r["batch"][k], v[:, rank:rank + 1], err_msg=k)
        np.testing.assert_array_equal(r["params"]["entity_embedding"],
                                      np.split(params["entity_embedding"], 4)[rank])
        np.testing.assert_array_equal(r["params"]["relation_embedding"],
                                      params["relation_embedding"])


def test_npz_checkpoint_from_and_onto_the_mesh(four):
    """``Trainer.save`` of the 4-rank run writes one ``.npz`` of the global
    arrays, de-interleaved, which the JAX package loads; loaded back onto
    the 4 ranks (``load_checkpoint(mesh=)``) it gives each rank its arrays
    bit for bit."""
    fits = four["res"]["fit"]
    wide = np.concatenate([r["final"]["param.entity_embedding"] for r in fits])
    params, state, sharding, meta = jax_ckpt.load_checkpoint(four["tmp"] / "fit.npz")
    assert meta["step"] == 3 and sharding.n_shard == 4
    np.testing.assert_array_equal(np.asarray(params["entity_embedding"]), wide[0::2])
    np.testing.assert_array_equal(np.asarray(state["entity"]["m"]), wide[1::2])
    np.testing.assert_array_equal(np.asarray(params["relation_embedding"]),
                                  fits[0]["final"]["param.relation_embedding"])
    for fit, loaded in zip(fits, four["res"]["load_npz"]):
        assert loaded.keys() == fit["final"].keys()
        for name, value in fit["final"].items():
            np.testing.assert_array_equal(loaded[name], value, err_msg=name)


def test_device_sampled_call_matches_jax(four):
    """Each rank's column of the device sampler's batch, bit for bit against
    the JAX package's ``slice_local``; the device-sampled call equal bit for
    bit to the host-fed step on the same global batch (held against the
    JAX package's step in ``test_sparse_step_matches_jax_at_4``)."""
    _, jmod, _, jdev = R.setup(JAX, 4, "sparse")
    key = four["key"]
    batch = jdev.sample(jdev.state(), key)
    got = four["res"]["device_step"]
    for rank, r in enumerate(got):
        want = jdev.slice_local(batch, rank)
        assert r["batch"].keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(r["batch"][k], np.asarray(want[k]), err_msg=k)
        assert r["uncaptured"] is None  # the CPU runs every call eagerly
        assert r["loss"] == r["host_loss"] and r["state"].keys() == r["host_state"].keys()
        for name, value in r["host_state"].items():
            np.testing.assert_array_equal(r["state"][name], value, err_msg=name)


def _topk_reference(params, sharding, batch, cands):
    """Full-table scores of each micro-batch's queries: (bps, n_shard,
    shard_bs, n_shard · max_entity_per_shard), padding rows and (with
    candidates) non-candidates at -inf."""
    table, rel = params["entity_embedding"], params["relation_embedding"]
    n, rows = sharding.n_shard, sharding.max_entity_per_shard
    home = (np.arange(n)[None, :, None] * rows + batch["head"]).astype(np.int64)
    q = table[home] + rel[batch["relation"]]
    scores = -np.abs(q[..., None, :] - table[None, None, None]).sum(-1)
    valid = (np.arange(rows)[None, :] < sharding.shard_counts[:, None]).reshape(-1)
    if cands is not None:
        in_set = np.zeros(n * rows, bool)
        in_set[sharding.entity_to_shard[cands[0]] * rows + sharding.entity_to_idx[cands[0]]] = True
        valid &= in_set
    return np.where(valid, scores, -np.inf)


@pytest.mark.parametrize("cand", [False, True])
def test_topk_matches_jax_at_4(four, cand):
    params, batches = four["topk_in"][cand]
    _, jtopk, _, cands = R.topk_setup(JAX, 4, cand)
    mesh = _jax_mesh(4)
    fwd = jax_bess.build_topk_forward(jtopk, mesh)
    got = four["res"][("topk", cand)]
    sure = 0
    for b, batch in enumerate(batches):
        want = {k: np.asarray(v) for k, v in fwd(shard_params(params, mesh),
                                                   shard_batch(batch, mesh)).items()}
        ref = np.sort(_topk_reference(params, jtopk.sharding, batch, cands), axis=-1)
        apart = (ref[..., -R.K] - ref[..., -R.K - 1]) > 1e-4
        for rank, r in enumerate(got):
            g = r["outs"][b]
            w_s = want["topk_scores"][:, rank:rank + 1]
            tol = FP32 * (np.abs(w_s) + np.abs(w_s).max())
            assert (np.abs(g["topk_scores"] - w_s) <= tol).all()
            ids, w_ids = g["topk_global_id"], want["topk_global_id"][:, rank:rank + 1]
            ok = apart[:, rank:rank + 1]
            np.testing.assert_array_equal(np.sort(ids, -1)[ok], np.sort(w_ids, -1)[ok])
            sure += int(ok.sum())
    assert sure > R.N_QUERY // 4


def test_census_of_the_step_and_of_top_k(four):
    """Per step 2 x bps all-to-alls (each micro-batch's forward and its
    transpose) of bench.py's payload, no all-gather and one all-reduce,
    smaller than a table block; per top-k batch 2 all-gathers and 2
    all-to-alls per micro-batch; a planted table-sized all-reduce is caught.
    The JAX package's compiled step holds the same contract."""
    module = four["sparse"][0]
    ppp = R.SHARD_BS // 4
    payload = 4 * (ppp + 2 * R.N_NEGATIVE) * R.DIM * 4  # S*(ppp + B*n_neg)*row*4B
    block = module.sharding.max_entity_per_shard * R.DIM * 4
    for form in ("sparse", "dense", "fused"):
        for r in four["res"][("train", form, False)]:
            c = r["census"]
            width = payload if form == "sparse" else 4 * (ppp + 2) * R.DIM * 4
            assert c["all-to-all"] == [width] * (2 * R.BPS), (form, c)
            assert c["all-gather"] == [] and len(c["all-reduce"]) == 1, (form, c)
            assert c["all-reduce"][0] < block and c["order"][-1] == "all-reduce"
    for cand in (False, True):
        params, batches = four["topk_in"][cand]
        _, jtopk, _, _ = R.topk_setup(JAX, 4, cand)
        mesh = _jax_mesh(4)
        fwd = jax_bess.build_topk_forward(jtopk, mesh)
        want = collective_census(lambda p, b: fwd(p, b), shard_params(params, mesh), shard_batch(
            {k: v for k, v in batches[0].items() if k in jax_bess._TOPK_KEYS}, mesh))
        # The JAX package's scan body: 2 all-gathers and 2 all-to-alls per
        # micro-batch; the port's 2 micro-batches, the same payloads but the
        # IDs' all-to-all, int64 in the port (int32 there).
        assert len(want["all-gather"]) == len(want["all-to-all"]) == 2 and not want["all-reduce"]
        for r in four["res"][("topk", cand)]:
            c = r["census"]
            assert sorted(c["all-gather"]) == sorted(want["all-gather"] * 2)
            assert c["all-to-all"] == [want["all-to-all"][0], 2 * want["all-to-all"][1]] * 2
            assert c["all-reduce"] == []
    assert all(four["res"]["planted"])
    # The JAX package: bench.py's census (bps 1) at n_shard 4.
    jmodule, params, batches = four["sparse"]
    opt, ent, mesh, p, s = _jax_state(4, "sparse", params, jmodule)
    step = jax_trainer.build_train_step(jmodule, opt, mesh, ent, donate=False)
    one = {k: v[:1] for k, v in batches[0].items()}
    census = collective_census(lambda a, b, c: step(a, b, c), p, s, shard_batch(one, mesh))
    assert census["all-to-all"] == [payload, payload]
    assert census["all-gather"] == [] and len(census["all-reduce"]) == 1


def test_checkpoints_cross_packages_at_4(four):
    """A sharded checkpoint saved from the port's 4 ranks (the dense step:
    the JAX package's sharded loader takes plain tables onto a mesh) loads
    into the JAX package on its mesh of 4, bit for bit, and its step resumes
    from it as from the same arrays put there directly; the JAX package's
    dense mesh checkpoint loads onto the port's 4 ranks bit for bit."""
    module, params, batches = four["dense"]
    got = four["res"][("train", "dense", False)]
    _, _, (step, jp, js, mesh) = _jax_train(4, "dense", params, batches)
    lp, ls, sharding, meta = jax_ckpt.load_checkpoint_sharded(four["tmp"] / "port_dense", mesh,
                                                              like=js)
    assert meta["step"] == 1 and sharding.n_shard == 4
    loaded = _flat_jax(lp, ls)
    assert loaded.keys() == got[0]["last"].keys()
    for name, w in loaded.items():
        for rank, r in enumerate(got):
            g = r["last"][name]
            block = len(w) // 4 if _per_rank(name, w) else None
            want = w[rank * block:(rank + 1) * block] if block else w
            np.testing.assert_array_equal(g, want, err_msg=name)
    direct = {k: np.concatenate([r["last"][f"param.{k}"] for r in got]) if k == "entity_embedding"
              else got[0]["last"][f"param.{k}"] for k in ("entity_embedding", "relation_embedding")}
    batch = shard_batch(batches[0], mesh)
    a = step(lp, ls, batch)
    b = step(shard_params(direct, mesh), ls, batch)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    # The JAX package's dense checkpoint, onto 4 ranks.
    jp, js, _, _ = jax_ckpt.load_checkpoint_sharded(four["tmp"] / "jax_dense")
    table = np.asarray(jp["entity_embedding"])
    for rank, r in enumerate(four["res"]["load"]):
        assert r["n_shard"] == 4 and r["step"] == 1
        np.testing.assert_array_equal(r["params"]["entity_embedding"],
                                      np.split(table, 4)[rank])
        np.testing.assert_array_equal(r["params"]["relation_embedding"],
                                      np.asarray(jp["relation_embedding"]))
        mu = np.asarray(js[0][1]["entity_embedding"])
        np.testing.assert_array_equal(r["state"]["mu"]["entity_embedding"], np.split(mu, 4)[rank])


# --------------------------------------------------------------------------
# ScoreMoving, evaluation, all-scores and SyncBN at four ranks


def _close(got, want, rtol, what, scale=None):
    """``|got − want| ≤ rtol·(|want| + scale)``, ``scale`` by default
    ``max|want|``."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rtol * (np.abs(want) + (np.abs(want).max() if scale is None else scale))
    assert (np.abs(got - want) <= tol).all(), (what, float(np.abs(got - want).max()))


def _sm_census_want(case):
    """The JAX package's collectives of a ScoreMoving case's forward: its
    scan body's (one micro-batch)."""
    score_fn, module, sampler = R.sm_setup(JAX, 4, case)
    mesh = _jax_mesh(4)
    params, batch = (shard_params(jax.tree.map(np.asarray, score_fn.initial_params()), mesh),
                     sampler.sample_batch(next(sampler.epoch_index_blocks(False))))
    fwd = jax_bess.build_bess_forward(module, mesh)
    return collective_summary(lambda p, b: fwd(p, b), params, shard_batch(
        {k: v for k, v in batch.items() if k in jax_bess._FORWARD_KEYS}, mesh))


@pytest.mark.parametrize("case", R.SM_CASES, ids=lambda c: "-".join(map(str, c)))
def test_score_moving_forward_matches_jax_at_4(four, case):
    """``ScoreMovingBessKGE`` through ``build_bess_forward`` over 4 ranks
    (``tests/test_bess.py:60``'s "h", "t", "ht" with shared and per-triple
    candidate sets, ``:265``'s random flat negatives): each rank's positive
    and negative scores and ranks against its column of the JAX package's
    ``shard_map`` forward, the summed metrics equal on every rank; per
    micro-batch one all-to-all and the all-gathers of the scheme (2, "ht" 3:
    ``tests/test_checkpoint_hlo.py:202``), as the JAX scan body has, and no
    backward collective."""
    params, batch = four["rest"]["sm"][case]
    _, module, _ = R.sm_setup(JAX, 4, case)
    mesh = _jax_mesh(4)
    want = jax_bess.build_bess_forward(module, mesh)(
        shard_params(params, mesh),
        shard_batch({k: v for k, v in batch.items() if k in jax_bess._FORWARD_KEYS}, mesh))
    want = {k: np.asarray(v) for k, v in want.items()}
    got = four["res"][("sm_forward", case)]
    bps = batch["relation"].shape[0]
    per_mb = _sm_census_want(case) if case[0] == "random" else None
    for rank, r in enumerate(got):
        assert r.keys() - {"census"} == want.keys()
        pos, neg = want["positive_score"][:, rank:rank + 1], want["negative_score"][:, rank:rank + 1]
        # Masked candidates carry BAD_NEGATIVE_SCORE: the scale is the real ones'.
        real = neg > jax_bess.BAD_NEGATIVE_SCORE / 2
        scale = max(np.abs(neg[real]).max(), np.abs(pos).max())
        _close(r["positive_score"], pos, FP32, "positive_score", scale)
        _close(r["negative_score"], neg, FP32, "negative_score", scale)
        if "ranks" in want:
            clear = ~((np.abs(neg - pos[..., None]) <= 2 * FP32 * scale) & real).any(-1)
            assert clear.mean() > 0.7
            np.testing.assert_array_equal(r["ranks"][clear], want["ranks"][:, rank:rank + 1][clear])
            np.testing.assert_array_equal(r["metrics"], got[0]["metrics"])
            if clear.all():
                _close(r["metrics"], want["metrics"], FP32, "metrics")
        c = r["census"]
        gathers = 3 if case[1] == "ht" else 2
        assert len(c["all-to-all"]) == bps and len(c["all-gather"]) == gathers * bps, c
        assert len(c["all-reduce"]) == (1 if "metrics" in want else 0) and not c["reduce-scatter"]
        if per_mb is not None:
            assert per_mb["all-to-all"] == 1 and per_mb["all-gather"] == gathers


def _smt_jax(n, scheme, params, batch):
    """Two JAX ScoreMoving steps on ``batch`` in the sparse and the dense
    form (``tests/test_optim.py:200``): {form: (losses, params)}."""
    _, module, _, _ = R.smt_setup(JAX, n, scheme)
    mesh = _jax_mesh(n)
    out = {}
    for form, ent in (("sparse", jax_optim.RowSGDM(learning_rate=0.5, momentum=0.0)),
                      ("dense", None)):
        opt = optax.sgd(0.5)
        p = shard_params({k: np.asarray(v) for k, v in params.items()}, mesh)
        st = jax_trainer.init_optimizer_state(opt, p, mesh, ent)
        step = jax_trainer.build_train_step(module, opt, mesh, ent, donate=False)
        losses = []
        for _ in range(2):
            p, st, o = step(p, st, shard_batch(batch, mesh))
            losses.append(float(o["loss"]))
        out[form] = (losses, {k: np.asarray(v) for k, v in p.items()})
    return out


def _hold_smt(n, scheme, params, batch, got):
    want = _smt_jax(n, scheme, params, batch)
    bps = batch["relation"].shape[0]
    for rank, r in enumerate(got):
        for form, (losses, wp) in want.items():
            for i, loss in enumerate(losses):
                assert abs(r[form]["loss"][i] - loss) <= FP32 * 2 * abs(loss), (form, i)
            rows = len(wp["entity_embedding"]) // n
            _close(r[form]["state"]["param.entity_embedding"],
                   wp["entity_embedding"][rank * rows:(rank + 1) * rows], FP32, (form, "entity"))
            _close(r[form]["state"]["param.relation_embedding"], wp["relation_embedding"], FP32,
                   (form, "relation"))
        # The sparse step equals the dense one, as tests/test_optim.py:200.
        for name in ("param.entity_embedding", "param.relation_embedding"):
            np.testing.assert_allclose(r["sparse"]["state"][name], r["dense"]["state"][name],
                                       rtol=1e-5, atol=1e-6, err_msg=name)
        # Per micro-batch: the score all-to-all and its transpose, the
        # all-gathers and a reduce-scatter for each gathered row tensor.
        c, rows_gathered = r["census"], 2 if scheme == "ht" else 1
        assert len(c["all-to-all"]) == 2 * bps and len(c["all-reduce"]) == 1, c
        assert len(c["all-gather"]) == (rows_gathered + 1) * bps, c
        assert len(c["reduce-scatter"]) == rows_gathered * bps, c
        d = r["device"]
        assert d["loss"] == d["host_loss"]
        for name, value in d["host_state"].items():
            np.testing.assert_array_equal(d["state"][name], value, err_msg=name)


@pytest.mark.parametrize("scheme", ["t", "ht"])
def test_score_moving_steps_match_jax_at_4(four, scheme):
    """ScoreMoving trained over 4 ranks, sparse (``RowSGDM``) and dense
    (SGD on the table), two steps each against the JAX package's mesh
    step: the gathered rows' gradients come back through the all-gathers'
    reduce-scatters; the sparse step equals the dense one; a device-sampled
    call equals the host-fed step on the batch it drew, bit for bit."""
    _hold_smt(4, scheme, *four["rest"]["smt"][scheme], four["res"][("sm_train", scheme)])


def test_run_device_eval_matches_jax_at_4(four):
    """``run_device_eval(mesh=)`` with a ragged last block
    (``tests/test_eval_loop.py:77``): the metrics equal on every rank and
    equal to the JAX package's ``run_device_eval`` over its mesh and to the
    per-step forward's sums; a reduction other than "sum" raises
    (``:107``)."""
    params = four["rest"]["eval"]
    _, module, sampler = R.eval_setup(JAX, 4)
    got = four["res"]["device_eval"]
    r0 = got[0]
    assert r0["n_steps"] % r0["spb"], "want a ragged final block"
    mesh = _jax_mesh(4)
    want, n_q = jax_eval.run_device_eval(module, shard_params(params, mesh), sampler,
                                         mesh=mesh, steps_per_block=r0["spb"])
    # Queries whose true score has another within the tolerance (a near tie
    # may rank either way): from the JAX package's scores of the same pass.
    module.return_scores = True
    fwd = jax_bess.build_bess_forward(module, mesh)
    n_near = 0
    for batch in sampler.get_dataloader(shuffle=False):
        out = fwd(shard_params(params, mesh), shard_batch(
            {k: v for k, v in batch.items() if k in jax_bess._FORWARD_KEYS}, mesh))
        pos, neg = np.asarray(out["positive_score"]), np.asarray(out["negative_score"])
        real = neg > jax_bess.BAD_NEGATIVE_SCORE / 2
        scale = max(np.abs(neg[real]).max(), np.abs(pos).max())
        near = ((np.abs(neg - pos[..., None]) <= 2 * FP32 * scale) & real).any(-1)
        n_near += int(near[batch["triple_mask"].reshape(near.shape)].sum())
    # (A candidate set of 40 of 360 entities holds the true one about one
    # time in nine: an exact tie, scored by another function on each side.)
    assert n_near < n_q / 5
    for r in got:
        assert r["sum_raised"] and r["n_queries"] == n_q
        assert r["metrics"] == r0["metrics"]
        for i, (name, value) in enumerate(want.items()):
            assert abs(r["metrics"][name] - value) <= n_near / n_q + 8 * n_q * 2.0**-24, name
            sums = r["step_sums"][i] / n_q
            assert abs(r["metrics"][name] - sums) <= 4 * n_q * 2.0**-24 * max(sums, 1e-30), name


def _jax_pipeline(case, params):
    kw = {"bf16": jax.numpy.bfloat16} if case == "packed" else {}
    _, pipe, pts, tri = R.pipe_setup(JAX, 4, case, _jax_mesh(4), **kw)
    return pipe.forward(params), pipe, pts, tri


@pytest.mark.parametrize("case", PIPE_CASES)
def test_allscores_pipeline_matches_jax_at_4(four, case):
    """``AllScoresPipeline(mesh=)`` over 4 ranks (``tests/test_pipeline.py``
    ``:69`` with filters, ``:135`` with candidates, ``:175`` over a packed
    bf16 table): every rank returns the same dict, the JAX package's over
    its mesh of 4: its keys, the triple order, -inf exactly where it is,
    the scores (fp32 1e-5, bf16 2^-7), ranks and per-query metrics where no
    other score is within the tolerance of the true one, top-k as sets
    where the k-th and (k+1)-th stand apart. Per window and micro-batch one
    all-to-all and two all-gathers, and per batch one all-gather of each
    output the rows of every rank make up."""
    params = four["rest"]["pipe"][case]
    want, pipe, pts, tri = _jax_pipeline(case, params)
    want = {k: (v if isinstance(v, dict) else np.asarray(v)) for k, v in want.items()}
    got = four["res"][("pipeline", case)]
    scores = want["scores"].astype(np.float32)
    inf = np.isneginf(scores)
    tol = (BF16 if case == "packed" else FP32) * (np.abs(scores[~inf]).max()
                                                  + np.where(inf, 0.0, np.abs(scores)))
    gt = tri[pts.triple_sort_idx[want["triple_idx"]], 2]
    clear = _clear_ranks(scores, gt, tol)
    # bf16 DistMult differs by up to an ulp between the packages (ROADMAP
    # C): few of the packed case's rows stand clear at 2^-7.
    assert clear.mean() > (0.0 if case == "packed" else 0.75)
    for r in got:
        out = r["out"]
        assert out.keys() == want.keys()
        for key in ("scores", "topk_global_id", "triple_idx", "ranks"):
            if key in want:
                assert out[key].shape == want[key].shape, key
                np.testing.assert_array_equal(out[key], got[0]["out"][key], err_msg=key)
        np.testing.assert_array_equal(out["triple_idx"], want["triple_idx"])
        np.testing.assert_array_equal(np.isneginf(out["scores"]), inf)
        assert (np.abs(out["scores"][~inf] - scores[~inf]) <= tol[~inf]).all()
        for name in want.get("metrics", {}):
            np.testing.assert_array_equal(out["metrics"][name], got[0]["out"]["metrics"][name])
            np.testing.assert_array_equal(out["metrics"][name][clear], want["metrics"][name][clear])
        if "ranks" in want:
            np.testing.assert_array_equal(out["ranks"][clear], want["ranks"][clear])
        if "topk_global_id" in want:
            assert _hold_topk_sets(out["topk_global_id"], scores, 7, tol) > len(scores) // 2
        windows = pipe.bess_module.n_step * pipe.batch_sampler.batches_per_step * sum(
            1 for _ in pipe.batch_sampler.epoch_index_blocks(False))
        per_batch = windows // (pipe.bess_module.n_step * pipe.batch_sampler.batches_per_step)
        outputs = (pipe.evaluation is not None) + 1 + ("topk_global_id" in want)
        assert r["census"]["all-to-all"] == windows and not r["census"]["all-reduce"]
        assert r["census"]["all-gather"] == 2 * windows + outputs * per_batch, r["census"]


def test_collective_gradients_match_jax(four):
    """The backward of ``all_gather`` (a reduce-scatter) and of ``pmean``
    (an all-reduce) at 4 and at 2 ranks, by ``torch.func.grad`` and by
    ``backward``, against ``jax.grad`` inside the JAX package's
    ``shard_map(check_vma=False)``; SyncBN's moments are the global batch's
    (``tests/test_conve_weighting.py:242``) and their gradient is the JAX
    program's. Each backward records its own collective."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    for n, got, (x, w, y, u) in ((4, four["res"]["collective_grads"], four["rest"]["grads"]),
                                 (2, [r[5] for r in four["two"]["ranks"]],
                                  four["two"]["rest"]["grads"])):
        mesh = _jax_mesh(n)
        score_fn = jax_scoring.ConvE(
            negative_sample_sharing=True, sharding=jax_sh.Sharding.create(100, n, seed=21),
            n_relation_type=4, embedding_size=32, embedding_height=4, embedding_width=8,
            sync_batch_norm=True, seed=21)
        score_fn.mesh_axis = "shard"

        def body(xb, wb, yb, ub):
            def gathered(t):
                return (wb[0] * jax.lax.all_gather(t, "shard") ** 2).sum()

            def meaned(t):
                return (ub[0] * jax.lax.pmean(t, "shard") ** 3).sum()

            def stats(t):
                m, v = score_fn._batch_stats(t, (0, 1, 2), True)
                c = ub[0, 0, : m.shape[0]]
                return (c * m).sum() + (c**2 * v).sum()
            m, v = score_fn._batch_stats(yb, (0, 1, 2), True)
            return (jax.grad(gathered)(xb[0])[None], jax.grad(meaned)(xb[0])[None],
                    jax.grad(stats)(yb), m[None], v[None])

        shard = P("shard")
        want = shard_map(body, mesh=mesh, in_specs=(shard,) * 4,
                         out_specs=(shard,) * 5, check_vma=False)(x, w, y, u)
        want = [np.asarray(a) for a in want]
        for rank, r in enumerate(got):
            _close(r["gather"], want[0][rank], FP32, (n, "all_gather"))
            np.testing.assert_array_equal(r["gather_backward"], r["gather"])
            _close(r["pmean"], want[1][rank], FP32, (n, "pmean"))
            _close(r["stats_grad"], np.split(want[2], n)[rank], FP32, (n, "stats"))
            _close(r["mean"], want[3][rank], FP32, (n, "mean"))
            _close(r["var"], want[4][rank], FP32, (n, "var"))
            np.testing.assert_allclose(r["mean"], y.mean((0, 1, 2)), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(r["var"], y.var((0, 1, 2)), rtol=1e-4, atol=1e-6)
            assert r["gather_census"]["order"] == ["all-gather", "reduce-scatter"]
            assert r["pmean_census"]["order"] == ["all-reduce", "all-reduce"]


def _conve_jax(form, sync, params, batch):
    score_fn, module, _ = R.conve_setup(JAX, 4, sync)
    mesh = _jax_mesh(4)
    if form == "sparse":
        opt, ent = optax.sgd(0.05, momentum=0.9), jax_optim.RowSGDM(0.05, momentum=0.9,
                                                                    interleaved=True)
        params = {**params, "entity_embedding": jax_optim.interleave_momentum(
            params["entity_embedding"])}
    else:
        opt, ent = optax.adamw(3e-3), jax_optim.FusedDenseAdamW(3e-3, weight_decay=1e-4)
    p = shard_params(params, mesh)
    sh = module.sharding
    st = jax_trainer.init_optimizer_state(opt, p, mesh, ent,
                                          n_logical=sh.n_shard * sh.max_entity_per_shard)
    step = jax_trainer.build_train_step(module, opt, mesh, ent, donate=False)
    p, st, out = step(p, st, shard_batch(batch, mesh))
    return float(out["loss"]), _flat_jax(p, st), score_fn


#: ConvE's params whose gradient the batch statistics make 0 without
#: dropout (``tests/test_torch_conve_train.py``'s ``invariant``): rounding
#: noise on both sides.
CONVE_INVARIANT = ("conv_b", "bn0.scale", "bn0.bias", "fc_b")


def _hold_conve(got, want, form, rank):
    """A rank's ConvE arrays against the JAX package's as
    ``tests/test_torch_conve_train.py`` holds them: fp32 arrays within 1e-5
    x (|want| + max|want|); a param also within lr x the difference of its
    update direction (SGD: the momentum; AdamW: ``m^/(sqrt(v^) + eps)``);
    the moments of the invariant params within 1e-5 of the tree's largest
    (nu: 1e-10); the running stats at rtol 1e-4, atol 1e-5."""
    lr = 0.05 if form == "sparse" else 3e-3

    def block(name, w):
        if _per_rank(name, w):
            rows = len(w) // 4
            return w[rank * rows:(rank + 1) * rows]
        return w

    def adam(mu, nu):  # the first step's m^/(sqrt(v^) + eps)
        return (mu / 0.1) / (np.sqrt(nu / 0.001) + 1e-8)

    def direction(tree, path):
        if form == "sparse":
            return tree[f"state.other.trace.{path}"]
        return adam(tree[f"state.other.mu.{path}"], tree[f"state.other.nu.{path}"])

    assert got.keys() == want.keys()
    largest = {}
    for name, w in want.items():
        kind = name.split(".")[2] if name.startswith("state.other.") else None
        if kind and np.ndim(w):
            largest[kind] = max(largest.get(kind, 0.0), float(np.abs(w).max()))
    for name, w in want.items():
        w, g = block(name, np.asarray(w)), np.asarray(got[name])
        if not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        path = name.split(".", 1)[1]
        extra = 0.0
        if name.startswith("state.other.") and path.split(".", 2)[-1] in CONVE_INVARIANT:
            kind = name.split(".")[2]
            floor = (FP32**2 if kind == "nu" else FP32) * largest[kind]
            assert np.abs(g).max() <= floor and np.abs(w).max() <= floor, name
            continue
        if path.endswith(("mean", "var")):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=name)
            continue
        if name == "param.entity_embedding" and form == "sparse":
            _close(g[1::2], w[1::2], FP32, "entity momentum")
            g, w, extra = g[0::2], w[0::2], lr * np.abs(g[1::2] - w[1::2])
        elif name == "param.entity_embedding":
            mine = [block(k, np.asarray(want[k])) for k in ("state.entity.mu", "state.entity.nu")]
            extra = lr * np.abs(adam(got["state.entity.mu"], got["state.entity.nu"]) - adam(*mine))
        elif name.startswith("param."):
            extra = lr * np.abs(direction(got, path) - direction(want, path))
        err = np.abs(g.astype(np.float32) - w.astype(np.float32))
        tol = FP32 * (np.abs(w) + np.abs(w).max()) + extra
        assert (err <= tol).all(), (name, rank, float(err.max()))


@pytest.mark.parametrize("sync", [True, False], ids=["sync_bn", "local_bn"])
@pytest.mark.parametrize("form", ["fused", "sparse"])
def test_conve_steps_match_jax_at_4(four, form, sync):
    """ConvE trained over 4 ranks with and without ``sync_batch_norm``
    (dropout 0), dense (``FusedDenseAdamW``, B10 on a card) and sparse
    (``RowSGDM`` interleaved, B3): the loss and every array against the JAX
    package's mesh step, the running stats equal on every rank and equal to
    the EMA of the global positive batch (``tests/test_conve_weighting.py:214``,
    its tolerance); with SyncBN a ``Trainer`` over two steps keeps them
    equal on every rank."""
    params, batch = four["rest"]["conve"][sync]
    loss, want, score_fn = _conve_jax(form, sync, params, batch)
    got = four["res"][("conve_train", form, sync)]
    for rank, r in enumerate(got):
        assert abs(r["loss"] - loss) <= FP32 * 2 * abs(loss)
        for k in ("bn0", "bn1", "bn2"):
            for s in ("mean", "var"):
                np.testing.assert_array_equal(r["state"][f"param.{k}.{s}"],
                                              got[0]["state"][f"param.{k}.{s}"])
        _hold_conve(r["state"], want, form, rank)
    # The in-step EMA of the global positive batch, on the host.
    table = params["entity_embedding"]
    rows = score_fn.sharding.max_entity_per_shard
    head, rel = batch["head"], batch["relation"]
    h_emb = np.concatenate([table[s * rows + head[:, s].reshape(-1)] for s in range(4)])
    rels = np.concatenate([rel[:, s].reshape(-1) for s in range(4)])
    score_fn.mesh_axis = None
    expected = score_fn.update_bn_stats(params, jax.numpy.asarray(h_emb),
                                        jax.numpy.asarray(rels), momentum=0.1)
    for k in ("bn0", "bn1", "bn2"):
        for s in ("mean", "var"):
            np.testing.assert_allclose(got[0]["state"][f"param.{k}.{s}"],
                                       np.asarray(expected[k][s]), rtol=2e-4, atol=2e-5)
    if form == "fused" and sync:
        fits = [r["fit"] for r in got]
        assert all(np.isfinite(f["losses"]).all() for f in fits)
        for f in fits[1:]:
            assert f["losses"] == fits[0]["losses"]
            for k, stats in f["bn"].items():
                for s, v in stats.items():
                    np.testing.assert_array_equal(v, fits[0]["bn"][k][s])


# --------------------------------------------------------------------------
# Two ranks


def test_two_ranks_match_jax_and_reshard_4_to_2(four):
    """The sparse and dense steps at 2 ranks against the JAX package at
    n_shard 2, and the JAX package's 4-shard dense checkpoint re-sharded onto
    2 ranks bit for bit."""
    two = four["two"]
    sparse, dense, ranks = two["sparse"], two["dense"], two["ranks"]
    path = four["tmp"] / "jax_dense"
    for i, (form, (_, params, batches)) in enumerate((("sparse", sparse), ("dense", dense))):
        losses, want, _ = _jax_train(2, form, params, batches)
        got = [r[i] for r in ranks]
        assert all(abs(r["loss"][0] - losses[0]) <= FP32 * 2 * abs(losses[0]) for r in got)
        _hold([r["first"] for r in got], want, FP32, 2)
        ppp = R.SHARD_BS // 2
        width = 2 * (ppp + 2 * (R.N_NEGATIVE if form == "sparse" else 1)) * R.DIM * 4
        assert got[0]["census"]["all-to-all"] == [width] * (2 * R.BPS)
    new = jax_sh.Sharding.create(R.N_ENTITY, 2, seed=0)
    jp, js, _, _ = jax_ckpt.load_checkpoint_sharded(path, new_sharding=new)
    for rank, r in enumerate(ranks):
        got = r[2]
        assert got["n_shard"] == 2
        np.testing.assert_array_equal(got["params"]["entity_embedding"],
                                      np.split(np.asarray(jp["entity_embedding"]), 2)[rank])
        np.testing.assert_array_equal(got["state"]["nu"]["entity_embedding"],
                                      np.split(np.asarray(js[0][2]["entity_embedding"]), 2)[rank])


def test_score_moving_step_matches_jax_at_2(four):
    """``tests/test_fuzz_configs.py``'s ScoreMoving RotatE "t" configuration
    trained over 2 ranks, sparse and dense, against the JAX package's mesh
    step (as ``test_score_moving_steps_match_jax_at_4``)."""
    two = four["two"]
    _hold_smt(2, "t", *two["rest"]["smt"]["t"], [r[4] for r in two["ranks"]])


def test_trainer_resumes_from_a_checkpoint_at_2(four):
    """At 2 ranks an interleaved block of the rank (2 x n_entity / 2 rows)
    is as high as the plain global table: a ``Trainer`` takes the params
    that ``load_checkpoint(mesh=, interleave_entity=True)`` gives as the
    rank's own, and holds the table it saved bit for bit."""
    for r in four["two"]["ranks"]:
        got = r[3]
        assert got["saved"].shape[0] == R.N_ENTITY
        np.testing.assert_array_equal(got["loaded"], got["saved"])
        np.testing.assert_array_equal(got["resumed"], got["saved"])


def test_a_module_is_bound_to_one_mesh():
    """A step built over a second mesh would move the collectives of the
    steps built before to its group: binding a module to another mesh
    raises, and to its own again does not."""
    from besskge_tpu_torch.parallel.mesh import ShardMesh

    _, module, _, _ = R.setup(R.PORT, 2, "sparse")
    opt, ent = R.optimizers("sparse")
    first, second = (ShardMesh(None, 0, 2, torch.device("cpu"), "gloo") for _ in range(2))
    R.port_trainer.build_train_step(module, opt, first, ent, device="cpu")
    R.port_trainer.build_train_step(module, opt, first, ent, device="cpu")
    with pytest.raises(ValueError, match="another mesh"):
        R.port_trainer.build_train_step(module, opt, second, ent, device="cpu")


def test_a_score_function_is_bound_to_one_mesh():
    """ConvE's SyncBN runs over the score function's mesh: a second module
    on the same score function over another mesh raises, where it would
    move the first module's pmean to the other group; over the same mesh
    it does not."""
    from besskge_tpu_torch.parallel.mesh import ShardMesh

    _, module, _ = R.conve_setup(R.PORT, 2, True)
    first, second = (ShardMesh(None, 0, 2, torch.device("cpu"), "gloo") for _ in range(2))
    twin, other = (R.port_bess.EmbeddingMovingBessKGE(
        module.negative_sampler, module.score_fn, module.loss_fn, axis_name="shard")
        for _ in range(2))
    opt, ent = R.conve_optimizers("dense")
    R.port_trainer.build_train_step(module, opt, first, ent, device="cpu")
    R.port_trainer.build_train_step(twin, opt, first, ent, device="cpu")
    with pytest.raises(ValueError, match="score function is bound to another mesh"):
        R.port_trainer.build_train_step(other, opt, second, ent, device="cpu")


# --------------------------------------------------------------------------
# Entry points


def test_every_former_a15b_site_runs_over_a_mesh(monkeypatch):
    """The rest of the mesh is ported: the package has no ``_a15b``, and
    none of the seven sites that raised over a mesh does: the
    ScoreMoving constructor, ``build_bess_forward`` and
    ``make_block_runner`` with it, ``AllScoresBESS``,
    ``build_allscores_forward``, ``AllScoresPipeline`` and ConvE's
    ``_batch_stats`` with SyncBN (which reaches ``collectives.pmean``)."""
    import besskge_tpu_torch
    from besskge_tpu_torch.parallel import collectives
    from besskge_tpu_torch.parallel.mesh import ShardMesh

    for info in pkgutil.walk_packages(besskge_tpu_torch.__path__, "besskge_tpu_torch."):
        assert not hasattr(importlib.import_module(info.name), "_a15b"), info.name
    mesh = ShardMesh(None, 1, 4, torch.device("cpu"), "gloo")
    _, module, _ = R.sm_setup(R.PORT, 4, ("tb", "t", False))
    R.port_bess.build_bess_forward(module, mesh, device="cpu")
    _, module, _ = R.eval_setup(R.PORT, 4)
    R.port_eval.make_block_runner(module, mesh, device="cpu")
    _, pipe, _, _ = R.pipe_setup(R.PORT, 4, "filters", mesh, device="cpu")
    assert pipe.bess_module.axis_name == "shard" and pipe.bess_module.mesh is mesh
    R.port_bess.build_allscores_forward(R.port_bess.AllScoresBESS(
        pipe.candidate_sampler, pipe.score_fn, 29, axis_name="shard"), mesh, device="cpu")
    score_fn, module, _ = R.conve_setup(R.PORT, 4, True)
    R.port_trainer.build_train_step(module, R.port_optim.SGD(0.1), mesh, device="cpu")
    assert score_fn.mesh is mesh and score_fn.mesh_axis == "shard"
    calls = []
    monkeypatch.setattr(collectives, "pmean", lambda x, m: calls.append(m) or x)
    x = torch.randn(8, 3, 5, 5)
    mean, var = score_fn._batch_stats(x, (0, 2, 3), True)
    assert calls == [mesh]
    torch.testing.assert_close(mean, x.mean((0, 2, 3)))
    torch.testing.assert_close(var, x.var((0, 2, 3), correction=0), rtol=1e-5, atol=1e-6)


def test_mesh_entry_points_default_to_the_card(monkeypatch):
    """A mesh runs on cuda with NCCL unless the caller names another device
    or backend: gloo on the CPU, gloo on a card; NCCL on the CPU and unknown
    backends raise, and so does the default without a card."""
    from besskge_tpu_torch.parallel import mesh as port_mesh
    from besskge_tpu_torch.parallel import multihost

    assert port_mesh._default_backend(torch.device("cuda")) == "nccl"
    assert port_mesh._default_backend(torch.device("cpu")) == "gloo"
    for backend, device in (("gloo", "cpu"), ("gloo", "cuda"), ("nccl", "cuda")):
        port_mesh._check_backend(backend, torch.device(device))
    for backend, device in (("nccl", "cpu"), ("mpi", "cuda"), ("ucc", "cpu")):
        with pytest.raises(ValueError, match="cannot run on"):
            port_mesh._check_backend(backend, torch.device(device))
    with pytest.raises(RuntimeError, match="initialised process group"):
        port_mesh.make_shard_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_mesh._rank_device(None, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.initialize("localhost:29500", 1, 0)
    with pytest.raises(ValueError, match="cannot run on cpu"):
        multihost.initialize("localhost:29500", 1, 0, backend="nccl", device="cpu")


def test_spawn_stops_ranks_at_its_timeout():
    """A rank that does not finish in time fails the call, and every rank
    is stopped: a hung rendezvous fails one test, not the run."""
    with pytest.raises(RuntimeError, match="timed out"):
        _spawn(R.run, 2, ([("planted", (2,))],), timeout=1.0)
