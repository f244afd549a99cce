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
multihost views; the collective census of each.

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
  10th and 11th scores of a full-table reference stand apart.
"""

import functools
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
from besskge_tpu import optim as jax_optim
from besskge_tpu import scoring as jax_scoring
from besskge_tpu import sharding as jax_sh
from besskge_tpu import trainer as jax_trainer
from besskge_tpu.ops import distance as jax_distance
from besskge_tpu.ops import pallas_distance as jax_pd
from besskge_tpu.parallel import make_shard_mesh, shard_batch, shard_params
from besskge_tpu.parallel.hlo_check import collective_census
from besskge_tpu_torch import convert
from besskge_tpu_torch.parallel.multihost import _spawn

JAX = {"ds": jax_ds, "sh": jax_sh, "ns": jax_ns, "bs": jax_bs, "dev": jax_dev, "sc": jax_scoring,
       "bess": jax_bess, "loss": jax_loss, "metric": jax_metric}
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
    return R.flat_state(convert.params_from_jax({k: np.asarray(v) for k, v in params.items()}, "cpu"),
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
    jobs2 = [("train", (2, "sparse", False, two["sparse"][1], two["sparse"][2])),
             ("train", (2, "dense", False, two["dense"][1], two["dense"][2])),
             ("load", (2, str(tmp / "jax_dense"), 2)),
             ("resume", (2, two["sparse"][1], str(tmp / "resume.npz")))]
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(2) as pool:
        mp.setenv("OMP_NUM_THREADS", "1")
        spawns = [pool.submit(_spawn, R.run, n, (j,), timeout=TIMEOUT)
                  for n, j in ((4, jobs), (2, jobs2))]
        ranks, two["ranks"] = (f.result() for f in spawns)
    results = {}
    for i, (name, args) in enumerate(jobs):
        at = (name, *args[1:3]) if name == "train" else (name, args[1]) if name == "topk" else name
        results[at] = [r[i] for r in ranks]
    return {"res": results, "sparse": sparse, "dense": dense, "fused": fused, "tmp": tmp,
            "key": key, "topk_in": topk_in, "two": two}


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


# --------------------------------------------------------------------------
# Entry points


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
