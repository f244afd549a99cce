"""The rank side of ``tests/test_torch_mesh.py``: the configurations both
packages build, and the bodies that the port's ranks run.

Each body runs in a process of its own, one per rank, started by
``besskge_tpu_torch.parallel.multihost._spawn`` over gloo on the CPU. This
module imports neither ``jax`` nor ``besskge_tpu``, so the ranks start in
about the time torch takes to import. The configuration functions take the
package's modules as an argument, so that the test builds the JAX package's
side with the same code.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from besskge_tpu_torch import batch_sampler as port_bs
from besskge_tpu_torch import bess as port_bess
from besskge_tpu_torch import checkpoint as port_ckpt
from besskge_tpu_torch import convert
from besskge_tpu_torch import dataset as port_ds
from besskge_tpu_torch import device_sampler as port_dev
from besskge_tpu_torch import eval_loop as port_eval
from besskge_tpu_torch import loss as port_loss
from besskge_tpu_torch import metric as port_metric
from besskge_tpu_torch import negative_sampler as port_ns
from besskge_tpu_torch import optim as port_optim
from besskge_tpu_torch import pipeline as port_pipeline
from besskge_tpu_torch import scoring as port_scoring
from besskge_tpu_torch import sharding as port_sh
from besskge_tpu_torch import trainer as port_trainer
from besskge_tpu_torch.parallel import collectives, make_shard_mesh, shard_params
from besskge_tpu_torch.parallel.census import assert_no_entity_allreduce, collective_census

N_ENTITY, N_RELATION, DIM, SHARD_BS, BPS, N_NEGATIVE = 800, 11, 32, 32, 2, 32
LR_SPARSE, LR_DENSE = 0.1, 0.01
N_QUERY, K, TOPK_WINDOW = 256, 10, 64

PORT = {"ds": port_ds, "sh": port_sh, "ns": port_ns, "bs": port_bs, "dev": port_dev,
        "sc": port_scoring, "bess": port_bess, "loss": port_loss, "metric": port_metric,
        "pipeline": port_pipeline}


def triples(n_triple: int = 6000, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(N_ENTITY, size=n_triple), rng.integers(N_RELATION, size=n_triple),
                     rng.integers(N_ENTITY, size=n_triple)], 1).astype(np.int32)


def setup(mods: Dict[str, Any], n_shard: int, form: str, compute_dtype: Any = None) -> tuple:
    """(score_fn, module, host sampler, device sampler) of a form on
    ``n_shard`` shards: "sparse" is the wikikg2 recipe cut in size
    (TransE-L1, 32 shared "ht" negatives with augmentation, SSCE); "dense"
    and "fused" the biokg one (RotatE p = 2, one shared "ht" negative,
    adversarial LogSigmoidLoss). The module runs over the ``"shard"`` axis."""
    tri = triples()
    ds = mods["ds"].KGDataset(n_entity=N_ENTITY, n_relation_type=N_RELATION,
                              triples={"train": tri}, original_triple_ids={"train": np.arange(len(tri))})
    sharding = mods["sh"].Sharding.create(N_ENTITY, n_shard, seed=0)
    pts = mods["sh"].PartitionedTripleSet.create_from_dataset(ds, "train", sharding)
    sparse = form == "sparse"
    ns = mods["ns"].RandomShardedNegativeSampler(N_NEGATIVE if sparse else 1, sharding, 0, "ht",
                                                 local_sampling=False, flat_negative_format=True)
    if sparse:
        score_fn = mods["sc"].TransE(negative_sample_sharing=True, scoring_norm=1,
                                     sharding=sharding, n_relation_type=N_RELATION,
                                     embedding_size=DIM, seed=0)
        score_fn.compute_dtype = compute_dtype
        loss_fn = mods["loss"].SampledSoftmaxCrossEntropyLoss(N_ENTITY)
    else:
        score_fn = mods["sc"].RotatE(negative_sample_sharing=True, scoring_norm=2,
                                     sharding=sharding, n_relation_type=N_RELATION,
                                     embedding_size=DIM // 2, seed=0)
        loss_fn = mods["loss"].LogSigmoidLoss(margin=12.0, negative_adversarial_sampling=True)
    module = mods["bess"].EmbeddingMovingBessKGE(negative_sampler=ns, score_fn=score_fn,
                                                 loss_fn=loss_fn, augment_negative=sparse,
                                                 axis_name="shard")
    sampler = mods["bs"].RandomShardedBatchSampler(pts, ns, shard_bs=SHARD_BS,
                                                   batches_per_step=BPS, seed=0)
    dev = mods["dev"].DeviceBatchSampler(pts, ns, shard_bs=SHARD_BS, batches_per_step=BPS, seed=0)
    return score_fn, module, sampler, dev


def topk_setup(mods: Dict[str, Any], n_shard: int, candidates: bool) -> tuple:
    """(score_fn, top-k module, sampler, candidate IDs) of TransE-L1 top-k
    over ``n_shard`` shards: tail queries against every entity (windows of
    :data:`TOPK_WINDOW` rows), or against one set of 300 candidates shared
    by all queries."""
    sharding = mods["sh"].Sharding.create(N_ENTITY, n_shard, seed=3)
    rng = np.random.default_rng(17)
    queries = np.stack([rng.integers(N_ENTITY, size=N_QUERY),
                        rng.integers(N_RELATION, size=N_QUERY)], 1).astype(np.int32)
    truth = rng.integers(N_ENTITY, size=N_QUERY).astype(np.int32)
    dataset = mods["ds"].KGDataset(n_entity=N_ENTITY, n_relation_type=N_RELATION,
                                   triples={"test": np.zeros((1, 3), np.int32)},
                                   original_triple_ids={"test": np.arange(1)})
    cands = None
    extra = {}
    if candidates:
        cands = rng.permutation(N_ENTITY)[None, :300].astype(np.int32)
        extra["negative"] = cands
    pts = mods["sh"].PartitionedTripleSet.create_from_queries(
        dataset, sharding, queries, "hr", ground_truth=truth, **extra)
    if candidates:
        ns = mods["ns"].TripleBasedShardedNegativeSampler(None, pts.neg_tails, sharding, "t",
                                                          seed=0, mask_on_gather=True)
    else:
        ns = mods["ns"].PlaceholderNegativeSampler(corruption_scheme="t", seed=0)
    sampler = mods["bs"].RigidShardedBatchSampler(pts, ns, shard_bs=32, batches_per_step=2,
                                                  seed=0)
    score_fn = mods["sc"].TransE(negative_sample_sharing=True, scoring_norm=1, sharding=sharding,
                                 n_relation_type=N_RELATION, embedding_size=DIM, seed=5)
    topk = mods["bess"].TopKQueryBessKGE(K, ns, score_fn, return_scores=True,
                                         window_size=None if candidates else TOPK_WINDOW,
                                         axis_name="shard")
    return score_fn, topk, sampler, cands


def optimizers(form: str) -> tuple:
    """The port's (optimizer, entity optimizer) of a form."""
    if form == "sparse":
        return (port_optim.SGD(LR_SPARSE, momentum=0.9),
                port_optim.RowSGDM(LR_SPARSE, momentum=0.9, interleaved=True))
    if form == "fused":
        return port_optim.AdamW(LR_DENSE), port_optim.FusedDenseAdamW(LR_DENSE, weight_decay=1e-4)
    return port_optim.AdamW(LR_DENSE), None


def flat_state(params: Dict[str, Any], state: Any) -> Dict[str, np.ndarray]:
    """Every param and optimizer-state array of the port, by a dotted name
    (a nested param, ConvE's ``bn0.mean``, by its path)."""
    out: Dict[str, np.ndarray] = {}

    def walk(tree: Any, prefix: str) -> None:
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}.")
            else:
                out[f"{prefix}{key}"] = np.array(val)

    walk(convert.params_to_numpy(params), "param.")
    walk(convert.opt_state_to_numpy(state), "state.")
    return out


def _mesh(n: int):
    return make_shard_mesh(n, devices=["cpu"] * n, backend="gloo")


def _state(module: Any, form: str, params: Dict[str, np.ndarray], mesh: Any) -> tuple:
    opt, ent = optimizers(form)
    local = shard_params(params, mesh)
    if form == "sparse":
        local["entity_embedding"] = ent.widen_table(local["entity_embedding"])
    state = port_trainer.init_optimizer_state(opt, local, mesh, ent,
                                              n_logical=module.sharding.n_shard
                                              * module.sharding.max_entity_per_shard)
    return opt, ent, local, state


def train(n: int, form: str, bf16: bool, params: Dict[str, np.ndarray],
          batches: List[Dict[str, np.ndarray]], save_to: str = "") -> Dict[str, Any]:
    """One host-fed step from ``params`` per batch through
    ``build_train_step`` over an ``n``-rank mesh: the loss of each step, the
    rank's arrays after the first step and after the last, the census of the
    first step; with ``save_to``, the last state saved there (sharded)."""
    mesh = _mesh(n)
    score_fn, module, _, _ = setup(PORT, n, form, torch.bfloat16 if bf16 else None)
    opt, ent, local, state = _state(module, form, params, mesh)
    step = port_trainer.build_train_step(module, opt, mesh, ent, device="cpu")
    out: Dict[str, Any] = {"loss": []}
    for i, batch in enumerate(batches):
        if i == 0:
            holder = {}

            def first(p, s, b):
                holder["res"] = step(p, s, b)
            out["census"] = assert_no_entity_allreduce(
                first, (n * module.sharding.max_entity_per_shard, DIM), local, state, batch,
                mesh=mesh)
            local, state, outs = holder["res"]
            out["first"] = flat_state(local, state)
        else:
            local, state, outs = step(local, state, batch)
        out["loss"].append(float(outs["loss"]))
    out["last"] = flat_state(local, state)
    if save_to:
        port_ckpt.save_checkpoint_sharded(save_to, local, state, module.sharding, step=len(batches),
                                          mesh=mesh)
    return out


def forward(n: int, params: Dict[str, np.ndarray], batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """``build_bess_forward`` of the sparse form over the mesh, with its
    scores: the loss (summed over the mesh) and the rank's scores, and the
    census of the call."""
    mesh = _mesh(n)
    _, module, _, _ = setup(PORT, n, "sparse")
    module.return_scores = True
    fwd = port_bess.build_bess_forward(module, mesh, device="cpu")
    local = shard_params(params, mesh)
    census = collective_census(fwd, local, batch, mesh=mesh)
    out = fwd(local, batch)
    return {"census": census, **{k: v.numpy() for k, v in out.items()}}


def device_step(n: int, form: str, params: Dict[str, np.ndarray], draws: List[np.ndarray],
                key: int) -> Dict[str, Any]:
    """The rank's column of the device sampler's batch, and one
    device-sampled call (``steps_per_call`` 1) from ``params`` with the
    host-fed step over the same global batch from the same state, all from
    the uniforms ``draws`` in the order the port draws them."""
    mesh = _mesh(n)
    score_fn, module, _, dev = setup(PORT, n, form)
    queue = [np.array(d) for d in draws]

    def uniform(k, stream, shape):
        u = torch.from_numpy(queue.pop(0))
        assert tuple(u.shape) == tuple(shape), (u.shape, shape)
        return u

    drawn, port_dev._uniform = port_dev._uniform, uniform
    try:
        dev_state = dev.state("cpu")
        whole = dev.sample(dev_state, torch.tensor(key))
        opt, ent, local, state = _state(module, form, params, mesh)
        host = port_trainer.build_train_step(module, opt, mesh, ent, donate=False, device="cpu")
        want = host(local, state, {k: v.numpy() for k, v in whole.items()})
        fn = port_trainer.build_device_train_step(module, opt, dev, mesh, ent, device="cpu")
        local, state, outs = fn(local, state, dev_state, torch.tensor(key))
    finally:
        port_dev._uniform = drawn
    return {"batch": {k: v.numpy() for k, v in dev.slice_local(whole, mesh.rank).items()},
            "loss": float(outs["loss"]), "host_loss": float(want[2]["loss"]),
            "state": flat_state(local, state), "host_state": flat_state(*want[:2]),
            "uncaptured": fn.uncaptured}


def fit(n: int, n_steps: int, params: Dict[str, np.ndarray], save_to: str) -> Dict[str, Any]:
    """The sparse form's ``Trainer`` over the first ``n_steps`` host-fed
    steps of an epoch from ``params``, saved to ``save_to`` with
    ``Trainer.save`` (one ``.npz``): the losses, the replicated params and
    the rank's (interleaved) table and state at the end."""
    mesh = _mesh(n)
    score_fn, module, sampler, _ = setup(PORT, n, "sparse")
    opt, ent = optimizers("sparse")
    trainer = port_trainer.Trainer(module, sampler, opt, mesh, params=shard_params(params, mesh),
                                   entity_optimizer=ent)
    losses = []
    for i, out in enumerate(trainer._step_stream(0, True)):
        losses.append(float(out["loss"]))
        if i + 1 == n_steps:
            break
    trainer.save(save_to, step=n_steps)
    final = flat_state(trainer.params, trainer.opt_state)
    # initial_params_device over the mesh: the rank's block of the
    # one-process draw, as shard_params cuts it.
    drawn = [score_fn.initial_params_device(mesh if own else None, "cpu",
                                            torch.Generator().manual_seed(7)) for own in (1, 0)]
    drawn[1] = shard_params(drawn[1], mesh)
    tables = [port_trainer.Trainer(module, sampler, opt, mesh, params=p,
                                   entity_optimizer=ent).params for p in drawn]
    return {"losses": losses, "replicated": convert.params_to_numpy(
        {k: v for k, v in trainer.params.items() if k != "entity_embedding"}),
        "own_block_equal": all(torch.equal(tables[0][k], tables[1][k]) for k in tables[0]),
        "own_block_rows": drawn[0]["entity_embedding"].shape[0], "final": final}


def resume(n: int, params: Dict[str, np.ndarray], path: str) -> Dict[str, np.ndarray]:
    """A resume over an ``n``-rank mesh: the sparse form's ``Trainer`` takes
    one step from ``params`` and saves one ``.npz``; a new ``Trainer`` takes
    the rank's params as ``load_checkpoint(mesh=, interleave_entity=True)``
    gives them. The rank's (interleaved) table saved, loaded and resumed."""
    mesh = _mesh(n)
    _, module, sampler, _ = setup(PORT, n, "sparse")
    opt, ent = optimizers("sparse")
    trainer = port_trainer.Trainer(module, sampler, opt, mesh, params=shard_params(params, mesh),
                                   entity_optimizer=ent)
    next(trainer._step_stream(0, True))
    trainer.save(path, step=1)
    loaded, _, _, _ = port_ckpt.load_checkpoint(path, interleave_entity=True, mesh=mesh)
    resumed = port_trainer.Trainer(module, sampler, opt, mesh, params=loaded,
                                   entity_optimizer=ent)
    return {name: p["entity_embedding"].numpy().copy()
            for name, p in (("saved", trainer.params), ("loaded", loaded),
                            ("resumed", resumed.params))}


def load_npz(n: int, path: str) -> Dict[str, np.ndarray]:
    """The rank's arrays of a ``.npz`` checkpoint of an interleaved run,
    loaded onto an ``n``-rank mesh and interleaved again."""
    mesh = _mesh(n)
    params, state, _, _ = port_ckpt.load_checkpoint(path, interleave_entity=True, mesh=mesh)
    return flat_state(params, state)


def topk(n: int, candidates: bool, params: Dict[str, np.ndarray],
         batches: List[Dict[str, np.ndarray]]) -> Dict[str, Any]:
    """The top-k outputs of the rank's queries of each batch, and the census
    of the first batch."""
    mesh = _mesh(n)
    _, module, _, _ = topk_setup(PORT, n, candidates)
    fwd = port_bess.build_topk_forward(module, mesh, device="cpu")
    local = shard_params(params, mesh)
    census = collective_census(fwd, local, batches[0], mesh=mesh)
    outs = [{k: v.numpy() for k, v in fwd(local, b).items()} for b in batches]
    return {"outs": outs, "census": census}


def load(n: int, path: str, new_n: int = 0) -> Dict[str, Any]:
    """The rank's arrays of a sharded checkpoint loaded onto an ``n``-rank
    mesh, re-sharded onto the ``new_n``-shard sharding when given."""
    mesh = _mesh(n)
    new = port_sh.Sharding.create(N_ENTITY, new_n, seed=0) if new_n else None
    params, state, sharding, meta = port_ckpt.load_checkpoint_sharded(path, mesh, new)
    return {"params": convert.params_to_numpy(params), "state": convert.opt_state_to_numpy(state),
            "n_shard": sharding.n_shard, "step": meta["step"]}


def multihost_views(n: int, batch: Dict[str, np.ndarray],
                    params: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """``parallel.multihost``'s views of the rank: its shard range, its
    column of a global batch (given as its own) and its params."""
    from besskge_tpu_torch.parallel import multihost

    mesh = multihost.make_global_mesh(devices=["cpu"] * n)
    lo, hi = multihost.local_shard_range(mesh)
    local = multihost.shard_batch_multihost({k: v[:, lo:hi] for k, v in batch.items()}, mesh)
    mine = multihost.shard_params_multihost(params, mesh)
    try:
        multihost.shard_batch_multihost(batch, mesh)
        whole_batch_raised = False
    except ValueError:
        whole_batch_raised = True
    return {"range": (lo, hi), "n_shard": mesh.n_shard,
            "batch": {k: v.numpy() for k, v in local.items()},
            "params": {k: v.numpy() for k, v in mine.items()},
            "whole_batch_raised": whole_batch_raised}


def planted(n: int) -> bool:
    """Whether the census catches an all-reduce of a table block."""
    mesh = _mesh(n)
    block = torch.zeros(8, DIM)
    try:
        assert_no_entity_allreduce(lambda: collectives.psum(block, mesh), (8 * n, DIM), mesh=mesh)
    except AssertionError:
        return True
    return False


# ---------------------------------------------------------------------------
# ScoreMoving, evaluation, all-scores and SyncBN over the mesh: the
# configurations of the JAX package's goldens, cut in size where named.


def _dataset(mods: Dict[str, Any], n_entity: int, n_relation: int, tri: np.ndarray,
             part: str = "train", neg: Any = None) -> Any:
    return mods["ds"].KGDataset(
        n_entity=n_entity, n_relation_type=n_relation, triples={part: tri},
        original_triple_ids={part: np.arange(len(tri))},
        neg_heads=None if neg is None else {part: neg[0]},
        neg_tails=None if neg is None else {part: neg[1]})


def _random_triples(rng: np.random.Generator, n_entity: int, n_relation: int,
                    n: int) -> np.ndarray:
    return np.stack([rng.integers(n_entity, size=n), rng.integers(n_relation, size=n),
                     rng.integers(n_entity, size=n)], 1).astype(np.int32)


#: ``tests/test_bess.py``'s ScoreMoving cases: (sampler, scheme, flat).
#: "tb" is its per-triple or shared candidate sets (TripleBased, 64 a
#: triple, 40 queries a shard per micro-batch, the first batch of a pass),
#: "random" its random flat negatives (``:265``, scheme "t") and
#: ``tests/test_checkpoint_hlo.py:202``'s census case (4 negatives, "ht").
SM_CASES = [("tb", s, f) for s in ("h", "t", "ht") for f in (True, False)] + [
    ("random", "t", True), ("random", "ht", True)]
SM_ENTITY, SM_RELATION, SM_DIM, SM_TRIPLE, SM_CANDIDATES = 500, 10, 64, 1000, 64


def sm_setup(mods: Dict[str, Any], n: int, case: tuple) -> tuple:
    """(score_fn, ScoreMoving module with scores and, for "tb", sum metrics
    and ranks, Rigid sampler) of a case on ``n`` shards."""
    kind, scheme, flat = case
    rng = np.random.default_rng(1234)
    tri = _random_triples(rng, SM_ENTITY, SM_RELATION, SM_TRIPLE)
    outer = 1 if flat else SM_TRIPLE
    neg = None
    if kind == "tb":
        neg = tuple(rng.integers(SM_ENTITY, size=(outer, SM_CANDIDATES), dtype=np.int32)
                    for _ in range(2))
    sharding = mods["sh"].Sharding.create(SM_ENTITY, n, seed=1234)
    pts = mods["sh"].PartitionedTripleSet.create_from_dataset(
        _dataset(mods, SM_ENTITY, SM_RELATION, tri, "test", neg), "test", sharding,
        partition_mode="ht_shardpair")
    score_fn = mods["sc"].TransE(negative_sample_sharing=flat, scoring_norm=1, sharding=sharding,
                                 n_relation_type=SM_RELATION, embedding_size=SM_DIM, seed=3)
    if kind == "tb":
        ns = mods["ns"].TripleBasedShardedNegativeSampler(
            pts.neg_heads, pts.neg_tails, sharding, corruption_scheme=scheme, seed=1234,
            return_sort_idx=True, mask_on_gather=False)
        evaluation = mods["metric"].Evaluation(["mrr", "hits@1"], reduction="sum",
                                               return_ranks=True)
        shard_bs, bps = 40, 2
    else:
        ns = mods["ns"].RandomShardedNegativeSampler(6 if scheme == "t" else 4, sharding, 1234,
                                                     scheme, local_sampling=False,
                                                     flat_negative_format=True)
        evaluation, shard_bs, bps = None, 16, 1
    sampler = mods["bs"].RigidShardedBatchSampler(pts, ns, shard_bs=shard_bs, batches_per_step=bps,
                                                  seed=1234, duplicate_batch=scheme == "ht",
                                                  return_triple_idx=True)
    module = mods["bess"].ScoreMovingBessKGE(negative_sampler=ns, score_fn=score_fn,
                                             evaluation=evaluation, return_scores=True,
                                             axis_name="shard")
    return score_fn, module, sampler


def sm_forward(n: int, case: tuple, params: Dict[str, np.ndarray],
               batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """``build_bess_forward`` of a ScoreMoving case over the mesh: the
    rank's outputs and the census of the call."""
    mesh = _mesh(n)
    _, module, _ = sm_setup(PORT, n, case)
    fwd = port_bess.build_bess_forward(module, mesh, device="cpu")
    local = shard_params(params, mesh)
    census = collective_census(fwd, local, batch, mesh=mesh)
    return {"census": census, **{k: v.numpy() for k, v in fwd(local, batch).items()}}


#: ScoreMoving training (``tests/test_optim.py:200``'s setup: DistMult,
#: d 16, 8 shared negatives, LogSigmoidLoss, bps 4 x 16; plain SGD 0.5 on
#: the replicated params, RowSGDM without momentum or SGD on the table);
#: "ht" takes the same with TransE-L2, and the 2-rank case
#: ``tests/test_fuzz_configs.py``'s RotatE "t" (5 negatives, bps 1).
SMT_ENTITY, SMT_RELATION = 90, 4


def smt_setup(mods: Dict[str, Any], n: int, scheme: str) -> tuple:
    rng = np.random.default_rng(5)
    tri = _random_triples(rng, SMT_ENTITY, SMT_RELATION, 1500)
    sharding = mods["sh"].Sharding.create(SMT_ENTITY, n, seed=5)
    pts = mods["sh"].PartitionedTripleSet.create_from_dataset(
        _dataset(mods, SMT_ENTITY, SMT_RELATION, tri), "train", sharding)
    kw = dict(negative_sample_sharing=True, sharding=sharding, n_relation_type=SMT_RELATION,
              seed=2)
    if n == 2:
        score_fn = mods["sc"].RotatE(scoring_norm=1, embedding_size=8, **kw)
        n_neg, shard_bs, bps = 5, 2 * n, 1
    elif scheme == "t":
        score_fn = mods["sc"].DistMult(embedding_size=16, **kw)
        n_neg, shard_bs, bps = 8, 16, 4
    else:
        score_fn = mods["sc"].TransE(scoring_norm=2, embedding_size=16, **kw)
        n_neg, shard_bs, bps = 8, 16, 4
    ns = mods["ns"].RandomShardedNegativeSampler(n_neg, sharding, 5, scheme, local_sampling=False,
                                                 flat_negative_format=True)
    sampler = mods["bs"].RandomShardedBatchSampler(pts, ns, shard_bs=shard_bs,
                                                   batches_per_step=bps, seed=5)
    loss_fn = mods["loss"].LogSigmoidLoss(margin=2.0, negative_adversarial_sampling=False)
    module = mods["bess"].ScoreMovingBessKGE(negative_sampler=ns, score_fn=score_fn,
                                             loss_fn=loss_fn, axis_name="shard")
    dev = mods["dev"].DeviceBatchSampler(pts, ns, shard_bs=shard_bs, batches_per_step=bps, seed=5)
    return score_fn, module, sampler, dev


def sm_train(n: int, scheme: str, params: Dict[str, np.ndarray],
             batch: Dict[str, np.ndarray], key: int) -> Dict[str, Any]:
    """Two ScoreMoving steps on ``batch`` from ``params`` in the sparse form
    and in the dense form; the census of the first sparse step; one
    device-sampled call from ``params`` against the host-fed step on the
    batch that the device sampler drew."""
    mesh = _mesh(n)
    _, module, _, dev = smt_setup(PORT, n, scheme)
    out: Dict[str, Any] = {}
    for form, ent in (("sparse", port_optim.RowSGDM(0.5, momentum=0.0)), ("dense", None)):
        opt = port_optim.SGD(0.5)
        local = shard_params(params, mesh)
        state = port_trainer.init_optimizer_state(opt, local, mesh, ent)
        step = port_trainer.build_train_step(module, opt, mesh, ent, device="cpu")
        losses = []
        for i in range(2):
            if i == 0 and form == "sparse":
                holder = {}

                def first(p, s, b):
                    holder["res"] = step(p, s, b)
                out["census"] = collective_census(first, local, state, batch, mesh=mesh)
                local, state, o = holder["res"]
            else:
                local, state, o = step(local, state, batch)
            losses.append(float(o["loss"]))
        out[form] = {"loss": losses, "state": flat_state(local, state)}
    # The device-sampled call takes ScoreMoving as the host-fed step does.
    opt, ent = port_optim.SGD(0.5), port_optim.RowSGDM(0.5, momentum=0.0)
    dev_state = dev.state("cpu")
    whole = {k: v.numpy() for k, v in dev.sample(dev_state, torch.tensor(key)).items()}
    local = shard_params(params, mesh)
    state = port_trainer.init_optimizer_state(opt, local, mesh, ent)
    host = port_trainer.build_train_step(module, opt, mesh, ent, donate=False, device="cpu")
    want = host(local, state, whole)
    fn = port_trainer.build_device_train_step(module, opt, dev, mesh, ent, device="cpu")
    local, state, o = fn(local, state, dev_state, torch.tensor(key))
    out["device"] = {"loss": float(o["loss"]), "host_loss": float(want[2]["loss"]),
                     "state": flat_state(local, state), "host_state": flat_state(*want[:2])}
    return out


#: ``tests/test_eval_loop.py``'s setup: TransE-L1 per-triple "ht" candidate
#: sets (40 a triple), 700 triples, bps 2 x 24, sum metrics.
EV_ENTITY, EV_RELATION, EV_TRIPLE = 360, 7, 700


def eval_setup(mods: Dict[str, Any], n: int) -> tuple:
    rng = np.random.default_rng(77)
    sharding = mods["sh"].Sharding.create(EV_ENTITY, n, seed=77)
    tri = _random_triples(rng, EV_ENTITY, EV_RELATION, EV_TRIPLE)
    neg = tuple(rng.integers(EV_ENTITY, size=(EV_TRIPLE, 40)).astype(np.int32) for _ in range(2))
    pts = mods["sh"].PartitionedTripleSet.create_from_dataset(
        _dataset(mods, EV_ENTITY, EV_RELATION, tri, "valid", neg), "valid", sharding)
    ns = mods["ns"].TripleBasedShardedNegativeSampler(pts.neg_heads, pts.neg_tails, sharding,
                                                      corruption_scheme="ht", seed=77)
    sampler = mods["bs"].RigidShardedBatchSampler(pts, ns, shard_bs=24, batches_per_step=2,
                                                  seed=77, duplicate_batch=True)
    score_fn = mods["sc"].TransE(negative_sample_sharing=False, scoring_norm=1, sharding=sharding,
                                 n_relation_type=EV_RELATION, embedding_size=32, seed=77)
    ev = mods["metric"].Evaluation(["mrr", "hits@1", "hits@3"], reduction="sum")
    module = mods["bess"].ScoreMovingBessKGE(negative_sampler=ns, score_fn=score_fn,
                                             evaluation=ev, axis_name="shard")
    return score_fn, module, sampler


def device_eval(n: int, params: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """``run_device_eval`` over the mesh with a ragged last block, the
    per-step forward's metric sums over the same pass, and whether a
    reduction other than "sum" raises."""
    mesh = _mesh(n)
    _, module, sampler = eval_setup(PORT, n)
    local = shard_params(params, mesh)
    fwd = port_bess.build_bess_forward(module, mesh, device="cpu")
    steps = [fwd(local, b)["metrics"].numpy().astype(np.float64).reshape(-1, 3).sum(0)
             for b in sampler.get_dataloader(shuffle=False)]
    spb = 3 if len(steps) % 3 else 4
    metrics, n_q = port_eval.run_device_eval(module, local, sampler, mesh=mesh,
                                             steps_per_block=spb, device="cpu")
    module.evaluation = port_metric.Evaluation(["mrr"], reduction="none")
    try:
        port_eval.run_device_eval(module, local, sampler, mesh=mesh, device="cpu")
        raised = False
    except ValueError as e:
        raised = "sum" in str(e)
    return {"metrics": metrics, "n_queries": n_q, "step_sums": np.sum(steps, 0),
            "n_steps": len(steps), "spb": spb, "sum_raised": raised}


#: ``tests/test_pipeline.py``'s cases: with filters (bps 2, window 29,
#: top-7, per-query metrics), with candidates (bps 1, window 50) and the
#: packed bf16 table (d 128, window 16): DistMult, 210 entities, 400
#: triples, shard_bs 24.
PIPE_ENTITY, PIPE_RELATION, PIPE_TRIPLE = 210, 4, 400


def pipe_setup(mods: Dict[str, Any], n: int, case: str, mesh: Any, **kw: Any) -> tuple:
    rng = np.random.default_rng(42)
    sharding = mods["sh"].Sharding.create(PIPE_ENTITY, n, seed=42)
    tri = _random_triples(rng, PIPE_ENTITY, PIPE_RELATION, PIPE_TRIPLE)
    cands = np.unique(rng.integers(PIPE_ENTITY, size=64)).astype(np.int32)
    pts = mods["sh"].PartitionedTripleSet.create_from_dataset(
        _dataset(mods, PIPE_ENTITY, PIPE_RELATION, tri, "test"), "test", sharding,
        partition_mode="h_shard")
    dim = 128 if case == "packed" else 16
    score_fn = mods["sc"].DistMult(negative_sample_sharing=True, sharding=sharding,
                                   n_relation_type=PIPE_RELATION, embedding_size=dim, seed=4)
    if case == "packed":
        score_fn.dtype = kw.pop("bf16")
        score_fn.packed_entity_storage = True
    ns = mods["ns"].PlaceholderNegativeSampler(corruption_scheme="t", seed=42)
    sampler = mods["bs"].RigidShardedBatchSampler(pts, ns, shard_bs=24,
                                                  batches_per_step=1 if case == "candidates" else 2,
                                                  seed=42, return_triple_idx=True)
    args = {"filters": dict(evaluation=mods["metric"].Evaluation(["mrr", "hits@5"],
                                                                 reduction="none",
                                                                 return_ranks=True),
                            filter_triples=[tri[: PIPE_TRIPLE // 2]], return_scores=True,
                            return_topk=True, k=7, window_size=29),
            "candidates": dict(candidate_ents=cands, return_scores=True, window_size=50),
            "packed": dict(evaluation=mods["metric"].Evaluation(["mrr"], reduction="none"),
                           return_scores=True, window_size=16)}[case]
    pipe = mods["pipeline"].AllScoresPipeline(sampler, "t", score_fn, mesh=mesh, **args, **kw)
    return score_fn, pipe, pts, tri


def pipeline(n: int, case: str, params: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """``AllScoresPipeline(mesh=)`` of a case: the dict the rank returns and
    the census of its pass."""
    mesh = _mesh(n)
    kw = {"bf16": torch.bfloat16} if case == "packed" else {}
    _, pipe, _, _ = pipe_setup(PORT, n, case, mesh, device="cpu", **kw)
    holder = {}

    def run(p):
        holder["out"] = pipe.forward(p)
    census = collective_census(run, shard_params(params, mesh), mesh=mesh)
    return {"out": holder["out"], "census": {k: len(v) for k, v in census.items() if k != "order"}}


def collective_grads(n: int, x: np.ndarray, w: np.ndarray, y: np.ndarray,
                     u: np.ndarray) -> Dict[str, Any]:
    """Gradients through the differentiable collectives on the rank's rows:
    of ``Σ w_r·all_gather(x_r)²`` by ``torch.func.grad`` and by
    ``backward``; of ``Σ u_r·pmean(x_r)³``; and ConvE's ``_batch_stats``
    with ``sync`` (NHWC axes, ``tests/test_conve_weighting.py:242``): the
    moments and the gradient of ``Σ u·mean + Σ u²·var`` by the rank's
    block of ``y``. Each body's census."""
    mesh = _mesh(n)
    r = mesh.rank
    xr, wr, ur = (torch.from_numpy(a[r]) for a in (x, w, u))
    yr = torch.from_numpy(np.split(y, n)[r])

    def gathered(t):
        return (wr * collectives.all_gather(t, mesh) ** 2).sum()

    def meaned(t):
        return (ur * collectives.pmean(t, mesh) ** 3).sum()

    out: Dict[str, Any] = {}
    out["gather_census"] = collective_census(lambda: torch.func.grad(gathered)(xr), mesh=mesh)
    out["gather"] = torch.func.grad(gathered)(xr).numpy()
    leaf = xr.clone().requires_grad_()
    gathered(leaf).backward()
    out["gather_backward"] = leaf.grad.numpy()
    out["pmean_census"] = collective_census(lambda: torch.func.grad(meaned)(xr), mesh=mesh)
    out["pmean"] = torch.func.grad(meaned)(xr).numpy()
    score_fn = port_scoring.ConvE(negative_sample_sharing=True,
                                  sharding=port_sh.Sharding.create(100, n, seed=21),
                                  n_relation_type=4, embedding_size=32, embedding_height=4,
                                  embedding_width=8, sync_batch_norm=True, seed=21)
    score_fn.mesh_axis, score_fn.mesh = "shard", mesh
    mean, var = score_fn._batch_stats(yr, (0, 1, 2), True)
    out["mean"], out["var"] = mean.numpy(), var.numpy()
    ub = torch.from_numpy(u[r, 0, : mean.shape[0]])

    def stats(t):
        m, v = score_fn._batch_stats(t, (0, 1, 2), True)
        return (ub * m).sum() + (ub**2 * v).sum()
    out["stats_grad"] = torch.func.grad(stats)(yr).numpy()
    return out


#: ``tests/test_conve_weighting.py``'s ConvE (100 entities, d 32 as 4 x 8,
#: inverse triples, 8 shared "t" negatives, SSCE, bps 1 x 32), dropout 0.
CV_ENTITY, CV_RELATION = 100, 4


def conve_setup(mods: Dict[str, Any], n: int, sync_bn: bool) -> tuple:
    rng = np.random.default_rng(21)
    h = rng.integers(CV_ENTITY, size=1600)
    r = rng.integers(CV_RELATION, size=1600)
    tri = np.stack([h, r, (h * (r + 2) + 1) % CV_ENTITY], 1).astype(np.int32)
    sharding = mods["sh"].Sharding.create(CV_ENTITY, n, seed=21)
    pts = mods["sh"].PartitionedTripleSet.create_from_dataset(
        _dataset(mods, CV_ENTITY, CV_RELATION, tri), "train", sharding, add_inverse_triples=True)
    score_fn = mods["sc"].ConvE(negative_sample_sharing=True, sharding=sharding,
                                n_relation_type=CV_RELATION, embedding_size=32,
                                embedding_height=4, embedding_width=8, inverse_relations=True,
                                input_dropout=0.0, feature_map_dropout=0.0, hidden_dropout=0.0,
                                sync_batch_norm=sync_bn, seed=21)
    ns = mods["ns"].RandomShardedNegativeSampler(8, sharding, 21, "t", local_sampling=False,
                                                 flat_negative_format=True)
    sampler = mods["bs"].RandomShardedBatchSampler(pts, ns, shard_bs=32, batches_per_step=1,
                                                   seed=21)
    module = mods["bess"].EmbeddingMovingBessKGE(
        negative_sampler=ns, score_fn=score_fn,
        loss_fn=mods["loss"].SampledSoftmaxCrossEntropyLoss(n_entity=CV_ENTITY),
        axis_name="shard")
    return score_fn, module, sampler


def conve_optimizers(form: str) -> tuple:
    if form == "sparse":
        return (port_optim.SGD(0.05, momentum=0.9),
                port_optim.RowSGDM(0.05, momentum=0.9, interleaved=True))
    return port_optim.AdamW(3e-3), port_optim.FusedDenseAdamW(3e-3, weight_decay=1e-4)


def conve_train(n: int, form: str, sync_bn: bool, params: Dict[str, Any],
                batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """One ConvE step over the mesh from ``params`` ("sparse": RowSGDM
    interleaved; "fused": FusedDenseAdamW on the table, AdamW on the
    trunk): the loss and the rank's arrays; for the fused form with SyncBN
    also a ``Trainer`` over two host-fed steps of its dataloader (losses,
    running stats)."""
    mesh = _mesh(n)
    _, module, sampler = conve_setup(PORT, n, sync_bn)
    opt, ent = conve_optimizers(form)
    local = shard_params(params, mesh)
    if form == "sparse":
        local["entity_embedding"] = ent.widen_table(local["entity_embedding"])
    state = port_trainer.init_optimizer_state(opt, local, mesh, ent,
                                              n_logical=module.sharding.n_shard
                                              * module.sharding.max_entity_per_shard)
    step = port_trainer.build_train_step(module, opt, mesh, ent, device="cpu")
    local, state, o = step(local, state, batch)
    out = {"loss": float(o["loss"]), "state": flat_state(local, state)}
    if form == "fused" and sync_bn:
        trainer = port_trainer.Trainer(module, sampler, opt, mesh,
                                       params=shard_params(params, mesh), entity_optimizer=ent)
        losses = [float(x["loss"]) for _, x in zip(range(2), trainer._step_stream(0, True))]
        out["fit"] = {"losses": losses, "bn": {k: {s: trainer.params[k][s].numpy()
                                                   for s in ("mean", "var")}
                                               for k in ("bn0", "bn1", "bn2")}}
    return out


def run(jobs: List[tuple]) -> List[Any]:
    """Run the named bodies of this module in order, each with its
    arguments: one spawn serves a whole scenario."""
    return [globals()[name](*args) for name, args in jobs]
