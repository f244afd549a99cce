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
from besskge_tpu_torch import loss as port_loss
from besskge_tpu_torch import metric as port_metric
from besskge_tpu_torch import negative_sampler as port_ns
from besskge_tpu_torch import optim as port_optim
from besskge_tpu_torch import scoring as port_scoring
from besskge_tpu_torch import sharding as port_sh
from besskge_tpu_torch import trainer as port_trainer
from besskge_tpu_torch.parallel import collectives, make_shard_mesh, shard_params
from besskge_tpu_torch.parallel.census import assert_no_entity_allreduce, collective_census

N_ENTITY, N_RELATION, DIM, SHARD_BS, BPS, N_NEGATIVE = 800, 11, 32, 32, 2, 32
LR_SPARSE, LR_DENSE = 0.1, 0.01
N_QUERY, K, TOPK_WINDOW = 256, 10, 64

PORT = {"ds": port_ds, "sh": port_sh, "ns": port_ns, "bs": port_bs, "dev": port_dev,
        "sc": port_scoring, "bess": port_bess, "loss": port_loss, "metric": port_metric}


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
    """Every param and optimizer-state array of the port, by a dotted name."""
    out = {f"param.{k}": np.array(v) for k, v in convert.params_to_numpy(params).items()}

    def walk(tree: Any, prefix: str) -> None:
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}.")
            else:
                out[f"{prefix}{key}"] = np.array(val)

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

    port_dev._uniform = uniform
    dev_state = dev.state("cpu")
    whole = dev.sample(dev_state, torch.tensor(key))
    opt, ent, local, state = _state(module, form, params, mesh)
    host = port_trainer.build_train_step(module, opt, mesh, ent, donate=False, device="cpu")
    want = host(local, state, {k: v.numpy() for k, v in whole.items()})
    fn = port_trainer.build_device_train_step(module, opt, dev, mesh, ent, device="cpu")
    local, state, outs = fn(local, state, dev_state, torch.tensor(key))
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


def run(jobs: List[tuple]) -> List[Any]:
    """Run the named bodies of this module in order, each with its
    arguments: one spawn serves a whole scenario."""
    return [globals()[name](*args) for name, args in jobs]
