"""Training step and loop for BESS-KGE on one device or over a mesh (torch).

Counterpart of ``besskge_tpu/trainer.py``:

* :func:`build_train_step` builds ``fn(params, opt_state, batch) ->
  (params, opt_state, outputs)``, in one of two forms, as the JAX package's:

  - **sparse** (an :class:`~besskge_tpu_torch.optim.EntityRowOptimizer`):
    the ``bps`` micro-batches of a step are fused with ``torch.func.vmap``
    over ``torch.func.vjp`` with respect to the gathered entity rows and the
    replicated params, as the JAX package fuses them with ``jax.vmap``; the
    p=1 distances then reach the batched L1 kernels (B1 forward, B2
    backward). The entity table takes a sparse, in-place row update, the
    replicated params a dense in-place one (``optimizer``);
  - **dense** (no entity optimizer, or
    :class:`~besskge_tpu_torch.optim.FusedDenseAdamW`): one gradient of the
    loss summed over the ``torch.func.vmap``-fused micro-batches, over the
    whole params dict; ``optimizer`` updates every param, or every param but
    the entity table, which B10 updates.

* :func:`build_device_train_step` builds ``fn(params, opt_state,
  sampler_state, key) -> (params, opt_state, outputs)``: the same steps on
  batches drawn on the device by a
  :class:`~besskge_tpu_torch.device_sampler.DeviceBatchSampler`,
  ``steps_per_call`` of them per call. On a card one call is one CUDA graph
  (the counterpart of the JAX package's ``lax.scan`` in one jitted
  program): captured on the first call, replayed from then on.

* :class:`Trainer` widens the table for an interleaved optimizer (a
  row-pair-packed one into its triplet or quintuplet store), builds the
  optimizer state, runs epochs over a host batch sampler, or over keys of
  a device sampler, and saves checkpoints in the JAX package's formats
  (:mod:`besskge_tpu_torch.checkpoint`).

Over a ``mesh`` (:class:`~besskge_tpu_torch.parallel.mesh.ShardMesh`, a
module with ``axis_name="shard"``) every rank runs the same step on its own
params (its block of the entity table, its optimizer state of that block,
and copies of the replicated params and their state) and its column of each
batch, as the JAX package's ``shard_map`` step runs on each device: the
micro-batches run one after another (the AllToAll of each cannot sit under
``vmap``), the entity rows' gradients come back to their rank through the
collectives' backwards (the AllToAll's, and with
:class:`~besskge_tpu_torch.bess.ScoreMovingBessKGE` the AllGathers'
reduce-scatters) and stay there, and the replicated params' summed
gradients go through one all-reduce with the loss
(:func:`besskge_tpu_torch.bess._reduce_outputs`). A device-sampled call
draws the global batch on every rank from the same key and keeps its own
column. With NCCL a call's collectives are captured in its CUDA graph; a
gloo mesh runs its calls uncaptured (:func:`build_device_train_step`).

A scorer with dropout (ConvE) takes a dropout key per step (``rng``), split
per micro-batch as the JAX package splits its key (over a mesh after folding
in the rank); its masks come from the device sampler's counter hash, so a
replayed graph draws anew from the key in its buffer. A scorer with
BatchNorm has its running stats refreshed in every step form
(:func:`_bn_ema`; over a mesh from the global batch's statistics, pmeaned
over the ranks). The params
may nest (ConvE's trunk); the dense optimizers' states mirror them.

Params and optimizer state are updated in place, as the JAX package donates
them to the step; ``donate=False`` updates copies instead.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, Optional, Tuple, Union

import torch

from besskge_tpu_torch.batch_sampler import ShardedBatchSampler
from besskge_tpu_torch.bess import (
    _FORWARD_KEYS,
    BessKGE,
    _batch_tensors,
    _device_step,
    _reduce_outputs,
    _stack,
    _step_device,
)
from besskge_tpu_torch.checkpoint import save_checkpoint, save_checkpoint_sharded
from besskge_tpu_torch.device_sampler import DeviceBatchSampler, _as_key, _fold_in, split_key
from besskge_tpu_torch.optim import AdamW, SGD, EntityRowOptimizer, FusedDenseAdamW
from besskge_tpu_torch.packed import is_packed, take_rows
from besskge_tpu_torch.parallel.mesh import ShardMesh, replicate_tree, shard_params
from besskge_tpu_torch.scoring import ConvE
from besskge_tpu_torch.utils import _tree_map

__all__ = ["build_train_step", "build_device_train_step", "init_optimizer_state", "Trainer"]

#: Tensors, and nested dicts of tensors (ConvE's trunk).
Params = Dict[str, Any]
Device = Optional[Union[str, torch.device]]
#: A dense optimizer of the port: ``init(params)``, ``update_(grads, state, params)``.
DenseOptimizer = Union[SGD, AdamW]
EntityOptimizer = Union[EntityRowOptimizer, FusedDenseAdamW]


def init_optimizer_state(
    optimizer: DenseOptimizer,
    params: Params,
    mesh: Any = None,
    entity_optimizer: Optional[EntityOptimizer] = None,
    n_logical: Optional[int] = None,
) -> Dict[str, Any]:
    """Optimizer state on the params' device: ``optimizer``'s state of every
    param without an ``entity_optimizer``; with one, ``{"entity": its state
    of the entity table, "other": optimizer's state of the other params}``.
    Over a ``mesh``, ``params`` are the rank's, so the state of the entity
    table is the state of the rank's block, and the rest is replicated.

    :param n_logical: the logical entity count
        (``sharding.n_shard * sharding.max_entity_per_shard``), with which the
        row optimizer checks the table's height (of a block: over the mesh,
        ``n_logical / n_shard``).
    """
    if mesh is not None:
        if not isinstance(mesh, ShardMesh):
            raise TypeError(f"mesh must be a ShardMesh, got {type(mesh).__name__}")
        if n_logical is not None:
            n_logical //= mesh.n_shard
    if entity_optimizer is None:
        return optimizer.init(params)
    other = {k: v for k, v in params.items() if k != "entity_embedding"}
    return {
        "entity": entity_optimizer.init(params["entity_embedding"], n_logical=n_logical),
        "other": optimizer.init(other),
    }


def _bn_ema(score_fn: Any, params: Params, batch: Dict[str, torch.Tensor],
            momentum: float = 0.1) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """BatchNorm running stats refreshed inside the step
    (``besskge_tpu/trainer.py``'s ``_apply_bn_ema``): ``{bn: (mean, var)}``
    of the momentum EMA of the step's positive (h, r) batch statistics,
    dropout-free, from the params as they are before the update; empty for a
    scorer without BatchNorm. :func:`_write_bn_stats` puts them into the
    params after the optimizer, which discards any optimizer touch of the
    running stats (AdamW's weight decay)."""
    if not getattr(score_fn, "batch_norm", False) or not hasattr(score_fn, "update_bn_stats"):
        return {}
    heads = batch["head"][:, 0].reshape(-1)
    rels = batch["relation"][:, 0].reshape(-1)
    h_emb = take_rows(params["entity_embedding"], heads,
                      n_logical=score_fn.sharding.max_entity_per_shard)
    refreshed = score_fn.update_bn_stats(params, h_emb, rels, momentum=momentum, sync=True)
    return {k: (refreshed[k]["mean"], refreshed[k]["var"])
            for k in ("bn0", "bn1", "bn2") if k in params}


def _write_bn_stats(params: Params, stats: Dict[str, Tuple[torch.Tensor, torch.Tensor]]) -> None:
    for k, (mean, var) in stats.items():
        params[k]["mean"].copy_(mean)
        params[k]["var"].copy_(var)


def _sparse_train_step(
    bess: BessKGE, optimizer: DenseOptimizer, entity_optimizer: EntityRowOptimizer
) -> Callable:
    """The step on tensors: differentiate w.r.t. the gathered rows only (no
    table-sized gradient), then the lazy row update of the touched rows."""

    def step(params: Params, opt_state: Dict[str, Any], batch: Dict[str, torch.Tensor],
             rng: Optional[torch.Tensor] = None):
        table = params["entity_embedding"]
        other = {k: v for k, v in params.items() if k != "entity_embedding"}
        mbs = {k: v[:, 0] for k, v in batch.items() if k in _FORWARD_KEYS}
        idx = torch.func.vmap(bess.gather_plan)(mbs["head"], mbs["tail"], mbs["negative"])
        gathered = take_rows(table, idx, n_logical=bess.sharding.max_entity_per_shard)
        one = torch.ones((), dtype=torch.float32, device=table.device)

        def mb_fn(mb, gathered_mb, mb_rng=None):
            def f(g, o):
                local = dict(o)
                local["entity_embedding"] = table
                out = bess.forward(local, train=True, rng=mb_rng, gathered_emb=g, **mb)
                return out["loss"], out

            _, vjp_fn, out = torch.func.vjp(f, gathered_mb, other, has_aux=True)
            g_gathered, g_other = vjp_fn(one)
            return out, g_gathered, g_other

        bps = idx.shape[0]
        if bess.axis_name is None:
            # Micro-batches fused with vmap, as jax.vmap(mb_fn) does, each
            # with its own dropout key.
            if rng is None:
                outs, g_rows, g_other = torch.func.vmap(mb_fn)(mbs, gathered)
            else:
                outs, g_rows, g_other = torch.func.vmap(mb_fn)(mbs, gathered, split_key(rng, bps))
        else:
            # Over a mesh the AllToAll of each micro-batch (and its transpose
            # in the VJP) runs in turn, as the JAX package's lax.scan.
            rngs = [None] * bps if rng is None else split_key(_fold_in(rng, bess.mesh.rank), bps)
            res = [mb_fn({k: v[i] for k, v in mbs.items()}, gathered[i], rngs[i])
                   for i in range(bps)]
            outs = _stack([r[0] for r in res])
            g_rows = torch.stack([r[1] for r in res])
            g_other = _tree_map(lambda *g: torch.stack(g), *[r[2] for r in res])
        with torch.no_grad():
            bn_stats = _bn_ema(bess.score_fn, params, batch)
            table, ent_state = entity_optimizer.update_rows(
                table, opt_state["entity"], idx.reshape(-1),
                g_rows.reshape(-1, g_rows.shape[-1]),
            )
            # The entity rows' gradients stay on their rank; the replicated
            # params' go through one all-reduce with the loss.
            formatted, acc_other = _reduce_outputs(
                bess, outs, _tree_map(lambda v: v.sum(0), g_other))
            other_state = optimizer.update_(acc_other, opt_state["other"], other)
        new_params = dict(other)
        new_params["entity_embedding"] = table
        _write_bn_stats(new_params, bn_stats)
        return new_params, {"entity": ent_state, "other": other_state}, formatted

    return step


def _dense_train_step(
    bess: BessKGE, optimizer: DenseOptimizer, fused_dense: Optional[FusedDenseAdamW]
) -> Callable:
    """The step on tensors with a dense table gradient: one gradient of the
    loss summed over the micro-batches (vmapped on one device), over the
    whole params dict (the table's gradient is table-sized, and over a mesh
    stays on its rank; every other gradient goes through the step's one
    all-reduce), then ``optimizer`` over every param, or B10 over the table
    and ``optimizer`` over the rest."""

    def step(params: Params, opt_state: Dict[str, Any], batch: Dict[str, torch.Tensor],
             rng: Optional[torch.Tensor] = None):
        if is_packed(params["entity_embedding"]):
            raise ValueError(
                "a row-pair-packed table cannot take a dense gradient; train it with"
                " a sparse EntityRowOptimizer"
            )

        def loss_fn(p: Params):
            # Micro-batches fused with vmap, as the JAX package's _device_step.
            outs = _device_step(bess, p, batch, train=True, rng=rng)
            return torch.sum(outs["loss"]), outs

        grads, outs = torch.func.grad(loss_fn, has_aux=True)(params)
        with torch.no_grad():
            bn_stats = _bn_ema(bess.score_fn, params, batch)
            ent_grad = grads.pop("entity_embedding")
            formatted, grads = _reduce_outputs(bess, outs, grads)
            if fused_dense is None:
                grads = {k: ent_grad if k == "entity_embedding" else grads[k] for k in params}
                new_state = optimizer.update_(grads, opt_state, params)
                _write_bn_stats(params, bn_stats)
                return params, new_state, formatted
            table, ent_state = fused_dense.apply_dense(
                params["entity_embedding"], opt_state["entity"], ent_grad
            )
            other = {k: v for k, v in params.items() if k != "entity_embedding"}
            other_state = optimizer.update_(grads, opt_state["other"], other)
        new_params = dict(other)
        new_params["entity_embedding"] = table
        _write_bn_stats(new_params, bn_stats)
        return new_params, {"entity": ent_state, "other": other_state}, formatted

    return step


def _clone(tree: Any) -> Any:
    """A copy of a dict of tensors (nested), for a step that must not write
    the caller's."""
    return _tree_map(torch.clone, tree)


def build_train_step(
    bess: BessKGE,
    optimizer: DenseOptimizer,
    mesh: Any = None,
    entity_optimizer: Optional[EntityOptimizer] = None,
    donate: bool = True,
    device: Device = None,
) -> Callable:
    """Build ``fn(params, opt_state, batch, rng=None) -> (params, opt_state,
    outputs)``, the BESS training step on one device (default ``cuda``), or
    on each rank of a ``mesh`` (on the mesh's device; ``params`` and
    ``opt_state`` the rank's, ``batch`` the global one or the rank's column).
    ``params`` and ``opt_state`` must live on that device; ``batch`` is a
    batch-sampler dict of ``(bps, 1, ...)`` numpy arrays or tensors; ``rng``
    a dropout key (an int or a 0-dim int64 tensor), split into one key per
    micro-batch, for a scorer with dropout (ConvE). ``outputs`` holds the
    step's ``loss`` (summed over micro-batches) plus the scores when the
    module returns them. A scorer with BatchNorm has its running stats
    refreshed by the step (:func:`_bn_ema`).

    :param optimizer: dense optimizer (:class:`~besskge_tpu_torch.optim.SGD`,
        :class:`~besskge_tpu_torch.optim.AdamW`) of the replicated params, or
        of every param when there is no ``entity_optimizer``.
    :param entity_optimizer: sparse row optimizer of the entity table, or
        :class:`~besskge_tpu_torch.optim.FusedDenseAdamW` for a dense one.
    :param donate: ``True``: ``params`` and ``opt_state`` are updated in
        place (the JAX package donates them); ``False``: the step updates
        copies and leaves the caller's tensors as they were.
    """
    device = _step_device(bess, mesh, device)
    if entity_optimizer is None or isinstance(entity_optimizer, FusedDenseAdamW):
        step = _dense_train_step(bess, optimizer, entity_optimizer)
    else:
        step = _sparse_train_step(bess, optimizer, entity_optimizer)

    def fn(params: Params, opt_state: Dict[str, Any], batch: Dict[str, Any], rng: Any = None):
        if params["entity_embedding"].device.type != device.type:
            raise ValueError(
                f"params on {params['entity_embedding'].device}, step built for {device}"
            )
        if not donate:
            params, opt_state = _clone(params), _clone(opt_state)
        return step(params, opt_state, _batch_tensors(batch, _FORWARD_KEYS, device, mesh),
                    _as_key(rng, device))

    return fn


def _leaves(tree: Dict[str, Any], prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(dotted path, tensor) of every leaf of a nested dict of tensors, in
    order."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def _write_back(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    """Make the tree ``dst`` hold ``src``'s values: a leaf that the step
    replaced by a new tensor (a step count) is copied into ``dst``'s own, so
    that the caller's tensors carry the whole state."""
    for key, value in src.items():
        if isinstance(value, dict):
            _write_back(dst[key], value)
        elif value is not dst[key]:
            dst[key].copy_(value)


def _device_steps(
    bess: BessKGE,
    optimizer: DenseOptimizer,
    sampler: DeviceBatchSampler,
    entity_optimizer: Optional[EntityOptimizer],
    steps_per_call: int,
    mesh: Optional[ShardMesh] = None,
) -> Callable:
    """The eager form of one device-sampled call: ``steps_per_call`` steps
    on batches drawn from ``key`` (split into one key per step when there
    are several, as is a dropout key ``rng``), updating ``params`` and
    ``opt_state`` in place. Over a ``mesh`` every rank draws the global
    batch from the same key and keeps its own column
    (:meth:`~besskge_tpu_torch.device_sampler.DeviceBatchSampler.slice_local`)."""
    if entity_optimizer is None or isinstance(entity_optimizer, FusedDenseAdamW):
        step = _dense_train_step(bess, optimizer, entity_optimizer)
    else:
        step = _sparse_train_step(bess, optimizer, entity_optimizer)

    def split(k: torch.Tensor) -> torch.Tensor:
        return k[None] if steps_per_call == 1 else split_key(k, steps_per_call)

    def run(params: Params, opt_state: Dict[str, Any], sampler_state: Dict[str, torch.Tensor],
            key: torch.Tensor, rng: Optional[torch.Tensor] = None):
        keys = split(key)
        rngs = [None] * steps_per_call if rng is None else split(rng)
        p, o = params, opt_state
        for k, r in zip(keys, rngs):
            batch = sampler.sample(sampler_state, k)
            if mesh is not None:
                batch = sampler.slice_local(batch, mesh.rank)
            p, o, outs = step(p, o, batch, r)
        _write_back(params, p)
        _write_back(opt_state, o)
        return params, opt_state, (outs if steps_per_call == 1 else {"loss": outs["loss"]})

    return run


class _GraphedCall:
    """One device-sampled call as a CUDA graph.

    The first call (and the first after the caller's tensors change) runs
    the steps eagerly on a side stream, which is its result and the graph's
    warm-up, then captures the same call into a graph: every kernel of
    sampling, forward (its dropout masks drawn from the counter hash, no
    generator), backward and update, reading and writing the state's
    tensors where they lie, and the key and the dropout key from static
    device buffers. Later calls write the keys there and replay the graph.
    ``donate=True``: the caller's tensors are the graph's state, updated in
    place and returned; ``donate=False``: the graph has its own copies,
    which each call fills from the caller's and returns copies of.
    """

    def __init__(self, run: Callable, donate: bool, device: torch.device) -> None:
        self.run, self.donate, self.device = run, donate, device
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.signature: Optional[tuple] = None
        #: Capture seconds, the bytes the graph's private pool holds, and the
        #: peak of the bytes allocated during the capture.
        self.stats: Dict[str, float] = {}

    def _signature(self, params, opt_state, sampler_state, rng) -> tuple:
        """Where the graph's inputs lie: it is bound to their addresses (and
        to whether it draws dropout masks)."""
        bound = [sampler_state] + ([params, opt_state] if self.donate else [])
        free = [] if self.donate else [params, opt_state]
        return (
            tuple((path, t.data_ptr(), t.shape, t.stride(), t.dtype)
                  for tree in bound for path, t in _leaves(tree)),
            tuple((path, t.shape, t.dtype) for tree in free for path, t in _leaves(tree)),
            rng is not None,
        )

    def _set_keys(self, key: Union[torch.Tensor, int], rng: Any) -> None:
        for buf, value in ((self.key, key), (self.rng, rng)):
            if value is None:
                continue
            if torch.is_tensor(value) and value.device.type == "cuda":
                buf.copy_(value)
            else:
                buf.fill_(int(value))  # a host value: no transfer, no sync

    def __call__(self, params, opt_state, sampler_state, key, rng=None):
        signature = self._signature(params, opt_state, sampler_state, rng)
        if self.graph is None or signature != self.signature:
            return self._capture(params, opt_state, sampler_state, key, rng, signature)
        if not self.donate:
            for tree, src in ((self.params, params), (self.opt_state, opt_state)):
                for (_, dst), (_, value) in zip(_leaves(tree), _leaves(src)):
                    dst.copy_(value)
        self._set_keys(key, rng)
        self.graph.replay()
        return self._result(params, opt_state, self.outputs)

    def _result(self, params, opt_state, outputs):
        outputs = {k: v.clone() for k, v in outputs.items()}
        if self.donate:
            return params, opt_state, outputs
        return _clone(self.params), _clone(self.opt_state), outputs

    def _capture(self, params, opt_state, sampler_state, key, rng, signature):
        self.graph = self.signature = None  # frees an earlier graph's pool
        if self.donate:
            self.params, self.opt_state = params, opt_state
        else:
            self.params, self.opt_state = _clone(params), _clone(opt_state)
        self.key = torch.zeros((), dtype=torch.int64, device=self.device)
        self.rng = None if rng is None else torch.zeros((), dtype=torch.int64, device=self.device)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._set_keys(key, rng)
            _, _, outputs = self.run(self.params, self.opt_state, sampler_state, self.key,
                                     self.rng)
        current.wait_stream(side)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        allocated = torch.cuda.memory_allocated(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            _, _, self.outputs = self.run(self.params, self.opt_state, sampler_state, self.key,
                                          self.rng)
        capture_s = time.perf_counter() - t0
        self.stats = {
            "capture_s": capture_s,
            "pool_bytes": torch.cuda.memory_reserved(self.device) - reserved,
            "peak_bytes": torch.cuda.max_memory_allocated(self.device) - allocated,
        }
        self.graph, self.signature = graph, signature
        return self._result(params, opt_state, outputs)


def build_device_train_step(
    bess: BessKGE,
    optimizer: DenseOptimizer,
    sampler: DeviceBatchSampler,
    mesh: Any = None,
    entity_optimizer: Optional[EntityOptimizer] = None,
    donate: bool = True,
    steps_per_call: int = 1,
    device: Device = None,
) -> Callable:
    """Build ``fn(params, opt_state, sampler_state, key, rng=None) ->
    (params, opt_state, outputs)`` with the batch drawn on the device by
    ``sampler`` (default device ``cuda``): the host feeds nothing but a key
    per call (:meth:`DeviceBatchSampler.next_key`), and ``sampler_state``
    is :meth:`DeviceBatchSampler.state` on that device.

    ``steps_per_call > 1`` runs that many optimizer steps per call, on the
    keys :func:`~besskge_tpu_torch.device_sampler.split_key` derives from
    ``key``; ``outputs`` then holds only the last step's ``loss``. Both
    forms of :func:`build_train_step` are taken: sparse with an
    :class:`~besskge_tpu_torch.optim.EntityRowOptimizer`, dense with or
    without :class:`~besskge_tpu_torch.optim.FusedDenseAdamW`. A dropout key
    ``rng`` (ConvE) is split per step as ``key`` is, then per micro-batch.

    On a card one call is one CUDA graph of all its steps, captured on the
    first call and replayed from then on (:class:`_GraphedCall`); a capture
    that fails raises. On the CPU the same steps run eagerly. Over a
    ``mesh`` each rank calls the step with its params and optimizer state
    and the replicated sampler state: with NCCL the graph holds the call's
    collectives; a gloo mesh cannot be captured (its collectives run on the
    host), so its calls run uncaptured on the card, as
    ``fn.uncaptured`` says (``None`` when the call is a graph or on the
    CPU).

    :param donate: ``True``: ``params`` and ``opt_state`` are updated in
        place and returned; ``False``: the caller's are left as they were.
    """
    device = _step_device(bess, mesh, device)
    run = _device_steps(bess, optimizer, sampler, entity_optimizer, steps_per_call, mesh)
    uncaptured = None
    if device.type == "cuda" and mesh is not None and not mesh.capturable:
        uncaptured = f"{mesh.backend} collectives run on the host and cannot be captured"
    graphed = (_GraphedCall(run, donate, device)
               if device.type == "cuda" and uncaptured is None else None)

    def fn(params: Params, opt_state: Dict[str, Any], sampler_state: Dict[str, torch.Tensor],
           key: torch.Tensor, rng: Any = None):
        for what, t in (("params", params["entity_embedding"]),
                        ("sampler_state", sampler_state["hrt"])):
            if t.device.type != device.type:
                raise ValueError(f"{what} on {t.device}, step built for {device}")
        if graphed is not None:
            return graphed(params, opt_state, sampler_state, key, rng)
        if not donate:
            params, opt_state = _clone(params), _clone(opt_state)
        return run(params, opt_state, sampler_state, _as_key(key, device), _as_key(rng, device))

    fn._eager = run  # type: ignore[attr-defined]
    fn._graph = graphed  # type: ignore[attr-defined]
    fn.uncaptured = uncaptured  # type: ignore[attr-defined]
    return fn


class Trainer:
    """End-to-end training loop on one device, or on each rank of a mesh.

    :param bess: the BESS module (must have a ``loss_fn``).
    :param batch_sampler: host-side batch stream
        (:class:`~besskge_tpu_torch.batch_sampler.ShardedBatchSampler`) or a
        :class:`~besskge_tpu_torch.device_sampler.DeviceBatchSampler`: with
        the latter, batches are drawn on the device and the host feeds only
        keys (:func:`build_device_train_step`).
    :param optimizer: dense optimizer of the replicated params (of every
        param without an ``entity_optimizer``).
    :param mesh: ``None`` (one device) or the rank's
        :class:`~besskge_tpu_torch.parallel.mesh.ShardMesh`, whose device the
        trainer runs on; the module needs ``axis_name="shard"``.
    :param params: initial params on the device; default
        ``score_fn.initial_params(device)``. A plain entity table (or a
        packed one, ``(n + 1) // 2`` rows) is widened for an interleaved
        ``entity_optimizer``; a widened one is taken as it is. Over a mesh,
        the rank's own params, with its block of the table (any device,
        numpy too): ``score_fn.initial_params_device(mesh)``, or
        :func:`~besskge_tpu_torch.parallel.mesh.shard_params` of the global
        ones; default the rank's block of ``score_fn.initial_params("cpu")``.
    :param seed: seed of the dropout stream: with a scorer that has
        dropout (ConvE, :attr:`needs_rng`), every step (host-fed) or call
        (device-sampled) takes the next key split from it, as the JAX
        package's Trainer splits ``PRNGKey(seed)``.
    :param entity_optimizer: sparse row optimizer of the entity table, or
        :class:`~besskge_tpu_torch.optim.FusedDenseAdamW`.
    :param steps_per_call: with a device sampler, optimizer steps per call
        (one CUDA graph on a card).
    :param device: default ``cuda``; over a mesh, the mesh's.
    """

    def __init__(
        self,
        bess: BessKGE,
        batch_sampler: Union[ShardedBatchSampler, DeviceBatchSampler],
        optimizer: DenseOptimizer,
        mesh: Any = None,
        params: Optional[Params] = None,
        seed: int = 0,
        entity_optimizer: Optional[EntityOptimizer] = None,
        steps_per_call: int = 1,
        device: Device = None,
    ) -> None:
        if bess.loss_fn is None:
            raise ValueError("Training requires a loss_fn on the BESS module")
        self.device_sampling = isinstance(batch_sampler, DeviceBatchSampler)
        if not (self.device_sampling or isinstance(batch_sampler, ShardedBatchSampler)):
            raise TypeError(
                "batch_sampler must be a ShardedBatchSampler or a DeviceBatchSampler, got"
                f" {type(batch_sampler).__name__}"
            )
        if steps_per_call != 1 and not self.device_sampling:
            raise ValueError("steps_per_call requires a DeviceBatchSampler")
        self.steps_per_call = steps_per_call
        self.mesh = mesh
        self.device = _step_device(bess, mesh, device)
        self.bess = bess
        self.batch_sampler = batch_sampler
        self.optimizer = optimizer
        self.entity_optimizer = entity_optimizer
        self.seed = seed
        n_global = bess.sharding.n_shard * bess.sharding.max_entity_per_shard
        if mesh is None:
            raw = dict(params) if params is not None else bess.score_fn.initial_params(self.device)
            n_rows = n_global
        else:
            raw = (shard_params(bess.score_fn.initial_params("cpu"), mesh) if params is None
                   else replicate_tree(params, mesh))
            n_rows = bess.sharding.max_entity_per_shard
        if getattr(entity_optimizer, "interleaved", False):
            tab = raw["entity_embedding"]
            height = tab.shape[-2]
            # A packed table holds two logical rows per row. The optimizer
            # owns its layout: the height of a widened table.
            plain = (n_rows + 1) // 2 if is_packed(tab) else n_rows
            wide = entity_optimizer.widen_table(
                torch.empty((plain, tab.shape[-1]), dtype=tab.dtype, device="meta")
            ).shape[-2]
            if height == plain:
                raw["entity_embedding"] = entity_optimizer.widen_table(tab)
            elif height != wide:
                raise ValueError(
                    f"entity table has {height} rows; expected {plain} (plain, to"
                    f" be widened) or {wide} (already interleaved for"
                    f" {type(entity_optimizer).__name__}) for this sharding"
                )
        self.params = _tree_map(lambda v: v.to(self.device), raw)
        self.opt_state = init_optimizer_state(
            optimizer, self.params, mesh, entity_optimizer, n_logical=n_global
        )
        if self.device_sampling:
            self.sampler_state = batch_sampler.state(self.device)
            self.train_step = build_device_train_step(
                bess, optimizer, batch_sampler, mesh, entity_optimizer,
                steps_per_call=steps_per_call, device=self.device,
            )
        else:
            self.train_step = build_train_step(
                bess, optimizer, mesh, entity_optimizer, device=self.device
            )
        #: The dropout stream: a key (0-dim int64 on the host), split anew
        #: for every step or call when :attr:`needs_rng`.
        self.rng = torch.tensor(seed & 0xFFFFFFFF, dtype=torch.int64)
        self.needs_rng = isinstance(bess.score_fn, ConvE)
        self.history: list = []

    def _next_rng(self) -> Optional[torch.Tensor]:
        """The next step's dropout key, or ``None`` for a scorer without
        dropout."""
        if not self.needs_rng:
            return None
        self.rng, sub = split_key(self.rng, 2)
        return sub

    def fit(
        self,
        n_epochs: int = 1,
        shuffle: bool = True,
        log_every: int = 0,
        callback: Optional[Callable[[int, Dict[str, Any]], None]] = None,
        valid_fn: Optional[Callable[[Params], Dict[str, float]]] = None,
        valid_every: int = 1,
        checkpoint_path: Optional[str] = None,
        checkpoint_metric: str = "mrr",
    ) -> Dict[str, Any]:
        """Run ``n_epochs`` over the sampler; returns summary stats.

        With a host sampler the numpy batch assembly runs in a background
        thread (:meth:`ShardedBatchSampler.get_dataloader`), and each batch
        is moved to the device one step ahead of its use; with a device
        sampler each call takes one key. A step of the history is a call.

        :param valid_fn: optional validation hook ``fn(params) -> {metric:
            value}``, called every ``valid_every`` epochs; results land in
            :attr:`history` as ``{"epoch", "valid": {...}}`` records.
        :param checkpoint_path: with ``valid_fn``, save a checkpoint here
            (:meth:`save`) whenever ``checkpoint_metric`` improves; without
            ``valid_fn``, save once after the last epoch.
        """
        step = 0
        triples_per_step = (
            self.batch_sampler.batches_per_step
            * self.batch_sampler.n_shard
            * self.batch_sampler.shard_bs
        ) * (self.steps_per_call if self.device_sampling else 1)
        out: Optional[Dict[str, Any]] = None
        best_metric = -float("inf")
        t0 = time.perf_counter()
        for epoch in range(n_epochs):
            for out in self._step_stream(epoch, shuffle):
                step += 1
                if log_every and step % log_every == 0:
                    rec = {"step": step, "epoch": epoch, "loss": float(out["loss"])}
                    self.history.append(rec)
                    if callback:
                        callback(step, rec)
            if valid_fn is not None and (epoch + 1) % valid_every == 0:
                metrics = valid_fn(self.params)
                self.history.append({"epoch": epoch, "valid": dict(metrics)})
                if checkpoint_path is not None:
                    val = float(metrics[checkpoint_metric])
                    if val > best_metric:
                        best_metric = val
                        self.save(checkpoint_path, step=step)
        if valid_fn is None and checkpoint_path is not None:
            self.save(checkpoint_path, step=step)
        last_loss = float(out["loss"]) if out is not None else float("nan")
        elapsed = time.perf_counter() - t0
        summary = {
            "steps": step,
            "epochs": n_epochs,
            "final_loss": last_loss,
            "wall_time_s": elapsed,
            "triples_per_s": step * triples_per_step / max(elapsed, 1e-9),
        }
        if best_metric > -float("inf"):
            summary[f"best_{checkpoint_metric}"] = best_metric
        return summary

    def _step_stream(self, epoch: int, shuffle: bool) -> Iterator[Dict[str, Any]]:
        """Run one epoch of train steps, yielding each step's outputs.

        Host-sampler path: iterate the background-prefetched dataloader and
        ship each batch. Device-sampler path: feed only a deterministic
        per-call key (``steps_per_call`` steps per call)."""
        if self.device_sampling:
            n_calls = max(1, -(-len(self.batch_sampler) // self.steps_per_call))
            for i in range(n_calls):
                key = self.batch_sampler.next_key(epoch * n_calls + i)
                self.params, self.opt_state, out = self.train_step(
                    self.params, self.opt_state, self.sampler_state, key, self._next_rng()
                )
                yield out
            return

        def put_ahead(it, depth=2):
            q: deque = deque()
            for b in it:
                q.append(_batch_tensors(b, _FORWARD_KEYS, self.device, self.mesh))
                if len(q) >= depth:
                    yield q.popleft()
            while q:
                yield q.popleft()

        for batch in put_ahead(
            self.batch_sampler.get_dataloader(shuffle=shuffle, seed_offset=epoch)
        ):
            self.params, self.opt_state, out = self.train_step(
                self.params, self.opt_state, batch, self._next_rng()
            )
            yield out

    def save(self, path: str, step: int = 0, sharded: bool = False) -> None:
        """Checkpoint the params, the optimizer state and the sharding in the
        JAX package's format (:func:`~besskge_tpu_torch.checkpoint.save_checkpoint`),
        an interleaved entity table de-interleaved on its device into the
        plain table and its state rows. With ``sharded=True``, the directory
        format (:func:`~besskge_tpu_torch.checkpoint.save_checkpoint_sharded`),
        which keeps the table as it is stored. Over a mesh every rank calls
        it: each writes its block, rank 0 the rest."""
        if sharded:
            save_checkpoint_sharded(path, self.params, opt_state=self.opt_state,
                                    sharding=self.bess.sharding, step=step, mesh=self.mesh)
            return
        opt = self.entity_optimizer
        save_checkpoint(
            path, self.params, opt_state=self.opt_state, sharding=self.bess.sharding, step=step,
            interleaved_entity=opt.interleave_layout if getattr(opt, "interleaved", False)
            else False, mesh=self.mesh,
        )
