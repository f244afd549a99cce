"""Training step and loop for BESS-KGE on one device (torch).

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

* :class:`Trainer` widens the table for an interleaved optimizer, builds the
  optimizer state and runs epochs over a host batch sampler.

Params and optimizer state are updated in place, as the JAX package donates
them to the step; ``donate=False`` updates copies instead. Only one device
is ported: a mesh raises (ROADMAP A15), on-device sampling
(``DeviceBatchSampler``, ``build_device_train_step``) waits on A8 and
checkpoints on A10.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, Optional, Union

import numpy as np
import torch

from besskge_tpu_torch.batch_sampler import ShardedBatchSampler
from besskge_tpu_torch.bess import _FORWARD_KEYS, BessKGE, _format_outputs
from besskge_tpu_torch.optim import AdamW, SGD, EntityRowOptimizer, FusedDenseAdamW
from besskge_tpu_torch.packed import take_rows
from besskge_tpu_torch.utils import resolve_device

__all__ = ["build_train_step", "init_optimizer_state", "Trainer"]

Params = Dict[str, torch.Tensor]
Device = Optional[Union[str, torch.device]]
#: A dense optimizer of the port: ``init(params)``, ``update_(grads, state, params)``.
DenseOptimizer = Union[SGD, AdamW]
EntityOptimizer = Union[EntityRowOptimizer, FusedDenseAdamW]


def _no_mesh(mesh: Any) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "multi-device training (a mesh) is not ported yet (ROADMAP A15)"
        )


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

    :param n_logical: the logical entity count
        (``sharding.n_shard * sharding.max_entity_per_shard``), with which the
        row optimizer checks the table's height.
    """
    _no_mesh(mesh)
    if entity_optimizer is None:
        return optimizer.init(params)
    other = {k: v for k, v in params.items() if k != "entity_embedding"}
    return {
        "entity": entity_optimizer.init(params["entity_embedding"], n_logical=n_logical),
        "other": optimizer.init(other),
    }


def _sparse_train_step(
    bess: BessKGE, optimizer: DenseOptimizer, entity_optimizer: EntityRowOptimizer
) -> Callable:
    """The step on tensors: differentiate w.r.t. the gathered rows only (no
    table-sized gradient), then the lazy row update of the touched rows."""

    def step(params: Params, opt_state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        table = params["entity_embedding"]
        other = {k: v for k, v in params.items() if k != "entity_embedding"}
        mbs = {k: v[:, 0] for k, v in batch.items() if k in _FORWARD_KEYS}
        idx = torch.func.vmap(bess.gather_plan)(mbs["head"], mbs["tail"], mbs["negative"])
        gathered = take_rows(table, idx, n_logical=bess.sharding.max_entity_per_shard)
        one = torch.ones((), dtype=torch.float32, device=table.device)

        def mb_fn(mb, gathered_mb):
            def f(g, o):
                local = dict(o)
                local["entity_embedding"] = table
                out = bess.forward(local, gathered_emb=g, **mb)
                return out["loss"], out

            _, vjp_fn, out = torch.func.vjp(f, gathered_mb, other, has_aux=True)
            g_gathered, g_other = vjp_fn(one)
            return out, g_gathered, g_other

        # Micro-batches fused with vmap, as jax.vmap(mb_fn) does.
        outs, g_rows, g_other = torch.func.vmap(mb_fn)(mbs, gathered)
        with torch.no_grad():
            table, ent_state = entity_optimizer.update_rows(
                table, opt_state["entity"], idx.reshape(-1),
                g_rows.reshape(-1, g_rows.shape[-1]),
            )
            acc_other = {k: v.sum(0) for k, v in g_other.items()}
            other_state = optimizer.update_(acc_other, opt_state["other"], other)
        new_params = dict(other)
        new_params["entity_embedding"] = table
        return new_params, {"entity": ent_state, "other": other_state}, _format_outputs(bess, outs)

    return step


def _dense_train_step(
    bess: BessKGE, optimizer: DenseOptimizer, fused_dense: Optional[FusedDenseAdamW]
) -> Callable:
    """The step on tensors with a dense table gradient: one gradient of the
    loss summed over the vmapped micro-batches, over the whole params dict
    (the table's gradient is table-sized), then ``optimizer`` over every
    param, or B10 over the table and ``optimizer`` over the rest."""

    def step(params: Params, opt_state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        if not params["entity_embedding"].is_floating_point():
            raise ValueError(
                "a row-pair-packed table cannot take a dense gradient; train it with"
                " a sparse EntityRowOptimizer"
            )
        mbs = {k: v[:, 0] for k, v in batch.items() if k in _FORWARD_KEYS}

        def loss_fn(p: Params):
            # Micro-batches fused with vmap, as the JAX package's _device_step.
            outs = torch.func.vmap(lambda mb: bess.forward(p, train=True, **mb))(mbs)
            return torch.sum(outs["loss"]), outs

        grads, outs = torch.func.grad(loss_fn, has_aux=True)(params)
        with torch.no_grad():
            if fused_dense is None:
                new_state = optimizer.update_(grads, opt_state, params)
                return params, new_state, _format_outputs(bess, outs)
            table, ent_state = fused_dense.apply_dense(
                params["entity_embedding"], opt_state["entity"], grads.pop("entity_embedding")
            )
            other = {k: v for k, v in params.items() if k != "entity_embedding"}
            other_state = optimizer.update_(grads, opt_state["other"], other)
        new_params = dict(other)
        new_params["entity_embedding"] = table
        return new_params, {"entity": ent_state, "other": other_state}, _format_outputs(bess, outs)

    return step


def _clone(tree: Any) -> Any:
    """A copy of a dict of tensors (nested), for a step that must not write
    the caller's."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch keys the forward takes, as tensors on ``device``."""
    return {
        k: (v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v))).to(device)
        for k, v in batch.items()
        if k in _FORWARD_KEYS
    }


def build_train_step(
    bess: BessKGE,
    optimizer: DenseOptimizer,
    mesh: Any = None,
    entity_optimizer: Optional[EntityOptimizer] = None,
    donate: bool = True,
    device: Device = None,
) -> Callable:
    """Build ``fn(params, opt_state, batch) -> (params, opt_state, outputs)``,
    the BESS training step on one device (default ``cuda``). ``params`` and
    ``opt_state`` must live on that device; ``batch`` is a batch-sampler dict
    of ``(bps, 1, ...)`` numpy arrays or tensors. ``outputs`` holds the
    step's ``loss`` (summed over micro-batches) plus the scores when the
    module returns them.

    :param optimizer: dense optimizer (:class:`~besskge_tpu_torch.optim.SGD`,
        :class:`~besskge_tpu_torch.optim.AdamW`) of the replicated params, or
        of every param when there is no ``entity_optimizer``.
    :param entity_optimizer: sparse row optimizer of the entity table, or
        :class:`~besskge_tpu_torch.optim.FusedDenseAdamW` for a dense one.
    :param donate: ``True``: ``params`` and ``opt_state`` are updated in
        place (the JAX package donates them); ``False``: the step updates
        copies and leaves the caller's tensors as they were.
    """
    _no_mesh(mesh)
    device = resolve_device(device)
    if entity_optimizer is None or isinstance(entity_optimizer, FusedDenseAdamW):
        step = _dense_train_step(bess, optimizer, entity_optimizer)
    else:
        step = _sparse_train_step(bess, optimizer, entity_optimizer)

    def fn(params: Params, opt_state: Dict[str, Any], batch: Dict[str, Any]):
        if params["entity_embedding"].device.type != device.type:
            raise ValueError(
                f"params on {params['entity_embedding'].device}, step built for {device}"
            )
        if not donate:
            params, opt_state = _clone(params), _clone(opt_state)
        return step(params, opt_state, _to_device(batch, device))

    return fn


class Trainer:
    """End-to-end training driver on one device.

    :param bess: the BESS module (must have a ``loss_fn``).
    :param batch_sampler: host-side batch stream
        (:class:`~besskge_tpu_torch.batch_sampler.ShardedBatchSampler`); a
        device sampler is not ported yet (ROADMAP A8).
    :param optimizer: dense optimizer of the replicated params (of every
        param without an ``entity_optimizer``).
    :param mesh: must be ``None``.
    :param params: initial params on the device; default
        ``score_fn.initial_params(device)``. A plain entity table is widened
        for an interleaved ``entity_optimizer``; a widened one is taken as it
        is.
    :param seed: seed of the dropout streams, which no ported scorer has
        (ConvE: ROADMAP A11); kept as :attr:`seed`.
    :param entity_optimizer: sparse row optimizer of the entity table, or
        :class:`~besskge_tpu_torch.optim.FusedDenseAdamW`.
    :param steps_per_call: must be 1 (fused steps need on-device sampling).
    :param device: default ``cuda``.
    """

    def __init__(
        self,
        bess: BessKGE,
        batch_sampler: ShardedBatchSampler,
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
        _no_mesh(mesh)
        if not isinstance(batch_sampler, ShardedBatchSampler) or steps_per_call != 1:
            raise NotImplementedError(
                "on-device sampling (DeviceBatchSampler, steps_per_call) is not"
                " ported yet (ROADMAP A8); use a host ShardedBatchSampler"
            )
        self.device = resolve_device(device)
        self.bess = bess
        self.batch_sampler = batch_sampler
        self.optimizer = optimizer
        self.entity_optimizer = entity_optimizer
        self.seed = seed
        raw = dict(params) if params is not None else bess.score_fn.initial_params(self.device)
        n_global = bess.sharding.n_shard * bess.sharding.max_entity_per_shard
        if getattr(entity_optimizer, "interleaved", False):
            tab = raw["entity_embedding"]
            height = tab.shape[-2]
            # The optimizer owns its layout: the height of a widened table.
            wide = entity_optimizer.widen_table(
                torch.empty((n_global, tab.shape[-1]), dtype=tab.dtype, device="meta")
            ).shape[-2]
            if height == n_global:
                raw["entity_embedding"] = entity_optimizer.widen_table(tab)
            elif height != wide:
                raise ValueError(
                    f"entity table has {height} rows; expected {n_global} (plain, to"
                    f" be widened) or {wide} (already interleaved for"
                    f" {type(entity_optimizer).__name__}) for this sharding"
                )
        self.params = {k: v.to(self.device) for k, v in raw.items()}
        self.opt_state = init_optimizer_state(
            optimizer, self.params, None, entity_optimizer, n_logical=n_global
        )
        self.train_step = build_train_step(
            bess, optimizer, None, entity_optimizer, device=self.device
        )
        self.history: list = []

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

        The numpy batch assembly runs in a background thread
        (:meth:`ShardedBatchSampler.get_dataloader`), and each batch is moved
        to the device one step ahead of its use.

        :param valid_fn: optional validation hook ``fn(params) -> {metric:
            value}``, called every ``valid_every`` epochs; results land in
            :attr:`history` as ``{"epoch", "valid": {...}}`` records.
        :param checkpoint_path: checkpoints are not ported yet (ROADMAP A10):
            anything but ``None`` raises.
        """
        if checkpoint_path is not None:
            raise NotImplementedError("checkpoints are not ported yet (ROADMAP A10)")
        step = 0
        triples_per_step = (
            self.batch_sampler.batches_per_step
            * self.batch_sampler.n_shard
            * self.batch_sampler.shard_bs
        )
        out: Optional[Dict[str, Any]] = None
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
        last_loss = float(out["loss"]) if out is not None else float("nan")
        elapsed = time.perf_counter() - t0
        return {
            "steps": step,
            "epochs": n_epochs,
            "final_loss": last_loss,
            "wall_time_s": elapsed,
            "triples_per_s": step * triples_per_step / max(elapsed, 1e-9),
        }

    def _step_stream(self, epoch: int, shuffle: bool) -> Iterator[Dict[str, Any]]:
        """Run one epoch of train steps, yielding each step's outputs."""

        def put_ahead(it, depth=2):
            q: deque = deque()
            for b in it:
                q.append(_to_device(b, self.device))
                if len(q) >= depth:
                    yield q.popleft()
            while q:
                yield q.popleft()

        for batch in put_ahead(
            self.batch_sampler.get_dataloader(shuffle=shuffle, seed_offset=epoch)
        ):
            self.params, self.opt_state, out = self.train_step(
                self.params, self.opt_state, batch
            )
            yield out
