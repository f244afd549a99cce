"""Carry parameters and optimizer state between the JAX package and the port.

The JAX package's values arrive as numpy arrays or as its own containers
(optax states are named tuples); nothing here imports JAX or optax.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from besskge_tpu_torch.utils import resolve_device

__all__ = ["opt_state_from_jax", "opt_state_to_numpy", "params_from_jax", "params_to_numpy"]

Device = Optional[Union[str, torch.device]]


def _tensor(value: Any, device: torch.device) -> Any:
    """A tensor of an array, kept by its bits; a dict (ConvE's trunk, its
    moments) leaf by leaf."""
    if isinstance(value, dict):
        return {k: _tensor(v, device) for k, v in value.items()}
    arr = np.array(value)  # a writable copy: torch.from_numpy shares memory
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    if arr.dtype == np.uint32:  # packed fp16 storage, carried by its bits
        return torch.from_numpy(arr.view(np.int32)).view(torch.uint32).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_jax(params: Dict[str, Any], device: Device = None) -> Dict[str, Any]:
    """The port's params from the JAX package's, given as numpy arrays
    (``{k: np.asarray(v) for k, v in jax_params.items()}``), on ``device``
    (default ``cuda``). Values and dtypes are kept bit for bit — a plain
    ``(N, D)`` table, a pair-major ``(2N, D)`` or treble-major ``(3N, D)``
    one, a row-pair-packed table (int32 bf16 pairs, uint32 fp16 pairs) or its
    triplet ``(3P, D)`` or quintuplet ``(5P, D)`` store, and their
    ``(1, ·, D)`` blocks alike; float16 arrays as they are, bfloat16 arrays
    (numpy dtype ``bfloat16`` from ``ml_dtypes``) by their bits. Nested
    dicts (ConvE's ``bn0``/``bn1``/``bn2``) stay nested."""
    device = resolve_device(device)
    return _tensor(dict(params), device)


def _dense_state(parts: Any, device: torch.device, count: Optional[torch.Tensor]) -> Dict[str, Any]:
    """The port's dense-optimizer state from an optax state: the momentum
    ``trace`` of ``optax.sgd``, the ``mu``/``nu`` of ``optax.adamw``, and the
    step count of the chain (``count`` when the chain keeps none)."""
    out: Dict[str, Any] = {}
    for part in parts if isinstance(parts, (tuple, list)) else (parts,):
        fields = getattr(part, "_fields", ())
        if "trace" in fields:
            out["trace"] = _tensor(dict(part.trace), device)
        if "mu" in fields:
            out["mu"] = _tensor(dict(part.mu), device)
            out["nu"] = _tensor(dict(part.nu), device)
        if "count" in fields:
            out["count"] = _tensor(part.count, device).to(torch.int32)
    if "count" not in out:
        out["count"] = (
            count.clone() if count is not None
            else torch.zeros((), dtype=torch.int32, device=device)
        )
    return out


def opt_state_from_jax(state: Any, device: Device = None) -> Dict[str, Any]:
    """The port's optimizer state from the JAX package's
    ``init_optimizer_state`` state, on ``device`` (default ``cuda``).

    * With an entity optimizer, ``{"entity": {...}, "other": optax state}``
      becomes ``{"entity": {...}, "other": {...}}``. The entity part is a
      dict of arrays in either package: ``{"count"}`` for an interleaved
      ``RowSGDM`` or ``RowAdamW`` (their moments live in the widened table,
      which :func:`params_from_jax` carries), ``{"m", "count"}`` for a
      separate-buffer ``RowSGDM`` (a packed table's moments are logical-major
      ``(2P, D)`` fp32), ``{"mu", "nu", "count"}`` for a
      separate-buffer ``RowAdamW`` and for ``FusedDenseAdamW``.
    * Without one, the optax state of every param becomes the port's dense
      state alone.

    A dense state is ``{"count", "trace"}`` for
    :class:`~besskge_tpu_torch.optim.SGD` (from ``optax.sgd``) and
    ``{"count", "mu", "nu"}`` for :class:`~besskge_tpu_torch.optim.AdamW`
    (from ``optax.adamw``'s ``ScaleByAdamState``). The dense step count is
    the chain's count when it keeps one, else the entity optimizer's (0
    without one).
    """
    device = resolve_device(device)
    if isinstance(state, dict) and set(state) == {"entity", "other"}:
        entity = {k: _tensor(v, device) for k, v in state["entity"].items()}
        return {"entity": entity, "other": _dense_state(state["other"], device, entity["count"])}
    return _dense_state(state, device, None)


def _numpy(value: Any) -> Any:
    if isinstance(value, dict):
        return {k: _numpy(v) for k, v in value.items()}
    value = value.detach().cpu()
    if value.dtype == torch.bfloat16:
        value = value.float()  # exact: numpy has no bfloat16
    if value.dtype == torch.uint32:
        return value.view(torch.int32).numpy().view(np.uint32)
    return value.numpy()


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's params as numpy arrays (nested dicts nested): a packed
    table (or its triplet or quintuplet store) as its int32 or uint32 words
    and float16 as float16, bit for bit as the JAX package holds them; a
    plain bfloat16 table widened to float32 (exact: numpy has no
    bfloat16)."""
    return _numpy(params)


def opt_state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's optimizer state as nested dicts of numpy arrays."""
    return _numpy(state)
