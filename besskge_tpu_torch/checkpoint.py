"""Checkpoints in the JAX package's on-disk formats, with resharding on
restore (torch).

Counterpart of ``besskge_tpu/checkpoint.py``: the same ``.npz`` keys
(``params/…``, ``opt/…``, ``sharding/…``, ``__meta__`` as JSON bytes) and the
same sharded directory (``shard_{s:05d}.npz``, ``replicated.npz``,
``sharding.npz``, ``meta.json``), so that a file written by either package
loads into the other, bit for bit.

* The arrays to save may be the port's tensors, on the card or the host, or
  numpy arrays. An interleaved entity table is de-interleaved where it lies,
  through views, and each array is copied to the host once. A plain bf16
  table is written by its bits as a two-byte void array, as ``np.savez``
  writes an ``ml_dtypes`` bfloat16 array (``np.load`` gives ``|V2`` either
  way); a packed uint32 (fp16-pair) table stays uint32 words.
* The port's dense optimizer states go to the file under the keys of the
  optax state that a JAX run writes: :class:`~besskge_tpu_torch.optim.AdamW`
  as ``optax.adamw``'s ``(count, mu, nu)`` at ``#0/#0``, ``#0/#1/<param>``,
  ``#0/#2/<param>``; :class:`~besskge_tpu_torch.optim.SGD` with momentum as
  ``optax.sgd``'s trace at ``#0/#0/<param>``, with no count; plain ``SGD``
  writes nothing. On load a dense state without a count takes the entity
  optimizer's. A schedule's own optax count (``scale_by_schedule``) is read
  but not written.
* Loading returns the port's tensors on the host (``like=`` puts the
  optimizer state on its template's devices); :class:`~besskge_tpu_torch.
  trainer.Trainer` moves params to its device.

Over a mesh (``mesh=``, a
:class:`~besskge_tpu_torch.parallel.mesh.ShardMesh`) every rank calls the
save and load functions with its own params: a save writes each rank's
block of the entity table and of its states, rank 0 the replicated arrays
and the manifest, and a barrier ends it; a load keeps the rank's block
(:func:`load_checkpoint_sharded` reads only the rank's shard file). The
files are those of a one-process save of the same global arrays.

Three checks the JAX package lacks: the height of a table to de-interleave
must be a multiple of its layout's stride, an unknown layout raises on save
and on load, and resharding moves only the entity table, the ``opt/entity``
state and the dense optimizer's moments of the entity table, never another
leaf that happens to have the table's shape.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from besskge_tpu_torch.embedding import refactor_embedding_sharding
from besskge_tpu_torch.packed import pack_table_host, unpack_table_host
from besskge_tpu_torch.parallel.mesh import ShardMesh
from besskge_tpu_torch.sharding import Sharding

__all__ = [
    "load_checkpoint",
    "load_checkpoint_sharded",
    "save_checkpoint",
    "save_checkpoint_sharded",
]

_SEP = "/"
_ENTITY = "entity_embedding"

#: The interleaved layouts: the names of their state rows in the file, and
#: how many physical rows one (fp32) logical row or one packed row spans.
_LAYOUTS = {
    "momentum": (("m",), 2, 3),
    "adagrad": (("acc",), 2, 3),
    "adamw": (("mu", "nu"), 3, 5),
}


def _layout(value: Any) -> Optional[str]:
    """The interleaved layout named by ``value``: ``False`` none, ``True``
    the momentum layout, or one of :data:`_LAYOUTS`; anything else raises."""
    if value is False:
        return None
    if value is True:
        return "momentum"
    if isinstance(value, str) and value in _LAYOUTS:
        return value
    raise ValueError(
        f"unknown interleaved layout {value!r}: expected False, True or one of {sorted(_LAYOUTS)}"
    )


# ---------------------------------------------------------------------------
# Arrays between the port and the file


def _torch(x: Any) -> torch.Tensor:
    """A tensor of ``x`` (a tensor, or a numpy array kept by its bits)."""
    if torch.is_tensor(x):
        return x.detach()
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16" or arr.dtype == np.dtype("V2"):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if arr.dtype == np.uint32:
        return torch.from_numpy(arr.view(np.int32)).view(torch.uint32)
    return torch.from_numpy(arr)


def _host(x: Any) -> np.ndarray:
    """The array the file holds for ``x``: one copy to the host for a tensor
    on a card; bfloat16 by its bits as ``|V2``, uint32 words as uint32."""
    if not torch.is_tensor(x):
        return np.asarray(x)
    t = x.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.numpy()


# ---------------------------------------------------------------------------
# Blocks of a mesh


def _per_rank(key: str, shape: Tuple[int, ...]) -> bool:
    """Whether the file array ``key`` (``params/…`` or ``opt/…``) is split
    by rows over a mesh: the entity table, its row optimizer's states
    (``opt/entity/…``, but a count) and a dense optimizer's moments of it."""
    return len(shape) > 0 and (key.startswith(f"opt{_SEP}entity{_SEP}")
                               or key.endswith(f"{_SEP}{_ENTITY}"))


def _rank_rows(x: np.ndarray, mesh: ShardMesh) -> np.ndarray:
    """A copy of the rank's block of rows of a global array."""
    if x.shape[0] % mesh.n_shard:
        raise ValueError(f"an array of {x.shape[0]} rows does not split into {mesh.n_shard} blocks")
    block = x.shape[0] // mesh.n_shard
    return x[mesh.rank * block : (mesh.rank + 1) * block].copy()


def _check_mesh(mesh: Any) -> None:
    if mesh is not None and not isinstance(mesh, ShardMesh):
        raise TypeError(f"mesh must be a ShardMesh, got {type(mesh).__name__}")


# ---------------------------------------------------------------------------
# Trees


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """``{"a/b/#0": leaf}`` of a tree of dicts, tuples and leaves (``None``
    and empty nodes hold no key)."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}{_SEP}"))
    elif tree is not None:
        out[prefix.rstrip(_SEP)] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Nested dicts of ``flat``'s keys (``#i`` parts stay dict keys)."""
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        *parents, last = key.split(_SEP)
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = val
    return tree


def _is_entity_form(state: Any) -> bool:
    """``{"entity": ..., "other": ...}``: the state of a run with an entity
    optimizer (``trainer.init_optimizer_state``)."""
    return isinstance(state, dict) and set(state) == {"entity", "other"}


def _dense_to_file(state: Dict[str, Any]) -> tuple:
    """The optax state a JAX run keeps for the port's dense state."""
    if "mu" in state:  # optax.adamw: (ScaleByAdamState(count, mu, nu), EmptyState(), EmptyState())
        return ((state["count"], state["mu"], state["nu"]),)
    if "trace" in state:  # optax.sgd(momentum): (TraceState(trace), EmptyState())
        return ((state["trace"],),)
    return ()  # optax.sgd: (EmptyState(), EmptyState())


def _opt_to_file(state: Any) -> Any:
    """The port's optimizer state as the tree the file holds."""
    if _is_entity_form(state):
        return {"entity": state["entity"], "other": _dense_to_file(state["other"])}
    if isinstance(state, dict) and "count" in state:
        return _dense_to_file(state)
    return state


def _dense_from_file(parts: Dict[str, Any], count: Optional[torch.Tensor]) -> Dict[str, Any]:
    """The port's dense state of an optax state read from a file: each part
    ``#i`` is an Adam state ``(count, mu, nu)``, a trace ``(trace,)`` or a
    schedule's ``(count,)``; without a count the entity optimizer's."""
    out: Dict[str, Any] = {}
    for key in sorted(parts, key=lambda k: int(k.lstrip("#"))):
        part = parts[key]
        fields = [part[f"#{i}"] for i in range(len(part))]
        if len(fields) == 3:
            out["count"], out["mu"], out["nu"] = fields
        elif isinstance(fields[0], dict):
            out["trace"] = fields[0]
        else:
            out.setdefault("count", fields[0])
    if "count" not in out:
        out["count"] = (count.clone() if count is not None
                        else torch.zeros((), dtype=torch.int32))
    return out


def _tensors(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return _torch(tree)


def _opt_from_file(flat: Dict[str, np.ndarray], like: Any) -> Any:
    """The port's optimizer state of the file's ``opt/…`` arrays, in the
    form of ``like`` (a port state) when given, else of the keys."""
    tree = _tensors(_unflatten(flat))
    entity_form = _is_entity_form(like) if like is not None else "entity" in tree
    if entity_form:
        entity = tree.get("entity", {})
        state: Any = {"entity": entity,
                      "other": _dense_from_file(tree.get("other", {}), entity.get("count"))}
    else:
        state = _dense_from_file(tree, None)
    return state if like is None else _restore_like(like, state)


def _restore_like(template: Any, state: Any, path: str = "opt") -> Any:
    """``state`` in ``template``'s tree, each leaf on its template leaf's
    device; a key of the template that ``state`` lacks raises."""
    if isinstance(template, dict):
        missing = [k for k in template if k not in state]
        if missing:
            raise ValueError(f"the checkpoint has no {path}/{missing[0]} (like= template)")
        return {k: _restore_like(v, state[k], f"{path}/{k}") for k, v in template.items()}
    return state.to(template.device)


# ---------------------------------------------------------------------------
# The .npz format


def _deinterleave(wide: torch.Tensor, layout: str) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The plain table and the state rows of an interleaved table, as views
    where they lie (a packed store's fp32 state rows logical-major)."""
    names, fp32_h, packed_h = _LAYOUTS[layout]
    packed = not wide.dtype.is_floating_point
    h = packed_h if packed else fp32_h
    *lead, height, d = wide.shape
    if height % h:
        raise ValueError(
            f"a {'packed' if packed else 'plain'} {layout!r} store has {h} rows per"
            f" {'packed ' if packed else ''}row; got a table of {height} rows"
        )
    blocks = wide.reshape(*lead, height // h, h, d)
    if not packed:
        return blocks[..., 0, :], {n: blocks[..., 1 + i, :] for i, n in enumerate(names)}
    # the state rows of packed row p: [row 2p | row 2p+1] per state, as fp32 bits
    return blocks[..., 0, :], {
        n: blocks[..., 1 + 2 * i: 3 + 2 * i, :].reshape(*lead, -1, d).view(torch.float32)
        for i, n in enumerate(names)
    }


def _sharding_arrays(sharding: Sharding) -> Dict[str, np.ndarray]:
    out = {
        "n_shard": np.asarray(sharding.n_shard),
        "entity_to_shard": sharding.entity_to_shard,
        "entity_to_idx": sharding.entity_to_idx,
        "shard_and_idx_to_entity": sharding.shard_and_idx_to_entity,
        "shard_counts": sharding.shard_counts,
    }
    if sharding.entity_type_counts is not None:
        out["entity_type_counts"] = sharding.entity_type_counts
        out["entity_type_offsets"] = sharding.entity_type_offsets
    return out


def save_checkpoint(
    path: Path,
    params: Dict[str, Any],
    opt_state: Any = None,
    sharding: Optional[Sharding] = None,
    step: int = 0,
    extra_meta: Optional[Dict[str, Any]] = None,
    interleaved_entity: "bool | str" = False,
    mesh: Optional[ShardMesh] = None,
) -> None:
    """Write params (+ optimizer state + sharding) to one ``.npz`` file.

    ``interleaved_entity`` names the layout of an interleaved entity table,
    which the file holds de-interleaved, as a non-interleaved run writes it:
    ``True`` or ``"momentum"`` (``RowSGDM``: pair-major fp32 or the packed
    triplet store; the momentum to ``opt/entity/m``), ``"adagrad"``
    (``RowAdagrad``, the same stores; ``opt/entity/acc``), ``"adamw"``
    (``RowAdamW``: treble-major fp32 or the quintuplet store;
    ``opt/entity/mu`` and ``nu``). A packed store's state goes to the file
    logical-major fp32 ``(2P, D)``. The state rows join ``opt/entity`` when
    ``opt_state`` is a dict, and are dropped without an ``opt_state``.

    Over a ``mesh`` each rank writes its blocks to a part file beside
    ``path``, and rank 0 joins them into the file, which holds the global
    arrays.
    """
    _check_mesh(mesh)
    path = Path(path)
    layout = _layout(interleaved_entity)
    params = dict(params)
    if layout is not None:
        plain, moments = _deinterleave(_torch(params[_ENTITY]), layout)
        params[_ENTITY] = plain
        if isinstance(opt_state, dict):
            opt_state = dict(opt_state, entity={**opt_state.get("entity", {}), **moments})
    arrays = {f"params{_SEP}{k}": _host(v) for k, v in _flatten(params).items()}
    if opt_state is not None:
        arrays.update({f"opt{_SEP}{k}": _host(v)
                       for k, v in _flatten(_opt_to_file(opt_state)).items()})
    if sharding is not None:
        arrays.update({f"sharding{_SEP}{k}": v for k, v in _sharding_arrays(sharding).items()})
    meta = {"step": step, **(extra_meta or {})}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    if mesh is None:
        np.savez(path, **arrays)
        return

    def part(rank: int) -> Path:
        return path.with_name(f".{path.name}.rank{rank}.npz")

    np.savez(part(mesh.rank), **{k: v for k, v in arrays.items() if _per_rank(k, v.shape)})
    dist.barrier(group=mesh.group)
    if mesh.rank == 0:
        parts = [np.load(part(r), allow_pickle=False) for r in range(mesh.n_shard)]
        try:
            for key in parts[0].files:
                arrays[key] = np.concatenate([p[key] for p in parts])
        finally:
            for p in parts:
                p.close()
        np.savez(path, **arrays)
        for r in range(mesh.n_shard):
            part(r).unlink()
    dist.barrier(group=mesh.group)


def _reshard(x: np.ndarray, old: Sharding, new: Sharding) -> np.ndarray:
    """A table, or a per-logical-row state, of ``old``'s rows under ``new``;
    a packed table through its logical 16-bit rows."""
    if np.issubdtype(x.dtype, np.integer):
        # Packed words would not survive the fp32 permutation: unpack to the
        # logical rows (pairs never cross a shard: per-shard row counts are
        # even), permute them, pack again.
        if new.max_entity_per_shard % 2:
            raise ValueError(
                "cannot re-shard a packed table onto a sharding with odd"
                f" max_entity_per_shard ({new.max_entity_per_shard}); create the new"
                " Sharding with an even per-shard row count"
            )
        logical = unpack_table_host(np.ascontiguousarray(x), 2 * x.shape[0])
        out = _reshard(logical.astype(np.float32), old, new)
        return pack_table_host(np.ascontiguousarray(out).astype(logical.dtype))
    bits = x.dtype == np.dtype("V2")  # bf16, exact in fp32
    x32 = (x.view(np.uint16).astype(np.uint32) << 16).view(np.float32) if bits else x
    x3 = x32.reshape(old.n_shard, -1, x.shape[-1]).astype(np.float32)
    out = refactor_embedding_sharding(x3, old, new).reshape(-1, x.shape[-1])
    if bits:
        return (out.view(np.uint32) >> 16).astype(np.uint16).view("V2")
    return out.astype(x.dtype)


def _interleave(tab: np.ndarray, states: Dict[str, Optional[np.ndarray]],
                layout: str) -> np.ndarray:
    """The interleaved store of ``tab`` and its state rows (zeros where a
    state is absent): pair-/treble-major fp32, or a packed table's triplet or
    quintuplet store with the logical-major fp32 states by their bits."""
    names, fp32_h, packed_h = _LAYOUTS[layout]
    *lead, n, d = tab.shape
    planes = [tab]
    if np.issubdtype(tab.dtype, np.integer):
        for name in names:
            m = states.get(name)
            bits = (np.zeros((*lead, 2 * n, d), tab.dtype) if m is None else
                    np.ascontiguousarray(np.asarray(m, np.float32)).view(np.uint32)
                    .view(tab.dtype))
            planes += [bits[..., 0::2, :], bits[..., 1::2, :]]
        h = packed_h
    else:
        planes += [np.zeros_like(tab) if states.get(name) is None
                   else np.asarray(states[name]).astype(tab.dtype, copy=False) for name in names]
        h = fp32_h
    return np.stack(planes, axis=-2).reshape(*lead, h * n, d)


def load_checkpoint(
    path: Path,
    new_sharding: Optional[Sharding] = None,
    like: Any = None,
    interleave_entity: "bool | str" = False,
    mesh: Optional[ShardMesh] = None,
) -> Tuple[Dict[str, torch.Tensor], Any, Optional[Sharding], Dict[str, Any]]:
    """Load a checkpoint of either package; optionally re-shard it onto
    ``new_sharding``.

    Params come back as the port's tensors on the host. The optimizer state
    is the port's (``{"entity": ..., "other": ...}`` with an entity
    optimizer, else the dense state alone); ``like``, a port state such as
    :func:`~besskge_tpu_torch.trainer.init_optimizer_state` gives, fixes its
    tree and puts each leaf on the template leaf's device.

    Re-sharding permutes the entity table, the ``opt/entity`` state rows (of
    the table's shape, or logical-major for a packed table) and the dense
    optimizer's moments of the entity table through the global-ID maps.

    ``interleave_entity`` (as ``save_checkpoint``'s ``interleaved_entity``)
    rebuilds the interleaved store after re-sharding, from the plain table
    and the state rows it consumes from ``opt/entity`` (zeros when absent).

    Over a ``mesh``, the rank's block of the (re-sharded, interleaved)
    table and of its states, and the replicated rest.

    :return: ``(params, opt_state, sharding, meta)``.
    """
    _check_mesh(mesh)
    path = Path(path)
    layout = _layout(interleave_entity)
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    meta = json.loads(bytes(flat.pop("__meta__")).decode())
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for key, val in flat.items():
        top, rest = key.split(_SEP, 1)
        groups.setdefault(top, {})[rest] = val
    del flat
    params = groups.get("params", {})
    opt = groups.get("opt")

    sharding = None
    if "sharding" in groups:
        s = groups["sharding"]
        sharding = Sharding(
            n_shard=int(s["n_shard"]),
            entity_to_shard=s["entity_to_shard"],
            entity_to_idx=s["entity_to_idx"],
            shard_and_idx_to_entity=s["shard_and_idx_to_entity"],
            shard_counts=s["shard_counts"],
            entity_type_counts=s.get("entity_type_counts"),
            entity_type_offsets=s.get("entity_type_offsets"),
        )

    if new_sharding is not None:
        if sharding is None:
            raise ValueError("Checkpoint has no sharding metadata; cannot re-shard")
        table = params[_ENTITY]
        # a packed table's fp32 states are logical-major (2P, D)
        shapes = {table.shape}
        if np.issubdtype(table.dtype, np.integer):
            shapes.add((2 * table.shape[-2], table.shape[-1]))
        params[_ENTITY] = _reshard(table, sharding, new_sharding)
        for key, val in (opt or {}).items():
            entity_state = key.startswith(f"entity{_SEP}") and val.shape in shapes
            if entity_state or key.endswith(f"{_SEP}{_ENTITY}"):
                opt[key] = _reshard(val, sharding, new_sharding)
        sharding = new_sharding

    if layout is not None:
        states = {name: (opt or {}).pop(f"entity{_SEP}{name}", None)
                  for name in _LAYOUTS[layout][0]}
        params[_ENTITY] = _interleave(params[_ENTITY], states, layout)

    if mesh is not None:
        for top, group in (("params", params), ("opt", opt or {})):
            for key, val in group.items():
                if _per_rank(f"{top}{_SEP}{key}", val.shape):
                    group[key] = _rank_rows(val, mesh)

    opt_state = None
    if opt is not None or like is not None:
        opt_state = _opt_from_file(opt or {}, like)
    return _tensors(_unflatten(params)), opt_state, sharding, meta


# ---------------------------------------------------------------------------
# The sharded directory format


def save_checkpoint_sharded(
    path: Path,
    params: Dict[str, Any],
    opt_state: Any = None,
    sharding: Optional[Sharding] = None,
    step: int = 0,
    extra_meta: Optional[Dict[str, Any]] = None,
    mesh: Optional[ShardMesh] = None,
) -> None:
    """Write a directory checkpoint: one ``shard_{s:05d}.npz`` per table
    shard with the rows of every array of the entity table's shape (the
    table as it is stored, interleaved or not), ``replicated.npz`` with
    every other array, ``sharding.npz`` and ``meta.json``. One shard's rows
    are on the host at a time.

    Over a ``mesh`` each rank passes its params and state and writes its own
    shard file, of the arrays of its block's shape; rank 0 writes the rest.
    A state of the table that is split over the mesh but not of the block's
    shape (a packed table's separate fp32 states) raises: save those with
    :func:`save_checkpoint`."""
    if sharding is None:
        raise ValueError("save_checkpoint_sharded requires the Sharding")
    _check_mesh(mesh)
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    table_shape = tuple(params[_ENTITY].shape)
    flat = {f"params{_SEP}{k}": v for k, v in _flatten(params).items()}
    if opt_state is not None:
        flat.update({f"opt{_SEP}{k}": v for k, v in _flatten(_opt_to_file(opt_state)).items()})
    table_keys = [k for k, v in flat.items() if tuple(np.shape(v)) == table_shape]
    if mesh is not None:
        stray = [k for k, v in flat.items() if k not in table_keys and _per_rank(k, np.shape(v))]
        if stray:
            raise ValueError(f"{stray} split over the mesh but not of the table's shape;"
                             " save this state with save_checkpoint")
        np.savez(path / f"shard_{mesh.rank:05d}.npz", **{k: _host(flat[k]) for k in table_keys})
        table_shape = (table_shape[0] * mesh.n_shard,) + table_shape[1:]
    else:
        rows_per_shard = table_shape[0] // sharding.n_shard
        for s in range(sharding.n_shard):
            rows = slice(s * rows_per_shard, (s + 1) * rows_per_shard)
            np.savez(path / f"shard_{s:05d}.npz", **{k: _host(flat[k][rows]) for k in table_keys})
    if mesh is not None and mesh.rank != 0:
        dist.barrier(group=mesh.group)
        return
    np.savez(path / "replicated.npz",
             **{k: _host(v) for k, v in flat.items() if k not in table_keys})
    sharding.save(path / "sharding.npz")
    meta = {
        "step": step,
        "table_keys": table_keys,
        "table_shape": list(table_shape),
        "n_shard": sharding.n_shard,
        **(extra_meta or {}),
    }
    (path / "meta.json").write_text(json.dumps(meta))
    if mesh is not None:
        dist.barrier(group=mesh.group)


def load_checkpoint_sharded(
    path: Path,
    mesh: Any = None,
    new_sharding: Optional[Sharding] = None,
    like: Any = None,
) -> Tuple[Dict[str, torch.Tensor], Any, Optional[Sharding], Dict[str, Any]]:
    """Load a :func:`save_checkpoint_sharded` directory of either package:
    tables concatenated on the host from their shard files, the optimizer
    state in the port's form (``like`` as in :func:`load_checkpoint`).

    With ``new_sharding``, each new shard's rows are gathered from the old
    shard files that hold them (padding rows zero). That needs a plain table
    of ``max_entity_per_shard`` rows per shard: an interleaved or packed
    one raises (re-shard it through :func:`load_checkpoint`).

    :param mesh: ``None``, or the rank's mesh: then the tables are the
        rank's block alone, read from its own shard file(s), on the host.
    :return: ``(params, opt_state, sharding, meta)``.
    """
    _check_mesh(mesh)
    path = Path(path)
    meta = json.loads((path / "meta.json").read_text())
    table_keys = list(meta["table_keys"])
    old_sharding = Sharding.load(path / "sharding.npz")
    rows_old = meta["table_shape"][0] // meta["n_shard"]
    if new_sharding is not None and rows_old != old_sharding.max_entity_per_shard:
        raise ValueError(
            f"cannot re-shard a table of {rows_old} rows per shard for"
            f" {old_sharding.max_entity_per_shard} entity rows (interleaved or packed)"
        )

    shard_files: Dict[int, Any] = {}

    def old_block(s: int, key: str) -> np.ndarray:
        if s not in shard_files:
            shard_files[s] = np.load(path / f"shard_{s:05d}.npz", allow_pickle=False)
        return shard_files[s][key]

    def block(s: int, key: str) -> np.ndarray:
        if new_sharding is None:
            return old_block(s, key)
        ids = new_sharding.shard_and_idx_to_entity[s]
        valid = np.nonzero(ids < old_sharding.n_entity)[0]
        src_shard = old_sharding.entity_to_shard[ids[valid]]
        src_idx = old_sharding.entity_to_idx[ids[valid]]
        probe = old_block(int(src_shard[0]) if len(src_shard) else 0, key)
        out = np.zeros((new_sharding.max_entity_per_shard,) + probe.shape[1:], probe.dtype)
        for s_old in np.unique(src_shard):
            m = src_shard == s_old
            out[valid[m]] = old_block(int(s_old), key)[src_idx[m]]
        return out

    eff_sharding = new_sharding if new_sharding is not None else old_sharding
    with np.load(path / "replicated.npz", allow_pickle=False) as data:
        flat: Dict[str, np.ndarray] = {k: data[k] for k in data.files}
    if mesh is not None and mesh.n_shard != eff_sharding.n_shard:
        raise ValueError(f"a {eff_sharding.n_shard}-shard table onto a mesh of {mesh.n_shard}")
    try:
        for key in table_keys:
            if mesh is not None:
                flat[key] = block(mesh.rank, key)
            else:
                flat[key] = np.concatenate([block(s, key) for s in range(eff_sharding.n_shard)])
    finally:
        for f in shard_files.values():
            f.close()
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for key, val in flat.items():
        top, rest = key.split(_SEP, 1)
        groups.setdefault(top, {})[rest] = val
    opt = groups.get("opt")
    opt_state = None
    if opt is not None or like is not None:
        opt_state = _opt_from_file(opt or {}, like)
    return _tensors(_unflatten(groups.get("params", {}))), opt_state, eff_sharding, meta
