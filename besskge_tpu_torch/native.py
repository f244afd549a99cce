"""ctypes bindings for the native (C++) host-side loops of the samplers.

The port's counterpart of ``besskge_tpu/native.py``: the same C++ source
(``csrc/bess_host.cpp`` at the root of the repository) built by
:mod:`besskge_tpu_torch._build` with the host compiler at first use, into the
port's own build directory (``build/besskge_tpu_torch/``). It exposes:

* :func:`assemble_hrt` — shard-pair (h, r, t) gather with the tail
  pre-transpose for the AllToAll;
* :func:`random_negatives` — balanced negative drawing (pcg32);
* :func:`rigid_take` — padded-epoch triple selection + mask;
* :func:`available` — whether the library builds and loads.

Unlike the JAX package's module, these functions raise ``RuntimeError`` when
the library cannot be built or loaded: a sampler asked to use the native
loops never switches by itself to the numpy random stream, which draws
different negatives. :func:`available` only reports it.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from besskge_tpu_torch import _build

__all__ = ["available", "assemble_hrt", "random_negatives", "rigid_take"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _get() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            try:
                lib = _build.load_library("bess_host")
            except (OSError, RuntimeError) as err:
                raise RuntimeError(
                    "the native host library (csrc/bess_host.cpp) could not be"
                    " built or loaded; pass use_native=False to the samplers to"
                    f" draw from the numpy stream instead: {err}"
                ) from err
            lib.bess_assemble_hrt.argtypes = [
                _i32p, _i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                _i32p, _i32p, _i32p,
            ]
            lib.bess_assemble_hrt_flat.argtypes = [
                _i32p, _i64p, ctypes.c_int64, _i32p, _i32p, _i32p,
            ]
            lib.bess_random_negatives.argtypes = [
                ctypes.c_uint64, _i64p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, _i32p,
            ]
            lib.bess_rigid_take.argtypes = [
                _i64p, _i64p, _i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, _i64p, _u8p,
            ]
            for fn in (lib.bess_assemble_hrt, lib.bess_assemble_hrt_flat,
                       lib.bess_random_negatives, lib.bess_rigid_take):
                fn.restype = None
            _lib = lib
        return _lib


def available() -> bool:
    """True when the native library builds and loads. It reports only: the
    samplers still raise on a library that does not load."""
    try:
        _get()
    except RuntimeError:
        return False
    return True


def assemble_hrt(
    triples: np.ndarray, sample_idx: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Gather (head, relation, tail) for a batch.

    For 4-D ``sample_idx`` (bps, S, S, ppp) — ht_shardpair — the returned
    tails are pre-transposed (shard_h <-> shard_t). 3-D input returns plain
    gathers.
    """
    lib = _get()
    triples = np.ascontiguousarray(triples, np.int32)
    sample_idx = np.ascontiguousarray(sample_idx, np.int64)
    head = np.empty(sample_idx.shape, np.int32)
    rel = np.empty(sample_idx.shape, np.int32)
    tail = np.empty(sample_idx.shape, np.int32)
    if sample_idx.ndim == 4:
        bps, s, s2, ppp = sample_idx.shape
        if s != s2:
            raise ValueError(f"expected (bps, S, S, ppp) indices, got {sample_idx.shape}")
        lib.bess_assemble_hrt(triples, sample_idx, bps, s, ppp, head, rel, tail)
    else:
        lib.bess_assemble_hrt_flat(
            triples, sample_idx.reshape(-1), sample_idx.size,
            head.reshape(-1), rel.reshape(-1), tail.reshape(-1),
        )
    return head, rel, tail


def random_negatives(
    seed: int, shard_counts: np.ndarray, bps: int, n_shard: int, b: int,
    n_negative: int,
) -> np.ndarray:
    """(bps, S_src, S_dest, B, n_neg) balanced local ids."""
    lib = _get()
    out = np.empty((bps, n_shard, n_shard, b, n_negative), np.int32)
    lib.bess_random_negatives(
        np.uint64(seed & (2**64 - 1)),
        np.ascontiguousarray(shard_counts, np.int64),
        bps, n_shard, b, n_negative, out,
    )
    return out


def rigid_take(
    padded_idx: np.ndarray, counts: np.ndarray, order: np.ndarray,
    bps: int, ppp: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """(take, mask) for a Rigid batch over (S, S, padded_len) indices."""
    lib = _get()
    if padded_idx.ndim != 3:
        raise ValueError(f"expected (S, S, padded_len) indices, got {padded_idx.shape}")
    s = padded_idx.shape[0]
    take = np.empty((bps, s, s, ppp), np.int64)
    mask = np.empty((bps, s, s, ppp), np.uint8)
    lib.bess_rigid_take(
        np.ascontiguousarray(padded_idx, np.int64),
        np.ascontiguousarray(counts, np.int64),
        np.ascontiguousarray(order, np.int64),
        bps, s, ppp, padded_idx.shape[-1], take, mask,
    )
    return take, mask.astype(bool)
