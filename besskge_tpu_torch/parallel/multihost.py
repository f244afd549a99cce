"""Process-group bring-up and the per-process views of a mesh.

Counterpart of ``besskge_tpu/parallel/multihost.py``. In the port every mesh
is one process per shard, on one host or on several (``torchrun``):

* :func:`initialize`: ``torch.distributed.init_process_group``, from
  ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT``) or from the arguments; nothing when a group is already
  initialised;
* :func:`make_global_mesh`: the ``"shard"`` mesh over every rank;
* :func:`local_shard_range`: the table shards this process owns, its own;
* :func:`shard_batch_multihost`, :func:`shard_params_multihost`: a process's
  own batch column and params on its device.

``_spawn`` starts ``n`` local ranks of a function for the tests and
``chip_smoke.py`` (a ``FileStore`` rendezvous in a temporary directory, a
hard timeout) and returns each rank's result.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from besskge_tpu_torch.parallel.mesh import (
    ShardMesh,
    _check_backend,
    _default_backend,
    _tensor,
    make_shard_mesh,
    shard_params,
)
from besskge_tpu_torch.utils import resolve_device

__all__ = [
    "initialize",
    "make_global_mesh",
    "local_shard_range",
    "shard_batch_multihost",
    "shard_params_multihost",
]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> None:
    """Initialise the default process group (nothing when it is already).

    :param coordinator_address: an ``init_method`` (``tcp://host:port``,
        ``file:///path``) or ``host:port``; default ``torchrun``'s
        environment (``env://``).
    :param num_processes: the world size (default ``WORLD_SIZE``).
    :param process_id: this process's rank (default ``RANK``).
    :param backend: default NCCL on a card, gloo on the CPU.
    :param device: the device the ranks run on (default ``cuda``), which
        picks the default backend.
    """
    if dist.is_initialized():
        return
    device = resolve_device(device)
    backend = backend or _default_backend(device)
    _check_backend(backend, device)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
    )


def make_global_mesh(
    n_shard: Optional[int] = None,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
) -> ShardMesh:
    """The ``"shard"`` mesh over every rank of the process group, each rank
    on its device of ``devices`` (default: a card each), with the default
    backend of the device (:func:`~besskge_tpu_torch.parallel.mesh.make_shard_mesh`)."""
    return make_shard_mesh(n_shard if n_shard is not None else dist.get_world_size(), devices)


def local_shard_range(mesh: ShardMesh) -> Tuple[int, int]:
    """[start, stop) table-shard indices owned by this process: its own."""
    return mesh.rank, mesh.rank + 1


def shard_batch_multihost(local_batch: Dict[str, Any], mesh: ShardMesh) -> Dict[str, torch.Tensor]:
    """This process's batch, ``(bps, 1, ...)`` arrays of its own shard (each
    process samples only its own column), on its device."""
    lo, hi = local_shard_range(mesh)
    out = {}
    for k, v in local_batch.items():
        if v.shape[1] != hi - lo:
            raise ValueError(
                f"Batch array '{k}' has {v.shape[1]} local shards; this process owns {hi - lo}"
            )
        out[k] = _tensor(v).to(mesh.device)
    return out


def shard_params_multihost(params: Dict[str, Any], mesh: ShardMesh) -> Dict[str, Any]:
    """Every process passes the same global params; each keeps its block of
    the entity table and the replicated rest
    (:func:`~besskge_tpu_torch.parallel.mesh.shard_params`)."""
    return shard_params(params, mesh)


# ---------------------------------------------------------------------------
# Local ranks for the tests and chip_smoke.py


def _module_of(fn: Callable) -> Tuple[str, str]:
    """(module name, directory to import it from) of a module-level function."""
    module = sys.modules[fn.__module__]
    path = Path(module.__file__).resolve()
    name = fn.__module__
    if name == "__main__":
        name = path.stem
    depth = name.count(".") + (path.stem == "__init__")
    root = path.parent
    for _ in range(depth):
        root = root.parent
    return name, str(root)


def _spawn(fn: Callable, n: int, args: Tuple = (), backend: str = "gloo",
           timeout: float = 60.0) -> List[Any]:
    """Run ``fn(*args)`` on ``n`` new local ranks of one ``backend`` process
    group (``file://`` rendezvous in a temporary directory: no port to race
    for) and return each rank's result, by rank. ``fn`` must be a
    module-level function of a module that imports without side effects;
    ``args`` and the results are pickled. Every rank is killed when one
    fails or when ``timeout`` seconds pass, and the call raises."""
    name, root = _module_of(fn)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root, str(Path(__file__).resolve().parents[2]), env.get("PYTHONPATH", "")])
    # The ranks share the host's cores: without a limit each would start a
    # thread per core.
    env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // n)))
    with tempfile.TemporaryDirectory() as tmp:
        job = Path(tmp)
        (job / "job.pkl").write_bytes(pickle.dumps((name, fn.__name__, args, backend, n)))
        logs = [job / f"rank{rank}.log" for rank in range(n)]
        procs = []
        for rank in range(n):
            with open(logs[rank], "wb") as log:
                procs.append(subprocess.Popen([sys.executable, "-m", __name__, str(job), str(rank)],
                                              env=env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            failed = [r for r, p in enumerate(procs) if p.poll() != 0]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        if failed:
            what = "timed out" if time.monotonic() > deadline else "failed"
            output = logs[failed[0]].read_text(errors="replace")
            raise RuntimeError(
                f"ranks {failed} of {n} {what} ({fn.__module__}.{fn.__name__});"
                f" rank {failed[0]}'s output:\n{output[-4000:]}"
            )
        return [pickle.loads((job / f"rank{r}.pkl").read_bytes()) for r in range(n)]


def _rank_main(job: Path, rank: int) -> None:
    import importlib

    name, fn_name, args, backend, n = pickle.loads((job / "job.pkl").read_bytes())
    fn = getattr(importlib.import_module(name), fn_name)
    initialize(f"file://{job / 'store'}", n, rank, backend=backend,
               device="cpu" if backend == "gloo" else None)
    try:
        result = fn(*args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    (job / f"rank{rank}.pkl").write_bytes(pickle.dumps(result))


if __name__ == "__main__":
    _rank_main(Path(sys.argv[1]), int(sys.argv[2]))
