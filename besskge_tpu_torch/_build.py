"""Build the port's native sources at first use and load them with ``ctypes``.

Each ``csrc/*.cu`` file of the port is compiled by one ``nvcc`` call, and the
repository's host-side C++ loops (``csrc/bess_host.cpp``, shared with the JAX
package) by one call of the host C++ compiler, into shared libraries with a
plain C interface under ``build/besskge_tpu_torch/`` at the root of the
checkout (``.gitignore`` lists ``build/``). A library's name carries a hash of
its source and of the flags, so an edited source is rebuilt and an unchanged
one is loaded as it is. Sources that need building are compiled in parallel,
one compiler process each, all started together. The compiler's output is
kept beside each library (``build_log``): for a CUDA source it holds
``ptxas``'s registers, shared memory and spills of every kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = [
    "BUILD_DIR", "CUDA_SOURCES", "HOST_FLAGS", "NVCC_FLAGS", "SOURCES", "build", "build_log",
    "check_launch", "find_nvcc", "load_library",
]

_CSRC = Path(__file__).resolve().parent / "csrc"
_REPO_CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: Where the shared libraries go: ``build/besskge_tpu_torch/`` beside the package.
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "besskge_tpu_torch"
#: Hopper only: ``sm_90a`` keeps wgmma/setmaxnreg available to later kernels;
#: ``-Xptxas -v`` reports each kernel's registers, shared memory and spills.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: Host C++ flags: position-independent, optimised, no CPU-specific code.
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")
#: Every CUDA source of the port, by library name.
CUDA_SOURCES = {
    "dense_adamw": _CSRC / "dense_adamw.cu",
    "l1_distance": _CSRC / "l1_distance.cu",
    "row_update": _CSRC / "row_update.cu",
}
#: Every native source, by library name: the CUDA kernels and the host loops.
SOURCES = {**CUDA_SOURCES, "bess_host": _REPO_CSRC / "bess_host.cpp"}
#: Where the CUDA toolkit is looked for when ``CUDA_HOME`` is not set.
DEFAULT_CUDA_HOME = "/usr/local/cuda"

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``DEFAULT_CUDA_HOME/bin``, then
    ``PATH``. Raises ``RuntimeError`` when there is none."""
    for home in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): the port's"
            " CUDA kernels are built on a machine with the CUDA toolkit"
        )
    return found


def _flags(name: str) -> tuple:
    return NVCC_FLAGS if name in CUDA_SOURCES else HOST_FLAGS


def host_compiler() -> str:
    """The host C++ compiler: Python's configured ``CXX``, else ``g++``."""
    return (sysconfig.get_config_var("CXX") or "g++").split()[0]


def library_path(name: str) -> Path:
    """Path of the library built from ``SOURCES[name]`` as it is now."""
    digest = hashlib.sha256(
        SOURCES[name].read_bytes() + " ".join(_flags(name)).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = tuple(SOURCES), nvcc: Optional[str] = None) -> Dict[str, Path]:
    """Compile each named source whose library is missing, one compiler
    process per source, all running at once. Returns the library paths.

    :param nvcc: CUDA compiler to use (default: :func:`find_nvcc`, looked up
        only when a CUDA source needs building).
    """
    names = list(names)
    paths = {name: library_path(name) for name in names}
    todo = [name for name in names if not paths[name].is_file()]
    if not todo:
        return paths
    if any(name in CUDA_SOURCES for name in todo):
        nvcc = nvcc or find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    try:
        for name in todo:
            compiler = nvcc if name in CUDA_SOURCES else host_compiler()
            # Write under a private name and rename: a concurrent build of
            # the same source never sees a half-written library.
            tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
            cmd = [compiler, *_flags(name), "-o", str(tmp), str(SOURCES[name])]
            procs.append((name, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
    except OSError:
        for _, tmp, proc in procs:
            proc.kill()
            proc.wait()
            tmp.unlink(missing_ok=True)
        raise
    failed = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            paths[name].with_suffix(".log").write_text(log)
            os.replace(tmp, paths[name])
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{SOURCES[name].name}:\n{log}")
    if failed:
        raise RuntimeError("native build failed for " + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """The compiler's output from building ``SOURCES[name]`` as it is now
    (empty when the library has not been built here)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def load_library(name: str, nvcc: Optional[str] = None) -> ctypes.CDLL:
    """The loaded library of ``SOURCES[name]``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name], nvcc)[name]))
            _loaded[name] = lib
        return lib


def check_launch(name: str, rc: int) -> None:
    """Raise when a kernel entry point returned a CUDA error (a refused
    launch never runs, and a later synchronisation would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
