"""The port stands alone: it never imports ``jax`` or ``besskge_tpu``.

The machine with the card has no JAX, so a port module or ``chip_smoke.py``
that reached either would die on import there.
"""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import besskge_tpu_torch

ROOT = Path(__file__).resolve().parent.parent


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(besskge_tpu_torch.__path__, "besskge_tpu_torch.")
    )


def test_port_imports_without_jax():
    modules = ["besskge_tpu_torch", *_port_modules()]
    for name in ("bess", "native", "trainer", "optim", "loss", "scoring", "utils", "embedding",
                 "convert", "checkpoint", "ops.distance", "ops.l1_kernels", "ops.row_kernels",
                 "ops.adamw_kernels", "eval_loop", "pipeline", "dataset", "negative_sampler",
                 "parallel", "parallel.mesh", "parallel.collectives", "parallel.census",
                 "parallel.multihost", "monitor", "_hostmem", "fixtures", "schedules"):
        assert f"besskge_tpu_torch.{name}" in modules, name
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "from besskge_tpu_torch.scoring import ConvE\n"
        "assert ConvE.__module__ == 'besskge_tpu_torch.scoring'\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'besskge_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    result = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert result.returncode == 0, result.stderr
    assert result.stdout.startswith("ok")


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_of_the_port_names_jax():
    sources = [ROOT / "chip_smoke.py", ROOT / "bench_torch.py",
               *sorted((ROOT / "besskge_tpu_torch").rglob("*.py"))]
    for path in sources:
        roots = _imported_roots(path)
        assert not roots & {"jax", "jaxlib", "besskge_tpu", "ml_dtypes"}, (path, roots)
    assert _imported_roots(ROOT / "chip_smoke.py") <= {
        "__future__", "bench_torch", "gc", "graft_entry_torch", "json", "os", "subprocess", "sys",
        "tempfile", "threading", "time",
        "pathlib", "typing",
        "numpy", "torch", "besskge_tpu_torch",
    }


def test_bench_torch_imports_without_jax():
    """``bench_torch.py`` runs on the card's machine: importing it, and its
    runners' imports of the port, pull in no ``jax``, ``besskge_tpu``,
    ``bench`` or ``__graft_entry__``."""
    code = (
        "import sys, bench_torch\n"
        "import besskge_tpu_torch.parallel.multihost, besskge_tpu_torch.pipeline\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'besskge_tpu', 'optax', 'bench', '__graft_entry__'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    result = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert result.returncode == 0, result.stderr
    assert _imported_roots(ROOT / "bench_torch.py") <= {
        "__future__", "gc", "json", "os", "subprocess", "sys", "tempfile", "time", "pathlib",
        "typing", "numpy", "torch", "besskge_tpu_torch",
    }


def test_graft_entry_torch_imports_without_jax():
    """``graft_entry_torch.py`` (the entry points) runs on the card's
    machine: importing it pulls in no ``jax``, ``jaxlib``, ``besskge_tpu``,
    ``optax``, ``bench`` or ``__graft_entry__``."""
    code = (
        "import sys, graft_entry_torch\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'besskge_tpu', 'optax', 'bench', '__graft_entry__'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    result = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert result.returncode == 0, result.stderr
    assert _imported_roots(ROOT / "graft_entry_torch.py") <= {
        "__future__", "os", "sys", "typing", "numpy", "torch", "besskge_tpu_torch",
    }
