"""Test configuration: force an 8-device virtual CPU mesh.

Multi-device BESS tests run on CPU with
``--xla_force_host_platform_device_count=8`` (the TPU analog of the
reference's IPUModel emulator tests, ``/root/reference/tests/test_bess.py:126``).

This environment may pre-register a TPU backend at interpreter start (before
pytest loads), so we clear the already-initialized backends and re-initialize
on the CPU platform.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402
import jax._src.xla_bridge as xb  # noqa: E402

try:
    xb._clear_backends()
except Exception:
    pass
jax.config.update("jax_platforms", "cpu")

assert jax.default_backend() == "cpu", jax.default_backend()
assert len(jax.devices()) >= 8, jax.devices()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA CUDA card and nvcc; skipped without a card"
    )
