"""Test configuration: run JAX on a virtual 8-device CPU mesh.

JAX_PLATFORMS and XLA_FLAGS are set before JAX creates a backend, and
the platform is also pinned in jax.config in case the caller's
environment imported JAX already.  Tests that need the GPU carry the
`gpu` marker and skip inside a fixture when there is none.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import bfc_jax  # noqa: E402,F401  (x64, compile-cache rule)


@pytest.fixture(autouse=True)
def _skip_without_gpu(request):
    """Skip `gpu`-marked tests: this configuration pins JAX to the CPU."""
    if request.node.get_closest_marker("gpu") is not None:
        if jax.default_backend() != "gpu":
            pytest.skip("needs a GPU; run on the card with `python chip_smoke.py`")
