"""Test configuration: the CPU platform with 8 virtual devices.

Multi-device sharding logic is unit-tested on one host through XLA's
host-platform device-count override. Tests that need an NVIDIA GPU carry the
``gpu`` marker and skip here; ``python chip_smoke.py`` runs their cases on
the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# no persistent compilation cache for CPU test programs
jax.config.update("jax_enable_compilation_cache", False)

import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX runs on a GPU (decided here, at
    run time, so every test worker collects the same tests)."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this case on the card")
