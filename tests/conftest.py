"""Test harness config (SURVEY.md §4.4).

When JAX_PLATFORMS is unset, the suite runs on the CPU backend with 8
virtual devices, so mesh/sharding/psum tests run in plain pytest on any
machine.  A JAX_PLATFORMS the caller set is respected: the card-only tests
(marker ``gpu``) run with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

and skip elsewhere.  Whether a card is present is decided inside the
``gpu_device`` fixture, never while a module is imported.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first JAX device if it is a GPU; skips the test otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX has {dev.platform!r} "
                    f"(run with JAX_PLATFORMS=cuda -m gpu on the card)")
    return dev
