"""Test harness.

By default everything runs on the CPU backend with 8 virtual devices, so the
sharding logic is exercised without a card. Tests marked ``gpu`` need an
NVIDIA GPU; they skip elsewhere and run on the card with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
"""

import os

# CPU unless the caller names another JAX platform. Set before jax is
# imported: backends read the platform list when they first initialize.
if os.environ.get("JAX_PLATFORMS", "") in ("", "cpu"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if jax.default_backend() == "cpu":
    assert jax.device_count() == 8, "tests expect 8 virtual CPU devices"

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (compiled kernels); skips "
                   "on other backends")


@pytest.fixture()
def gpu():
    """Skip unless JAX's backend is a GPU. Decided here, at run time, so
    every worker collects the same tests."""
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU; the JAX backend here is "
                    f"{jax.default_backend()!r}")


@pytest.fixture()
def rng():
    # Function-scoped so tests are order-independent (a shared mutable RNG
    # made results depend on which test files ran first).
    return np.random.RandomState(42)
