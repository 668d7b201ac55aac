"""Test configuration.

Runs the suite on CPU with 8 virtual devices so the multi-device sharding
layer (lsqr_tpu.parallel) is exercised without several cards, and enables
x64 — the conformance precision that reproduces the reference's real64
iteration counts (reference test strategy: SURVEY.md §4;
/root/reference/test/lsqrtest_module.f90).

``JAX_PLATFORMS`` picks the platform and defaults to ``cpu``. The tests
marked ``gpu`` need a card; they skip, from the ``gpu`` fixture, where JAX
finds none. On a machine with a card run them with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture
def rng():
    import numpy as np

    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX finds none."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda,cpu "
                    "on a machine with a card)")
    return devices[0]
