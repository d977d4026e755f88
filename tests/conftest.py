"""Test harness config: run JAX on a virtual 8-device CPU mesh.

CPU tests run with `JAX_PLATFORMS=cpu` (set here when the environment does
not say otherwise); the CPU backend gets 8 virtual devices so the sharding
tests see a real multi-device mesh. Tests marked `gpu` need the card: they
skip here, and run on a GPU host with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu

(`python chip_smoke.py` is the end-to-end check on the card.)
"""

import os

import jax

jax.config.update("jax_num_cpu_devices", 8)
if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips on other platforms"
    )


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (decided at run time)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev
