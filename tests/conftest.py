"""Test configuration: force a virtual 8-device CPU mesh.

Logic/parity tests run on the CPU backend; mesh-sharding tests use the 8
virtual devices (SURVEY.md section 4 "multi-node testing"). XLA_FLAGS and
the platform must be set before jax initializes a backend.

Tests marked `gpu` need an NVIDIA GPU: they skip here, and run on a GPU
host with `EMOSAIC_TEST_GPU=1 python -m pytest tests -m gpu`, which keeps
the default (GPU) platform instead of forcing the CPU.
"""

import os

import pytest

if os.environ.get("EMOSAIC_TEST_GPU") != "1":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if os.environ.get("EMOSAIC_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when the process has none.
    Decided here, at run time — never while a module is imported."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (this process runs on {dev.platform})")
    return dev
