"""Test configuration: CPU execution with a virtual 8-device mesh.

Tests run on the CPU unless JAX_PLATFORMS names another platform. Tests
that need an NVIDIA GPU carry the `gpu` marker and take the `gpu` fixture,
which skips them when JAX finds no GPU; run them on the card with
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

REFERENCE = "/root/reference"


@pytest.fixture(scope="session")
def reference_dir():
    if not os.path.isdir(REFERENCE):
        pytest.skip("reference repo not mounted")
    return REFERENCE


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; run on the card with "
                    "JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")
