import os

# The unit suite runs on the CPU backend, with a virtual 8-device mesh for
# the sharding tests; chip_smoke.py runs the device paths on the GPU.
# jax.config is applied before any backend is initialized, so the CPU
# choice holds whatever JAX_PLATFORMS says.
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")

import pathlib

import pytest

CAMINANDES = pathlib.Path(
    "/root/reference/test/excerpt_(CC)_caminandes.com_640x360.hevc")


@pytest.fixture(scope="session")
def caminandes_bytes() -> bytes:
    return CAMINANDES.read_bytes()
