"""Test configuration: JAX on a virtual 8-device CPU mesh, so
multi-device sharding paths are exercised without a GPU.

JAX_PLATFORMS=cuda selects the card instead, for the tests marked gpu:
    JAX_PLATFORMS=cuda python -m pytest tests -m gpu

Must run before any module imports jax.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
platforms = os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

# through jax.config as well, in case jax was imported before this file
jax.config.update("jax_platforms", platforms)

from gmap_gsnap.utils import jaxenv  # noqa: E402

jaxenv.enable_compilation_cache()

import pathlib

import pytest

REFERENCE = pathlib.Path("/root/reference")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips elsewhere (see the module "
        "docstring for running them on the card)")
    config.addinivalue_line("markers", "slow: long-running")


@pytest.fixture(scope="session")
def ref_tests() -> pathlib.Path:
    return REFERENCE / "tests"


@pytest.fixture
def gpu():
    """Skip unless JAX sees a GPU.  Decided when the test runs, never at
    import, so every pytest-xdist worker collects the same tests."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU")
