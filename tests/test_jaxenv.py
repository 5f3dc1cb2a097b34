"""Where the persistent compilation cache goes."""

import os

import jax
import pytest

from gmap_gsnap.utils import jaxenv

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("env_set", [True, False])
def test_cache_dir(env_set, monkeypatch, tmp_path, restore_cache_dir):
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
        want = str(tmp_path / "c")
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(CHECKOUT, ".jax_cache")
    assert jaxenv.cache_dir() == want
    jaxenv.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == want
    assert os.path.isdir(want)


def test_default_cache_is_gitignored():
    with open(os.path.join(CHECKOUT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
