"""JAX environment helpers: the persistent compilation cache.

The CLIs recompile the alignment pipeline on every process start; the
persistent compilation cache makes repeat invocations fast (XLA reloads
the compiled executable instead of re-tracing/compiling).
"""

from __future__ import annotations

import os

# <checkout>/.jax_cache: a fixed path, because the path is part of the
# cache key (listed in .gitignore)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compilation_cache() -> None:
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
