"""Where JAX keeps its persistent compilation cache.

If `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing
here changes any setting. Otherwise the cache goes to a fixed directory
inside the checkout (`build/jax_cache`, git-ignored): the path is part of
the cache key, so a fixed path is what lets a later process hit it.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, "build", "jax_cache")


def compile_cache_dir(environ=None) -> str:
    """The cache directory for this process's environment."""
    environ = os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX at `compile_cache_dir()`; returns the directory."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
