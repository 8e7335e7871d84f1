"""Compile-cache placement (runtime/compile_cache.py)."""

import os

import jax

from henjou.runtime import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_wins_and_nothing_is_set(monkeypatch):
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert compile_cache.compile_cache_dir() == "/elsewhere/cache"
    assert compile_cache.enable_compile_cache() == "/elsewhere/cache"
    assert calls == []


def test_default_is_a_fixed_ignored_dir_in_the_checkout(monkeypatch):
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(ROOT, "build", "jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "build/" in f.read().split()
