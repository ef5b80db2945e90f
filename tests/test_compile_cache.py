"""utils/compile_cache.py: the env var wins; otherwise a fixed path."""

import os

import jax
import pytest

from bipymc_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def recorded(monkeypatch):
    """Record jax.config updates instead of applying them (the suite's
    own process must not start writing a cache)."""
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.__setitem__(name, value))
    return calls


def test_env_var_set_sets_no_directory(monkeypatch, recorded, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in recorded


def test_env_var_unset_uses_fixed_in_checkout_dir(monkeypatch, recorded):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable_compile_cache()
    want = os.path.join(REPO, "benchmarks", ".jax_cache")
    assert got == want == compile_cache.DEFAULT_CACHE_DIR
    assert recorded["jax_compilation_cache_dir"] == want
    assert recorded["jax_persistent_cache_min_compile_time_secs"] == 0.0


def test_default_dir_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "benchmarks/.jax_cache/" in f.read().split()
