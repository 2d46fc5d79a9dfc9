"""Placement of the persistent compile cache by the entry points."""

import os

import jax
import pytest

from linrad_tpu.utils import compile_cache


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_is_left_to_jax(monkeypatch, tmp_path, restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_unset_uses_checkout_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    path = compile_cache.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_unset_path_is_fixed(monkeypatch, restore_cache_dir):
    """The path is part of the cache key: it may not depend on the
    process, the time or a temp directory."""
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    monkeypatch.setenv("TMPDIR", "/nonexistent-tmp")
    a = compile_cache.enable_compile_cache()
    b = compile_cache.enable_compile_cache()
    assert a == b
    assert not a.startswith("/nonexistent-tmp")
    assert os.path.basename(a) == compile_cache.CACHE_DIRNAME
