"""Where the persistent compilation cache goes (utils/cache.py)."""

import jax
import pytest

from verticut_tpu.utils import cache


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs",
            "jax_persistent_cache_min_entry_size_bytes")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_cache_defaults_to_repo_dir(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    path = cache.enable_compilation_cache()
    assert path == cache.DEFAULT_DIR
    assert path.endswith(".jax_cache")
    assert jax.config.jax_compilation_cache_dir == cache.DEFAULT_DIR


def test_cache_env_var_sets_no_dir(monkeypatch, tmp_path,
                                   restore_cache_config):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself: the
    program sets no directory of its own."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert cache.enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None
