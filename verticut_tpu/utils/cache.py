"""Persistent XLA compilation cache.

MIH search compiles one program per (radius-group, batch-bucket, cap)
combination. The persistent cache lets every later process on the same
machine start warm, which matters for CLI tools, the serving front-end and
repeated benchmark runs.
"""

from __future__ import annotations

import os

#: the cache directory when ``JAX_COMPILATION_CACHE_DIR`` is unset; a fixed
#: path, because the path is part of every cache key
DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn the persistent cache on and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
    directory is set here; otherwise the cache is ``<repo>/.jax_cache``."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
