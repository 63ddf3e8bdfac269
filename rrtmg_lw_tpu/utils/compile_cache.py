"""JAX's persistent compilation cache, in one place.

When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
helper leaves that setting alone.  Otherwise the cache lives at the
fixed ``<repo>/.jax_cache`` (listed in ``.gitignore``): the path is part
of the cache key, so a directory that moves never hits.
"""

from __future__ import annotations

import os
import pathlib

REPO_CACHE = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Point JAX's persistent compile cache at its directory and return
    that directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(REPO_CACHE)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path
