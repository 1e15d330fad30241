"""Where JAX keeps its persistent compilation cache.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here overrides it.  Otherwise the cache lives at a fixed directory inside
the checkout (``<repo>/.jax_cache``, listed in ``.gitignore``), so that a
second process -- a test worker, a rerun of ``chip_smoke.py`` -- finds
what the first one compiled.
"""

from __future__ import annotations

import os

REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent cache uses in this process."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache_dir()
