"""Persistent XLA compile cache for the program's entry points.

The megakernel is one large program per (scene class, resolution, knob)
combination; without a cache every cold process compiles it again. The
entry points (``bench.py``, ``chip_smoke.py``, ``python -m
ray_tracer_2_tpu``, the viewer server) call :func:`enable_compile_cache`
once at start-up. Importing the package does not, so tests never write a
cache.
"""
from __future__ import annotations

import os
from pathlib import Path

#: fixed in-repo default (listed in .gitignore); a fixed path matters
#: because the cache key includes it
REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and it is
    left alone; otherwise the cache goes to ``<repo>/.jax_cache``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    return str(REPO_CACHE_DIR)
