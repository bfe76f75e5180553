"""Persistent compilation cache location.

The reference binaries have no analog (quicklearn.cc starts training at
once); here every jitted grower compiles on first use, so the CLIs, the
driver and the tests keep XLA's compiled programs on disk.
"""

from __future__ import annotations

import os

#: the checkout's own cache directory (git-ignored), used when
#: ``JAX_COMPILATION_CACHE_DIR`` is not set
CHECKOUT_CACHE_DIR = os.path.normpath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".jax_cache")
)


def compile_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else the checkout's
    ``.jax_cache`` — a fixed path, since the path is part of what makes a
    later process find the cache."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
    directory is set here.  Idempotent."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)
    return compile_cache_dir()
