"""JAX runtime config: persistent compilation cache.

Device kernels here have a handful of fixed shapes, so caching compiled
executables across processes removes nearly all startup latency (analogous
to the reference paying index-load cost once via --mm/--shmem,
mm.h/shmem.h).

Where the cache lives: JAX_COMPILATION_CACHE_DIR when it is set (JAX reads
the variable itself, and no other directory is set here), otherwise a
fixed directory inside the checkout. The path is part of what makes a
cache hit, so it never moves between runs.
"""

from __future__ import annotations

import os

_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(_ROOT, ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent compile cache uses in this process."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache() -> None:
    """Point JAX's persistent compile cache at cache_dir(). A directory
    already configured (by JAX_COMPILATION_CACHE_DIR or by the caller,
    e.g. the test suite) is left as it is."""
    import jax

    if jax.config.jax_compilation_cache_dir:
        return
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
