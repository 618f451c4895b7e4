"""Test config: run on the CPU with 8 virtual devices so the multi-device
sharding paths are exercised without accelerator hardware.

Tests marked `gpu` need an NVIDIA GPU: they take the `gpu` fixture, which
skips them on any other platform (decided when the test runs, never at
import). `python chip_smoke.py` runs them on the card."""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# Compile cache: JAX_COMPILATION_CACHE_DIR when set (JAX reads it itself).
# Otherwise the package's default directory, READ-ONLY: the cache-WRITE
# path (executable.serialize() in put_executable_and_time) has segfaulted
# in long one-process runs once enough executables accumulate, while
# every test file passes in isolation. A CLI run warms the cache; the
# suite then only reads it.
if not jax.config.jax_compilation_cache_dir:
    from omp_bowtie2_prime_tpu.utils.jaxcfg import DEFAULT_CACHE_DIR

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e18)

_FULL_SUITE = {"on": False, "count": 0}


def pytest_collection_modifyitems(config, items):
    # Long one-process runs have crashed once a few hundred tests' worth
    # of compiled executables accumulate (in the cache write, then the
    # cache read, then backend_compile_and_load itself) while every file
    # passes in isolation: the fault tracks live executables in jaxlib.
    # Full-suite collections clear jax's caches every 150 tests so the
    # live-executable count stays below that threshold.
    if len(items) > 400:
        _FULL_SUITE["on"] = True


def pytest_runtest_teardown(item, nextitem):
    if _FULL_SUITE["on"]:
        _FULL_SUITE["count"] += 1
        if _FULL_SUITE["count"] % 150 == 0:
            jax.clear_caches()


@pytest.fixture
def gpu():
    """The NVIDIA GPU a `gpu`-marked test runs on; skips elsewhere."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (found {dev.platform}); "
                    "run on the card by `python chip_smoke.py`")
    return dev
