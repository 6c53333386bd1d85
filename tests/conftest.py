"""Test configuration.

Tests run on CPU with an 8-device virtual mesh (to exercise multi-chip
sharding paths without accelerator hardware) and in x64 mode (for 1e-8-level parity
with the float64 reference). These env vars must be set before JAX initializes.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
# The CLI entry points turn on the persistent compile cache; tests compile
# in-process and write no cache.
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture(autouse=True, scope="module")
def _clear_jit_caches_between_modules():
    """Drop compiled executables after each test module.

    The full suite compiles thousands of programs in one process; the
    LLVM-JITted CPU executables each hold mmapped code pages, and past
    ~215 tests the process crosses vm.max_map_count (65530 here) — the
    next compilation segfaults inside XLA's backend_compile_and_load
    (measured round 4: deterministic crash in test_parallel at the same
    suite position, while every file-level subset passes alone). Clearing
    between modules bounds the live-executable count; the recompiles cost
    a few percent of suite runtime.
    """
    yield
    jax.clear_caches()
