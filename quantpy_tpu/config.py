"""Precision, device and compile-cache configuration for quantpy-tpu.

The default is single precision (float32/complex64). For parity tests
against the CPU reference (which runs in float64/complex128, see reference
quantpy/routines.py) an x64 mode is provided via :func:`enable_x64`.

All numeric modules in this package derive their dtypes from the *current* JAX
x64 flag through :func:`rdtype`/:func:`cdtype`, so flipping the flag switches
the whole framework's precision coherently.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax
import jax.numpy as jnp

__all__ = [
    "enable_x64",
    "is_x64",
    "rdtype",
    "cdtype",
    "set_matmul_precision",
    "use_compile_cache",
]

#: persistent compile cache used when JAX_COMPILATION_CACHE_DIR is unset:
#: a fixed path in the checkout, so one run's compiled programs are found
#: again by the next (the cache key includes the path)
DEFAULT_COMPILE_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def set_matmul_precision(precision: str = "highest") -> None:
    """Set the global matmul precision.

    'highest' keeps float32 matmuls in full float32 arithmetic; on NVIDIA
    GPUs it rules out TF32, which keeps only about three decimal digits of
    each operand. Reduced-precision matmuls cost tomography accuracy: the
    RrhoR MLE's likelihood ratios f/p amplify operand rounding, and the
    bootstrap distance distribution it feeds sits at the 1e-3 scale.
    Called with 'highest' on package import.
    """
    jax.config.update("jax_default_matmul_precision", precision)


def use_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a fixed directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets nothing. Otherwise the cache goes to ``<checkout>/.jax_cache``,
    derived from the package's own location. Returns the directory in
    use. Importing the package does not call this: entry points
    (``bench.py``, ``chip_smoke.py``, the CLIs) do.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(DEFAULT_COMPILE_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def enable_x64(enable: bool = True) -> None:
    """Globally enable/disable 64-bit precision (float64/complex128)."""
    jax.config.update("jax_enable_x64", enable)


def is_x64() -> bool:
    """Whether 64-bit mode is currently active."""
    return bool(jax.config.jax_enable_x64)


def rdtype() -> jnp.dtype:
    """Current default real dtype (float32, or float64 in x64 mode)."""
    return jnp.dtype(jnp.float64 if is_x64() else jnp.float32)


def cdtype() -> jnp.dtype:
    """Current default complex dtype (complex64, or complex128 in x64 mode)."""
    return jnp.dtype(jnp.complex128 if is_x64() else jnp.complex64)

