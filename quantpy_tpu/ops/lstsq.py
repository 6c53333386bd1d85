"""Least-squares / pseudo-inverse primitives.

The reference forms the explicit normal-equation left inverse
(A^T A)^{-1} A^T (quantpy/routines.py:69-71). That squares the condition
number — fatal in float32 — so the default solve path here goes
through a (batched) solve instead, with the explicit inverse kept only
where downstream code genuinely needs the matrix (moment/Sugiyama
intervals inspect its entries).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["left_inverse", "lstsq_solve"]


def left_inverse(a: jnp.ndarray) -> jnp.ndarray:
    """Explicit left pseudo-inverse (A^T A)^{-1} A^T, batched.

    Semantics of reference quantpy/routines.py:69-71 (note: the reference
    uses A.T even for complex A; inputs here are real POVM/bloch matrices,
    where this equals the Moore-Penrose pseudo-inverse for full column rank).
    """
    a = jnp.asarray(a)
    at = jnp.swapaxes(a, -1, -2)
    return jnp.linalg.solve(at @ a, at)


def lstsq_solve(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve min ||A x - b||_2 via normal equations with a Cholesky-friendly
    solve (batched; stays on device matmuls). A: (..., m, n), b: (..., m) or
    (..., m, k)."""
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    at = jnp.swapaxes(a, -1, -2)
    gram = at @ a
    vec_input = b.ndim == a.ndim - 1
    if vec_input:
        b = b[..., None]
    x = jnp.linalg.solve(gram, at @ b)
    return x[..., 0] if vec_input else x
