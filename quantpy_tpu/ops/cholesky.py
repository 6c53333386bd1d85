"""Cholesky (real-vector) parametrization of PSD matrices — batched.

Matches the reference layout exactly (quantpy/routines.py:84-101):
for a d x d matrix the parameter vector is

    [diag_0 .. diag_{d-1},
     Re(strictly-lower entries, row-major tril order),
     Im(strictly-lower entries, row-major tril order)]

of total length d + d*(d-1). The matrix is recovered as L @ L^H.
All functions support leading batch dimensions and are jit/vmap safe.
"""

from __future__ import annotations

import functools
import math

import jax.numpy as jnp
import numpy as np

from ..config import cdtype, rdtype

__all__ = [
    "real_tril_vec_to_matrix",
    "matrix_to_real_tril_vec",
    "tril_param_dim",
    "matrix_dim_from_param",
]


def tril_param_dim(d: int) -> int:
    """Length of the parameter vector for a d x d matrix: d + d(d-1)."""
    return d * d


def matrix_dim_from_param(length: int) -> int:
    """Matrix dimension from parameter-vector length (solves d^2 = length,
    as in reference quantpy/routines.py:93)."""
    d = int(round(math.sqrt(length)))
    if d * d != length:
        raise ValueError(f"Invalid Cholesky parameter length {length}")
    return d


@functools.lru_cache(maxsize=None)
def _tril_indices_np(d: int):
    rows, cols = np.tril_indices(d, -1)
    return rows.astype(np.int32), cols.astype(np.int32)


def real_tril_vec_to_matrix(vector: jnp.ndarray, d: int | None = None) -> jnp.ndarray:
    """Restore L @ L^H from the real parameter vector (..., d^2)
    (reference quantpy/routines.py:93-101). Batched.
    """
    vector = jnp.asarray(vector, dtype=rdtype())
    if d is None:
        d = matrix_dim_from_param(vector.shape[-1])
    batch_shape = vector.shape[:-1]
    n_off = d * (d - 1) // 2
    diag = vector[..., :d]
    re = vector[..., d : d + n_off]
    im = vector[..., d + n_off :]
    rows, cols = _tril_indices_np(d)
    tril = jnp.zeros(batch_shape + (d, d), dtype=cdtype())
    tril = tril.at[..., rows, cols].set(re + 1j * im)
    didx = jnp.arange(d)
    tril = tril.at[..., didx, didx].set(diag.astype(cdtype()))
    return tril @ jnp.swapaxes(tril.conj(), -1, -2)


def matrix_to_real_tril_vec(matrix: jnp.ndarray) -> jnp.ndarray:
    """Parametrize a PSD Hermitian matrix via its (lower) Cholesky factor
    (reference quantpy/routines.py:84-90). Batched.

    Note: like the reference, this requires strict positive definiteness;
    callers should clip eigenvalues first (e.g. via make-feasible) for
    boundary states.
    """
    matrix = jnp.asarray(matrix, dtype=cdtype())
    d = matrix.shape[-1]
    tril = jnp.linalg.cholesky(matrix)
    rows, cols = _tril_indices_np(d)
    didx = jnp.arange(d)
    diag = tril[..., didx, didx].real.astype(rdtype())
    off = tril[..., rows, cols]
    return jnp.concatenate(
        [diag, off.real.astype(rdtype()), off.imag.astype(rdtype())], axis=-1
    )


# ---------------------------------------------------------------------------
# Host-side (numpy) twins, for object-layer / interval-setup code that works
# on single small matrices on the host.
# ---------------------------------------------------------------------------


def np_matrix_to_real_tril_vec(matrix: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`matrix_to_real_tril_vec`."""
    matrix = np.asarray(matrix, dtype=np.complex128)
    d = matrix.shape[-1]
    tril = np.linalg.cholesky(matrix)
    rows, cols = _tril_indices_np(d)
    didx = np.arange(d)
    diag = tril[..., didx, didx].real
    off = tril[..., rows, cols]
    return np.concatenate([diag, off.real, off.imag], axis=-1)


def np_real_tril_vec_to_matrix(vector: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`real_tril_vec_to_matrix`."""
    vector = np.asarray(vector, dtype=np.float64)
    d = matrix_dim_from_param(vector.shape[-1])
    batch_shape = vector.shape[:-1]
    n_off = d * (d - 1) // 2
    diag = vector[..., :d]
    re = vector[..., d : d + n_off]
    im = vector[..., d + n_off :]
    rows, cols = _tril_indices_np(d)
    tril = np.zeros(batch_shape + (d, d), dtype=np.complex128)
    tril[..., rows, cols] = re + 1j * im
    didx = np.arange(d)
    tril[..., didx, didx] = diag
    return tril @ np.swapaxes(tril.conj(), -1, -2)
