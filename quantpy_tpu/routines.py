"""Compatibility module mirroring reference quantpy/routines.py.

Every helper the reference exposes here has a batched equivalent in
`quantpy_tpu.ops`; this module re-exports them under the reference's names
(including the underscore-private ones that the reference's notebooks and
downstream code import directly) so migrating code keeps working.
"""

from __future__ import annotations

import numpy as np

from .ops.cholesky import (
    matrix_to_real_tril_vec as _matrix_to_real_tril_vec_dev,
    np_matrix_to_real_tril_vec,
    np_real_tril_vec_to_matrix,
    real_tril_vec_to_matrix as _real_tril_vec_to_matrix_dev,
)
from .ops.lstsq import left_inverse
from .ops.paulis import PAULI_1, generate_pauli

__all__ = [
    "generate_pauli",
    "generate_single_entries",
    "kron",
    "join_gates",
]

_SIGMA_I, _SIGMA_X, _SIGMA_Y, _SIGMA_Z = (
    PAULI_1[0],
    PAULI_1[1],
    PAULI_1[2],
    PAULI_1[3],
)


def generate_single_entries(dim: int) -> list:
    """All dim x dim matrices with a single unit entry
    (reference routines.py:22-31)."""
    out = []
    for i in range(dim):
        for j in range(dim):
            e = np.zeros((dim, dim), dtype=np.complex128)
            e[i, j] = 1.0
            out.append(e)
    return out


def kron(a, b):
    """Kronecker product of two quantum objects (reference routines.py:34-36)."""
    return a.kron(b)


def join_gates(gates):
    """Compose gates applied left-to-right (reference routines.py:39-44)."""
    out = gates[0]
    for g in gates[1:]:
        out = g @ out
    return out


def _vec2mat(vector):
    """Column-stacking un-vectorization (reference routines.py:53-56)."""
    vector = np.asarray(vector)
    d = int(round(np.sqrt(vector.shape[-1])))
    return vector.reshape(vector.shape[:-1] + (d, d)).swapaxes(-1, -2)


def _mat2vec(matrix):
    """Column-stacking vectorization (reference routines.py:59-61)."""
    matrix = np.asarray(matrix)
    return matrix.swapaxes(-1, -2).reshape(matrix.shape[:-2] + (-1,))


def _density(psi):
    """|psi><psi| (reference routines.py:64-66)."""
    psi = np.asarray(psi, dtype=np.complex128).reshape(-1)
    return np.outer(psi, psi.conj())


def _left_inv(a):
    """(A^T A)^{-1} A^T (reference routines.py:69-71). Host numpy."""
    a = np.asarray(a)
    return np.linalg.solve(a.T @ a, a.T)


def _real_to_complex(z):
    """Real (2n,) -> complex (n,) (reference routines.py:74-76)."""
    z = np.asarray(z)
    n = z.shape[-1] // 2
    return z[..., :n] + 1j * z[..., n:]


def _complex_to_real(z):
    """Complex (n,) -> real (2n,) (reference routines.py:79-81)."""
    z = np.asarray(z)
    return np.concatenate([z.real, z.imag], axis=-1)


# Cholesky parametrization: host twins (device versions live in ops.cholesky)
_matrix_to_real_tril_vec = np_matrix_to_real_tril_vec
_real_tril_vec_to_matrix = np_real_tril_vec_to_matrix

# device variants, exported under explicit names
matrix_to_real_tril_vec = _matrix_to_real_tril_vec_dev
real_tril_vec_to_matrix = _real_tril_vec_to_matrix_dev
left_inv_device = left_inverse
