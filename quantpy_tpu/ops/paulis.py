"""Pauli-basis transforms — the L1 core of the framework.

The reference library materializes the full n-qubit Pauli basis as a dense
(4^n, 2^n, 2^n) array and loops over it in Python for every bloch<->matrix
conversion (reference: quantpy/routines.py:14-19, quantpy/qobj.py:109-135),
which costs O(16^n) memory and kills batching.

Here the transform is expressed two ways, both jit/vmap friendly:

1. *Factored* per-qubit contractions (`bloch_to_matrix` / `matrix_to_bloch`):
   a chain of n small tensordots, O(n * 4^n) work per item, no basis
   materialization. Works for any qubit count.
2. A cached dense *Pauli transfer matrix* (`pauli_transfer_matrix`) mapping
   bloch -> vec(matrix) as a single (4^n, 4^n) complex matmul — the
   matmul path the estimators use for n <= PTM_MAX_QUBITS.

Conventions (identical to the reference):
- Pauli ordering I, X, Y, Z per qubit, lexicographic over qubits
  (reference: quantpy/routines.py:6-19).
- bloch vector b of a Hermitian A satisfies A = sum_i b_i P_i, i.e.
  b_i = Re Tr(P_i A) / 2^n  (reference: quantpy/qobj.py:126-135).
- vec() is COLUMN-stacking (reference: quantpy/routines.py:53-61).
"""

from __future__ import annotations

import functools
import math

import jax.numpy as jnp
import numpy as np

from ..config import cdtype, rdtype

__all__ = [
    "PAULI_1",
    "generate_pauli",
    "bloch_to_matrix",
    "matrix_to_bloch",
    "pauli_transfer_matrix",
    "pauli_transpose_signs",
    "vec",
    "unvec",
    "n_qubits_from_dim",
    "kron_all",
    "ptrace",
]

# Single-qubit Pauli basis [I, X, Y, Z], numpy-side master copy.
_PAULI_1_NP = np.array(
    [
        [[1, 0], [0, 1]],
        [[0, 1], [1, 0]],
        [[0, -1j], [1j, 0]],
        [[1, 0], [0, -1]],
    ],
    dtype=np.complex128,
)

PAULI_1 = _PAULI_1_NP  # public numpy constant


def n_qubits_from_dim(dim: int) -> int:
    """Number of qubits for a 2^n matrix dimension."""
    n = int(round(math.log2(dim)))
    if 2**n != dim:
        raise ValueError(f"Dimension {dim} is not a power of two")
    return n


@functools.lru_cache(maxsize=None)
def _pauli_basis_np(n_qubits: int) -> np.ndarray:
    """Dense (4^n, 2^n, 2^n) Pauli basis (numpy, complex128). Cached.

    Only used for small n (tests, transfer-matrix construction); the hot
    paths use the factored transform or the cached transfer matrix.
    """
    basis = _PAULI_1_NP
    for _ in range(n_qubits - 1):
        basis = np.kron(basis, _PAULI_1_NP)
    return basis


def generate_pauli(n_qubits: int) -> jnp.ndarray:
    """Dense Pauli basis as a (4^n, 2^n, 2^n) device array.

    API parity with reference quantpy/routines.py:14-19 (there: a list of
    2-D arrays; here: one stacked 3-D array).
    """
    return jnp.asarray(_pauli_basis_np(n_qubits), dtype=cdtype())


@functools.lru_cache(maxsize=None)
def pauli_transpose_signs(n_qubits: int) -> np.ndarray:
    """(4^n,) signs s with P_a^T = s_a P_a: -1 iff the multi-index contains
    an odd number of Y factors (sigma_y is the only antisymmetric Pauli).

    Lets transposition act directly on bloch vectors: bloch(rho^T) =
    signs * bloch(rho) — used by the bloch-space channel application."""
    idx = np.arange(4**n_qubits)
    y_count = np.zeros(4**n_qubits, dtype=np.int64)
    for _ in range(n_qubits):
        y_count += (idx % 4) == 2
        idx //= 4
    return np.where(y_count % 2 == 1, -1.0, 1.0)


# Maximum qubit count for which the dense (4^n, 4^n) transfer matrix is
# precomputed (n=6 -> 4096^2 complex64 = 134 MB; beyond that use factored).
PTM_MAX_QUBITS = 6


@functools.lru_cache(maxsize=None)
def _pauli_transfer_np(n_qubits: int) -> np.ndarray:
    """(4^n, 4^n) complex matrix M with M[:, i] = vec(P_i) (column-stacking)."""
    basis = _pauli_basis_np(n_qubits)  # (4^n, d, d)
    # vec(A) column-stacking = A.T.reshape(-1)
    return np.ascontiguousarray(basis.transpose(0, 2, 1).reshape(basis.shape[0], -1).T)


def pauli_transfer_matrix(n_qubits: int) -> jnp.ndarray:
    """Cached device copy of the bloch->vec(matrix) transfer matrix."""
    if n_qubits > PTM_MAX_QUBITS:
        raise ValueError(
            f"Dense Pauli transfer matrix capped at {PTM_MAX_QUBITS} qubits; "
            "use the factored bloch_to_matrix/matrix_to_bloch instead"
        )
    return jnp.asarray(_pauli_transfer_np(n_qubits), dtype=cdtype())


# Qubits are contracted in groups of this size by the factored transforms:
# the cached dense group basis is (4^g, 2^g, 2^g) = (64, 8, 8) at g=3 (tiny),
# while the einsum minor dimensions grow from 2/4 to 64/8; the group size
# was chosen for the earlier target's 128-lane tiles and is not measured on
# the H100 (ROADMAP C2). The math is identical (kron associativity); only
# the contraction order changes.
TRANSFORM_GROUP = 3


def group_sizes(n_qubits: int, group: int = TRANSFORM_GROUP) -> tuple[int, ...]:
    """Split n qubits into contraction groups of at most `group` qubits.

    A remainder of 1 is folded into the last full group as (2, 2) instead
    of (3, 1): a size-1 group would reintroduce the radix-4 minor
    dimensions the grouping exists to avoid."""
    full, rem = divmod(n_qubits, group)
    if rem == 1 and full >= 1:
        return (group,) * (full - 1) + (2, 2)
    return (group,) * full + ((rem,) if rem else ())


def _pauli_flat(dtype) -> jnp.ndarray:
    """(4, 4) matrix P4[i, a*2+b] = Pauli_i[a, b]."""
    return jnp.asarray(_PAULI_1_NP.reshape(4, 4), dtype=dtype)


def _group_basis_flat(g: int, dtype) -> jnp.ndarray:
    """(4^g, 4^g) matrix B[i, a*2^g+b] = (g-qubit Pauli basis)_i[a, b]."""
    return jnp.asarray(_pauli_basis_np(g).reshape(4**g, 4**g), dtype=dtype)


def bloch_to_matrix(bloch: jnp.ndarray, n_qubits: int | None = None) -> jnp.ndarray:
    """Convert bloch vectors (..., 4^n) to matrices (..., 2^n, 2^n).

    A = sum_i b_i P_i, computed as ceil(n/3) grouped contractions against
    cached (64, 8, 8) group bases — never materializes the O(16^n) n-qubit
    Pauli basis (replaces reference quantpy/qobj.py:109-118 which loops over
    all 4^n basis matrices).
    """
    bloch = jnp.asarray(bloch)
    if n_qubits is None:
        n_qubits = n_qubits_from_dim(int(round(math.sqrt(bloch.shape[-1]))))
    n = n_qubits
    dim = 2**n
    groups = group_sizes(n)
    k = len(groups)
    batch_shape = bloch.shape[:-1]
    ct = cdtype()
    t = bloch.astype(ct).reshape(batch_shape + tuple(4**g for g in groups))
    bdim = len(batch_shape)
    for g in groups:
        # contract the leading group axis; flat (a, b) axis appended last
        t = jnp.tensordot(t, _group_basis_flat(g, ct), axes=[[bdim], [0]])
    # t: batch + ((a1 b1), ..., (ak bk)); split pairs and regroup to (a.., b..)
    t = t.reshape(
        batch_shape + sum(((2**g, 2**g) for g in groups), ())
    )
    perm = (
        list(range(bdim))
        + [bdim + 2 * j for j in range(k)]
        + [bdim + 2 * j + 1 for j in range(k)]
    )
    return t.transpose(perm).reshape(batch_shape + (dim, dim))


def matrix_to_bloch(matrix: jnp.ndarray) -> jnp.ndarray:
    """Convert matrices (..., 2^n, 2^n) to bloch vectors (..., 4^n) (real).

    b_i = Re Tr(P_i A) / 2^n, contracted in 3-qubit groups (replaces
    reference quantpy/qobj.py:126-135).
    """
    matrix = jnp.asarray(matrix, dtype=cdtype())
    dim = matrix.shape[-1]
    n = n_qubits_from_dim(dim)
    groups = group_sizes(n)
    k = len(groups)
    batch_shape = matrix.shape[:-2]
    bdim = len(batch_shape)
    # Tr(P_i A) = sum_{ab} P_i[a, b] A[b, a]; arrange A as x[(a1 b1)...(ak bk)]
    # with value A[b.., a..]
    t = matrix.reshape(batch_shape + tuple(2**g for g in groups) * 2)
    # axes: batch, b1..bk, a1..ak -> batch, (a1, b1), (a2, b2), ...
    perm = list(range(bdim))
    for j in range(k):
        perm += [bdim + k + j, bdim + j]  # a_j then b_j
    t = t.transpose(perm).reshape(batch_shape + tuple(4**g for g in groups))
    for g in groups:
        t = jnp.tensordot(t, _group_basis_flat(g, cdtype()), axes=[[bdim], [1]])
    return (t.real / dim).reshape(batch_shape + (4**n,)).astype(rdtype())


def vec(matrix: jnp.ndarray) -> jnp.ndarray:
    """Column-stacking vectorization (reference quantpy/routines.py:59-61)."""
    matrix = jnp.asarray(matrix)
    batch_shape = matrix.shape[:-2]
    return jnp.swapaxes(matrix, -1, -2).reshape(batch_shape + (-1,))


def unvec(vector: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`vec` (reference quantpy/routines.py:53-56)."""
    vector = jnp.asarray(vector)
    batch_shape = vector.shape[:-1]
    d = int(round(math.sqrt(vector.shape[-1])))
    return jnp.swapaxes(vector.reshape(batch_shape + (d, d)), -1, -2)


def kron_all(matrices) -> jnp.ndarray:
    """Kronecker product of a sequence of matrices (left-to-right)."""
    out = jnp.asarray(matrices[0])
    for m in matrices[1:]:
        out = jnp.kron(out, jnp.asarray(m))
    return out


def ptrace(matrix: jnp.ndarray, keep, n_qubits: int | None = None) -> jnp.ndarray:
    """Partial trace keeping the qubits in `keep` (preserving their order
    as positions, like reference quantpy/qobj.py:145-165).

    Supports leading batch dimensions.
    """
    matrix = jnp.asarray(matrix)
    if n_qubits is None:
        n_qubits = n_qubits_from_dim(matrix.shape[-1])
    n = n_qubits
    keep = sorted(int(k) for k in keep)
    traced = [i for i in range(n) if i not in keep]
    batch_shape = matrix.shape[:-2]
    bdim = len(batch_shape)
    t = matrix.reshape(batch_shape + (2,) * (2 * n))
    # row (ket) axes: bdim..bdim+n-1 ; col (bra) axes: bdim+n..bdim+2n-1
    for idx, q in enumerate(traced):
        # after tracing `idx` qubits, axis positions shift
        row_ax = bdim + (q - sum(1 for t_ in traced[:idx] if t_ < q))
        n_rem = n - idx
        col_ax = row_ax + n_rem
        t = jnp.trace(t, axis1=row_ax, axis2=col_ax)
    d_keep = 2 ** len(keep)
    return t.reshape(batch_shape + (d_keep, d_keep))


# ---------------------------------------------------------------------------
# Host-side (numpy) variants of the factored transforms. The object layer
# (Qobj/Operator/Channel) is a lightweight host layer — single small matrices
# are host work — so it uses these instead of the jnp versions.
# ---------------------------------------------------------------------------


def np_bloch_to_matrix(bloch: np.ndarray, n_qubits: int | None = None) -> np.ndarray:
    """Numpy twin of :func:`bloch_to_matrix` (same factored algorithm)."""
    bloch = np.asarray(bloch)
    if n_qubits is None:
        n_qubits = n_qubits_from_dim(int(round(math.sqrt(bloch.shape[-1]))))
    n = n_qubits
    dim = 2**n
    batch_shape = bloch.shape[:-1]
    p4 = _PAULI_1_NP.reshape(4, 4)
    t = bloch.astype(np.complex128).reshape(batch_shape + (4,) * n)
    bdim = len(batch_shape)
    for _ in range(n):
        t = np.tensordot(t, p4, axes=[[bdim], [0]])
    t = t.reshape(batch_shape + (2, 2) * n)
    perm = (
        list(range(bdim))
        + [bdim + 2 * k for k in range(n)]
        + [bdim + 2 * k + 1 for k in range(n)]
    )
    return t.transpose(perm).reshape(batch_shape + (dim, dim))


def np_matrix_to_bloch(matrix: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`matrix_to_bloch` (same factored algorithm)."""
    matrix = np.asarray(matrix, dtype=np.complex128)
    dim = matrix.shape[-1]
    n = n_qubits_from_dim(dim)
    batch_shape = matrix.shape[:-2]
    bdim = len(batch_shape)
    t = matrix.reshape(batch_shape + (2,) * (2 * n))
    perm = list(range(bdim))
    for k in range(n):
        perm += [bdim + n + k, bdim + k]
    t = t.transpose(perm).reshape(batch_shape + (4,) * n)
    p4 = _PAULI_1_NP.reshape(4, 4)
    for _ in range(n):
        t = np.tensordot(t, p4, axes=[[bdim], [1]])
    return (t.real / dim).reshape(batch_shape + (4**n,))
