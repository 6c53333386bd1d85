"""Batched parametric-bootstrap core — the flagship workload.

The reference's BootstrapStateInterval re-simulates and re-estimates
experiments one at a time in a Python loop (reference
quantpy/tomography/interval.py:598-612, ~5 hours for 1000 4-qubit MLE
resamples). Here the whole bootstrap is ONE jitted program:

    counts  ~ Multinomial(povm, bloch_est)        # (B, m, p) in one draw
    blochs  = estimate(counts)                    # vmapped lin / MLE
    dists   = dst(rho(blochs), rho(bloch_est))    # batched eigh/Frobenius

Everything crosses the host<->device boundary as real arrays.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import rdtype
from ..ops import geometry
from ..ops.paulis import bloch_to_matrix
from . import state_core

__all__ = ["bootstrap_distances", "bootstrap_blochs"]


@functools.partial(jax.jit, static_argnames=("name", "n_qubits"))
def _distance_batch(name: str, blochs, bloch_ref, n_qubits: int):
    """Batched distance between bloch-encoded states; jitted, so complex
    intermediates stay inside one compiled program.

    The Hilbert-Schmidt distance never leaves bloch space: Pauli
    orthogonality gives ||A - B||_F^2 = 2^n * sum_i (a_i - b_i)^2, so
    hs = sqrt(2^n * sum diff^2 / 2) with no matrix materialization
    (verified equal to the matrix path to 4e-8)."""
    blochs = jnp.asarray(blochs, rdtype())
    bloch_ref = jnp.asarray(bloch_ref, rdtype())
    if name == "hs":
        diff = blochs - bloch_ref
        d = jnp.sqrt((2**n_qubits) * jnp.sum(diff**2, axis=-1) / 2.0)
        return jnp.where(d < geometry.SNAP_EPS, 0.0, d)
    rho_b = bloch_to_matrix(blochs, n_qubits)
    rho_r = bloch_to_matrix(bloch_ref, n_qubits)
    fn = geometry.resolve_distance(name)
    return fn(rho_b, rho_r)


@functools.partial(jax.jit, static_argnames=("name", "n_qubits"))
def tril_samples_distance(name: str, tril_vecs, bloch_ref, n_qubits: int):
    """Distance of Cholesky-parametrized samples (trace-normalized) to a
    reference state — used by the MHMC state interval."""
    from ..ops.cholesky import real_tril_vec_to_matrix
    from ..ops.paulis import matrix_to_bloch

    rho = real_tril_vec_to_matrix(jnp.asarray(tril_vecs, rdtype()), 2**n_qubits)
    tr = jnp.trace(rho, axis1=-2, axis2=-1).real
    blochs = matrix_to_bloch(rho) / tr[..., None]
    return _distance_batch(name, blochs, bloch_ref, n_qubits)


@functools.partial(
    jax.jit,
    static_argnames=("n_points", "method", "dst", "max_iter", "physical", "init", "tol"),
)
def bootstrap_distances(
    key,
    bloch_est,
    povm_matrix,
    n_measurements,
    n_points: int,
    method: str = "lin",
    dst: str = "hs",
    max_iter: int = 100,
    physical: bool = True,
    init: str = "lin",
    tol: float = 1e-3,
):
    """Simulate + re-estimate `n_points` experiments from `bloch_est` and
    return UNSORTED distances to it (sort host-side or via jnp.sort).

    All-real signature: bloch_est (D,), povm_matrix (m, p, D),
    n_measurements (m,). Returns (n_points,) distances. `physical`, `init`
    and `tol` are forwarded to the per-resample estimator exactly as the
    reference forwards them (reference interval.py:600-609).
    """
    povm_matrix = jnp.asarray(povm_matrix, dtype=rdtype())
    bloch_est = jnp.asarray(bloch_est, dtype=rdtype())
    import math

    n_qubits = int(round(math.log2(povm_matrix.shape[-1]) / 2))
    blochs = jnp.broadcast_to(bloch_est, (n_points,) + bloch_est.shape)
    counts = state_core.simulate_experiment(key, povm_matrix, blochs, n_measurements)
    est = state_core.estimate(
        counts, povm_matrix, n_measurements, method=method, max_iter=max_iter,
        physical=physical, init=init, tol=tol,
    )
    return _distance_batch(dst, est, bloch_est, n_qubits)


@functools.partial(
    jax.jit,
    static_argnames=("n_points", "method", "max_iter", "physical", "init", "tol"),
)
def bootstrap_blochs(
    key,
    bloch_est,
    povm_matrix,
    n_measurements,
    n_points: int,
    method: str = "lin",
    max_iter: int = 100,
    physical: bool = True,
    init: str = "lin",
    tol: float = 1e-3,
):
    """Like :func:`bootstrap_distances` but returns the re-estimated bloch
    vectors (n_points, D) — used by process bootstrap and calibration."""
    povm_matrix = jnp.asarray(povm_matrix, dtype=rdtype())
    bloch_est = jnp.asarray(bloch_est, dtype=rdtype())
    blochs = jnp.broadcast_to(bloch_est, (n_points,) + bloch_est.shape)
    counts = state_core.simulate_experiment(key, povm_matrix, blochs, n_measurements)
    return state_core.estimate(
        counts, povm_matrix, n_measurements, method=method, max_iter=max_iter,
        physical=physical, init=init, tol=tol,
    )
