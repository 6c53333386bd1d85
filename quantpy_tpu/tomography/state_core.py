"""Functional core of quantum state tomography — pure, jitted, batched.

This module replaces the scalar hot loops of reference
quantpy/tomography/state.py:71-273 with batch-first device code:

- `experiment_probabilities` / counts simulation: reference state.py:109-114
- `estimate_lin`: linear inversion, reference state.py:191-202
- `make_feasible`: eigh clip + renormalize, reference state.py:267-273
- `nll_tril` / `estimate_mle_chol`: Cholesky-parametrized MLE with *analytic*
  gradients (reference state.py:204-229 uses finite-difference BFGS)
- `estimate_mle_rhor`: RrhoR fixed-point maximum-likelihood iteration
  (Hradil's iterative MLE) — the batched MLE path: each step is one
  (K, 4^n) matvec + one bloch->matrix transform + two d x d matmuls,
  vmappable over thousands of experiments.

Every function takes/returns REAL arrays (bloch vectors, counts, Cholesky
parameter vectors); complex density matrices exist only inside the jitted
computations.

Shape conventions:
- povm_matrix: (m, p, D) real, D = 4^n — bloch rows
- n_measurements: (m,) shots per POVM
- counts / results: (..., m, p) real
- bloch: (..., D) real
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import rdtype
from ..ops.cholesky import matrix_to_real_tril_vec, real_tril_vec_to_matrix
from ..ops.paulis import bloch_to_matrix, matrix_to_bloch, n_qubits_from_dim
from ..ops.rhor_sandwich import (
    rhor_sandwich,
    rhor_sandwich_xla,
    sandwich_kernel_applies,
)
from ..ops.sampling import sample_multinomial

__all__ = [
    "weighted_povm_flat",
    "experiment_probabilities",
    "simulate_experiment",
    "estimate_lin",
    "make_feasible_bloch",
    "nll_bloch",
    "nll_tril",
    "estimate_mle_chol",
    "estimate_mle_rhor",
    "estimate",
]

_NLL_EPS = 1e-10  # probability floor in the log (reference state.py:219)


def _n_qubits_of_povm(povm_matrix) -> int:
    import math

    return n_qubits_from_dim(int(round(math.sqrt(povm_matrix.shape[-1]))))


def weighted_povm_flat(povm_matrix, n_measurements):
    """Flatten (m, p, D) -> (m*p, D) with rows of POVM m scaled by
    n_m / sum(n) (the reweighting of reference state.py:194-197)."""
    povm_matrix = jnp.asarray(povm_matrix, dtype=rdtype())
    n_measurements = jnp.asarray(n_measurements, dtype=rdtype())
    w = n_measurements / jnp.sum(n_measurements)
    scaled = povm_matrix * w[:, None, None]
    return scaled.reshape(-1, povm_matrix.shape[-1])


def experiment_probabilities(povm_matrix, bloch):
    """Outcome probabilities p[..., m, o] = 2^n * (povm . bloch)
    (reference state.py:109), clipped to [0, 1]."""
    povm_matrix = jnp.asarray(povm_matrix, dtype=rdtype())
    bloch = jnp.asarray(bloch, dtype=rdtype())
    dim = jnp.sqrt(jnp.asarray(povm_matrix.shape[-1], dtype=rdtype()))
    probs = jnp.einsum("mod,...d->...mo", povm_matrix, bloch) * dim
    return jnp.clip(probs, 0.0, 1.0)


@jax.jit
def simulate_experiment(key, povm_matrix, bloch, n_measurements):
    """Draw multinomial outcome counts for one or a batch of states.

    Returns counts with shape (batch..., m, p). Replaces the per-POVM
    Python loop of reference state.py:111-114 with one batched draw.
    """
    probs = experiment_probabilities(povm_matrix, bloch)
    n = jnp.broadcast_to(
        jnp.asarray(n_measurements, dtype=rdtype()), probs.shape[:-1]
    )
    return sample_multinomial(key, n, probs)


@functools.partial(jax.jit, static_argnames=("n_qubits",))
def make_feasible_bloch(bloch, n_qubits: int):
    """Project onto physical states: clip eigenvalues to EPS, renormalize
    trace (reference state.py:267-273). Batched; real in/out."""
    eps = 1e-15
    rho = bloch_to_matrix(bloch, n_qubits)
    evals, evecs = jnp.linalg.eigh(rho)
    evals = jnp.maximum(evals, eps)
    evals = evals / jnp.sum(evals, axis=-1, keepdims=True)
    rho = (evecs * evals[..., None, :].astype(evecs.dtype)) @ jnp.swapaxes(
        evecs.conj(), -1, -2
    )
    return matrix_to_bloch(rho)


@functools.partial(jax.jit, static_argnames=("physical",))
def estimate_lin(counts, povm_matrix, n_measurements, physical: bool = True):
    """Linear-inversion estimate (reference state.py:191-202), batched.

    Solves the weighted least-squares system with a Gram solve (batched matmuls)
    instead of the explicit (A^T A)^{-1} A^T of reference routines.py:69-71.

    Parameters
    ----------
    counts : (..., m, p) outcome counts
    povm_matrix : (m, p, D)
    n_measurements : (m,)

    Returns
    -------
    bloch : (..., D)
    """
    counts = jnp.asarray(counts, dtype=rdtype())
    n_qubits = _n_qubits_of_povm(povm_matrix)
    a = weighted_povm_flat(povm_matrix, n_measurements)  # (K, D)
    freq = counts.reshape(counts.shape[:-2] + (-1,))
    freq = freq / jnp.sum(freq, axis=-1, keepdims=True)  # (..., K)
    gram = a.T @ a  # (D, D)
    rhs = jnp.einsum("kd,...k->...d", a, freq)
    bloch = jnp.linalg.solve(gram, rhs[..., None])[..., 0] / (2**n_qubits)
    if physical:
        bloch = make_feasible_bloch(bloch, n_qubits)
    return bloch


def nll_bloch(bloch, povm_flat_w, frequencies, n_qubits: int):
    """Negative log-likelihood of a bloch vector given weighted POVM rows
    and count fractions (reference state.py:217-229)."""
    probs = povm_flat_w @ bloch * (2**n_qubits)
    return -jnp.sum(frequencies * jnp.log(probs + _NLL_EPS), axis=-1)


def nll_tril(tril_vec, povm_flat_w, frequencies, n_qubits: int):
    """NLL of a Cholesky parameter vector: rho = LL^H / tr
    (reference state.py:217-229). Fully differentiable."""
    rho = real_tril_vec_to_matrix(tril_vec, 2**n_qubits)
    tr = jnp.trace(rho, axis1=-2, axis2=-1).real
    bloch = matrix_to_bloch(rho) / tr[..., None]
    return nll_bloch(bloch, povm_flat_w, frequencies, n_qubits)


@functools.partial(jax.jit, static_argnames=("max_iter", "n_qubits"))
def _mle_chol_lbfgs(x0, povm_flat_w, frequencies, n_qubits, max_iter, tol):
    """LBFGS (optax) on the Cholesky parametrization with analytic
    gradients. vmappable: the linesearch is lax-loop based."""
    import optax

    fun = lambda x: nll_tril(x, povm_flat_w, frequencies, n_qubits)  # noqa: E731
    opt = optax.lbfgs()
    vg = optax.value_and_grad_from_state(fun)

    def cond(carry):
        _, state, it, gnorm = carry
        return jnp.logical_and(it < max_iter, gnorm > tol)

    def step(carry):
        x, state, it, _ = carry
        value, grad = vg(x, state=state)
        updates, state = opt.update(
            grad, state, x, value=value, grad=grad, value_fn=fun
        )
        x = optax.apply_updates(x, updates)
        return x, state, it + 1, jnp.linalg.norm(grad)

    state0 = opt.init(x0)
    x, _, _, _ = jax.lax.while_loop(
        cond, step, (x0, state0, jnp.asarray(0), jnp.asarray(jnp.inf, rdtype()))
    )
    return x


@functools.partial(jax.jit, static_argnames=("max_iter",))
def estimate_mle_chol(
    counts,
    povm_matrix,
    n_measurements,
    init_bloch=None,
    max_iter: int = 100,
    tol: float = 1e-6,
):
    """Cholesky-parametrized MLE via jitted LBFGS with analytic gradients.

    Semantics of reference state.py:204-229 ('mle'), but jit/vmap-native:
    the reference runs scipy BFGS with finite differences, one experiment
    at a time. Batched over leading axes of `counts`.

    Returns the bloch vector of the (trace-normalized) estimate.
    """
    counts = jnp.asarray(counts, dtype=rdtype())
    n_qubits = _n_qubits_of_povm(povm_matrix)
    dim = 2**n_qubits
    a = weighted_povm_flat(povm_matrix, n_measurements)
    freq = counts.reshape(counts.shape[:-2] + (-1,))
    freq = freq / jnp.sum(freq, axis=-1, keepdims=True)
    if init_bloch is None:
        init_bloch = estimate_lin(counts, povm_matrix, n_measurements, physical=True)
    init_bloch = jnp.asarray(init_bloch, dtype=rdtype())
    # strictly PD starting point for the Cholesky factor
    mixed = jnp.zeros_like(init_bloch).at[..., 0].set(1.0 / dim)
    x0 = matrix_to_real_tril_vec(
        bloch_to_matrix(0.99 * init_bloch + 0.01 * mixed, n_qubits)
    )

    batch_shape = freq.shape[:-1]
    if batch_shape:
        run = _mle_chol_lbfgs
        for _ in batch_shape:
            run = jax.vmap(run, in_axes=(0, None, 0, None, None, None))
        x = run(x0, a, freq, n_qubits, max_iter, tol)
    else:
        x = _mle_chol_lbfgs(x0, a, freq, n_qubits, max_iter, tol)
    rho = real_tril_vec_to_matrix(x, dim)
    tr = jnp.trace(rho, axis1=-2, axis2=-1).real
    return matrix_to_bloch(rho) / tr[..., None]


@functools.partial(jax.jit, static_argnames=("max_iter",))
def estimate_mle_rhor(
    counts,
    povm_matrix,
    n_measurements,
    init_bloch=None,
    max_iter: int = 200,
    tol: float = 1e-10,
):
    """Maximum-likelihood estimate via the RrhoR fixed-point iteration.

    rho_{t+1} = N[ R(rho_t) rho_t R(rho_t) ],  R(rho) = sum_j (f_j / p_j) E_j

    with the weighted POVM effects E_j (which sum to the identity, so the
    fixed point maximizes exactly the reference NLL, state.py:217-229).
    R is assembled in bloch space — one (K,) / (K, D) contraction — and
    materialized with the factored bloch->matrix transform, so one
    iteration is pure matmul work.

    `tol` stops on max |bloch change|; iteration always runs under
    `lax.while_loop` with `max_iter` as the hard cap. Batched over
    leading axes of `counts`.
    """
    counts = jnp.asarray(counts, dtype=rdtype())
    n_qubits = _n_qubits_of_povm(povm_matrix)
    a2 = weighted_povm_flat(povm_matrix, n_measurements) * (2**n_qubits)  # (K, D)
    freq = counts.reshape(counts.shape[:-2] + (-1,))
    freq = freq / jnp.sum(freq, axis=-1, keepdims=True)
    if init_bloch is None:
        init_bloch = estimate_lin(counts, povm_matrix, n_measurements, physical=True)
    init_bloch = jnp.asarray(init_bloch, dtype=rdtype())
    dim = 2**n_qubits
    # mix toward the fully mixed state: RrhoR preserves the kernel of rho,
    # so the start must be full rank
    mixed = jnp.zeros_like(init_bloch).at[..., 0].set(1.0 / dim)
    bloch0 = 0.95 * init_bloch + 0.05 * mixed

    # R rho R via dense Pauli-transfer matmuls when the PTM is cached
    # (n <= 6) instead of the factored per-qubit transform chain (not
    # measured on the H100). Works in the TRANSPOSED matrix space
    # (column-stacked reshape of vec yields A^T; Hermitian palindromes are
    # closed under transposition: (R rho R)^T = R^T rho^T R^T) so the
    # reshape never needs untransposing. Real-split arithmetic keeps every
    # product a real f32 matmul.
    from ..ops.paulis import PTM_MAX_QUBITS, _pauli_transfer_np

    use_ptm = n_qubits <= PTM_MAX_QUBITS

    if use_ptm:
        ptm = _pauli_transfer_np(n_qubits)
        ptm_re = jnp.asarray(ptm.real, dtype=rdtype())
        ptm_im = jnp.asarray(ptm.imag, dtype=rdtype())
        batch_shape = bloch0.shape[:-1]

        def to_mats(vecs):
            re = (vecs @ ptm_re.T).reshape(batch_shape + (dim, dim))
            im = (vecs @ ptm_im.T).reshape(batch_shape + (dim, dim))
            return re, im

        def from_mats(tre, tim):
            tre = tre.reshape(batch_shape + (dim * dim,))
            tim = tim.reshape(batch_shape + (dim * dim,))
            return (tre @ ptm_re + tim @ ptm_im) / dim

        # the fused sandwich kernel where it applies (f32 on a GPU), else
        # the same arithmetic as XLA ops; both return T / tr(T)
        sandwich = (
            rhor_sandwich
            if sandwich_kernel_applies(dim, rdtype())
            else rhor_sandwich_xla
        )

        def update(bloch, r_bloch):
            with jax.named_scope("rhor_ptm"):
                rre, rim = to_mats(r_bloch)
                pre, pim = to_mats(bloch)
            with jax.named_scope("rhor_sandwich"):
                tre, tim = sandwich(rre, rim, pre, pim)
            with jax.named_scope("rhor_ptm"):
                return from_mats(tre, tim)

    else:

        def update(bloch, r_bloch):
            r = bloch_to_matrix(r_bloch, n_qubits)
            rho = bloch_to_matrix(bloch, n_qubits)
            new = r @ rho @ r
            tr = jnp.trace(new, axis1=-2, axis2=-1).real
            return matrix_to_bloch(new) / tr[..., None]

    def cond(carry):
        _, it, delta = carry
        return jnp.logical_and(it < max_iter, delta > tol)

    # The named scopes label the loop's stages in profiler traces
    # (tools/trace_flagship.py attributes device time by them).
    def step(carry):
        bloch, it, _ = carry
        with jax.named_scope("rhor_contract"):
            probs = jnp.einsum("kd,...d->...k", a2, bloch)
            c = freq / jnp.clip(probs, _NLL_EPS, None)
            r_bloch = jnp.einsum("kd,...k->...d", a2, c)
        new_bloch = update(bloch, r_bloch)
        delta = jnp.max(jnp.abs(new_bloch - bloch))
        return new_bloch, it + 1, delta

    bloch, _, _ = jax.lax.while_loop(
        cond, step, (bloch0, jnp.asarray(0), jnp.asarray(jnp.inf, rdtype()))
    )
    return bloch


_METHODS = ("lin", "mle", "mle-constr", "mle-rhor")


def estimate(
    counts,
    povm_matrix,
    n_measurements,
    method: str = "lin",
    physical: bool = True,
    init: str = "lin",
    max_iter: int = 100,
    tol: float = 1e-3,
):
    """Dispatching estimator mirroring reference point_estimate
    (state.py:143-189), batched over leading axes of `counts`.

    'mle' / 'mle-constr' run Cholesky-LBFGS (the trace constraint of the
    reference's SLSQP variant is inactive because the estimate is
    trace-normalized either way); 'mle-rhor' is the batched fixed-point
    MLE. All return bloch vectors.
    """
    if method == "lin":
        return estimate_lin(counts, povm_matrix, n_measurements, physical=physical)
    if init == "mixed":
        n_qubits = _n_qubits_of_povm(povm_matrix)
        counts_arr = jnp.asarray(counts)
        batch_shape = counts_arr.shape[:-2]
        dim2 = povm_matrix.shape[-1]
        init_bloch = jnp.zeros(batch_shape + (dim2,), dtype=rdtype())
        init_bloch = init_bloch.at[..., 0].set(1.0 / (2**n_qubits))
    elif init == "lin":
        init_bloch = None
    else:
        raise ValueError("Invalid value for argument `init`")
    if method in ("mle", "mle-constr"):
        mle_tol = tol * 1e-3  # reference tol=1e-3 is scipy's BFGS gtol scale
        return estimate_mle_chol(
            counts, povm_matrix, n_measurements, init_bloch, max_iter, mle_tol
        )
    if method == "mle-rhor":
        # delta tolerance floor keyed to the working precision: ten
        # machine epsilons of the working dtype, or tol * 1e-3 where that
        # is larger. max_iter is honored as
        # given (reference BFGS default max_iter=100 is comparable).
        import numpy as np

        rhor_tol = max(float(np.finfo(np.dtype(rdtype())).eps) * 10, tol * 1e-3)
        return estimate_mle_rhor(
            counts, povm_matrix, n_measurements, init_bloch, max_iter, rhor_tol
        )
    raise ValueError("Invalid value for argument `method`")
