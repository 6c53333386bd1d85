"""Functional core of quantum process tomography — pure, jitted, batched.

Replaces the numerics of reference quantpy/tomography/process.py:142-327.

Everything runs in the CHOI BLOCH representation: the Choi matrix of an
n-qubit channel is a Hermitian operator on 2n qubits, hence exactly a real
vector of length 16^n. This buys three things:

1. real-only host<->device boundaries;
2. the TP constraint Tr_out(C) = I becomes a *coordinate* condition: in the
   Pauli product basis P_a (x) P_b, partial trace over the output kills every
   b != 0 term, so TP fixes the 4^n coefficients c[(a, 0)]:
       c[(0,0)] = 1/2^n,   c[(a,0)] = 0 for a != 0.
   The reference builds an explicit 16^n x 16^n ptrace operator for this
   (quantpy/routines.py:47-50, process.py:259-268); here the TP projection
   is a masked scatter - exactly the "trivial indices" of reference
   interval.py:187;
3. the measurement model is one real matmul: p[s,o] = A[s,o] . c with
   A rows = 4^n * kron(bloch(rho_s^T), w_o)  (reference builds complex
   kron rows, process.py:203-208).

Shape conventions:
- input_blochs_t: (S, D) bloch vectors of TRANSPOSED input states, D = 4^n
- povm_matrix: (m, p, D); counts: (..., S, m, p)
- choi_bloch: (..., D2) with D2 = 16^n
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from ..config import rdtype
from ..ops.df32 import (  # re-exported: tests/docs cite sum2f here
    df_div_ff as _df_div_ff,
    df_log1p_f as _df_log1p_f,
    sum2f,
    two_prod as _two_prod,
    two_sum as _two_sum,
)
from ..ops.paulis import bloch_to_matrix, matrix_to_bloch
from . import state_core

__all__ = [
    "measurement_operator",
    "process_probabilities",
    "simulate_process_experiment",
    "choi_apply_bloch",
    "np_choi_apply_bloch",
    "tp_project_bloch",
    "cp_project_bloch",
    "cptp_project_bloch",
    "kraus_param_to_choi_bloch",
    "kraus_param_to_choi_bloch_whitened",
    "kraus_design_whitener",
    "np_kraus_param_from_choi_bloch",
    "np_kraus_anchor_pack",
    "kraus_delta_choi_bloch",
    "process_nll_anchored",
    "estimate_lifp",
    "estimate_pgdb",
    "estimate_pgdb_factored",
    "estimate_pgdb_factored_host",
    "pgdb_factored_step",
    "process_nll",
    "process_nll_factored",
    "kron_fisher_whitener",
]

_CP_EPS = 1e-12  # eigenvalue floor of the CP projection (process.py:270-278)


def _n_from_d2(d2: int) -> int:
    n = int(round(math.log(d2, 16)))
    if 16**n != d2:
        raise ValueError(f"Invalid Choi bloch dimension {d2}")
    return n


def measurement_operator(input_blochs_t, povm_matrix, n_measurements):
    """The real process-measurement matrix A: (S*K, 16^n).

    Rows are 4^n * kron(bloch(rho_s^T), w_o) over (input state s, weighted
    flattened POVM row o) — the bloch-space equivalent of reference
    process.py:203-211.
    """
    input_blochs_t = jnp.asarray(input_blochs_t, dtype=rdtype())
    w = state_core.weighted_povm_flat(povm_matrix, n_measurements)  # (K, D)
    d = input_blochs_t.shape[-1]  # 4^n
    s, k = input_blochs_t.shape[0], w.shape[0]
    rows = jnp.einsum("sd,ke->skde", input_blochs_t, w).reshape(s * k, -1)
    return rows * d


def process_probabilities(a_matrix, choi_bloch):
    """p = A @ c, batched over leading axes of choi_bloch."""
    return jnp.einsum("kd,...d->...k", a_matrix, choi_bloch)


def simulate_process_experiment(key, povm_matrix, output_blochs, n_measurements):
    """Simulate state tomography of every channel output state in one call.

    output_blochs: (S, D) bloch vectors of the channel applied to each input
    state (computed host-side; the channel object is a host handle).
    Returns counts (S, m, p).
    """
    return state_core.simulate_experiment(
        key, povm_matrix, output_blochs, n_measurements
    )


def _choi_apply_core(xp, choi_bloch, in_blochs, signs):
    """Shared math of the channel action in bloch space.

    The Choi matrix C = sum_ab c[a,b] P_a (x) P_b (input factor first) acts
    by Phi(rho) = Tr_in[(rho^T (x) I) C]; with rho = sum_x r_x P_x and
    Tr(rho^T P_a) = s_a r_a 2^n (s = Pauli transpose signs) this is

        bloch_out[b] = 2^n * sum_a s_a r_a c[a, b]

    — one (D1, D1) real matvec instead of the reference's O(16^n)-entry
    kron contraction (reference quantpy/channel.py:131-142).
    """
    d2 = choi_bloch.shape[-1]
    d1 = int(round(math.sqrt(d2)))
    n = int(round(math.log(d1, 4)))
    c = choi_bloch.reshape(choi_bloch.shape[:-1] + (d1, d1))
    return (2**n) * xp.einsum("...a,...ab->...b", in_blochs * signs, c)


@functools.partial(jax.jit, static_argnames=())
def choi_apply_bloch(choi_bloch, in_blochs):
    """Apply channel(s) to state(s), all in bloch space (device, jitted).

    choi_bloch: (..., 16^n) Choi bloch vector(s); in_blochs: (..., 4^n)
    state bloch vector(s) (batch axes broadcast). Returns (..., 4^n)."""
    from ..ops.paulis import pauli_transpose_signs

    choi_bloch = jnp.asarray(choi_bloch, dtype=rdtype())
    in_blochs = jnp.asarray(in_blochs, dtype=rdtype())
    n = int(round(math.log(in_blochs.shape[-1], 4)))
    signs = jnp.asarray(pauli_transpose_signs(n), dtype=rdtype())
    return _choi_apply_core(jnp, choi_bloch, in_blochs, signs)


def np_choi_apply_bloch(choi_bloch, in_blochs):
    """Host-numpy twin of :func:`choi_apply_bloch` (used by
    Channel.transform so Choi-represented channels stay cheap)."""
    import numpy as np

    from ..ops.paulis import pauli_transpose_signs

    choi_bloch = np.asarray(choi_bloch, dtype=np.float64)
    in_blochs = np.asarray(in_blochs, dtype=np.float64)
    n = int(round(math.log(in_blochs.shape[-1], 4)))
    return _choi_apply_core(np, choi_bloch, in_blochs, pauli_transpose_signs(n))


@functools.partial(jax.jit, static_argnames=())
def tp_project_bloch(choi_bloch):
    """Orthogonal projection onto trace-preserving Choi matrices
    (bloch-coordinate fix; semantics of reference process.py:259-268)."""
    choi_bloch = jnp.asarray(choi_bloch, dtype=rdtype())
    d2 = choi_bloch.shape[-1]
    n = _n_from_d2(d2)
    d_in = 4**n
    d_out = 4**n
    c = choi_bloch.reshape(choi_bloch.shape[:-1] + (d_in, d_out))
    target = jnp.zeros((d_in,), dtype=choi_bloch.dtype).at[0].set(1.0 / (2**n))
    c = c.at[..., :, 0].set(jnp.broadcast_to(target, c.shape[:-1]))
    return c.reshape(choi_bloch.shape)


@functools.partial(jax.jit, static_argnames=())
def cp_project_bloch(choi_bloch):
    """Projection onto completely positive (PSD-Choi) maps: eigh, floor
    eigenvalues at 1e-12, recompose (reference process.py:270-278)."""
    choi_bloch = jnp.asarray(choi_bloch, dtype=rdtype())
    n2 = 2 * _n_from_d2(choi_bloch.shape[-1])  # Choi lives on 2n qubits
    rho = bloch_to_matrix(choi_bloch, n2)
    evals, evecs = jnp.linalg.eigh(rho)
    evals = jnp.maximum(evals, _CP_EPS)
    rho = (evecs * evals[..., None, :].astype(evecs.dtype)) @ jnp.swapaxes(
        evecs.conj(), -1, -2
    )
    return matrix_to_bloch(rho)


_NS_SAFETY = 0.99  # keep t * u_max <= 0.99 * sqrt(3): g_t sign-preserving


@functools.lru_cache(maxsize=None)
def _ns_schedule(ns_iter: int) -> tuple:
    """Per-step scaling factors t_k for the SCALED cubic Newton-Schulz
    sign iteration S <- g_t(S) with g_t(x) = (t x)(3 - (t x)^2)/2.

    Unscaled NS grows small eigenvalues by 1.5x per step; pre-scaling by
    t grows them by 1.5 t (up to ~2.57x at t ~= 0.99*sqrt(3)) while the
    cap t*u <= 0.99*sqrt(3) keeps g_t sign-preserving on the whole
    spectral envelope [l, u] (g_t > 0 on (0, sqrt(3)/t)). The schedule is
    derived offline-style here by a greedy envelope optimization: at each
    step pick t maximizing the worst-case image min(g_t(l), g_t(u)) —
    the top edge folds down once l is large, so t anneals back to 1 —
    then append two unscaled polish steps (quadratic convergence near 1:
    e -> 1.5 e^2). The resolvable floor l0 is chosen by bisection so the
    schedule length equals ns_iter; at the default 19 the floor is
    ~7e-7 * ||A||_F, matching the old 34 unscaled iterations at 1.79x
    fewer matmuls (measured error vs eigh: 1.1e-6 * ||A||_F in f32).
    Scaled-sign background: Chen & Chow-style scaled Newton iterations.
    """
    if ns_iter <= 2:
        return (1.0,) * ns_iter

    def g(x, t):
        y = t * x
        return 0.5 * y * (3.0 - y * y)

    def greedy(l0):
        l, u = l0, 1.0
        ts = []
        for _ in range(4 * ns_iter + 8):
            cand = np.linspace(1.0, np.sqrt(3.0) * _NS_SAFETY / u, 2001)
            worst = np.minimum(g(l, cand), g(u, cand))
            t = float(cand[np.argmax(worst)])
            xs = np.linspace(l, u, 2001)
            ys = g(xs, t)
            l, u = float(ys.min()), float(ys.max())
            ts.append(t)
            if l >= 0.97:
                break
        return ts

    lo, hi = -40.0, np.log10(0.97)  # log10 of the resolvable floor
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if len(greedy(10.0**mid)) > ns_iter - 2:
            lo = mid
        else:
            hi = mid
    ts = greedy(10.0**hi)[: ns_iter - 2]
    return tuple(ts) + (1.0,) * (ns_iter - len(ts))


def _ns_sign(s, eye, ns_iter: int):
    """Scaled-schedule cubic Newton-Schulz sign iteration (see
    _ns_schedule). Differentiable (the t_k are constants)."""
    ts = jnp.asarray(_ns_schedule(ns_iter), dtype=rdtype())

    def body(s, t):
        y = t.astype(s.dtype) * s
        return 0.5 * y @ (3.0 * eye - y @ y), None

    s, _ = jax.lax.scan(body, s, ts)
    return s


@functools.partial(jax.jit, static_argnames=("ns_iter",))
def cp_project_bloch_ns(choi_bloch, ns_iter: int = 19):
    """PSD projection via the matrix sign function computed with
    scaled Newton-Schulz iterations — pure matmuls, no eigendecomposition.

    max(A, 0) = (A + |A|)/2 with |A| = A sign(A); sign(A) from the scaled
    cubic Newton-Schulz map S <- g_t(S) (schedule: _ns_schedule), which
    converges for ||S_0||_2 <= 1 (start S_0 = A/||A||_F). It replaces a
    large batched eigh by ns_iter matmuls — the matmul route for the
    large-n Dykstra cleanups (not measured on the H100). Accuracy: eigenvalues below the schedule floor
    (~7e-7 * ||A||_F at the default 19) keep ~half their magnitude
    (absolute error tiny in norm); equality with the eigh path is tested
    to 1e-5 * ||A||."""
    choi_bloch = jnp.asarray(choi_bloch, dtype=rdtype())
    n2 = 2 * _n_from_d2(choi_bloch.shape[-1])
    a = bloch_to_matrix(choi_bloch, n2)
    fro = jnp.sqrt(
        jnp.sum(jnp.abs(a) ** 2, axis=(-2, -1), keepdims=True).real
    )
    s = a / jnp.maximum(fro, 1e-30).astype(a.dtype)
    eye = jnp.eye(a.shape[-1], dtype=a.dtype)
    s = _ns_sign(s, eye, ns_iter)
    psd = 0.5 * (a + a @ s)
    psd = 0.5 * (psd + jnp.swapaxes(psd.conj(), -1, -2))
    return matrix_to_bloch(psd)


def default_cptp_tol(tol: float | None = None) -> float:
    """Dykstra tolerance floored at working precision.

    The stop criterion is the SQUARED correction increment, so the floor
    scales as eps^1.5 (measured at 3 qubits in f32: a 100*eps floor left a
    1.8e-2 trace-preservation error; eps^1.5 ~ 4e-11 converges to TP error
    ~1e-4 in a few hundred extra iterations). A raw sub-floor tolerance in
    f32 silently burns the full iteration budget on every call (measured:
    the 4-qubit process bootstrap ran 2000 Dykstra iterations per resample
    chasing 1e-11)."""
    eps = float(np.finfo(np.dtype(rdtype())).eps)
    return max(eps**1.5, 0.0 if tol is None else tol)


@functools.partial(jax.jit, static_argnames=("max_iter", "cp"))
def cptp_project_bloch(
    choi_bloch, max_iter: int = 2000, tol: float | None = None, cp: str = "eigh"
):
    """Dykstra alternating projections onto CPTP, in bloch space, batched,
    under lax.while_loop.

    Semantics of reference process.py:237-257 with a documented fix: the
    reference updates its correction vector with the ALREADY-updated
    iterate (`p += x_new - y`, process.py:251-252), which is not Dykstra's
    scheme and biases the returned point (measured: the PGD direction it
    produces stops being a descent direction ~1e-4 away from the optimum).
    This implements the textbook two-set Dykstra:

        y_k     = P_TP(x_k + p_k);   p_{k+1} = x_k + p_k - y_k
        x_{k+1} = P_CP(y_k + q_k);   q_{k+1} = y_k + q_k - x_{k+1}

    Stop: squared change of both correction increments below tol (the usual
    Birgin-Raydan criterion), maximized over the batch.

    `cp` selects the CP-projection engine: exact 'eigh' (default) or the
    matmul-only 'ns' Newton-Schulz sign iteration (cp_project_bloch_ns) —
    the batched-matmul route when the projection is batched over many
    resamples.
    """
    cp_fn = cp_project_bloch_ns if cp == "ns" else cp_project_bloch
    x0 = jnp.asarray(choi_bloch, dtype=rdtype())
    zeros = jnp.zeros_like(x0)
    # floor at working precision even for traced tolerances
    tol = jnp.maximum(
        jnp.asarray(0.0 if tol is None else tol, rdtype()), default_cptp_tol()
    )

    def cond(carry):
        _, _, _, it, crit = carry
        return jnp.logical_and(it < max_iter, crit > tol)

    def step(carry):
        x, p, q, it, _ = carry
        x_new, p_new, q_new, crit = _dykstra_step(x, p, q, cp_fn)
        return x_new, p_new, q_new, it + 1, crit

    x, _, _, _, _ = jax.lax.while_loop(
        cond,
        step,
        (x0, zeros, zeros, jnp.asarray(0), jnp.asarray(jnp.inf, rdtype())),
    )
    return x


def _dykstra_step(x, p, q, cp_fn=None):
    """One textbook two-set Dykstra update; returns (x, p, q, max crit)."""
    cp_fn = cp_fn or cp_project_bloch
    s = x + p
    y = tp_project_bloch(s)
    p_new = s - y
    t = y + q
    x_new = cp_fn(t)
    q_new = t - x_new
    crit = jnp.sum((p_new - p) ** 2, axis=-1) + jnp.sum(
        (q_new - q) ** 2, axis=-1
    )
    return x_new, p_new, q_new, jnp.max(crit)


def _tp_project_mat(c):
    """Matrix-space twin of tp_project_bloch: the orthogonal projection
    onto Tr_out(C) = I is C + ((I - Tr_out C)/d_out) (x) I_out (input
    factor first, matching the bloch layout). Equality with the bloch-space
    projection is tested."""
    d = c.shape[-1]
    d_in = int(round(math.sqrt(d)))
    c4 = c.reshape(c.shape[:-2] + (d_in, d_in, d_in, d_in))
    tr_out = jnp.einsum("...ibjb->...ij", c4)
    eye = jnp.eye(d_in, dtype=c.dtype)
    corr = (eye - tr_out) / d_in
    c4 = c4 + corr[..., :, None, :, None] * eye[None, :, None, :]
    return c4.reshape(c.shape)


def _ns_psd_mat(a, ns_iter: int):
    """Matrix-space scaled Newton-Schulz PSD clip (the body of
    cp_project_bloch_ns without the bloch transforms)."""
    fro = jnp.sqrt(
        jnp.sum(jnp.abs(a) ** 2, axis=(-2, -1), keepdims=True).real
    )
    s = a / jnp.maximum(fro, 1e-30).astype(a.dtype)
    eye = jnp.eye(a.shape[-1], dtype=a.dtype)
    s = _ns_sign(s, eye, ns_iter)
    psd = 0.5 * (a + a @ s)
    return 0.5 * (psd + jnp.swapaxes(psd.conj(), -1, -2))


@functools.partial(jax.jit, static_argnames=("n_steps", "cp", "ns_iter"))
def _dykstra_chunk(x, p, q, n_steps: int, cp: str = "eigh", ns_iter: int = 19):
    """`n_steps` Dykstra iterations as one device program (for the
    host-chunked projection at 5+ qubits). `cp` selects the CP-projection
    engine: exact 'eigh' or matmul-only 'ns' (Newton-Schulz sign
    iteration; the matmul route for 4096-dim Choi matrices).

    The 'ns' engine runs the whole chunk in MATRIX space: the Pauli
    bloch<->matrix transforms move to the chunk boundary (6 per chunk
    instead of 2 per iteration — they were a dominant cost of the batched
    4-qubit bootstrap projection), and the boundary carries stay real
    bloch vectors. The
    stop criterion is rescaled by 2^(2n) so the tolerance keeps the
    bloch-space semantics."""
    if cp == "ns":
        n2 = 2 * _n_from_d2(x.shape[-1])
        xm = bloch_to_matrix(x, n2)
        pm = bloch_to_matrix(p, n2)
        qm = bloch_to_matrix(q, n2)

        def body(carry, _):
            xm, pm, qm, _ = carry
            s = xm + pm
            y = _tp_project_mat(s)
            pm_new = s - y
            t = y + qm
            xm_new = _ns_psd_mat(t, ns_iter)
            qm_new = t - xm_new
            crit = jnp.sum(
                jnp.abs(pm_new - pm) ** 2, axis=(-2, -1)
            ) + jnp.sum(jnp.abs(qm_new - qm) ** 2, axis=(-2, -1))
            return (xm_new, pm_new, qm_new, jnp.max(crit.real)), None

        (xm, pm, qm, crit), _ = jax.lax.scan(
            body,
            (xm, pm, qm, jnp.asarray(jnp.inf, rdtype())),
            None,
            length=n_steps,
        )
        scale = jnp.asarray(1.0 / 2**n2, rdtype())
        return (
            matrix_to_bloch(xm),
            matrix_to_bloch(pm),
            matrix_to_bloch(qm),
            crit * scale,
        )

    def body(carry, _):
        x, p, q, _ = carry
        return _dykstra_step(x, p, q, cp_project_bloch), None

    (x, p, q, crit), _ = jax.lax.scan(
        body, (x, p, q, jnp.asarray(jnp.inf, rdtype())), None, length=n_steps
    )
    return x, p, q, crit


@functools.partial(jax.jit, static_argnames=("n_steps", "ns_iter"))
def cptp_project_bloch_diff(choi_bloch, n_steps: int = 100, ns_iter: int = 19):
    """Fixed-length, reverse-differentiable CPTP projection.

    Same math as the `cp='ns'` branch of :func:`_dykstra_chunk` (matrix-
    space NS Dykstra), but exposed as a pure fixed-iteration map so
    `jax.grad` can flow through it — the enabler for MALA proposals on the
    projected-likelihood MHMC target (the while_loop projection is not
    reverse-differentiable). The Dykstra body is checkpointed: the
    backward pass recomputes each step's NS sign iteration instead of
    storing its ns_iter inner matmul activations (~36 MB/step at 4 qubits)."""
    x = jnp.asarray(choi_bloch, dtype=rdtype())
    n2 = 2 * _n_from_d2(x.shape[-1])
    xm = bloch_to_matrix(x, n2)
    pm = jnp.zeros_like(xm)
    qm = jnp.zeros_like(xm)

    @jax.checkpoint
    def body(carry, _):
        xm, pm, qm = carry
        s = xm + pm
        y = _tp_project_mat(s)
        pm_new = s - y
        t = y + qm
        xm_new = _ns_psd_mat(t, ns_iter)
        qm_new = t - xm_new
        return (xm_new, pm_new, qm_new), None

    (xm, _, _), _ = jax.lax.scan(body, (xm, pm, qm), None, length=n_steps)
    return matrix_to_bloch(xm)


@functools.partial(jax.jit, static_argnames=())
def kraus_param_to_choi_bloch(y):
    """Smooth, surjective, EXACTLY-TP parametrization of CPTP Choi matrices
    — the projection-free route for MCMC over processes.

    ``y``: real (..., 2, D, D) re/im pair of a complex factor M with
    D = 4^n the Choi dimension. The map is

        G = M M^H                       (CP automatic)
        rho = Tr_out(G)                 (2^n x 2^n, input factor first)
        X = (L^{-1} (x) I_out) G (L^{-H} (x) I_out),   rho = L L^H

    so Tr_out(X) = L^{-1} rho L^{-H} = I exactly — both CPTP constraints
    hold by construction, no Dykstra projection anywhere. Surjective onto
    CPTP: M = X^{1/2} gives rho = I and X back. Smooth wherever rho is PD
    (a relative 1e-9 ridge keeps the Cholesky defined for arbitrary y;
    rho ~ O(1) along any chain started from a density-operator-normalized
    Choi, so the TP violation from the ridge is O(1e-9)).

    Why it exists: the reference's project-the-proposal MHMC scheme
    (quantpy/tomography/interval.py:839 + process.py:280-282) freezes at 4
    qubits, and the projected-likelihood target mixes slowly
    because the CPTP projection's spectral-clip kink defeats gradient
    proposals (measured). This map is C^inf in y, so
    MALA works, and one evaluation is ~3 D x D matmuls + one 2^n Cholesky
    — ~100x cheaper than a 100-step NS Dykstra projection. The sampled law
    is the pushforward of exp(-NLL) through the parametrization (same
    epistemic status as the projection pushforward; cross-validated
    against the parametric bootstrap).

    Returns real Choi bloch vectors (..., D^2). Batched over leading axes;
    reverse-differentiable (Cholesky + triangular solve have JAX JVPs).
    """
    y = jnp.asarray(y, dtype=rdtype())
    m = jax.lax.complex(y[..., 0, :, :], y[..., 1, :, :])
    return _kraus_m_to_choi_bloch(m)


def _kraus_m_to_choi_bloch(m):
    """Complex-matrix core of :func:`kraus_param_to_choi_bloch` (in-jit)."""
    d = m.shape[-1]  # Choi matrix dimension 4^n
    d_in = int(round(math.sqrt(d)))  # 2^n
    g = m @ jnp.swapaxes(m.conj(), -1, -2)
    g4 = g.reshape(g.shape[:-2] + (d_in, d_in, d_in, d_in))
    rho = jnp.einsum("...ibjb->...ij", g4)
    tr = jnp.trace(rho, axis1=-2, axis2=-1).real
    eye = jnp.eye(d_in, dtype=rho.dtype)
    lam = (1e-9 * tr / d_in + 1e-30).astype(rho.dtype)
    l_chol = jnp.linalg.cholesky(rho + lam[..., None, None] * eye)
    m_rows = m.reshape(m.shape[:-2] + (d_in, d_in * d))
    n_rows = jax.scipy.linalg.solve_triangular(l_chol, m_rows, lower=True)
    n_mat = n_rows.reshape(m.shape)
    x = n_mat @ jnp.swapaxes(n_mat.conj(), -1, -2)
    return matrix_to_bloch(x)


@functools.partial(jax.jit, static_argnames=())
def kraus_param_to_choi_bloch_whitened(z, a_l_pair, a_r_pair):
    """Whitened-coordinate kraus decode: M = A_L Z A_R, then the kraus map.

    `z`: real (..., 2, D, D) re/im chain state; `a_l_pair`/`a_r_pair`: the
    whitening matrices of :func:`kraus_design_whitener` as real (D, D, 2)
    pairs, the package's convention for complex data at jit boundaries."""
    from ..ops.cplx import pair_to_complex

    z = jnp.asarray(z, dtype=rdtype())
    m0 = jax.lax.complex(z[..., 0, :, :], z[..., 1, :, :])
    a_l = pair_to_complex(jnp.asarray(a_l_pair, dtype=rdtype()))
    a_r = pair_to_complex(jnp.asarray(a_r_pair, dtype=rdtype()))
    return _kraus_m_to_choi_bloch(a_l @ m0 @ a_r)


def kraus_design_whitener(
    input_blochs_t,
    w_flat,
    flat_counts,
    choi_bloch_hat,
    ridge: float = 1e-6,
    x_floor: float = 1e-2,
):
    """M-space curvature whitener for kraus-parametrized process chains.

    The NLL's Gauss-Newton form in the factor M (Choi X ~ M M^H, rows
    p_k = Tr(A_k X) with A_k = rho_s^T (x) E_o) is
    F_M = sum_k c_k vec(A_k M0) vec(A_k M0)^H with c_k = n_k / p_k^2.
    Two structured averages bound its anisotropy:

    - LEFT index: sum_k c_k A_k X A_k ~ G_B (x) G_W with
      G_B = sum_s u_s (rho_s^T)^2, G_W = sum_o v_o E_o^2 (the same rank-1
      weight fit c ~ u v as kron_fisher_whitener) — the measured-operator
      Gram of the design;
    - RIGHT index: M0^H (...) M0 ~ X_hat — weakly-populated Kraus
      directions (small Choi eigenvalues) carry little curvature; the
      floor `x_floor * tr(X)/D` bounds their step amplification.

    Sampling Z with M = A_L Z A_R, A_L = (G_B (x) G_W)^{-1/2},
    A_R = (X_hat + eps I)^{-1/2} runs the chain in approximately-isotropic
    curvature coordinates (proposal covariance ~ F_M^{-1} in the averaged
    metric). Host f64; returns complex (a_l, a_r, a_l_inv, a_r_inv) with
    z0 = a_l_inv M0 a_r_inv. No reference counterpart (the reference's
    sampler is an isotropic random walk, interval.py:762-850)."""
    from ..ops.paulis import np_bloch_to_matrix

    b = np.asarray(input_blochs_t, dtype=np.float64)
    w = np.asarray(w_flat, dtype=np.float64)
    d1 = b.shape[-1]  # Choi matrix dim = 4^n
    n = int(round(math.log(d1, 4)))
    c = np.asarray(flat_counts, dtype=np.float64).reshape(b.shape[0], -1)
    x_hat = np.asarray(choi_bloch_hat, dtype=np.float64).reshape(d1, d1)
    p_hat = d1 * (b @ x_hat @ w.T)
    floor = 0.5 / max(float(c.sum(axis=-1).max()), 1.0)
    p_hat = np.maximum(p_hat, floor)
    r = c / (p_hat * p_hat)
    total = float(r.sum())
    u = r.sum(axis=1)
    v = r.sum(axis=0) / max(total, 1e-30)
    rho_mats = np_bloch_to_matrix(b, n)  # (S, 2^n, 2^n), Hermitian
    e_mats = np_bloch_to_matrix(w, n)  # (K, 2^n, 2^n), Hermitian
    g_b = np.einsum("s,sij,sjk->ik", u, rho_mats, rho_mats)
    g_w = np.einsum("o,oij,ojk->ik", v, e_mats, e_mats)

    def _sqrt_pair(g, lam):
        evals, evecs = np.linalg.eigh(g)
        evals = np.clip(evals, 0.0, None) + lam
        inv_s = (evecs / np.sqrt(evals)) @ evecs.conj().T
        s = (evecs * np.sqrt(evals)) @ evecs.conj().T
        return inv_s, s

    inv_b, sq_b = _sqrt_pair(g_b, ridge * np.trace(g_b).real / g_b.shape[0])
    inv_w, sq_w = _sqrt_pair(g_w, ridge * np.trace(g_w).real / g_w.shape[0])
    x_mat = np_bloch_to_matrix(choi_bloch_hat, 2 * n)
    a_r, a_r_inv = _sqrt_pair(
        x_mat, x_floor * np.trace(x_mat).real / d1
    )
    a_l = np.kron(inv_b, inv_w)
    a_l_inv = np.kron(sq_b, sq_w)
    return a_l, a_r, a_l_inv, a_r_inv


def np_kraus_param_from_choi_bloch(choi_bloch):
    """Host-side inverse-at-CPTP of :func:`kraus_param_to_choi_bloch`:
    the Hermitian square root M = X^{1/2} (eigenvalues clipped at 0), as a
    real (2, D, D) re/im pair. For a CPTP X, rho = Tr_out(X) = I there, so
    the parametrization maps this start point back to X (round-trip
    tested); used to initialize MHMC chains at the point estimate."""
    from ..ops.paulis import np_bloch_to_matrix

    choi_bloch = np.asarray(choi_bloch, dtype=np.float64)
    n2 = 2 * _n_from_d2(choi_bloch.shape[-1])
    x = np_bloch_to_matrix(choi_bloch, n2)
    w, v = np.linalg.eigh(x)
    w = np.sqrt(np.clip(w, 0.0, None))
    m = (v * w[..., None, :]) @ np.swapaxes(v.conj(), -1, -2)
    return np.stack([m.real, m.imag], axis=-3)


def np_kraus_anchor_pack(z_ref, a_l=None, a_r=None):
    """Host-f64 anchor constants for the ANCHORED EXACT-DELTA kraus decode.

    Why this exists: the 4-qubit kraus-MALA chain is precision-bound —
    the residual target roughness of the full decode is a deterministic
    +-2.5 f32 rounding field through the parametrization graph, against
    a needed ~0.3 log-ratio fidelity at 4.1e7 counts. The field's origin:
    every f32 quantity along the decode (M, G = MM^H, chol, X) carries
    state-dependent rounding of RELATIVE size eps ~ 1.2e-7, and the
    count-weighted NLL amplifies relative-eps errors of the FULL-SIZE
    quantities to O(N_total * eps) ~ +-2.5.

    The fix is algebraic, not double-float: re-express the decode so every
    state-dependent intermediate is an exact function of the SMALL offset
    dz = z - z_ref (products of small factors with O(1) constants), never
    a difference of two full-size f32 results. Then all rounding scales
    with the posterior-sized |dX| ~ 2.5e-2 |X| instead of |X|, cutting the
    field by that factor. Constant (state-independent) rounding of the
    anchor merely shifts the anchor point / tempers the target by O(eps) —
    it is exactly cancelled in every MH ratio and cannot cause roughness.

    The delta algebra (U0 = L_ref^{-1} (x) I, E' = (L^{-1}-L_ref^{-1}) (x) I):

        dM    = A_L (Z - Z_ref) A_R                      (linear; Z - Z_ref
                                                          exact by Sterbenz)
        dG    = M_ref dM^H + dM M_ref^H + dM dM^H
        drho  = Tr_out dG  (+ ridge delta)
        A     = L_ref^{-1} drho L_ref^{-H}
        L     = L_ref (I + S),  S + S^H + S S^H = A      (S = chol(I+A)-I by
                                                          fixed-point iteration)
        E     = -S (I+S)^{-1} L_ref^{-1}                  (no subtraction)
        dX    = U dG U^H + E' C_ref + (E' C_ref)^H + E' G_ref E'^H
                with U = L^{-1} (x) I, C_ref = G_ref (L_ref^{-H} (x) I)
        dbloch = pauli(dX)                                (linear)

    At dz = 0 every term is exactly zero, so target(z_ref) == 0 in f32.

    Returns (pack, x_ref_bloch): `pack` is a dict of f32 device constants
    consumed by :func:`kraus_delta_choi_bloch` /
    :func:`process_nll_anchored`; `x_ref_bloch` is the f64 anchor Choi
    bloch (compute p_ref from it in f64). `z_ref`: complex (D, D) whitened
    anchor; `a_l`/`a_r`: the whitening matrices (None = identity).
    """
    from ..ops.cplx import to_pair
    from ..ops.paulis import np_matrix_to_bloch

    z_ref = np.asarray(z_ref, dtype=np.complex128)
    d = z_ref.shape[-1]
    d_in = int(round(math.sqrt(d)))
    a_l = np.eye(d, dtype=np.complex128) if a_l is None else np.asarray(
        a_l, dtype=np.complex128
    )
    a_r = np.eye(d, dtype=np.complex128) if a_r is None else np.asarray(
        a_r, dtype=np.complex128
    )
    m_ref = a_l @ z_ref @ a_r
    g_ref = m_ref @ m_ref.conj().T
    g4 = g_ref.reshape(d_in, d_in, d_in, d_in)
    rho = np.einsum("ibjb->ij", g4)
    tr = float(np.trace(rho).real)
    lam = 1e-9 * tr / d_in + 1e-30
    l_ref = np.linalg.cholesky(rho + lam * np.eye(d_in))
    l_ref_inv = np.linalg.solve(l_ref, np.eye(d_in))
    # X_ref = (L^{-1} (x) I) G (L^{-H} (x) I) via the row-factor reshape
    t = (l_ref_inv @ g_ref.reshape(d_in, d_in * d)).reshape(d, d)
    x_ref = (l_ref_inv @ t.conj().T.reshape(d_in, d_in * d)).reshape(d, d)
    x_ref = x_ref.conj().T
    c_ref = (l_ref_inv @ g_ref.conj().T.reshape(d_in, d_in * d)).reshape(d, d)
    c_ref = c_ref.conj().T  # G_ref (L_ref^{-H} (x) I)
    x_ref_bloch = np_matrix_to_bloch(x_ref)
    pack = {
        "a_l": to_pair(a_l),
        "a_r": to_pair(a_r),
        "m_ref": to_pair(m_ref),
        "g_ref": to_pair(g_ref),
        "c_ref": to_pair(c_ref),
        "l_ref_inv": to_pair(l_ref_inv),
        "z_ref": to_pair(z_ref),
    }
    return pack, x_ref_bloch


def _apply_left_factor(mat, y, d_in):
    """(mat (x) I) y for y (..., D, D), mat (d_in, d_in), D = d_in * d_out:
    contract mat over the FIRST row-index factor (the Choi input space)."""
    d = y.shape[-1]
    rows = y.reshape(y.shape[:-2] + (d_in, (d // d_in) * d))
    return (mat @ rows).reshape(y.shape)


@functools.partial(jax.jit, static_argnames=("s_iters",))
def kraus_delta_choi_bloch(dz_pair, pack, s_iters: int = 12):
    """Anchored exact-delta decode: Choi-bloch OFFSET from the anchor as an
    exact-in-small-quantities function of the whitened chain offset.

    `dz_pair`: real (..., 2, D, D) re/im pair of Z - Z_ref (subtract the
    chain state and z_ref OUTSIDE — nearby f32 subtraction is exact);
    `pack`: constants from :func:`np_kraus_anchor_pack`. Returns
    dbloch (..., D^2) with X = X_ref + dX; fully differentiable (the
    chol(I+A) factor is a fixed `s_iters`-step contraction S <- Phi(A - S S^H),
    quadratic error ~|A|^(s_iters+1), and posterior-scale |A| << 1).
    See the pack docstring for the algebra and the accuracy argument.
    """
    from ..ops.cplx import pair_to_complex

    dz_pair = jnp.asarray(dz_pair, dtype=rdtype())
    dz = jax.lax.complex(dz_pair[..., 0, :, :], dz_pair[..., 1, :, :])
    a_l = pair_to_complex(pack["a_l"])
    a_r = pair_to_complex(pack["a_r"])
    m_ref = pair_to_complex(pack["m_ref"])
    g_ref = pair_to_complex(pack["g_ref"])
    c_ref = pair_to_complex(pack["c_ref"])
    l_ref_inv = pair_to_complex(pack["l_ref_inv"])
    d = dz.shape[-1]
    d_in = l_ref_inv.shape[-1]

    dm = a_l @ dz @ a_r
    dmh = jnp.swapaxes(dm.conj(), -1, -2)
    dg = m_ref @ dmh + dm @ jnp.swapaxes(m_ref.conj(), -1, -2) + dm @ dmh
    g4 = dg.reshape(dg.shape[:-2] + (d_in, d_in, d_in, d_in))
    drho = jnp.einsum("...ibjb->...ij", g4)
    # ridge delta: the plain decode's ridge is 1e-9 * tr(rho)/d_in
    dtr = jnp.trace(drho, axis1=-2, axis2=-1).real
    eye = jnp.eye(d_in, dtype=drho.dtype)
    drho = drho + (1e-9 * dtr / d_in)[..., None, None].astype(drho.dtype) * eye
    a = l_ref_inv @ drho @ jnp.swapaxes(l_ref_inv.conj(), -1, -2)

    def phi(h):
        return jnp.tril(h, -1) + 0.5 * eye * h

    # the fixed-point iteration contracts only for small ||A|| (the
    # posterior-bulk regime where its cancellation-free form matters);
    # for large excursions fall back to the direct chol(I+A) - I, whose
    # subtraction error eps*|L| is harmless relative to the then-large |S|.
    # I + A = L_ref^{-1} rho_tilde L_ref^{-H} is PD by construction, so the
    # chol branch is always defined. Each branch runs on a ZEROED stand-in
    # where unselected (chol(I) - I = 0; iteration at 0 stays 0) so neither
    # a diverging iteration nor its cotangent can leak NaNs through where.
    anorm = jnp.max(jnp.abs(a), axis=(-2, -1))[..., None, None]
    small = anorm < 0.25
    a_h = 0.5 * (a + jnp.swapaxes(a.conj(), -1, -2))
    a_it = jnp.where(small, a_h, jnp.zeros_like(a_h))
    a_ch = jnp.where(small, jnp.zeros_like(a_h), a_h)

    def body(s, _):
        return phi(a_it - s @ jnp.swapaxes(s.conj(), -1, -2)), None

    s_it, _ = jax.lax.scan(body, phi(a_it), None, length=s_iters)
    s_ch = jnp.linalg.cholesky(eye + a_ch) - eye
    s = jnp.where(small, s_it, s_ch)
    # L^{-1} = (I+S)^{-1} L_ref^{-1}; E = L^{-1} - L_ref^{-1} = -S (I+S)^{-1} L_ref^{-1}
    l_inv = jax.scipy.linalg.solve_triangular(eye + s,
        jnp.broadcast_to(l_ref_inv, s.shape[:-2] + l_ref_inv.shape), lower=True)
    e = -(s @ l_inv)
    # dX = U dG U^H + E' C_ref + (E' C_ref)^H + E' G_ref E'^H
    t1 = _apply_left_factor(l_inv, dg, d_in)
    t1 = _apply_left_factor(l_inv, jnp.swapaxes(t1.conj(), -1, -2), d_in)
    t1 = jnp.swapaxes(t1.conj(), -1, -2)
    t2 = _apply_left_factor(e, jnp.broadcast_to(c_ref, dz.shape), d_in)
    t4 = _apply_left_factor(e, jnp.broadcast_to(g_ref, dz.shape), d_in)
    t4 = _apply_left_factor(e, jnp.swapaxes(t4.conj(), -1, -2), d_in)
    t4 = jnp.swapaxes(t4.conj(), -1, -2)
    dx = t1 + t2 + jnp.swapaxes(t2.conj(), -1, -2) + t4
    return matrix_to_bloch(dx)


def _rel_nll_from_dp(dp, unnorm_counts, p_ref):
    """-sum n log1p(dp / p_ref): the shared reduction of the anchored and
    rel-form NLLs, evaluated in DOUBLE-FLOAT elementwise arithmetic
    (ops/df32.py) with a compensated pairwise tree sum.

    Compensated summation alone is NOT enough where an accelerator's f32
    `divide` and `log1p` are a few ulp off (CPU f32 runs them through f64
    libm): that per-element error amplifies to eps_op * sum|n log1p|,
    several log-density units on the 4q anchored config (measured on the
    earlier target, not on the H100; ROADMAP C4).
    Double-float division + log1p carry ~2^-48 relative per element,
    dropping the field under the ~0.3 MH log-ratio budget."""
    r_hi, r_lo = _df_div_ff(dp, jnp.maximum(p_ref, _CP_EPS))
    lim = jnp.asarray(-1.0 + 1e-7, dtype=r_hi.dtype)
    clamped = r_hi < lim
    r_hi = jnp.where(clamped, lim, r_hi)
    r_lo = jnp.where(clamped, 0.0, r_lo)
    l_hi, l_lo = _df_log1p_f(r_hi)
    # fold the ratio's low part through d/dr log1p = 1/(1+r)
    l_lo = l_lo + r_lo / (1.0 + r_hi)
    t_hi, t_err = _two_prod(unnorm_counts, l_hi)
    t_lo = unnorm_counts * l_lo + t_err
    return -sum2f(t_hi, t_lo)


def process_nll_anchored(
    dz_flat, input_blochs_t, w_flat, unnorm_counts, pack, p_ref,
    s_iters: int = 12,
):
    """Anchored delta-form process NLL for kraus chains: NLL(X(z)) -
    NLL(X_ref) evaluated WITHOUT ever forming the full-size X in f32.

    dp = D * b dXmat w runs on the exact-delta dXmat from
    :func:`kraus_delta_choi_bloch`, so the bilinear form's operands are
    posterior-sized — its f32 rounding scales with |dX|, not |X| (the
    round-3 rel form still subtracted full-size decodes, docstring of
    :func:`process_nll_factored_rel`). `dz_flat`: (..., 2*D*D) flattened
    re/im offset Z - Z_ref."""
    b = jnp.asarray(input_blochs_t, dtype=rdtype())
    w = jnp.asarray(w_flat, dtype=rdtype())
    d1 = b.shape[-1]
    dz_flat = jnp.asarray(dz_flat, dtype=rdtype())
    d = int(round(math.sqrt(dz_flat.shape[-1] // 2)))
    dbloch = kraus_delta_choi_bloch(
        dz_flat.reshape(dz_flat.shape[:-1] + (2, d, d)), pack, s_iters
    )
    dm = dbloch.reshape(dbloch.shape[:-1] + (d1, d1))
    dp = d1 * jnp.einsum("sa,...ab,kb->...sk", b, dm, w)
    dp = dp.reshape(dbloch.shape[:-1] + (-1,))
    return _rel_nll_from_dp(dp, unnorm_counts, p_ref)


def cptp_project_bloch_host(
    choi_bloch,
    max_iter: int = 2000,
    tol: float | None = None,
    chunk: int | None = None,
    cp: str = "eigh",
):
    """Host-chunked twin of :func:`cptp_project_bloch` for large Choi
    matrices: at 5 qubits each Dykstra iteration carries a 1024-dim eigh,
    and the fused while_loop exceeded a single-execution time limit of the
    earlier target (ROADMAP C1); here `chunk` iterations run per device
    call with the stop criterion checked between calls. `cp='ns'` swaps
    the per-iteration eigh for the Newton-Schulz matmul projection
    (cp_project_bloch_ns), at an accuracy floor ample for short denoising
    cleanups. `chunk=None` sizes the per-call iteration count by the Choi
    matrix dimension (10 at 4096-dim, 100 below)."""
    x = jnp.asarray(choi_bloch, dtype=rdtype())
    if chunk is None:
        mat_dim = int(round(math.sqrt(x.shape[-1])))
        chunk = 10 if mat_dim >= 4096 else 100
    p = jnp.zeros_like(x)
    q = jnp.zeros_like(x)
    tol = default_cptp_tol(tol)
    done = 0
    while done < max_iter:
        x, p, q, crit = _dykstra_chunk(x, p, q, min(chunk, max_iter - done), cp)
        done += chunk
        if float(np.asarray(crit)) <= tol:
            break
    return x


@functools.partial(jax.jit, static_argnames=("cptp", "cptp_iter"))
def estimate_lifp(
    counts, a_matrix, cptp: bool = True, cptp_iter: int = 2000, cptp_tol: float = 1e-11
):
    """Linear-inversion process estimate (reference process.py:284-289).

    counts: (..., S, m, p); frequencies are normalized per input state
    (reference normalizes each tomograph's flat results). Returns the Choi
    bloch vector(s).
    """
    counts = jnp.asarray(counts, dtype=rdtype())
    s = counts.shape[-3]
    freq = counts.reshape(counts.shape[:-2] + (-1,))  # (..., S, K)
    freq = freq / jnp.sum(freq, axis=-1, keepdims=True)
    freq = freq.reshape(freq.shape[:-2] + (-1,))  # (..., S*K)
    gram = a_matrix.T @ a_matrix
    rhs = jnp.einsum("kd,...k->...d", a_matrix, freq)
    choi_bloch = jnp.linalg.solve(gram, rhs[..., None])[..., 0]
    if cptp:
        choi_bloch = cptp_project_bloch(choi_bloch, cptp_iter, cptp_tol)
    return choi_bloch


def process_nll(choi_bloch, a_matrix, unnorm_counts):
    """Poisson-style NLL: -sum(n_j log(p_j + eps))
    (reference process.py:310-314)."""
    probs = process_probabilities(a_matrix, choi_bloch)
    return -jnp.sum(unnorm_counts * jnp.log(probs + _CP_EPS), axis=-1)


def process_nll_factored_rel(
    choi_bloch, input_blochs_t, w_flat, unnorm_counts, x_ref_bloch, p_ref
):
    """Process NLL RELATIVE to an anchor estimate, in DELTA form:
    -sum_k n_k log1p(dp_k / p_ref,k) with dp = D * b (X - X_ref) w.

    Identical to :func:`process_nll_factored` minus a constant, so every
    MH acceptance ratio is unchanged in exact arithmetic. The two-stage
    anchoring exists for f32 MCMC targets:

    1. the raw-count NLL at 4 qubits is O(1e8) (f32 resolution ~8 units at
       that magnitude) while chain log-ratios are O(1-1e3);
    2. even the anchored difference log p - log p_ref computed from two
       separate bilinear forms inherits the cancellation noise of the
       p = D b X w einsum (65k near-cancelling products per entry —
       measured +-6 target noise at 4 qubits, which makes stored-logp MH
       chains stick on noise flukes and collapses step adaptation).
       Evaluating the DELTA bilinear form dp = D b (X - X_ref) w instead
       gives each summand relative-eps accuracy (measured noise ~1e-2).

    `x_ref_bloch`: (D^2,) anchor Choi bloch; `p_ref`: (S*K,) its
    probabilities under the same design, p_ref = D * b X_ref w (compute
    once with the SAME dtype/forward so p = p_ref + dp holds exactly)."""
    choi_bloch = jnp.asarray(choi_bloch, dtype=rdtype())
    b = jnp.asarray(input_blochs_t, dtype=rdtype())
    w = jnp.asarray(w_flat, dtype=rdtype())
    d1 = b.shape[-1]
    delta = choi_bloch - x_ref_bloch
    dm = delta.reshape(delta.shape[:-1] + (d1, d1))
    dp = d1 * jnp.einsum("sa,...ab,kb->...sk", b, dm, w)
    dp = dp.reshape(choi_bloch.shape[:-1] + (-1,))
    ratio = jnp.maximum(dp / jnp.maximum(p_ref, _CP_EPS), -1.0 + 1e-7)
    return -jnp.sum(unnorm_counts * jnp.log1p(ratio), axis=-1)


def process_nll_factored(choi_bloch, input_blochs_t, w_flat, unnorm_counts):
    """Process NLL with the FACTORED measurement matvec — never builds the
    (S*K, 16^n) operator (the reference materializes it for every NLL
    evaluation at process.py:197-211, its memory wall above 3 qubits).

    Identical value to :func:`process_nll` on the materialized operator:
    p[s,k] = 4^n * (B X W^T)[s,k] with B the transposed-input blochs,
    W the weighted flattened POVM rows and X the (D1, D1)-reshaped Choi
    bloch. `unnorm_counts`: flattened (S*K,) counts, matching the row order
    of measurement_operator. Batched over leading axes of choi_bloch.
    """
    choi_bloch = jnp.asarray(choi_bloch, dtype=rdtype())
    b = jnp.asarray(input_blochs_t, dtype=rdtype())
    w = jnp.asarray(w_flat, dtype=rdtype())
    d1 = b.shape[-1]
    xm = choi_bloch.reshape(choi_bloch.shape[:-1] + (d1, d1))
    probs = d1 * jnp.einsum("sa,...ab,kb->...sk", b, xm, w)
    probs = probs.reshape(choi_bloch.shape[:-1] + (-1,))
    return -jnp.sum(unnorm_counts * jnp.log(probs + _CP_EPS), axis=-1)


@functools.partial(jax.jit, static_argnames=("max_iter", "cptp_iter"))
def estimate_pgdb(
    counts,
    a_matrix,
    max_iter: int = 1000,
    tol: float = 1e-10,
    cptp_iter: int = 1000,
    cptp_tol: float = 1e-10,
):
    """Projected gradient descent with backtracking on the process NLL
    (reference process.py:291-308, 'pgdb').

    Documented divergence: the reference's stopping rule
    `if nll(old) - nll(new) > tol: break` (process.py:303) exits on LARGE
    progress, so it effectively runs a single projected step (SURVEY.md
    "known quirks"). Here the loop stops when progress is SMALL (< tol),
    i.e. at convergence.
    """
    counts = jnp.asarray(counts, dtype=rdtype())
    flat = counts.reshape(counts.shape[:-3] + (-1,))
    # Normalize to frequencies: the reference optimizes the raw-count NLL
    # (process.py:294-300), whose O(N_shots) gradient throws the projected
    # point ~1e6 bloch units away — Dykstra cannot recover from there (the
    # TP step subtracts a huge identity component, the CP step then clips
    # the matrix to ~0). The PGDB formulation (arXiv:1803.10062, eq. 6)
    # uses normalized frequencies with mu = 1.5/d^2; the maximizer is the
    # same up to the positive scale.
    flat = flat / jnp.sum(flat, axis=-1, keepdims=True)
    d2 = a_matrix.shape[-1]
    n = _n_from_d2(d2)
    # start at the Choi bloch of the fully depolarizing channel:
    # fully_mixed on 2n qubits (reference process.py:292)
    x0 = jnp.zeros(flat.shape[:-1] + (d2,), dtype=rdtype()).at[..., 0].set(
        1.0 / (4**n)
    )
    mu = 1.5 / (4**n)
    gamma = 0.3

    def nll(x):
        # probabilities of any CPTP map lie in [0, 1]; capping the log at
        # p = 1 leaves the objective unchanged on the feasible set but
        # removes the unbounded-descent failure mode where an iterate
        # inflated beyond CPTP (e.g. through an under-converged inner
        # Dykstra projection at f32, observed at 4 qubits) is
        # rewarded with ever-lower NLL
        probs = jnp.clip(
            process_probabilities(a_matrix, x), _CP_EPS, 1.0
        )
        return -jnp.sum(flat * jnp.log(probs), axis=-1)

    def backtrack(x, d, grad):
        slope = jnp.sum(d * grad, axis=-1)
        f0 = nll(x)

        def cond(carry):
            alpha, it = carry
            return jnp.logical_and(
                jnp.any(nll(x + alpha[..., None] * d) - f0 > gamma * alpha * slope),
                it < 30,
            )

        def step(carry):
            alpha, it = carry
            return alpha / 2, it + 1

        alpha0 = jnp.ones(f0.shape, dtype=rdtype())
        alpha, _ = jax.lax.while_loop(cond, step, (alpha0, jnp.asarray(0)))
        return alpha

    def cond(carry):
        _, it, delta = carry
        return jnp.logical_and(it < max_iter, delta > tol)

    def step(carry):
        x, it, _ = carry
        probs = process_probabilities(a_matrix, x)
        # gradient of the capped NLL: terms with p >= 1 contribute zero
        c = jnp.where(probs < 1.0, flat / jnp.clip(probs, _CP_EPS, None), 0.0)
        grad = -jnp.einsum("kd,...k->...d", a_matrix, c)
        d = cptp_project_bloch(x - grad / mu, cptp_iter, cptp_tol) - x
        alpha = backtrack(x, d, grad)
        x_new = x + alpha[..., None] * d
        delta = jnp.max(nll(x) - nll(x_new))
        return x_new, it + 1, delta

    x, _, _ = jax.lax.while_loop(
        cond, step, (x0, jnp.asarray(0), jnp.asarray(jnp.inf, rdtype()))
    )
    # the loop returns x + alpha*d — a convex-ish combination of projected
    # points, not exactly CPTP; project once more so the returned channel
    # is feasible (the reference returns the raw iterate)
    return cptp_project_bloch(x, cptp_iter, cptp_tol)


@functools.partial(jax.jit, static_argnames=())
def states_to_choi_bloch(output_blochs, dec):
    """Recombine per-input-state reconstructions into Choi bloch vectors.

    The 'states' method (reference process.py:316-327) composes each
    single-entry matrix E_(r,c) in the input basis and its image in the
    basis of reconstructed output states with the SAME coefficients
    dec[e, s]; since composition is linear, the whole Choi assembly is one
    einsum + reshape:

        choi[b, r*d+i, c*d+j] = sum_s dec[(r,c), s] * O[b, s, i, j]

    Parameters
    ----------
    output_blochs : (..., S, D) reconstructed output-state bloch vectors
    dec : (d^2, S) complex decomposition of single entries in the input
        basis, shipped as a real (d^2, S, 2) pair (jit boundary rule).

    Returns
    -------
    choi_bloch : (..., D^2) real Choi bloch vectors.
    """
    from ..ops.cplx import pair_to_complex

    output_blochs = jnp.asarray(output_blochs, dtype=rdtype())
    d2, s = dec.shape[0], dec.shape[1]
    d = int(round(math.sqrt(d2)))
    n = int(round(math.log2(d)))
    o_mats = bloch_to_matrix(output_blochs, n)  # (..., S, d, d)
    dec_c = pair_to_complex(jnp.asarray(dec, dtype=rdtype()))
    t = jnp.einsum("es,...sij->...eij", dec_c, o_mats)
    batch = t.shape[:-3]
    t = t.reshape(batch + (d, d, d, d))
    # axes (r, c, i, j) -> (r, i, c, j)
    perm = tuple(range(len(batch))) + tuple(
        len(batch) + k for k in (0, 2, 1, 3)
    )
    choi = t.transpose(perm).reshape(batch + (d * d, d * d))
    return matrix_to_bloch(choi)


@functools.partial(jax.jit, static_argnames=("cptp", "cptp_iter", "cp"))
def estimate_lifp_factored(
    counts,
    input_blochs_t,
    povm_matrix,
    n_measurements,
    cptp: bool = True,
    cptp_iter: int = 2000,
    cptp_tol: float = 1e-11,
    cp: str = "eigh",
):
    """Linear-inversion process estimate WITHOUT materializing the
    (S*K, 16^n) measurement operator.

    The operator factorizes as A = 4^n * (B (x) W) with B the input blochs
    and W the weighted POVM rows (probabilities live on the 2n-qubit space,
    hence the 4^n trace scale), so its Gram splits,
    (A^T A) = 16^n (B^T B) (x) (W^T W), and the normal-equation solution is

        Choi[a, b] = (1/4^n) * [(B^T B)^{-1} B^T  F  W (W^T W)^{-1}]

    with F the (S, K) frequency table — three small matmuls and two solves.
    Same estimate as estimate_lifp (parity-tested); this path scales to
    3+ qubit channels where the dense A is hundreds of MB.
    """
    counts = jnp.asarray(counts, dtype=rdtype())
    b = jnp.asarray(input_blochs_t, dtype=rdtype())  # (S, D1)
    w = state_core.weighted_povm_flat(povm_matrix, n_measurements)  # (K, D1)
    d1 = b.shape[-1]  # 4^n, also the probability trace scale
    freq = counts.reshape(counts.shape[:-2] + (-1,))  # (..., S, K)
    freq = freq / jnp.sum(freq, axis=-1, keepdims=True)
    b_pinv = jnp.linalg.solve(b.T @ b, b.T)  # (D1, S)
    w_pinv = jnp.linalg.solve(w.T @ w, w.T).T  # (K, D1)
    choi_mat = jnp.einsum(
        "ds,...sk,ke->...de", b_pinv, freq, w_pinv
    ) / d1
    choi_bloch = choi_mat.reshape(choi_mat.shape[:-2] + (d1 * d1,))
    if cptp:
        choi_bloch = cptp_project_bloch(choi_bloch, cptp_iter, cptp_tol, cp)
    return choi_bloch


def _pgdb_forward(x, b, w):
    """A x = 4^n vec(B X W^T): (..., D2) -> (..., S*K), never building A."""
    d1 = b.shape[-1]
    xm = x.reshape(x.shape[:-1] + (d1, d1))
    p = d1 * jnp.einsum("sa,...ab,kb->...sk", b, xm, w)
    return p.reshape(x.shape[:-1] + (-1,))


def _pgdb_adjoint(y, b, w):
    """A^T y = 4^n vec(B^T Y W): (..., S*K) -> (..., D2)."""
    s_count, k_count = b.shape[0], w.shape[0]
    d1 = b.shape[-1]
    ym = y.reshape(y.shape[:-1] + (s_count, k_count))
    g = d1 * jnp.einsum("sa,...sk,kb->...ab", b, ym, w)
    return g.reshape(y.shape[:-1] + (d1 * d1,))


def _pgdb_nll(x, flat, b, w):
    """Capped NLL — exact on the CPTP set (p <= 1 there); the cap removes
    the unbounded descent through infeasible iterates (see estimate_pgdb)."""
    p = jnp.clip(_pgdb_forward(x, b, w), _CP_EPS, 1.0)
    return -jnp.sum(flat * jnp.log(p), axis=-1)


_PGDB_GAMMA = 0.3


def _pgdb_backtrack(x, d_dir, grad, flat, b, w):
    """Armijo halving line search (<= 30 halvings), batched."""
    slope = jnp.sum(d_dir * grad, axis=-1)
    f0 = _pgdb_nll(x, flat, b, w)

    def cond(carry):
        alpha, it = carry
        return jnp.logical_and(
            jnp.any(
                _pgdb_nll(x + alpha[..., None] * d_dir, flat, b, w) - f0
                > _PGDB_GAMMA * alpha * slope
            ),
            it < 30,
        )

    def step(carry):
        alpha, it = carry
        return alpha / 2, it + 1

    alpha0 = jnp.ones(f0.shape, dtype=rdtype())
    alpha, _ = jax.lax.while_loop(cond, step, (alpha0, jnp.asarray(0)))
    return alpha


@functools.partial(jax.jit, static_argnames=("cptp_iter",))
def pgdb_factored_step(x, flat, b, w, cptp_iter: int = 1000, cptp_tol=1e-10):
    """ONE projected-gradient step (projection + line search), jitted.

    Building block for the host-driven pgdb loop: at 4+ qubits the outer
    descent loop lives on the host with one device call per step, which
    kept each call under a single-execution time limit of the earlier
    target (ROADMAP C1). Returns
    (x_new, nll_decrease)."""
    d1 = b.shape[-1]
    mu = 1.5 / d1
    p = _pgdb_forward(x, b, w)
    c = jnp.where(p < 1.0, flat / jnp.clip(p, _CP_EPS, None), 0.0)
    grad = -_pgdb_adjoint(c, b, w)
    d_dir = cptp_project_bloch(x - grad / mu, cptp_iter, cptp_tol) - x
    alpha = _pgdb_backtrack(x, d_dir, grad, flat, b, w)
    x_new = x + alpha[..., None] * d_dir
    delta = jnp.max(_pgdb_nll(x, flat, b, w) - _pgdb_nll(x_new, flat, b, w))
    return x_new, delta


def pgdb_prepare(counts, input_blochs_t, povm_matrix, n_measurements):
    """Shared setup for the pgdb variants: (flat frequencies, B, W, x0)."""
    counts = jnp.asarray(counts, dtype=rdtype())
    b = jnp.asarray(input_blochs_t, dtype=rdtype())  # (S, D1)
    w = state_core.weighted_povm_flat(povm_matrix, n_measurements)  # (K, D1)
    d1 = b.shape[-1]
    flat = counts.reshape(counts.shape[:-3] + (-1,))
    flat = flat / jnp.sum(flat, axis=-1, keepdims=True)
    batch = flat.shape[:-1]
    x0 = jnp.zeros(batch + (d1 * d1,), dtype=rdtype()).at[..., 0].set(1.0 / d1)
    return flat, b, w, x0


@functools.partial(jax.jit, static_argnames=("max_iter", "cptp_iter"))
def estimate_pgdb_factored(
    counts,
    input_blochs_t,
    povm_matrix,
    n_measurements,
    max_iter: int = 1000,
    tol: float = 1e-10,
    # at 3 qubits Dykstra needs ~600+ iterations for a usable projection
    # (200 left the iterate non-TP with trace 12 instead of 8, measured)
    cptp_iter: int = 1000,
    cptp_tol: float = 1e-10,
):
    """Projected-gradient process MLE with FACTORED measurement matvecs.

    Same algorithm and fixed point as :func:`estimate_pgdb`, but the
    operator A = 4^n (B (x) W) is never materialized: with the Choi bloch
    x viewed as a (D1, D1) matrix X,

        A x   = 4^n vec(B X W^T)        (probabilities)
        A^T y = 4^n vec(B^T Y W)        (gradient pullback)

    — two small matmuls each, so 3+ qubit channels (dense A ~0.5 GB) run
    in the same memory envelope as the counts. Batched over leading axes.

    The whole descent runs as one device program; for 4+ qubits use
    :func:`estimate_pgdb_factored_host` (host-chunked; ROADMAP C1).
    """
    flat, b, w, x0 = pgdb_prepare(
        counts, input_blochs_t, povm_matrix, n_measurements
    )
    d1 = b.shape[-1]
    mu = 1.5 / d1

    def cond(carry):
        _, it, delta = carry
        return jnp.logical_and(it < max_iter, delta > tol)

    def step(carry):
        x, it, _ = carry
        p = _pgdb_forward(x, b, w)
        c = jnp.where(p < 1.0, flat / jnp.clip(p, _CP_EPS, None), 0.0)
        grad = -_pgdb_adjoint(c, b, w)
        d_dir = cptp_project_bloch(x - grad / mu, cptp_iter, cptp_tol) - x
        alpha = _pgdb_backtrack(x, d_dir, grad, flat, b, w)
        x_new = x + alpha[..., None] * d_dir
        delta = jnp.max(
            _pgdb_nll(x, flat, b, w) - _pgdb_nll(x_new, flat, b, w)
        )
        return x_new, it + 1, delta

    x, _, _ = jax.lax.while_loop(
        cond, step, (x0, jnp.asarray(0), jnp.asarray(jnp.inf, rdtype()))
    )
    # project the returned iterate (x + alpha*d is not exactly CPTP)
    return cptp_project_bloch(x, cptp_iter, cptp_tol)


@functools.partial(jax.jit, static_argnames=("n_steps", "cp"))
def dys_factored_chunk(z, flat, b, w, gamma, n_steps: int, cp: str = "eigh"):
    """`n_steps` Davis-Yin three-operator-splitting iterations, jitted.

    Solves min NLL(x) + I_CP(x) + I_TP(x) with ONE eigenvalue projection
    per iteration (arXiv:1504.01032):

        x_g = P_CP(z)
        x_h = P_TP(2 x_g - z - gamma * grad NLL(x_g))
        z  += x_h - x_g

    versus pgdb's nested Dykstra (~1000 eigh calls per gradient step,
    process.py:237-257 in the reference). Returns (z, x_g, nll(x_g)) so a
    host loop can chunk the iteration (ROADMAP C1) and stop on the NLL
    plateau.

    `cp='ns'` swaps the per-iteration eigh CP prox for the Newton-Schulz
    sign-iteration projection (cp_project_bloch_ns) — at 5-6 qubits the
    1024/4096-dim eigh was the dys wall on the earlier target;
    the matmul-only prox runs the same step in milliseconds. The inexact
    prox is absorbed by the splitting (errors enter additively and the NLL
    plateau stop still governs); final feasibility is squared away by the
    caller's closing Dykstra projection.
    """
    cp_fn = cp_project_bloch_ns if cp == "ns" else cp_project_bloch

    def body(z, _):
        x_g = cp_fn(z)
        p = _pgdb_forward(x_g, b, w)
        c = jnp.where(p < 1.0, flat / jnp.clip(p, _CP_EPS, None), 0.0)
        grad = -_pgdb_adjoint(c, b, w)
        x_h = tp_project_bloch(2 * x_g - z - gamma * grad)
        return z + (x_h - x_g), None

    z, _ = jax.lax.scan(body, z, None, length=n_steps)
    x_g = cp_fn(z)
    return z, x_g, _pgdb_nll(x_g, flat, b, w)


def estimate_dys_factored(
    counts,
    input_blochs_t,
    povm_matrix,
    n_measurements,
    max_iter: int = 10000,
    tol: float | None = None,
    chunk: int | None = None,
    gamma: float | None = None,
    init_bloch=None,
    cp: str | None = None,
):
    """Process MLE via Davis-Yin splitting with factored matvecs.

    Same constrained optimum as pgdb (the CPTP maximum-likelihood Choi
    matrix) at a fraction of the cost: one CP prox per iteration instead of
    a Dykstra loop per gradient step. Host-chunked (`chunk` iterations per device
    call); stops when the per-iteration NLL decrease falls below `tol`.

    gamma is the splitting step size (must be < 2/L for the NLL gradient's
    local Lipschitz constant L); the default 0.5/4^n tracks the pgdb step
    mu = 1.5/4^n conservatively and was validated against the pgdb fixed
    point at 2 qubits (equal NLL to 1e-9).

    `cp` selects the CP-prox engine ('eigh'/'ns'); default: 'ns' at 5+
    qubits (the per-iteration 1024/4096-dim eigh is the dys wall there; NS
    replaces it with matmuls at the same NLL plateau), exact 'eigh' below.
    """
    import numpy as np

    flat, b, w, x0 = pgdb_prepare(
        counts, input_blochs_t, povm_matrix, n_measurements
    )
    d1 = b.shape[-1]
    big = d1 >= 1024  # 5+ qubits: each iteration carries a 1024+-dim eigh
    if cp is None:
        cp = "ns" if big else "eigh"
    if chunk is None:
        # per-call iteration counts sized to a single-execution time limit
        # of the earlier target (ROADMAP C1): the NS prox is matmul-only,
        # so its chunks are larger at 1024-dim, while at 4096-dim each NS
        # prox is ~9 TFLOP of matmuls, so the 6-qubit chunk stays small
        if cp == "ns":
            chunk = 500 if d1 <= 1024 else 20
        else:
            chunk = 200 if big else 500
    if gamma is None:
        gamma = 0.5 / d1
    if tol is None:
        # mean NLL decrease per iteration at the stopping plateau; the f32
        # floor is set by NLL round-off (~1e-7 per readback)
        tol = 1e-13 if np.dtype(rdtype()) == np.float64 else 1e-9
    z = (
        jnp.broadcast_to(jnp.asarray(init_bloch, dtype=rdtype()), x0.shape)
        if init_bloch is not None
        else x0
    )
    gamma = jnp.asarray(gamma, dtype=rdtype())
    last_nll = np.inf
    x_g = z
    for _ in range(0, max_iter, chunk):
        z, x_g, nll = dys_factored_chunk(z, flat, b, w, gamma, chunk, cp)
        nll_now = float(np.max(np.asarray(nll)))
        if last_nll - nll_now <= tol * chunk:
            break
        last_nll = nll_now
    # x_g is CP by construction; a final short Dykstra squares away the
    # (already small) TP residual
    if big:
        return cptp_project_bloch_host(x_g, max_iter=200, cp="ns")
    return cptp_project_bloch(x_g, 200)


def estimate_pgdb_factored_host(
    counts,
    input_blochs_t,
    povm_matrix,
    n_measurements,
    max_iter: int = 1000,
    tol: float = 1e-10,
    cptp_iter: int = 1000,
    cptp_tol: float = 1e-10,
    init_bloch=None,
):
    """pgdb with the outer descent loop on the HOST: one jitted
    projection+linesearch step per device call, convergence checked between
    calls. Identical math to :func:`estimate_pgdb_factored`; used at 4+
    qubits, where the fused while_loop exceeded a single-execution time
    limit of the earlier target (ROADMAP C1).

    `init_bloch` warm-starts the descent (e.g. from the lifp estimate:
    measured at 4 qubits, ~10 steps to the f32 NLL floor and hs error 0.33
    vs 1.33 after 40 steps from the reference's fully-depolarized start)."""
    import numpy as np

    flat, b, w, x = pgdb_prepare(
        counts, input_blochs_t, povm_matrix, n_measurements
    )
    if init_bloch is not None:
        x = jnp.broadcast_to(
            jnp.asarray(init_bloch, dtype=rdtype()), x.shape
        )
    for _ in range(max_iter):
        x, delta = pgdb_factored_step(x, flat, b, w, cptp_iter, cptp_tol)
        if float(np.asarray(delta)) <= tol:
            break
    return cptp_project_bloch(x, cptp_iter, cptp_tol)


def kron_fisher_whitener(
    input_blochs_t, w_flat, flat_counts, choi_bloch_hat, ridge: float = 1e-4
):
    """Kronecker-factored Gauss-Newton whitener of the process NLL at a
    point estimate — the preconditioner for MALA process sampling.

    The factored measurement model is p[s, k] = D1 * (B X W^T)[s, k]
    (:func:`process_nll_factored`), so the NLL's Gauss-Newton matrix at
    X_hat is a weighted sum of Kronecker squares,

        H  =  D1^2 * sum_{s,k} r[s,k] (b_s b_s^T) (x) (w_k w_k^T),
        r[s,k] = c[s,k] / p_hat[s,k]^2 .

    The rank-1 (independence) fit r[s,k] ~ u[s] v[k] / sum(r) turns H into
    one Kronecker product H ~ F_B (x) F_W with F_B = B^T diag(u) B and
    F_W = W^T diag(v) W — the K-FAC recipe specialized to the bilinear
    tomography design, computable with two D1 x D1 Grams instead of the
    16^n x 16^n Hessian. Each factor gets a relative ridge
    `ridge * tr(F)/D1` before Cholesky: it bounds the amplification of the
    design's null directions (the TP-fixed coordinates the projection
    overwrites and anything outside the POVM row span), which carry no
    likelihood curvature.

    Returns host float64 ``(a_b, a_w, l_b, l_w)`` with F = L L^T per side:
    the whitening map is z = (L_B^T (x) L_W^T) x and the unwhitening map
    x = (A_B (x) A_W) z with A = L^{-T}, so a unit-isotropic MALA step in z
    is exactly Fisher-preconditioned MALA in x (proposal covariance
    ~ H^{-1}). No reference counterpart (the reference's sampler is an
    isotropic random walk, quantpy/tomography/interval.py:762-850).
    """
    from scipy.linalg import solve_triangular

    b = np.asarray(input_blochs_t, dtype=np.float64)
    w = np.asarray(w_flat, dtype=np.float64)
    d1 = b.shape[-1]
    c = np.asarray(flat_counts, dtype=np.float64).reshape(b.shape[0], -1)
    x_hat = np.asarray(choi_bloch_hat, dtype=np.float64).reshape(d1, d1)
    p_hat = d1 * (b @ x_hat @ w.T)
    # floor the model probabilities at half a count of the busiest row so a
    # boundary estimate (p_hat ~ 0 where c > 0) cannot blow up one weight
    floor = 0.5 / max(float(c.sum(axis=-1).max()), 1.0)
    p_hat = np.maximum(p_hat, floor)
    r = c / (p_hat * p_hat)
    total = float(r.sum())
    if total <= 0.0:  # no counts at all — fall back to the identity metric
        eye = np.eye(d1)
        return eye, eye, eye, eye
    u = r.sum(axis=1)
    v = r.sum(axis=0) / total
    f_b = (b * u[:, None]).T @ b
    f_w = (w * v[:, None]).T @ w
    out = []
    for f in (f_b, f_w):
        lam = ridge * float(np.trace(f)) / d1
        l = np.linalg.cholesky(f + lam * np.eye(d1))
        a = solve_triangular(l, np.eye(d1), lower=True).T  # L^{-T}
        out.append((a, l))
    (a_b, l_b), (a_w, l_w) = out
    return a_b, a_w, l_b, l_w
