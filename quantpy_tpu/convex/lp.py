"""Batched linear programming on device via PDHG (Chambolle-Pock).

The reference solves its confidence-polytope LPs with cvxopt, two per
confidence level in a Python loop (reference
quantpy/tomography/interval.py:317-329, 394-411):

    min <c, x>  s.t.  A x <= b

Here hundreds of such LPs (one per polytope margin delta, for +/-c) run as
ONE jitted primal-dual iteration, batched over the b vectors. The problems
are tiny (D <= a few hundred variables), so even tens of thousands of PDHG
iterations are cheap on the device.

PDHG for  min_x c^T x + I_{<=b}(Ax):
    y_{k+1} = max(0, y_k + sigma (A xbar_k - b))
    x_{k+1} = x_k - tau (c + A^T y_{k+1})
    xbar_{k+1} = 2 x_{k+1} - x_k
with tau * sigma * ||A||^2 < 1.

Convergence control: the
iteration runs in chunks under a lax.while_loop and stops when the worst
LP of the batch satisfies the standard PDHG optimality residuals —
primal feasibility ||(Ax - b)_+||_inf, dual feasibility ||c + A^T y||_inf
(with y >= 0 by construction), and the complementarity gap
|c^T x + b^T y| (strong duality: at the optimum c^T x = -b^T y) — all
below tol * (1 + problem scale). The number of iterations actually used is
returned for diagnostics.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import rdtype

__all__ = ["solve_lp_batch", "solve_lp_batch_kron", "solve_lp_batch_factors"]

#: iterations per convergence check
_CHUNK = 500


@functools.partial(jax.jit, static_argnames=("n_iter",))
def _pdhg(c_batch, a_matrix, b_batch, tau, sigma, n_iter, tol):
    """Chunked PDHG with residual-based early stopping.

    c_batch (..., D), a_matrix (K, D), b_batch (..., K). Returns
    (x, obj, viol, iters)."""

    def pdhg_chunk(carry_xy, _):
        x, xbar, y = carry_xy
        y = jnp.maximum(
            0.0, y + sigma * (jnp.einsum("kd,...d->...k", a_matrix, xbar) - b_batch)
        )
        x_new = x - tau * (c_batch + jnp.einsum("kd,...k->...d", a_matrix, y))
        xbar = 2 * x_new - x
        return (x_new, xbar, y), None

    def converged(x, y):
        ax = jnp.einsum("kd,...d->...k", a_matrix, x)
        res_p = jnp.max(jnp.maximum(ax - b_batch, 0.0))
        res_d = jnp.max(
            jnp.abs(c_batch + jnp.einsum("kd,...k->...d", a_matrix, y))
        )
        p_obj = jnp.sum(c_batch * x, axis=-1)
        d_obj = -jnp.sum(b_batch * y, axis=-1)
        gap = jnp.max(jnp.abs(p_obj - d_obj))
        scale = 1.0 + jnp.max(jnp.abs(p_obj)) + jnp.max(jnp.abs(d_obj))
        return (
            (res_p <= tol * (1.0 + jnp.max(jnp.abs(b_batch))))
            & (res_d <= tol * (1.0 + jnp.max(jnp.abs(c_batch))))
            & (gap <= tol * scale)
        )

    def cond(carry):
        _, _, _, it, done = carry
        return jnp.logical_and(it < n_iter, jnp.logical_not(done))

    def step(carry):
        x, xbar, y, it, _ = carry
        (x, xbar, y), _ = jax.lax.scan(
            pdhg_chunk, (x, xbar, y), None, length=_CHUNK
        )
        return x, xbar, y, it + _CHUNK, converged(x, y)

    x0 = jnp.zeros_like(c_batch)
    y0 = jnp.zeros_like(b_batch)
    x, _, y, iters, _ = jax.lax.while_loop(
        cond, step, (x0, x0, y0, jnp.asarray(0), jnp.asarray(False))
    )
    obj = jnp.sum(c_batch * x, axis=-1)
    viol = jnp.max(
        jnp.maximum(
            jnp.einsum("kd,...d->...k", a_matrix, x) - b_batch, 0.0
        ),
        axis=-1,
    )
    return x, obj, viol, iters


def _kron_ops(static_ctx, povm1):
    """(fwd, adj) for the kron-factored polytope constraint operator
    A = 2^n * (kron povm1 rows)[:, 1:] — variables are the traceless bloch
    components, the matvecs are the factored forward/adjoint chains from
    kron_core (the dense matrix at 6 qubits would be 0.8 GB x the delta
    grid)."""
    from ..tomography.kron_core import kron_adjoint_flat, kron_forward_flat

    n_qubits = static_ctx
    dim = 2**n_qubits

    def fwd(v):
        vfull = jnp.concatenate(
            [jnp.zeros(v.shape[:-1] + (1,), v.dtype), v], axis=-1
        )
        return dim * kron_forward_flat(povm1, n_qubits, vfull)

    def adj(w):
        return dim * kron_adjoint_flat(povm1, n_qubits, w)[..., 1:]

    return fwd, adj


def _factors_ops(static_ctx, left, right):
    """(fwd, adj) for the two-factor operator A = left (x) right (the
    process polytope constraint matrix, interval.py:483-485 — dense at 4
    qubits it would be (256*1296) x 65280 ~ 86 GB). Variables travel
    flattened (..., A*B); constraints flattened (..., S*K)."""
    a_dim, b_dim = static_ctx

    def fwd(v):
        vm = v.reshape(v.shape[:-1] + (a_dim, b_dim))
        out = jnp.einsum("sa,...ab,kb->...sk", left, vm, right, optimize=True)
        return out.reshape(v.shape[:-1] + (-1,))

    def adj(w):
        wm = w.reshape(w.shape[:-1] + (left.shape[0], right.shape[0]))
        out = jnp.einsum("sa,...sk,kb->...ab", left, wm, right, optimize=True)
        return out.reshape(w.shape[:-1] + (-1,))

    return fwd, adj


@functools.partial(jax.jit, static_argnames=("make_ops", "static_ctx", "n_chunk"))
def _pdhg_matvec_chunk(
    operands, c_batch, b_batch, x, xbar, y, tau, sigma, make_ops, static_ctx, n_chunk
):
    """Run `n_chunk` PDHG iterations with matvecs built by
    `make_ops(static_ctx, *operands)` and return the updated state plus
    the convergence residuals. Host-chunked: the caller loops over chunks
    and checks the residuals, which kept each device execution under a
    single-execution time limit of the earlier target (ROADMAP C1).
    """
    fwd, adj = make_ops(static_ctx, *operands)

    def body(carry, _):
        x, xbar, y = carry
        y = jnp.maximum(0.0, y + sigma * (fwd(xbar) - b_batch))
        x_new = x - tau * (c_batch + adj(y))
        return (x_new, 2 * x_new - x, y), None

    (x, xbar, y), _ = jax.lax.scan(body, (x, xbar, y), None, length=n_chunk)

    ax = fwd(x)
    viol = jnp.max(jnp.maximum(ax - b_batch, 0.0), axis=-1)
    res_p = jnp.max(viol)
    res_d = jnp.max(jnp.abs(c_batch + adj(y)))
    obj = jnp.sum(c_batch * x, axis=-1)
    d_obj = -jnp.sum(b_batch * y, axis=-1)
    gap = jnp.max(jnp.abs(obj - d_obj))
    scale = 1.0 + jnp.max(jnp.abs(obj)) + jnp.max(jnp.abs(d_obj))
    return x, xbar, y, obj, viol, res_p, res_d, gap, scale


def _solve_chunked(
    c, b, operands, make_ops, static_ctx, norm, n_iter, tol,
    tau=None, sigma=None,
):
    """Shared chunked-PDHG driver with residual-based early stopping for
    the matvec (kron / two-factor) solvers. c and b are flattened
    (..., D) / (..., K); returns (x, obj, viol, iters). `tau`/`sigma`
    override the scalar 0.9/norm steps with per-variable/per-constraint
    arrays (diagonal preconditioning)."""
    if tol is None:
        tol = 1e-9 if np.dtype(rdtype()) == np.float64 else 3e-5
    if tau is None:
        tau = jnp.asarray(0.9 / norm, dtype=rdtype())
        sigma = jnp.asarray(0.9 / norm, dtype=rdtype())
    else:
        tau = jnp.asarray(tau, dtype=rdtype())
        sigma = jnp.asarray(sigma, dtype=rdtype())
    b_scale = 1.0 + float(jnp.max(jnp.abs(b)))
    c_scale = 1.0 + float(jnp.max(jnp.abs(c)))
    x = jnp.zeros_like(c)
    xbar = x
    y = jnp.zeros_like(b)
    iters = 0
    obj = viol = None
    while iters < n_iter:
        x, xbar, y, obj, viol, res_p, res_d, gap, scale = _pdhg_matvec_chunk(
            operands, c, b, x, xbar, y, tau, sigma, make_ops, static_ctx, _CHUNK
        )
        iters += _CHUNK
        if (
            float(res_p) <= tol * b_scale
            and float(res_d) <= tol * c_scale
            and float(gap) <= tol * float(scale)
        ):
            break
    return x, obj, viol, iters


def solve_lp_batch_kron(
    c,
    povm1,
    n_qubits: int,
    b_batch,
    n_iter: int = 20000,
    tol: float | None = None,
):
    """Factored twin of :func:`solve_lp_batch` for kron-mode tomographs.

    Solves min <c, x> s.t. 2^n (kron povm1 rows)[:, 1:] x <= b for a batch
    of right-hand sides without materializing the constraint matrix.
    Same return signature as solve_lp_batch: (x, obj, viol, iters).
    """
    povm1 = jnp.asarray(povm1, dtype=rdtype())
    b = jnp.asarray(b_batch, dtype=rdtype())
    c = jnp.asarray(c, dtype=rdtype())
    if c.ndim == 1:
        c = jnp.broadcast_to(c, b.shape[:-1] + c.shape)
    # ||A||_2 <= 2^n * sigma_max(A1)^n; dropping the trace column only
    # shrinks the norm, so this keeps tau * sigma * ||A||^2 < 1
    a1 = np.asarray(povm1, dtype=np.float64).reshape(-1, 4)
    norm = 2.0**n_qubits * float(np.linalg.svd(a1, compute_uv=False)[0]) ** n_qubits
    return _solve_chunked(
        c, b, (povm1,), _kron_ops, n_qubits, norm, n_iter, tol
    )


def solve_lp_batch_factors(
    c,
    left,
    right,
    b_batch,
    n_iter: int = 20000,
    tol: float | None = None,
):
    """Two-Kronecker-factor twin of :func:`solve_lp_batch`.

    Solves min <c, x> s.t. (left (x) right) x <= b for a batch of
    right-hand sides without materializing the constraint matrix.
    `c` is (A, B) or (..., A, B); `left` (S, A); `right` (K, B); `b_batch`
    (..., S, K). Returns (x, obj, viol, iters) with x of shape
    (..., A, B) and flattened-column order matching
    kron(left, right) = einsum('sa,kb->skab').reshape(S K, A B).
    """
    left = jnp.asarray(left, dtype=rdtype())
    right = jnp.asarray(right, dtype=rdtype())
    b = jnp.asarray(b_batch, dtype=rdtype())
    c = jnp.asarray(c, dtype=rdtype())
    if c.ndim == 2:
        c = jnp.broadcast_to(c, b.shape[:-2] + c.shape)
    a_dim, b_dim = c.shape[-2], c.shape[-1]
    # Pock-Chambolle diagonal preconditioning (alpha = 1): per-variable
    # tau_j = 1/sum_i |A_ij| and per-constraint sigma_i = 1/sum_j |A_ij|.
    # For A = kron(L, R) both abs-sums are outer products of the factors'
    # abs-sums — no materialization. The scalar 0.9/||A|| steps stall on
    # this badly row-scaled LP (the 4-qubit process polytope ran its full
    # 20k-iteration budget without reaching feasibility).
    l_abs = np.abs(np.asarray(left, np.float64))
    r_abs = np.abs(np.asarray(right, np.float64))
    eps = 1e-30
    tau = 1.0 / np.maximum(
        np.outer(l_abs.sum(axis=0), r_abs.sum(axis=0)).reshape(-1), eps
    )
    sigma = 1.0 / np.maximum(
        np.outer(l_abs.sum(axis=1), r_abs.sum(axis=1)).reshape(-1), eps
    )
    x, obj, viol, iters = _solve_chunked(
        c.reshape(c.shape[:-2] + (-1,)),
        b.reshape(b.shape[:-2] + (-1,)),
        (left, right),
        _factors_ops,
        (a_dim, b_dim),
        1.0,
        n_iter,
        tol,
        tau=tau,
        sigma=sigma,
    )
    return x.reshape(x.shape[:-1] + (a_dim, b_dim)), obj, viol, iters


def solve_lp_batch(c, a_matrix, b_batch, n_iter: int = 20000, tol: float | None = None):
    """Solve min <c, x> s.t. A x <= b for a batch of right-hand sides.

    Parameters
    ----------
    c : (D,) or (..., D) objective(s)
    a_matrix : (K, D) constraint matrix (shared)
    b_batch : (..., K) right-hand sides
    n_iter : iteration cap (checked every 500 iterations)
    tol : residual/duality-gap tolerance for early stopping; default
        1e-9 in x64, 3e-5 in f32 (the PDHG drift floor at f32)

    Returns
    -------
    x : (..., D) solutions
    obj : (...,) objective values
    viol : (...,) max residual constraint violation (diagnostic)
    iters : () number of iterations actually run (diagnostic)
    """
    a = jnp.asarray(a_matrix, dtype=rdtype())
    b = jnp.asarray(b_batch, dtype=rdtype())
    c = jnp.asarray(c, dtype=rdtype())
    if c.ndim == 1:
        c = jnp.broadcast_to(c, b.shape[:-1] + c.shape)
    if tol is None:
        tol = 1e-9 if np.dtype(rdtype()) == np.float64 else 3e-5
    norm = float(np.linalg.norm(np.asarray(a, dtype=np.float64), ord=2))
    tau = jnp.asarray(0.9 / norm, dtype=rdtype())
    sigma = jnp.asarray(0.9 / norm, dtype=rdtype())
    return _pdhg(c, a, b, tau, sigma, n_iter, jnp.asarray(tol, dtype=rdtype()))
