"""Kron-factored measurement paths — tomography without materializing POVMs.

For product POVMs (every preset, and any per-qubit design) the full
measurement matrix is a Kronecker power: at 6 qubits, proj-set is
(729, 64, 4096) = 0.8 GB of redundant structure, and the reference's dense
linear inversion over it takes ~45 s (BASELINE.md). This module exploits the
factorization end to end:

- probabilities p = (2^n/M) * (kron_n A1) bloch  -> an einsum chain of
  per-GROUP (3 qubits each: (27, 8, 64) for proj-set) contractions,
  O(n) chain length; per-qubit radix-4 chains are avoided because their
  2/4-sized minor dimensions made the chain relayout-bound on the earlier
  target (not measured on the H100; ROADMAP C2);
- the adjoint A^T c is the mirrored chain;
- the linear-inversion Gram matrix factorizes: (kron A1)^T (kron A1) =
  kron(A1^T A1), so the normal-equation solve is n tiny 4x4 solves applied
  as another einsum chain;
- RrhoR MLE reuses the same two chains for its matvecs.

Everything is jitted with real-only boundaries; the only 6^n-sized arrays
are the outcome counts themselves.

Restriction: uniform shot counts per POVM (warm-start reweighting breaks
the product structure; the dense path handles that case).
"""

from __future__ import annotations

import functools
import math
import string

import jax
import jax.numpy as jnp
import numpy as np

from ..config import rdtype
from ..ops.paulis import bloch_to_matrix, group_sizes, matrix_to_bloch
from ..ops.sampling import sample_multinomial

__all__ = [
    "kron_probs",
    "kron_apply_adjoint",
    "kron_forward_flat",
    "kron_adjoint_flat",
    "kron_row_component",
    "kron_simulate",
    "kron_simulate_chunked",
    "kron_estimate_lin",
    "kron_estimate_mle_rhor",
]

_NLL_EPS = 1e-10


def _subscripts(n: int, batch: str = "z"):
    """Index letters for the n-qubit chains: (m_k, p_k, d_k) per qubit."""
    letters = string.ascii_lowercase.replace(batch, "") + string.ascii_uppercase
    m = letters[:n]
    p = letters[n : 2 * n]
    d = letters[2 * n : 3 * n]
    return m, p, d


def _forward_spec(n: int) -> str:
    """einsum: bloch (z, d1..dn) x n povm1 factors -> (z, m1..mn, p1..pn)."""
    m, p, d = _subscripts(n)
    operands = ["z" + "".join(d)]
    operands += [m[k] + p[k] + d[k] for k in range(n)]
    return ",".join(operands) + "->z" + "".join(m) + "".join(p)


def _adjoint_spec(n: int) -> str:
    """einsum: c (z, m.., p..) x n povm1 factors -> (z, d1..dn)."""
    m, p, d = _subscripts(n)
    operands = ["z" + "".join(m) + "".join(p)]
    operands += [m[k] + p[k] + d[k] for k in range(n)]
    return ",".join(operands) + "->z" + "".join(d)


def _solve_spec(n: int) -> str:
    """einsum: rhs (z, d1..dn) x n gram-inverse factors -> (z, e1..en)."""
    m, p, d = _subscripts(n)
    e = p  # reuse letters: p's are free here
    operands = ["z" + "".join(d)]
    operands += [d[k] + e[k] for k in range(n)]
    return ",".join(operands) + "->z" + "".join(e)


def _grouped_factors(povm1, n_qubits: int):
    """Kron the per-qubit factor into per-GROUP factors (3 qubits a group).

    The per-qubit einsum chain leaves every intermediate with minor
    dimensions of 2/4, which made the 6-qubit MLE loop relayout-bound on
    the earlier target. Grouped factors (27, 8, 64) keep the same
    O(n)-chain structure with larger minor dimensions.
    Returns (groups, factors): group sizes and the (m1^g, p1^g, 4^g) arrays.
    """
    povm1 = jnp.asarray(povm1, dtype=rdtype())
    groups = group_sizes(n_qubits)
    factors = []
    for g in groups:
        f = povm1
        for _ in range(g - 1):
            f = jnp.einsum("mpd,nqe->mnpqde", f, povm1).reshape(
                f.shape[0] * povm1.shape[0],
                f.shape[1] * povm1.shape[1],
                f.shape[2] * povm1.shape[2],
            )
        factors.append(f)
    return groups, factors


#: per-resample design volume (m1*p1)^n above which the grouped einsum
#: chains switch to the m-block-chunked evaluation (see
#: _forward_grouped_chunked): at 11 qubits the fused chain's 9-axis
#: intermediate (27,27,27,9,8,8,8,4) was lane-padded 32x by the earlier
#: target's (8, 128) tiling and did not fit its memory. 6^10 = 60M sits
#: under this bound, 6^11 = 363M over it. Not re-derived for the H100's
#: 80 GB (ROADMAP C2).
CHUNKED_CHAIN_VOLUME = 1 << 27


def _chunked_specs(k: int):
    """einsum specs for one m0-slice of the first group.

    forward: bloch (z, d0..dk-1) x f0-slice (p0, d0) x rest (mj, pj, dj)
             -> (z, m1..mk-1, p0, p1..pk-1)
    adjoint: the mirror, back to (z, d0..dk-1)."""
    m, p, d = _subscripts(k)
    f_ops = [p[0] + d[0]] + [m[j] + p[j] + d[j] for j in range(1, k)]
    out = "z" + "".join(m[1:]) + p[0] + "".join(p[1:])
    fwd = ",".join(["z" + "".join(d)] + f_ops) + "->" + out
    adj = ",".join([out] + f_ops) + "->z" + "".join(d)
    return fwd, adj


def _forward_grouped_chunked(x, factors, groups):
    """Forward chain chunked over the FIRST group's measurement axis.

    At 11+ qubits the fused multi-axis einsum intermediate lane-pads to
    ~24.5 GB (see CHUNKED_CHAIN_VOLUME). Evaluating one m0-slice at a
    time shrinks every padded intermediate by M0 (= 27 for 3-qubit
    proj-set groups) while the block results assemble into the clean 2-D
    flat output; lax.map keeps it one compiled program.
    Returns (z, M_total, P_total)."""
    k = len(groups)
    f0 = factors[0]
    m0 = f0.shape[0]
    fwd, _ = _chunked_specs(k)
    m_rest = int(np.prod([f.shape[0] for f in factors[1:]], initial=1))
    p_tot = int(np.prod([f.shape[1] for f in factors]))

    def block(f0_slice):
        out = jnp.einsum(fwd, x, f0_slice, *factors[1:], optimize=True)
        return out.reshape(x.shape[0], m_rest, p_tot)

    out = jax.lax.map(block, f0)  # (m0, z, m_rest, p_tot)
    out = jnp.moveaxis(out, 0, 1)
    return out.reshape(x.shape[0], m0 * m_rest, p_tot)


def _adjoint_grouped_chunked(c, factors, groups, d_shape):
    """Adjoint chain chunked over the first group's measurement axis:
    accumulates sum_m0 A_m0^T c_m0 with one m0-slice materialized at a
    time (the mirror of :func:`_forward_grouped_chunked`).
    `c`: (z, M_total, P_total); returns (z, 4^n)."""
    k = len(groups)
    f0 = factors[0]
    m0, p0 = f0.shape[0], f0.shape[1]
    _, adj = _chunked_specs(k)
    m_rest = [f.shape[0] for f in factors[1:]]
    p_rest = [f.shape[1] for f in factors[1:]]
    z = c.shape[0]
    # slice on the CLEAN 3-D layout; only the per-block slice takes the
    # padded multi-axis view (1/m0 of the fused chain's request)
    c3 = c.reshape(z, m0, int(np.prod(m_rest, initial=1)), c.shape[-1])

    def body(acc, f0_and_slice):
        f0_slice, c_slice = f0_and_slice
        cb = c_slice.reshape((z, *m_rest, p0, *p_rest))
        out = jnp.einsum(adj, cb, f0_slice, *factors[1:], optimize=True)
        return acc + out, None

    init = jnp.zeros((z,) + tuple(d_shape), dtype=c.dtype)
    acc, _ = jax.lax.scan(body, init, (f0, jnp.moveaxis(c3, 1, 0)))
    return acc.reshape(z, -1)


def kron_probs(povm1, n_qubits: int, bloch):
    """Outcome probabilities 2^n * (kron povm1) . bloch, clipped to [0, 1].

    povm1: (m1, p1, 4); bloch: (..., 4^n). Returns (..., m1^n, p1^n).
    Matches state_core.experiment_probabilities on the materialized POVM.
    Above CHUNKED_CHAIN_VOLUME the chain evaluates one first-group
    m-slice at a time (the 11-qubit enabler)."""
    bloch = jnp.asarray(bloch, dtype=rdtype())
    n = n_qubits
    m1, p1, _ = povm1.shape
    groups, factors = _grouped_factors(povm1, n)
    k = len(groups)
    batch_shape = bloch.shape[:-1]
    x = bloch.reshape((-1,) + tuple(4**g for g in groups))
    if (m1 * p1) ** n > CHUNKED_CHAIN_VOLUME:
        out = _forward_grouped_chunked(x, factors, groups)
    else:
        out = jnp.einsum(_forward_spec(k), x, *factors, optimize=True)
    out = out.reshape(batch_shape + (m1**n, p1**n)) * (2**n)
    return jnp.clip(out, 0.0, 1.0)


def kron_apply_adjoint(povm1, n_qubits: int, c):
    """(kron povm1)^T c for c of shape (..., m1^n, p1^n) -> (..., 4^n).
    Above CHUNKED_CHAIN_VOLUME the mirror of the chunked forward runs
    (one first-group m-slice at a time, scan-accumulated)."""
    c = jnp.asarray(c, dtype=rdtype())
    n = n_qubits
    m1, p1, _ = povm1.shape
    groups, factors = _grouped_factors(povm1, n)
    k = len(groups)
    batch_shape = c.shape[:-2]
    if (m1 * p1) ** n > CHUNKED_CHAIN_VOLUME:
        out = _adjoint_grouped_chunked(
            c.reshape((-1,) + c.shape[-2:]),
            factors,
            groups,
            tuple(4**g for g in groups),
        )
        return out.reshape(batch_shape + (4**n,))
    x = c.reshape(
        (-1,)
        + tuple(f.shape[0] for f in factors)
        + tuple(f.shape[1] for f in factors)
    )
    out = jnp.einsum(_adjoint_spec(k), x, *factors, optimize=True)
    return out.reshape(batch_shape + (4**n,))


@jax.jit
def kron_simulate(key, povm1, bloch, n_shots):
    """Multinomial experiment simulation on the factored design.

    bloch (..., 4^n); returns counts (..., m1^n, p1^n); n_shots scalar
    (uniform shots per POVM)."""
    import math as _math

    povm1 = jnp.asarray(povm1, dtype=rdtype())
    n = int(round(_math.log(jnp.asarray(bloch).shape[-1], 4)))
    probs = kron_probs(povm1, n, bloch)
    n_arr = jnp.full(probs.shape[:-1], n_shots, dtype=rdtype())
    return sample_multinomial(key, n_arr, probs)


def kron_simulate_chunked(key, povm1, bloch, n_shots, n_calls: int | None = None):
    """Multinomial simulation split into `n_calls` HOST-dispatched device
    calls over the first measurement group's m-axis.

    Each POVM row is an independent multinomial, so drawing m-blocks in
    separate device calls samples exactly the same design as
    :func:`kron_simulate` (with a different key stream: one fold per
    block). This exists for the 11+ qubit scale, where the fused draw
    came close to a single-execution time limit of the earlier target
    (ROADMAP C1). `n_calls=None` picks the first-group m-size (27
    one-slice calls at 11 qubits; not measured on the H100); eager only.
    """
    bloch = jnp.asarray(bloch, dtype=rdtype())
    n = int(round(math.log(bloch.shape[-1], 4)))
    povm1 = jnp.asarray(povm1, dtype=rdtype())
    groups, factors = _grouped_factors(povm1, n)
    f0 = factors[0]
    m0 = f0.shape[0]
    if n_calls is None:
        n_calls = m0
    n_calls = max(1, min(int(n_calls), m0))
    block = -(-m0 // n_calls)
    batch_shape = bloch.shape[:-1]
    x = bloch.reshape((-1,) + tuple(4**g for g in groups))
    m_rest = int(np.prod([f.shape[0] for f in factors[1:]], initial=1))
    p_tot = int(np.prod([f.shape[1] for f in factors]))
    fwd = _forward_spec(len(groups))

    @jax.jit
    def draw_block(k, f0_blk):
        probs = jnp.einsum(fwd, x, f0_blk, *factors[1:], optimize=True)
        probs = jnp.clip(probs * (2**n), 0.0, 1.0)
        probs = probs.reshape(x.shape[0], f0_blk.shape[0] * m_rest, p_tot)
        n_arr = jnp.full(probs.shape[:-1], n_shots, dtype=rdtype())
        return sample_multinomial(k, n_arr, probs)

    # blocks STAY on device: the calls are separate executions either way,
    # and a host round trip per slab would add a transfer per block
    parts = []
    for i, k in enumerate(jax.random.split(key, -(-m0 // block))):
        parts.append(draw_block(k, f0[i * block : (i + 1) * block]))
    counts = jnp.concatenate(parts, axis=1)
    return counts.reshape(batch_shape + (m0 * m_rest, p_tot))


def kron_forward_flat(povm1, n_qubits: int, bloch):
    """Raw (kron povm1) @ bloch with rows flattened: (..., m1^n * p1^n).

    Unlike :func:`kron_probs` there is no 2^n scaling and no clipping —
    this is the plain linear operator, the matvec the LP/PDHG layer needs
    (dense twin: povm_matrix.reshape(-1, 4^n) @ bloch).
    """
    bloch = jnp.asarray(bloch, dtype=rdtype())
    n = n_qubits
    m1, p1, _ = povm1.shape
    groups, factors = _grouped_factors(povm1, n)
    batch_shape = bloch.shape[:-1]
    x = bloch.reshape((-1,) + tuple(4**g for g in groups))
    if (m1 * p1) ** n > CHUNKED_CHAIN_VOLUME:
        out = _forward_grouped_chunked(x, factors, groups)
    else:
        out = jnp.einsum(_forward_spec(len(groups)), x, *factors, optimize=True)
    return out.reshape(batch_shape + ((m1 * p1) ** n,))


def kron_adjoint_flat(povm1, n_qubits: int, c):
    """(kron povm1)^T c for flat c of shape (..., m1^n * p1^n) -> (..., 4^n)."""
    c = jnp.asarray(c, dtype=rdtype())
    m1, p1, _ = povm1.shape
    return kron_apply_adjoint(
        povm1, n_qubits, c.reshape(c.shape[:-1] + (m1**n_qubits, p1**n_qubits))
    )


def kron_nll_tril(tril_vec, povm1, n_qubits: int, freq_flat, m_total: int):
    """NLL of a Cholesky parameter vector on the kron-factored design.

    Identical numbers to state_core.nll_tril on the materialized POVM with
    uniform row weights 1/m (the only weighting the kron path supports);
    probabilities run through the factored forward chain. Differentiable —
    used by the MHMC state interval at 6+ qubits."""
    from .state_core import real_tril_vec_to_matrix

    rho = real_tril_vec_to_matrix(tril_vec, 2**n_qubits)
    tr = jnp.trace(rho, axis1=-2, axis2=-1).real
    bloch = matrix_to_bloch(rho) / tr[..., None]
    probs = kron_forward_flat(povm1, n_qubits, bloch) * (2**n_qubits / m_total)
    return -jnp.sum(freq_flat * jnp.log(probs + _NLL_EPS), axis=-1)


def kron_row_component(povm1, n_qubits: int, component: int = 0) -> np.ndarray:
    """One bloch component of every flattened design row: (m1^n * p1^n,).

    Row (m-multi, p-multi) is the kron of per-qubit rows, so its
    `component`-th entry factorizes into a product of per-qubit entries;
    used for the LP right-hand sides (dense twin: povm_flat[:, component]).
    Only component 0 (the trace column) is meaningful per-qubit-wise."""
    assert component == 0
    t = np.asarray(povm1, dtype=np.float64)[:, :, 0]  # (m1, p1)
    out = t
    for _ in range(n_qubits - 1):
        out = np.einsum("mp,nq->mnpq", out, t).reshape(
            out.shape[0] * t.shape[0], out.shape[1] * t.shape[1]
        )
    return out.reshape(-1)


def _gram1_inv(povm1) -> jnp.ndarray:
    """Inverse single-qubit Gram factor (A1^T A1)^{-1}, A1 = flattened rows."""
    a1 = jnp.asarray(povm1, dtype=rdtype()).reshape(-1, povm1.shape[-1])
    return jnp.linalg.inv(a1.T @ a1)


def _grouped_gram_inv(povm1, groups):
    """Per-group inverse Gram factors kron(G1^{-1}, ...) = (kron G1)^{-1}."""
    g1 = _gram1_inv(povm1)
    out = []
    for g in groups:
        f = g1
        for _ in range(g - 1):
            f = jnp.kron(f, g1)
        out.append(f)
    return out


@functools.partial(jax.jit, static_argnames=("n_qubits", "physical"))
def kron_estimate_lin(counts, povm1, n_qubits: int, physical: bool = True):
    """Linear inversion on the factored design (uniform weights).

    Solves the same weighted least-squares problem as state_core.estimate_lin
    (weights w_m = 1/M cancel between Gram and rhs for uniform shots):
        bloch = kron(G1^{-1}) A^T f_rownorm * M / 2^n ... assembled from
    per-qubit factors; no array larger than the counts is formed.
    """
    counts = jnp.asarray(counts, dtype=rdtype())
    n = n_qubits
    m_total = counts.shape[-2]
    batch_shape = counts.shape[:-2]
    freq = counts / jnp.sum(counts, axis=(-2, -1), keepdims=True)
    rhs = kron_apply_adjoint(povm1, n, freq)  # (batch, 4^n), carries 1/M via f
    groups = group_sizes(n)
    gram_invs = _grouped_gram_inv(povm1, groups)
    x = rhs.reshape((-1,) + tuple(4**g for g in groups))
    sol = jnp.einsum(_solve_spec(len(groups)), x, *gram_invs, optimize=True)
    # undo uniform weighting: A_w = A/M in both gram (1/M^2) and rhs (1/M)
    bloch = sol.reshape(batch_shape + (4**n,)) * m_total / (2**n)
    if physical:
        from .state_core import make_feasible_bloch

        bloch = make_feasible_bloch(bloch, n)
    return bloch


@functools.partial(jax.jit, static_argnames=("n_qubits", "max_iter"))
def kron_estimate_mle_rhor(
    counts,
    povm1,
    n_qubits: int,
    init_bloch=None,
    max_iter: int = 100,
    tol: float = 1e-6,
):
    """RrhoR fixed-point MLE with factored matvecs (uniform weights).

    Identical fixed point to state_core.estimate_mle_rhor on the
    materialized POVM; the per-iteration matvecs run as einsum chains."""
    counts = jnp.asarray(counts, dtype=rdtype())
    n = n_qubits
    dim = 2**n
    m_total = counts.shape[-2]
    scale = (2**n) / m_total  # weighted effect scaling (w_m = 1/M) * 2^n
    freq = counts / jnp.sum(counts, axis=(-2, -1), keepdims=True)
    if init_bloch is None:
        init_bloch = kron_estimate_lin(counts, povm1, n, physical=True)
    init_bloch = jnp.asarray(init_bloch, dtype=rdtype())
    mixed = jnp.zeros_like(init_bloch).at[..., 0].set(1.0 / dim)
    bloch0 = 0.95 * init_bloch + 0.05 * mixed

    def cond(carry):
        _, it, delta = carry
        return jnp.logical_and(it < max_iter, delta > tol)

    def step(carry):
        bloch, it, _ = carry
        probs = kron_probs(povm1, n, bloch) / m_total
        c = freq / jnp.clip(probs, _NLL_EPS, None)
        r_bloch = kron_apply_adjoint(povm1, n, c) * scale
        r = bloch_to_matrix(r_bloch, n)
        rho = bloch_to_matrix(bloch, n)
        new = r @ rho @ r
        tr = jnp.trace(new, axis1=-2, axis2=-1).real
        new_bloch = matrix_to_bloch(new) / tr[..., None]
        delta = jnp.max(jnp.abs(new_bloch - bloch))
        return new_bloch, it + 1, delta

    bloch, _, _ = jax.lax.while_loop(
        cond, step, (bloch0, jnp.asarray(0), jnp.asarray(jnp.inf, rdtype()))
    )
    return bloch


def kron_bootstrap_distances(
    key,
    bloch_est,
    povm1,
    n_qubits: int,
    n_shots,
    n_points: int,
    method: str = "lin",
    dst: str = "hs",
    max_iter: int = 100,
    physical: bool = True,
    init: str = "lin",
    chunk: int | None = None,
):
    """Parametric bootstrap on the kron-factored design: simulate + estimate
    + distance for `n_points` resamples per device program (the factored
    twin of bootstrap_core.bootstrap_distances). `physical` applies to the
    'lin' re-estimates; `init` ('lin'|'mixed') selects the MLE start.

    `chunk` splits the resample batch (`None` = auto): at 9 qubits the
    per-resample counts volume is ~10M entries and fused batches of 8+ hit
    a memory cliff on the earlier target's 16 GB; the auto rule caps the
    fused batch so the per-call counts volume stays under ~2^25 entries —
    fused in one program through 8 qubits for 'proj' runs and for
    'proj-set' up to 19 resamples (chunk=19 at 6^8 entries/resample), 3
    resamples per call at 9-qubit proj-set (6^9). The cap is not
    re-derived for the H100 (ROADMAP C2). Eagerly each chunk is its own
    device call: streaming the chunks through lax.map inside one program
    was much slower on the earlier target, and one call per chunk also
    kept each call under its single-execution time limit (ROADMAP C1).
    Under a trace (e.g. inside parallel.mesh's shard_map programs) there
    is no host to dispatch from, so one lax.map covers everything. Any
    split changes the per-key random stream relative to the single fused
    program (one key fold per chunk)."""
    import numpy as _np

    m1, p1, _ = jnp.asarray(povm1).shape
    per_resample = (m1 * p1) ** n_qubits
    if chunk is None:
        chunk = max(1, min(n_points, (1 << 25) // per_resample))
    if chunk >= n_points:
        return _kron_bootstrap_fused(
            key, bloch_est, povm1, n_qubits, n_shots, n_points,
            method, dst, max_iter, physical, init,
        )
    tracing = any(
        isinstance(x, jax.core.Tracer)
        for x in (key, bloch_est, povm1, n_shots)
    )
    n_calls = -(-n_points // chunk)
    keys = jax.random.split(key, n_calls)

    def one_chunk(kc):
        return _kron_bootstrap_fused(
            kc, bloch_est, povm1, n_qubits, n_shots, chunk,
            method, dst, max_iter, physical, init,
        )

    if tracing:
        return jax.lax.map(one_chunk, keys).reshape(-1)[:n_points]
    # eager: one device call per chunk (see the docstring; ROADMAP C1)
    parts = [_np.asarray(one_chunk(k)) for k in keys]
    return jnp.asarray(_np.concatenate(parts)[:n_points])


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_qubits", "n_points", "method", "dst", "max_iter", "physical", "init"
    ),
)
def _kron_bootstrap_fused(
    key,
    bloch_est,
    povm1,
    n_qubits: int,
    n_shots,
    n_points: int,
    method: str = "lin",
    dst: str = "hs",
    max_iter: int = 100,
    physical: bool = True,
    init: str = "lin",
):
    """One fused simulate + estimate + distance program (jitted body of
    :func:`kron_bootstrap_distances`)."""
    from .bootstrap_core import _distance_batch

    bloch_est = jnp.asarray(bloch_est, dtype=rdtype())
    blochs = jnp.broadcast_to(bloch_est, (n_points,) + bloch_est.shape)
    counts = kron_simulate(key, povm1, blochs, n_shots)
    if method == "lin":
        est = kron_estimate_lin(counts, povm1, n_qubits, physical=physical)
    elif method in ("mle", "mle-rhor"):
        if init == "mixed":
            init_bloch = jnp.zeros(
                (n_points, 4**n_qubits), dtype=rdtype()
            ).at[..., 0].set(1.0 / 2**n_qubits)
        elif init == "lin":
            init_bloch = None
        else:
            raise ValueError("Invalid value for argument `init`")
        est = kron_estimate_mle_rhor(
            counts, povm1, n_qubits, init_bloch=init_bloch, max_iter=max_iter
        )
    else:
        raise ValueError(f"method {method!r} unsupported on the kron path")
    return _distance_batch(dst, est, bloch_est, n_qubits)
