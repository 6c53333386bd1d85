"""Analytic confidence intervals on Kronecker-factored designs.

The reference's Moment/Sugiyama intervals are dense-POVM-only: above 5 qubits the
tomograph never materializes its measurement matrix (kron_core), and the
reference's recipes need its pseudo-inverse — MomentInterval builds the
full (mp)^2 weights tensor (reference quantpy/tomography/interval.py:76-88)
and SugiyamaInterval the per-axis inverse spread (interval.py:242-252).
Both blow up at 6+ qubits (proj-set: the weights tensor alone would be
(729*64)^2 ~ 2e9 entries).

This module computes the SAME quantities exactly, exploiting that a product
design factorizes its pseudo-inverse: for A = kron_n(A1),
A^+ = kron_n(A1^+), so V = A^+ never has to exist. Everything reduces to
per-qubit einsum steps over tensors no larger than the frequency table
times small factors:

- Moment interval: with the quadratic-form identities of stats.py
  (mean = tr(R - S)/N, var = 2||R - S||_F^2/N^2; R = V diag(f) V^T,
  S = (Vf per-POVM)(..)^T), every trace reduces to chains over the
  single-qubit Gram kernel C1 = V1^T V1:
      tr R    = < f, kron(diag C1) >
      tr R^2  = < f, kron(C1 o C1) f >          (o = Hadamard)
      S       = T T^T with T = per-POVM contraction of V against f
      <R, S>  = sum_{ai} f[ai] || (V^T T)[ai, :] ||^2
  The largest object is T (4^n x m1^n) resp. V^T T ((m1 p1)^n x m1^n,
  computed in column chunks).

- Sugiyama interval: c_alpha needs max_i - min_i over outcomes of
  V[d, a, i] = prod_k V1[d_k, a_k, i_k]; the extrema of a product of
  independently-chosen factors follow from an interval-arithmetic fold
  over qubits carrying per-partial-product (min, max).

Host numpy on purpose: these run once per interval setup (not in the hot
path), and x64 matches the dense-path accuracy for the equality tests.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "kron_l2_moments",
    "kron_sugiyama_c_alpha",
    "channel_l2_moments",
    "channel_l2_moments_kron",
]


def _v1(povm1: np.ndarray) -> np.ndarray:
    """Single-qubit pseudo-inverse factor V1 (4, m1, p1) of the (m1, p1, 4)
    POVM block: A^+ = kron(A1^+) for A = kron(A1)."""
    povm1 = np.asarray(povm1, dtype=np.float64)
    m1, p1, _ = povm1.shape
    a1 = povm1.reshape(m1 * p1, 4)
    v1 = np.linalg.solve(a1.T @ a1, a1.T)  # (4, m1*p1)
    return v1.reshape(4, m1, p1)


def _interleave(freq: np.ndarray, m1: int, p1: int, n: int) -> np.ndarray:
    """(m1^n, p1^n) frequency table -> qubit-major (m1, p1)*n layout."""
    x = np.asarray(freq, dtype=np.float64).reshape((m1,) * n + (p1,) * n)
    perm = [j for k in range(n) for j in (k, n + k)]
    return x.transpose(perm)


def _compute_t(x, v1, n):
    """T[d, a] = sum_i prod_k V1[d_k, a_k, i_k] f[a, i] as (4^n, m1^n).

    x is the interleaved frequency table; each step consumes the leading
    (a, i) pair and appends (d, a)."""
    for _ in range(n):
        x = np.einsum("ai...,dai->...da", x, v1)
    # axes now (d1, a1, ..., dn, an) -> (d.., a..)
    perm = [2 * k for k in range(n)] + [2 * k + 1 for k in range(n)]
    x = x.transpose(perm)
    return x.reshape(4**n, -1)


def _kron_quadform(x, op, n):
    """< x, kron_n(op) x > for an (m1, p1, m1, p1) per-qubit operator and an
    interleaved table x; each step consumes the leading (a, i) pair and
    appends (b, j), so the result stays in interleaved layout."""
    y = x
    for _ in range(n):
        y = np.einsum("ai...,aibj->...bj", y, op)
    return float(np.sum(x * y))


def _kron_diag_contract(x, diag, n):
    """< f, kron_n(diag) > for a per-qubit (m1, p1) diagonal table."""
    y = x
    for _ in range(n):
        y = np.einsum("ai...,ai->...", y, diag)
    return float(y)


def kron_l2_moments(povm1, n_qubits: int, freq, n_trials, chunk: int | None = None):
    """(mean, variance) of the weighted L2 statistic of MomentInterval for a
    kron-factored design — exact (same numbers as the dense path, verified
    by test), never materializing the POVM, its pseudo-inverse, or the
    weights tensor.

    povm1: (m1, p1, 4) single-qubit block; freq: (m1^n, p1^n) observed
    frequencies; n_trials: shots per POVM (uniform — the kron experiment
    path guarantees this).
    """
    n = n_qubits
    v1 = _v1(np.asarray(povm1)) * 0.5  # per-qubit share of the 1/2^n scale
    m1, p1 = v1.shape[1], v1.shape[2]
    x = _interleave(freq, m1, p1, n)

    v1f = v1.reshape(4, m1 * p1)
    c1 = (v1f.T @ v1f).reshape(m1, p1, m1, p1)  # per-qubit Gram kernel
    diag_c1 = np.einsum("aiai->ai", c1)

    tr_r = _kron_diag_contract(x, diag_c1, n)
    tr_r2 = _kron_quadform(x, c1 * c1, n)

    t = _compute_t(x, v1, n)  # (4^n, m1^n); host folds — the per-qubit
    # einsum chain carries minor dims of 4/6 that relayouted pathologically
    # on the earlier target (not measured on the H100; ROADMAP C2)
    tr_s = float(np.sum(t * t))
    if t.size > _RS_DEVICE_THRESHOLD:
        # ... but the T^T T Gram is one dense 160-GFLOP gemm at 7 qubits,
        # which goes to the device
        import jax.numpy as jnp

        from ..config import rdtype

        t_dev = jnp.asarray(t, rdtype())
        y = t_dev.T @ t_dev
        tr_s2 = float(jnp.sum(y * y))
    else:
        y = t.T @ t  # (m1^n, m1^n)
        tr_s2 = float(np.sum(y * y))

    # <R, S> = sum_{ai} f[ai] * sum_b G[ai, b]^2 with G = V^T T, computed in
    # column chunks of T to bound memory at (m1 p1)^n * chunk
    rs = _rs_term(t, x, v1, n, chunk)
    mean = (tr_r - tr_s) / n_trials
    variance = 2.0 * (tr_r2 - 2.0 * rs + tr_s2) / n_trials**2
    return mean, variance


#: above this many work-tensor elements per chunk-fold the <R, S> term runs
#: as jitted device folds (at 7 qubits the host einsum loop dominated the
#: interval setup on a single-core host; the device folds are the same
#: contractions batched on the device; not re-derived on the H100)
_RS_DEVICE_THRESHOLD = 1 << 22


def _rs_term(t, x, v1, n: int, chunk: int | None) -> float:
    """sum_{ai} f[ai] sum_b (V^T T)[ai, b]^2 over column chunks of T."""
    import string

    m1, p1 = v1.shape[1], v1.shape[2]
    m_total = t.shape[1]
    if chunk is None:  # keep each chunk's work tensor under ~2^24 entries
        chunk = max(1, (1 << 24) // (m1 * p1) ** n)
    sub = string.ascii_lowercase[: 2 * n]  # (a1, i1, ..., an, in) letters
    use_device = chunk * (m1 * p1) ** n > _RS_DEVICE_THRESHOLD

    if use_device:
        import jax
        import jax.numpy as jnp

        from ..config import rdtype

        rd = rdtype()
        v1_d = jnp.asarray(v1, rd)
        x_d = jnp.asarray(x, rd)

        @jax.jit
        def rs_chunk(cols):
            g = cols
            for _ in range(n):
                g = jnp.einsum("d...,dai->...ai", g, v1_d)
            return jnp.einsum(f"z{sub},{sub}->", g * g, x_d)

        rs = 0.0
        for lo in range(0, m_total, chunk):
            cols = jnp.asarray(
                t[:, lo : lo + chunk].reshape((4,) * n + (-1,)), rd
            )
            rs += float(rs_chunk(cols))
        return rs

    rs = 0.0
    for lo in range(0, m_total, chunk):
        cols = t[:, lo : lo + chunk].reshape((4,) * n + (-1,))
        g = cols
        for _ in range(n):
            g = np.einsum("d...,dai->...ai", g, v1)
        # g axes: (B, a1, i1, ..., an, in); contract everything to a scalar
        rs += float(np.einsum(f"z{sub},{sub}->", g * g, x))
    return rs


def channel_l2_moments(states_matrix, povm_matrix, freq, n_trials):
    """(mean, variance) of the MomentInterval L2 statistic for a process
    design, never materializing the (S*K, 16^n) channel matrix.

    The process measurement map is exactly a two-factor Kronecker product
    (reference quantpy/tomography/interval.py:76-88 builds it dense):
    A[(s,k), (d,e)] = states_matrix[s, d] * povm_flat[k, e], so
    A^+ = states_matrix^+ (x) povm_flat^+, and with the quadratic-form
    identities of stats.py the moment matrix splits per input state:

        M = sum_s (v_s v_s^T) (x) Mp[s],
        Mp[s] = Vp diag(f_s) Vp^T - Tp[s] Tp[s]^T   (dp x dp per state)

    with v_s = column s of Vs = states_matrix^+. Hence

        tr M      = sum_s ||v_s||^2 tr Mp[s]
        ||M||_F^2 = sum_{s,s'} (v_s . v_s')^2  <Mp[s], Mp[s']>_F

    — everything is (S, dp, dp)-sized; at 4 qubits that is 134 MB where the
    dense pseudo-inverse would be 21 GB (the reference's wall at n >= 3).
    Exactness vs the dense path is tested at 1-2 qubits.

    Parameters
    ----------
    states_matrix : (S, ds) input-state bloch rows (tmg._input_blochs_t())
    povm_matrix : (m, p, dp) POVM bloch tensor of the child tomographs
    freq : (S, m, p) observed frequencies
    n_trials : shots per (state, POVM) multinomial (uniform)
    """
    states_matrix = np.asarray(states_matrix, dtype=np.float64)
    povm = np.asarray(povm_matrix, dtype=np.float64)
    f = np.asarray(freq, dtype=np.float64)
    n_states, m, p = f.shape
    dp = povm.shape[-1]
    dim = float(dp)  # the dense path scales A^+ by 1/dim with dim = 4^n,
    # the Choi Hilbert dimension == the POVM bloch length (interval.py:150)

    vs = np.linalg.pinv(states_matrix)  # (ds, S)
    vp = np.linalg.pinv(povm.reshape(m * p, dp)) / dim  # (dp, m p)
    cs = vs.T @ vs  # (S, S) state-factor Gram

    if n_states * dp * dp > _DEVICE_MOMENTS_THRESHOLD:
        tr_mp, p_gram = _channel_block_grams_device(vp, f)
    else:
        tr_mp, p_gram = _channel_block_grams_host(vp, f)
    mean = float(np.diag(cs) @ tr_mp) / n_trials
    fro2 = float(np.sum(cs * cs * p_gram))
    variance = 2.0 * fro2 / n_trials**2
    return mean, variance


#: above this many Mp-block elements the per-state Grams run on the
#: default jax device (f32 matmuls; this host has a single CPU core, where
#: the 5-qubit case would be ~10 minutes of serial BLAS)
_DEVICE_MOMENTS_THRESHOLD = 1 << 25


def _channel_block_grams_host(vp, f):
    """(tr Mp[s], <Mp[s], Mp[s']>_F) on host in f64 (exact reference)."""
    n_states, m, p = f.shape
    dp = vp.shape[0]
    vp3 = vp.reshape(dp, m, p)
    tp = np.einsum("dai,sai->sda", vp3, f, optimize=True)
    f_flat = f.reshape(n_states, m * p)
    mp_blocks = np.empty((n_states, dp, dp))
    for s in range(n_states):
        vpf = vp * f_flat[s][None, :]
        mp_blocks[s] = vpf @ vp.T - tp[s] @ tp[s].T
    tr_mp = np.trace(mp_blocks, axis1=-2, axis2=-1)
    x = mp_blocks.reshape(n_states, dp * dp)
    return tr_mp, x @ x.T


def _channel_block_grams_device(vp, f, chunk: int = 16):
    """Device twin of :func:`_channel_block_grams_host`: the per-state
    moment blocks Mp[s] and their pairwise Frobenius Gram as f32 device
    matmuls, host-chunked over input states so each device call stayed
    under a single-execution time limit of the earlier target (ROADMAP
    C1). All boundary arrays are real. f32 is ample here: the
    Gram feeds a variance whose statistical use tolerates ~1e-3 relative
    error (tested vs the f64 host path at 2 qubits)."""
    import jax
    import jax.numpy as jnp

    n_states, m, p = f.shape
    dp = vp.shape[0]

    @jax.jit
    def block_chunk(vp_dev, f_chunk):
        vp3 = vp_dev.reshape(dp, m, p)
        tp = jnp.einsum("dai,sai->sda", vp3, f_chunk)
        vpf = vp_dev[None, :, :] * f_chunk.reshape(f_chunk.shape[0], 1, -1)
        mp = jnp.matmul(vpf, vp_dev.T) - jnp.matmul(
            tp, jnp.swapaxes(tp, -1, -2)
        )
        tr = jnp.trace(mp, axis1=-2, axis2=-1)
        return tr, mp.reshape(mp.shape[0], dp * dp)

    vp_dev = jnp.asarray(vp, dtype=jnp.float32)
    trs, xs = [], []
    for lo in range(0, n_states, chunk):
        tr, x = block_chunk(vp_dev, jnp.asarray(f[lo : lo + chunk], jnp.float32))
        trs.append(tr)
        xs.append(x)
    x_all = jnp.concatenate(xs, axis=0)
    p_gram = jnp.matmul(x_all, x_all.T)
    return (
        np.asarray(jnp.concatenate(trs), dtype=np.float64),
        np.asarray(p_gram, dtype=np.float64),
    )


def kron_sugiyama_c_alpha(povm1, n_qubits: int) -> np.ndarray:
    """The Sugiyama c_alpha vector (4^n,) for a kron-factored design.

    Dense recipe (reference interval.py:242-252): scale the POVM rows by
    dim/sqrt(2 dim), invert, and for every bloch axis d sum over POVMs the
    squared outcome spread (max_i - min_i of inv[d, a, i]) times the shot
    ratio. Here inv[d, a, i] = s * prod_k V1[d_k, a_k, i_k] with
    s = sqrt(2/dim), and the per-axis extrema over the product of
    independently-chosen outcome factors come from an interval-arithmetic
    fold: carry (lo, hi) of the partial product and extend one qubit at a
    time over all p1 candidate factors.

    Returns c_alpha WITHOUT the shot-ratio weighting (uniform shots give a
    constant ratio m1^n applied by the caller) and WITHOUT the +EPS floor.
    """
    n = n_qubits
    v1 = _v1(np.asarray(povm1))  # (4, m1, p1)
    dim = 2**n
    s = np.sqrt(2.0 / dim)

    lo = np.ones(())
    hi = np.ones(())
    for _ in range(n):
        # candidates over this qubit's outcomes: shape (..., d, a, p1)
        cand_lo = lo[..., None, None, None] * v1
        cand_hi = hi[..., None, None, None] * v1
        both = np.stack([cand_lo, cand_hi])
        lo = both.min(axis=0).min(axis=-1)  # (..., d, a)
        hi = both.max(axis=0).max(axis=-1)
    # axes (d1, a1, ..., dn, an) -> (d.., a..)
    perm = [2 * k for k in range(n)] + [2 * k + 1 for k in range(n)]
    lo = lo.transpose(perm).reshape(4**n, -1)
    hi = hi.transpose(perm).reshape(4**n, -1)
    spread = (hi - lo) * s
    return np.sum(spread**2, axis=-1)


# --------------------------------------------------------------------------
# 6+ qubit channel moments: exact mean + Hutchinson Frobenius term
# --------------------------------------------------------------------------


def _channel_kron_factors(states1_t, povm1):
    """Per-qubit factors of the fully kron-factored process design:
    V1 = pinv of the flattened single-qubit POVM block, its Gram G1, and
    the input-state Gram Cs1 = Vs1^T Vs1."""
    states1_t = np.asarray(states1_t, dtype=np.float64)  # (S1, 4)
    povm1 = np.asarray(povm1, dtype=np.float64)  # (m1, p1, 4)
    m1, p1, _ = povm1.shape
    f1 = povm1.reshape(m1 * p1, 4)
    v1 = np.linalg.solve(f1.T @ f1, f1.T)  # (4, m1 p1)
    g1 = v1.T @ v1  # (m1 p1, m1 p1)
    vs1 = np.linalg.pinv(states1_t)  # (4, S1)
    cs1 = vs1.T @ vs1  # (S1, S1)
    return v1, g1, cs1, m1, p1


def _fold_axis(u, k, op):
    """Contract fused per-qubit axis 1+k of u (s leading) with op (c, out):
    u[..., c_k, ...] -> u[..., out_k, ...] keeping axis order."""
    import jax.numpy as jnp

    u = jnp.moveaxis(u, 1 + k, -1)
    u = jnp.matmul(u, op)
    return jnp.moveaxis(u, -1, 1 + k)


def _fold_block_axis(u, k, b1, m1, p1):
    """Per-POVM quadratic-kernel fold on fused axis 1+k: with the axis
    viewed as (a, i), map to (a, j) via b1[a, i, j] (the G1 diagonal
    blocks)."""
    import jax.numpy as jnp

    u = jnp.moveaxis(u, 1 + k, -1)
    u = u.reshape(u.shape[:-1] + (m1, p1))
    u = jnp.einsum("...ai,aij->...aj", u, b1)
    u = u.reshape(u.shape[:-2] + (m1 * p1,))
    return jnp.moveaxis(u, -1, 1 + k)


def channel_l2_moments_kron(
    states1_t,
    povm1,
    n_qubits: int,
    freq,
    n_trials,
    n_probes: int = 128,
    key=None,
    state_chunk: int = 256,
    probe_chunk: int = 16,
):
    """(mean, variance) of the channel-mode MomentInterval L2 statistic for
    a FULLY kron-factored process design (input states AND POVM are tensor
    powers of single-qubit blocks) — the 6-qubit regime, where even the
    per-state factored path of :func:`channel_l2_moments` is infeasible
    (its (4^n)^2 moment blocks Mp[s] and their pairwise Gram would cost
    ~26 PFLOP and ~275 GB at 6 qubits).

    The MEAN is EXACT: tr Mp[s] = sum_j ||vp_j||^2 f_sj - ||tp_s||_F^2,
    where vp = kron(V1)/4^n has Kronecker column norms and the second term
    is a per-POVM quadratic form in the G1 = V1^T V1 diagonal blocks —
    both per-qubit folds of the frequency tensor.

    The Frobenius term of the VARIANCE is an unbiased Rademacher
    Hutchinson estimate: with the state-Gram Hadamard square
    W = (Vs^T Vs)^{o 2} (a Kronecker power),

        fro2 = sum_{s,s'} W[s,s'] tr(Mp[s] Mp[s']) = E_z[u_z],
        u_z  = sum_{s,s'} W[s,s'] (Mp[s] z).(Mp[s'] z),

    and Mp[s] z factorizes through ONE kron-structured pseudo-inverse
    apply: Mp[s] z = vp-apply(C_s), C_s[(a,i)] = f_s[(a,i)] (y[(a,i)] -
    t_s[a]), y = vp^T z, t_s[a] = sum_i f_s[(a,i)] y[(a,i)] — no tp or Mp
    is ever materialized (exactness of this identity is tested against the
    dense Mp at 2 qubits). n_probes=128 reproduces the exact variance to
    ~2 percent at 2-3 qubits (tested); the estimator error enters only the
    interval radius through a square root (~1 percent).

    Parameters
    ----------
    states1_t : (S1, 4) TRANSPOSED single-qubit input-state bloch rows
        (per-qubit factor of tmg._input_blochs_t())
    povm1 : (m1, p1, 4) single-qubit POVM block
    freq : (S, m1^n, p1^n) observed frequencies, S = S1^n
    n_trials : uniform shots per (state, POVM)
    """
    import jax
    import jax.numpy as jnp

    from ..config import rdtype

    n = n_qubits
    v1, g1, cs1, m1, p1 = _channel_kron_factors(states1_t, povm1)
    f = np.asarray(freq, dtype=np.float64)
    s_count = f.shape[0]
    dim = float(4**n)
    # (S, m, p) -> (S, c1, ..., cn) with fused c_k = (a_k, i_k)
    x = f.reshape((s_count,) + (m1,) * n + (p1,) * n)
    perm = [0] + [1 + j for k in range(n) for j in (k, n + k)]
    x = np.ascontiguousarray(x.transpose(perm)).reshape(
        (s_count,) + (m1 * p1,) * n
    )

    rd = rdtype()
    v1t_d = jnp.asarray(v1.T, rd)  # (c, 4): vp-apply op per qubit
    v1_d = jnp.asarray(v1, rd)  # (4, c): vp^T-apply op per qubit
    g1_diag = jnp.asarray(np.diag(g1), rd)  # (c,)
    b1_d = jnp.asarray(
        np.einsum("aiaj->aij", g1.reshape(m1, p1, m1, p1)), rd
    )  # (m1, p1, p1)
    w1_d = jnp.asarray(cs1 * cs1, rd)  # (S1, S1)
    s1 = cs1.shape[0]
    cs_diag = _kron_power_vec(np.diag(cs1), n)  # (S,)

    @jax.jit
    def tr_mp_chunk(xc):
        """Exact (chunk,) tr Mp[s]: diagonal fold minus block quadratic."""
        t1 = xc
        for _ in range(n):
            # consuming axis 1 repeatedly walks through every qubit
            t1 = jnp.tensordot(t1, g1_diag, axes=([1], [0]))
        u = xc
        for k in range(n):
            u = _fold_block_axis(u, k, b1_d, m1, p1)
        t2 = jnp.sum(u * xc, axis=tuple(range(1, n + 1)))
        return (t1 - t2) / (dim * dim)

    @jax.jit
    def u_probe_chunk(xc, z_batch):
        """(chunk, nz, 4^n) factored Mp[s] z for a probe batch.

        z_batch: (nz,) + (4,)*n tensors. Returns U with the 1/dim^2 of
        Mp's two vp factors applied."""
        nz = z_batch.shape[0]
        y = z_batch
        for k in range(n):
            y = _fold_axis(y, k, v1_d)  # (nz, c1..cn), vp^T z * dim
        w = xc[:, None] * y[None]  # (chunk, nz, c1..cn)
        t = jnp.sum(
            w.reshape(w.shape[:2] + (m1, p1) * n),
            axis=tuple(3 + 2 * k for k in range(n)),
        )  # (chunk, nz, a1..an)
        # broadcast t back over the outcome axes, refused to (c,) per qubit
        t_b = t.reshape(t.shape[:2] + (m1, 1) * n)
        t_b = jnp.broadcast_to(
            t_b, t.shape[:2] + (m1, p1) * n
        ).reshape(w.shape)
        c = xc[:, None] * (y[None] - t_b)  # (chunk, nz, c1..cn)
        u = c.reshape((c.shape[0] * nz,) + c.shape[2:])
        for k in range(n):
            u = _fold_axis(u, k, v1t_d)  # c_k -> d_k (vp-apply * dim)
        u = u.reshape(c.shape[0], nz, -1)
        return u / (dim * dim)

    @jax.jit
    def w_quadratic(u_all):
        """(nz,) u_z = sum_{s,s'} W[s,s'] U[s].U[s'] via per-qubit w1
        folds over the state axis."""
        nz, dp = u_all.shape[1], u_all.shape[2]
        v = u_all.reshape((s1,) * n + (nz * dp,))
        for k in range(n):
            v = jnp.moveaxis(jnp.matmul(
                jnp.moveaxis(v, k, -1), w1_d
            ), -1, k)
        v = v.reshape(s_count, nz, dp)
        return jnp.sum(u_all * v, axis=(0, 2))

    # upload the interleaved frequency tensor ONCE (at 6 qubits it is
    # ~760 MB in f32; per-chunk host slices would re-ship it to the device
    # once per probe batch)
    x_dev = jnp.asarray(x, rd)
    chunks = [
        jax.lax.slice_in_dim(x_dev, lo, min(lo + state_chunk, s_count), axis=0)
        for lo in range(0, s_count, state_chunk)
    ]

    # ---- exact mean ----
    tr_mp = np.concatenate(
        [np.asarray(tr_mp_chunk(c)) for c in chunks]
    )
    mean = float(cs_diag @ tr_mp) / n_trials

    # ---- Hutchinson Frobenius term ----
    if key is None:
        key = jax.random.key(1234)
    u_sum = 0.0
    done = 0
    while done < n_probes:
        nz = min(probe_chunk, n_probes - done)
        key, sub = jax.random.split(key)
        z = jax.random.rademacher(
            sub, (nz,) + (4,) * n, dtype=rd
        )
        u_all = jnp.concatenate(
            [u_probe_chunk(c, z) for c in chunks], axis=0
        )  # (S, nz, 4^n)
        u_sum += float(jnp.sum(w_quadratic(u_all)))
        done += nz
    fro2 = u_sum / n_probes
    variance = 2.0 * fro2 / n_trials**2
    return mean, variance


def _kron_power_vec(vec1, n: int) -> np.ndarray:
    """n-fold Kronecker power of a vector (host, float64)."""
    out = np.asarray(vec1, dtype=np.float64)
    for _ in range(n - 1):
        out = np.kron(out, vec1)
    return out
