"""Double-float (two-float compensated) elementwise arithmetic.

Why this exists: the anchored 4-qubit kraus-chain target needs the
count-weighted reduction  -sum_i n_i * log1p(dp_i / p_i)  accurate to a
~0.3 MH log-ratio budget at 4.1e7 total counts. Where an accelerator's
f32 elementwise `divide` and `log1p` are a few ulp off (polynomial
approximations; CPU f32 runs them through f64 libm under
--xla_allow_excess_precision), the error amplifies to
eps_op * sum_i |n_i log1p(r_i)|, several log-density units at this count
scale (not measured on the H100; ROADMAP C4) — compensated SUMMATION
alone cannot help when the summands themselves are wrong. Double-float evaluation carries
~48-bit effective mantissas through the division and the log1p, dropping
the field to the 1e-3 scale (measured; same doc).

The primitives are the classical error-free transformations (Knuth
TwoSum, Dekker split/TwoProduct — no FMA assumed, so products split into
12-bit halves that multiply exactly in f32) composed into renormalized
(hi, lo) pairs. log1p uses 2^K-th-root argument reduction (K df square
roots, each one Newton step over the hardware sqrt) followed by the
odd atanh series at |u| <= ~0.22, valid over the full clamp range of the
NLL ratio (r in [1e-7 - 1, ~1e12]; _CP_EPS floors the denominator).

Everything is branch-free jnp, jit/vmap/grad-safe (gradients flow through
the plain-f32 data path; the compensation terms carry tiny cotangents).
No reference counterpart: nordmtr/quantpy runs float64 NumPy throughout
(e.g. quantpy/tomography/interval.py:762-850 samples the float64 NLL).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp
from jax import lax

__all__ = [
    "two_sum",
    "two_prod",
    "df_add",
    "df_add_f",
    "df_mul",
    "df_mul_f",
    "df_div_ff",
    "df_sqrt",
    "df_log1p_f",
    "sum2f",
]

_SPLIT = 4097.0  # 2**12 + 1: splits a 24-bit f32 mantissa into 12+12


def two_sum(a, b):
    """Knuth EFT: a + b = s + err exactly (6 flops, any a, b).

    The sum is wrapped in an optimization barrier: XLA's algebraic
    simplifier rewrites (a + b) - a -> b when it can see the add (measured
    under jit with a constant operand: two_sum(1.0, 1e-9) returned err=0),
    which silently deletes the recovered rounding error. The barrier hides
    the producer; the arithmetic is unchanged."""
    s = lax.optimization_barrier(a + b)
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _quick_two_sum(a, b):
    """Renormalize assuming |a| >= |b| (3 flops; barrier as in two_sum)."""
    s = lax.optimization_barrier(a + b)
    return s, b - (s - a)


def _split(a):
    """Dekker split: a = hi + lo with 12-bit halves (exact f32 products)."""
    c = lax.optimization_barrier(_SPLIT * a)
    hi = lax.optimization_barrier(c - (c - a))
    return hi, a - hi


def two_prod(a, b):
    """Dekker EFT: a * b = p + err exactly (FMA-free)."""
    p = lax.optimization_barrier(a * b)
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def df_add(x, y):
    """(hi, lo) + (hi, lo)."""
    s, e = two_sum(x[0], y[0])
    return _quick_two_sum(s, e + (x[1] + y[1]))


def df_add_f(x, f):
    """(hi, lo) + plain float."""
    s, e = two_sum(x[0], f)
    return _quick_two_sum(s, e + x[1])


def df_mul(x, y):
    """(hi, lo) * (hi, lo)."""
    p, e = two_prod(x[0], y[0])
    return _quick_two_sum(p, e + (x[0] * y[1] + x[1] * y[0]))


def df_mul_f(x, f):
    """(hi, lo) * plain float."""
    p, e = two_prod(x[0], f)
    return _quick_two_sum(p, e + x[1] * f)


def df_div_ff(a, b):
    """plain / plain -> (hi, lo): one exact-residual correction of the
    hardware quotient (an f32 divide may be a few ulp off; the corrected
    quotient is accurate to ~2^-48 relative)."""
    q0 = a / b
    p, e = two_prod(q0, b)
    r = (a - p) - e  # a - q0*b, exact (p within one ulp of a)
    return _quick_two_sum(q0, r / b)


def df_sqrt(x):
    """sqrt of (hi, lo): one df Newton step over the hardware sqrt."""
    y0 = jnp.sqrt(x[0])
    p, e = two_prod(y0, y0)
    d = ((x[0] - p) - e) + x[1]
    return _quick_two_sum(y0, d / (2.0 * y0))


_LOG1P_HALVINGS = 6  # (1+r) -> (1+r)^(1/64): |u| <= ~0.22 for r in [1e-12-1, 1e12]
_ATANH_TERMS = 8  # odd series through u^15: truncation < 4e-12 at |u| = 0.25


def df_log1p_f(r):
    """log1p of a plain-f32 array, returned as (hi, lo) with ~2^-48
    relative (plus a 2^(K+1) * 2^-48 absolute floor from the argument
    reduction). Valid for r in (~1e-12 - 1, ~1e12) — the NLL ratio's
    clamp range."""
    w = two_sum(1.0, r)  # exact: 1 + r as a df
    for _ in range(_LOG1P_HALVINGS):
        w = df_sqrt(w)
    v = df_add_f(w, -1.0)  # w - 1: Sterbenz-exact near 1
    u = _df_div(v, df_add_f(v, 2.0))
    u2 = df_mul(u, u)
    s = _atanh_coef(_ATANH_TERMS - 1)
    for k in range(_ATANH_TERMS - 2, -1, -1):
        s = df_add(_atanh_coef(k), df_mul(u2, s))
    s = df_mul(u, s)
    scale = float(2 ** (_LOG1P_HALVINGS + 1))
    return s[0] * scale, s[1] * scale


def _df_div(x, y):
    """(hi, lo) / (hi, lo)."""
    q0 = x[0] / y[0]
    p, e = two_prod(q0, y[0])
    r = ((x[0] - p) - e) + (x[1] - q0 * y[1])
    return _quick_two_sum(q0, r / y[0])


def _atanh_coef(k: int):
    """1/(2k+1) as an (hi, lo) f32 pair (exact to ~2^-48)."""
    c = 1.0 / np.float64(2 * k + 1)
    hi = np.float32(c)
    lo = np.float32(c - np.float64(hi))
    return jnp.float32(hi), jnp.float32(lo)


def sum2f(x, lo=None):
    """Two-float pairwise-tree sum over the LAST axis: each level combines
    pairs with TwoSum and accumulates the exact per-pair errors into a
    running low part (~2x f32 mantissa at log2(N) vectorized levels)."""
    if lo is None:
        lo = jnp.zeros_like(x)
    n = x.shape[-1]
    m = 1 << (n - 1).bit_length()
    if m != n:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, m - n)]
        x = jnp.pad(x, pad)
        lo = jnp.pad(lo, pad)
    while x.shape[-1] > 1:
        s, e = two_sum(x[..., 0::2], x[..., 1::2])
        lo = lo[..., 0::2] + lo[..., 1::2] + e
        x = s
    return x[..., 0] + lo[..., 0]
