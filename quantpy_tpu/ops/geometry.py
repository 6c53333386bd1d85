"""Distances between quantum objects — batched, jittable, eigh-based.

Replaces reference quantpy/geometry.py. The reference computes matrix square
roots with scipy.linalg.sqrtm (quantpy/geometry.py:23-56) which is neither
jittable nor batched; since every input here is Hermitian PSD, sqrtm is done
spectrally via eigh, which XLA batches natively.

The functions are *backend polymorphic*: called with jax arrays (inside jit /
on device) they trace to XLA; called with numpy arrays or host Qobj objects
they compute in numpy, so host-side Qobj distance calls on single small
matrices never pay a device dispatch.

All functions accept leading batch dimensions. The reference's snap-to-zero
at 1e-15 (quantpy/geometry.py:17-19) is applied elementwise.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "hs_dst",
    "trace_dst",
    "if_dst",
    "product",
    "fidelity",
    "resolve_distance",
    "SNAP_EPS",
]

SNAP_EPS = 1e-15


def _as_matrix(x):
    """Accept raw arrays or objects exposing `.matrix` (Qobj/Operator)."""
    return getattr(x, "matrix", x)


def _backend(*arrays):
    """numpy for host data, jnp for traced/device data."""
    for a in arrays:
        if isinstance(a, (jax.Array, jax.core.Tracer)):
            return jnp
    return np


def _snap(xp, d):
    return xp.where(d < SNAP_EPS, xp.zeros_like(d), d)


def hs_dst(a, b):
    """Hilbert-Schmidt distance sqrt(Tr((A-B)^2))/sqrt(2).

    For Hermitian A, B this equals ||A-B||_F / sqrt(2)
    (reference quantpy/geometry.py:5-20).
    """
    a, b = _as_matrix(a), _as_matrix(b)
    xp = _backend(a, b)
    diff = xp.asarray(a) - xp.asarray(b)
    d = xp.sqrt(xp.sum(xp.abs(diff) ** 2, axis=(-2, -1))) / xp.sqrt(
        xp.asarray(2.0, dtype=diff.real.dtype)
    )
    return _snap(xp, d)


def trace_dst(a, b):
    """Trace distance |A - B|_1 / 2 via eigh of the Hermitian difference
    (reference quantpy/geometry.py:23-38 uses scipy sqrtm instead)."""
    a, b = _as_matrix(a), _as_matrix(b)
    xp = _backend(a, b)
    diff = xp.asarray(a) - xp.asarray(b)
    evals = xp.linalg.eigvalsh(diff)
    d = xp.sum(xp.abs(evals), axis=-1) / 2.0
    return _snap(xp, d)


def _sqrtm_psd(xp, a):
    """Hermitian PSD matrix square root via eigh (batched)."""
    evals, evecs = xp.linalg.eigh(a)
    sq = xp.sqrt(xp.clip(evals, 0.0, None)).astype(a.dtype)
    return (evecs * sq[..., None, :]) @ xp.swapaxes(evecs.conj(), -1, -2)


def fidelity(a, b):
    """Uhlmann fidelity F(A, B) = (Tr sqrt(sqrt(A) B sqrt(A)))^2 (batched)."""
    a, b = _as_matrix(a), _as_matrix(b)
    xp = _backend(a, b)
    a = xp.asarray(a)
    b = xp.asarray(b)
    sa = _sqrtm_psd(xp, a)
    m = sa @ b @ sa
    evals = xp.linalg.eigvalsh(m)
    return xp.sum(xp.sqrt(xp.clip(evals, 0.0, None)), axis=-1) ** 2


def if_dst(a, b):
    """Infidelity 1 - F(A, B) (reference quantpy/geometry.py:41-56)."""
    a, b = _as_matrix(a), _as_matrix(b)
    xp = _backend(a, b)
    d = 1.0 - fidelity(a, b)
    return _snap(xp, d)


def product(a, b):
    """Hermitian inner product Tr(A @ B^H) = sum_ij A_ij conj(B_ij)
    (reference quantpy/geometry.py:59-70)."""
    a, b = _as_matrix(a), _as_matrix(b)
    xp = _backend(a, b)
    return xp.sum(xp.asarray(a) * xp.asarray(b).conj(), axis=(-2, -1))


DISTANCES = {"hs": hs_dst, "trace": trace_dst, "if": if_dst}


def resolve_distance(dst):
    """Map a distance name or callable to a callable
    (mirrors reference quantpy/tomography/state.py:55-66)."""
    if callable(dst):
        return dst
    try:
        return DISTANCES[dst]
    except KeyError:
        raise ValueError("Invalid value for argument `dst`") from None
