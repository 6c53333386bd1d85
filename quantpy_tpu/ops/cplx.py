"""Real <-> complex packing at jit boundaries.

The framework's jitted functions take and return real arrays (ROADMAP C5
asks whether that contract is still needed); complex compute happens inside
jit. These helpers define the framework-wide convention for moving
non-Hermitian complex data (gates, kets, Kraus/Choi factors) across jit
boundaries: a trailing re/im axis of size 2.

Hermitian data should instead travel as bloch vectors (ops.paulis), which are
exactly real.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..config import rdtype

__all__ = ["to_pair", "from_pair", "pair_to_complex", "complex_to_pair"]


def to_pair(array) -> jnp.ndarray:
    """Host-side: pack a (numpy or jax) complex array into a real (..., 2)
    device-safe array."""
    a = np.asarray(array)
    return jnp.asarray(
        np.stack([a.real, a.imag], axis=-1), dtype=rdtype()
    )


def from_pair(pair) -> np.ndarray:
    """Host-side: unpack a real (..., 2) array back into numpy complex."""
    p = np.asarray(pair)
    return p[..., 0] + 1j * p[..., 1]


def pair_to_complex(pair: jnp.ndarray) -> jnp.ndarray:
    """In-jit: view a real (..., 2) array as a complex array (…)."""
    import jax

    return jax.lax.complex(pair[..., 0], pair[..., 1])


def complex_to_pair(z: jnp.ndarray) -> jnp.ndarray:
    """In-jit: split a complex array into a real (..., 2) array."""
    return jnp.stack([z.real, z.imag], axis=-1)
