"""On-device measurement-outcome sampling.

The reference draws POVM outcomes with the *global, unseeded* NumPy RNG, one
Python call per POVM (quantpy/tomography/state.py:111-114). Here sampling is a
pure function of an explicit `jax.random` key, fully batched: a whole
bootstrap's worth of experiments is drawn in one jitted call.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import rdtype

__all__ = ["sample_multinomial"]

#: probs volume above which the binary splitter runs in BIT-REVERSED block
#: order: the natural-order interleave (`stack([...], axis=-1)`) carries a
#: trailing size-2 axis that the earlier target's (8, 128) tiling padded 64x,
#: and at the 10-qubit bootstrap scale that padded copy ran out of device
#: memory. Bit-reversed order appends the right halves with a concatenate
#: and restores natural outcome order with one static gather at the end.
#: The two orders draw DIFFERENT (equally distributed) streams for the same
#: key; the threshold sits between the largest volume that ran in natural
#: order (9q bootstrap chunks, (4, 19683, 512) = 40.3M) and the failing
#: (2, 59049, 256) = 60.5M. Not measured on the H100 (ROADMAP C2).
_BITREV_SPLIT_VOLUME = 3 << 24


@functools.lru_cache(maxsize=None)
def _bitrev_perm(bits: int):
    """Bit-reversal permutation of 2**bits indices (static, an involution)."""
    idx = np.arange(1 << bits)
    rev = np.zeros(1 << bits, dtype=np.int32)
    for b in range(bits):
        rev |= ((idx >> b) & 1).astype(np.int32) << (bits - 1 - b)
    return rev


def _multinomial_binary_split(key, n_trials, probs):
    """Exact multinomial sampling by recursive binary splitting.

    jax.random.multinomial scans a *sequential* chain of m-1 conditional
    binomials over the outcome axis; each binomial is a rejection sampler
    whose while-loop latency cannot overlap. Binary splitting draws the
    same distribution with only ceil(log2(m)) batched binomial rounds:
    at each level every block's left-half count is one conditional
    binomial, and all blocks at a level batch into a single call.

    probs must be normalized along the last axis; the outcome axis is
    zero-padded to the next power of two (Binomial(n, 0) == 0 exactly,
    so padding never receives counts).
    """
    m = probs.shape[-1]
    m_pad = 1 << (m - 1).bit_length()
    if m_pad != m:
        pad = [(0, 0)] * (probs.ndim - 1) + [(0, m_pad - m)]
        probs = jnp.pad(probs, pad)
    batch_shape = probs.shape[:-1]
    counts = jnp.asarray(n_trials, dtype=rdtype()).reshape(batch_shape + (1,))
    levels = m_pad.bit_length() - 1
    bitrev = probs.size > _BITREV_SPLIT_VOLUME
    # block probability masses per level, coarsest first
    block_sums = [probs]
    for _ in range(levels):
        prev = block_sums[-1]
        block_sums.append(prev[..., 0::2] + prev[..., 1::2])
    block_sums.reverse()  # block_sums[k] has 2^k blocks
    for level in range(levels):
        key, sub = jax.random.split(key)
        total = block_sums[level]
        lmass = block_sums[level + 1][..., 0::2]
        ratio = jnp.where(total > 0, lmass / jnp.where(total > 0, total, 1.0), 0.0)
        # f32 rounding can push the ratio one ulp past 1 (ratio 1.0000001
        # -> binomial returns NaN); clamp to the valid range
        ratio = jnp.clip(ratio, 0.0, 1.0)
        if bitrev and level > 1:
            # counts are held in bit-reversed block order (see below);
            # permute the natural-order ratios to match (rev_k is an
            # involution; rev_0/rev_1 are identity)
            ratio = jnp.take(ratio, jnp.asarray(_bitrev_perm(level)), axis=-1)
        # On the earlier target jax.random.binomial sequentialized over a
        # SMALL leading axis when the per-element trailing volume was
        # large, while flattening shapes with a leading axis >= 256 was
        # slower — so only the small-leading x large-volume case is
        # flattened. Leading 128-255 with large volume (no workload
        # produces it) stays on the native path. Element order is
        # preserved, so the streams are bit-identical either way. Scope:
        # rank <= 3 only — flattening a rank-4 process-bootstrap batch
        # forced a padded relayout copy there. None of this is measured on
        # the H100 (ROADMAP C2).
        lead = counts.shape[0] if counts.ndim > 1 else counts.size
        if counts.ndim <= 3 and lead < 128 and counts.size >= lead * (1 << 16):
            left = jax.random.binomial(
                sub, counts.reshape(-1), ratio.reshape(-1)
            ).reshape(counts.shape)
        else:
            left = jax.random.binomial(sub, counts, ratio)
        if bitrev:
            # pad-free growth: appending the right halves on the lane axis
            # keeps blocks in bit-reversed order (index s*2^k + b at level
            # k+1 is natural block 2*rev_k(b) + s = rev_{k+1} of itself)
            counts = jnp.concatenate([left, counts - left], axis=-1)
        else:
            counts = jnp.stack([left, counts - left], axis=-1).reshape(
                batch_shape + (-1,)
            )
    if bitrev:
        counts = jnp.take(counts, jnp.asarray(_bitrev_perm(levels)), axis=-1)
    return counts[..., :m]


def sample_multinomial(key, n_trials, probs, shape=None, method: str = "binary"):
    """Multinomial counts with outcomes along the last axis of `probs`.

    Parameters
    ----------
    key : jax PRNG key
    n_trials : scalar or array broadcastable to probs.shape[:-1]
        Number of shots per distribution.
    probs : (..., n_outcomes) array
        Outcome probabilities (need not be exactly normalized; they are
        renormalized defensively, matching the reference's clip-to-[0,1]
        at quantpy/tomography/state.py:110).
    shape : optional result batch shape (prefix, excluding outcome axis).
    method : 'binary' (log-depth binary splitting, default) or 'chain'
        (jax.random.multinomial's sequential conditional-binomial scan).
        Both are exact samplers of the same distribution.
    """
    probs = jnp.asarray(probs, dtype=rdtype())
    probs = jnp.clip(probs, 0.0, 1.0)
    probs = probs / jnp.sum(probs, axis=-1, keepdims=True)
    n_trials = jnp.asarray(n_trials, dtype=rdtype())
    if shape is not None:
        probs = jnp.broadcast_to(probs, tuple(shape) + probs.shape[-1:])
    if method == "chain":
        return jax.random.multinomial(key, n_trials, probs)
    n_trials = jnp.broadcast_to(n_trials, probs.shape[:-1])
    return _multinomial_binary_split(key, n_trials, probs)
