"""Monte-Carlo coverage verification of confidence polytopes.

Counterpart of reference quantpy/tomography/polytopes/verification.py:9-78,
the reference's de-facto statistical test harness (SURVEY.md section 4):
repeat the experiment many times and count how often the TRUE state/process
satisfies every polytope inequality at each nominal confidence level.

The reference loops trials in Python (1000+ experiments x bisections each);
here all trials are simulated in one device call and the (trial, level)
bisection grid is one vmapped fixed-depth bisection. The per-key trial
kernel (:func:`coverage_hits`) is exposed separately so the mesh layer can
shard trials across chips (parallel/mesh.py: each device runs its own key
fold, hit counts are psum-reduced).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ...config import rdtype
from ...measurements import generate_measurement_matrix
from .. import state_core
from .utils import count_delta

__all__ = ["test_qst", "test_qpt", "qst_problem", "qpt_problem", "coverage_hits"]

_EPS = 1e-15


def _coverage(polytope_prod, base_offset, counts_n_meas, conf_levels,
              clip_b: bool):
    """Shared coverage count: for each (trial, level), check
    min(b - A @ true_bloch) > -EPS with b = clip(freq + delta) - offset."""
    conf_levels = jnp.asarray(conf_levels, dtype=rdtype())

    def per_trial(freq_t):
        # sequential over confidence levels (lax.map) so peak memory stays
        # at one (S, m, p) KL tensor per trial instead of L of them — this
        # is what lets 3-qubit QPT coverage (L x 64 x 27 x 8 per trial)
        # run at 10^4 trials
        def one_level(cl):
            delta = count_delta(cl.reshape(1), freq_t, counts_n_meas)[0]
            flat = freq_t.reshape(-1)
            b = flat + delta
            if clip_b:
                b = jnp.clip(b, _EPS, 1 - _EPS)
            b = b - base_offset
            return jnp.min(b - polytope_prod) > -_EPS

        return jax.lax.map(one_level, conf_levels)

    return per_trial


@functools.partial(jax.jit, static_argnames=("n_trials", "clip_b"))
def coverage_hits(
    key,
    povm_matrix,
    n_meas,
    sim_blochs,
    polytope_prod,
    base_offset,
    conf_levels,
    n_trials: int,
    clip_b: bool,
):
    """Per-level HIT COUNTS (L,) over `n_trials` simulated experiments.

    The shardable unit of the coverage harness: simulate + clip + polytope
    membership for one key. `sim_blochs` is the (4^n,) state bloch (QST) or
    the (S, 4^n) output-state blochs (QPT); all-real signature."""
    povm_matrix = jnp.asarray(povm_matrix, dtype=rdtype())
    n_meas = jnp.asarray(n_meas, dtype=rdtype())
    sim_blochs = jnp.asarray(sim_blochs, dtype=rdtype())
    blochs = jnp.broadcast_to(sim_blochs, (n_trials,) + sim_blochs.shape)
    counts = state_core.simulate_experiment(key, povm_matrix, blochs, n_meas)
    freq = jnp.clip(counts / n_meas[:, None], _EPS, 1 - _EPS)
    per_trial = _coverage(
        jnp.asarray(polytope_prod, rdtype()),
        jnp.asarray(base_offset, rdtype()),
        n_meas,
        conf_levels,
        clip_b=clip_b,
    )
    hits = jax.vmap(per_trial)(freq)
    return jnp.sum(hits.astype(rdtype()), axis=0)


def qst_problem(state, n_measurements):
    """Static arrays of the QST coverage problem: (povm_matrix, n_meas,
    sim_blochs, polytope_prod, base_offset, clip_b)."""
    dim = 2**state.n_qubits
    povm_matrix = generate_measurement_matrix("proj-set", state.n_qubits)
    m = povm_matrix.shape[0]
    n_meas = np.full(m, n_measurements, dtype=np.float64)

    povm_flat = (
        povm_matrix * n_meas[:, None, None] / n_meas.sum()
    ).reshape(-1, povm_matrix.shape[-1]) * m
    a_matrix = povm_flat[:, 1:] * dim
    polytope_prod = a_matrix @ np.asarray(state.bloch[1:])
    base_offset = povm_flat[:, 0]
    return (
        povm_matrix,
        n_meas,
        np.asarray(state.bloch, dtype=np.float64),
        polytope_prod,
        base_offset,
        True,
    )


def qpt_problem(channel, n_measurements, input_states="sic"):
    """Static arrays of the QPT coverage problem (same tuple layout as
    :func:`qst_problem`)."""
    from ..process import ProcessTomograph

    tmg = ProcessTomograph(channel, input_states=input_states)
    n = channel.n_qubits
    dim = 4**n

    povm_matrix = generate_measurement_matrix("proj-set", n)
    m = povm_matrix.shape[0]
    n_meas = np.full(m, n_measurements, dtype=np.float64)

    meas_flat = (
        povm_matrix * n_meas[:, None, None] / n_meas.sum()
    ).reshape(-1, povm_matrix.shape[-1]) * m
    states_matrix = tmg._input_blochs_t()
    # the constraint rows factor as a[(s,j)] = dim * b_s (x) w_j with the
    # W-side identity component dropped (the reference's bloch_indices mask,
    # i.e. every (a, b) with b > 0), so A @ x never needs the materialized
    # (S*K, dim^2 - dim) operator — at 4 qubits that operator would be
    # ~170 GB, the wall that kept coverage verification at <= 3 qubits
    choi_rect = np.asarray(channel.choi.bloch).reshape(dim, dim)[:, 1:]
    polytope_prod = (
        dim * states_matrix @ choi_rect @ meas_flat[:, 1:].T
    ).reshape(-1)
    base_offset = np.tile(meas_flat[:, 0], states_matrix.shape[0])

    out_blochs = np.stack(
        [channel.transform(s).bloch for s in tmg.input_basis.elements]
    )
    return povm_matrix, n_meas, out_blochs, polytope_prod, base_offset, False


def test_qst(state, conf_levels, n_measurements=1000, n_trials=1000, key=None):
    """Empirical coverage of the state confidence polytope
    (reference verification.py:9-37). Returns per-level coverage in [0, 1].
    """
    if key is None:
        key = jax.random.key(0)
    povm, n_meas, sim_blochs, prod, offset, clip_b = qst_problem(
        state, n_measurements
    )
    sums = coverage_hits(
        key, povm, n_meas, sim_blochs, prod, offset,
        jnp.asarray(conf_levels, rdtype()), n_trials, clip_b,
    )
    return np.asarray(sums, dtype=np.float64) / n_trials


def test_qpt(channel, conf_levels, n_measurements=1000, n_trials=1000,
             input_states="sic", key=None):
    """Empirical coverage of the process confidence polytope
    (reference verification.py:40-78)."""
    if key is None:
        key = jax.random.key(1)
    povm, n_meas, sim_blochs, prod, offset, clip_b = qpt_problem(
        channel, n_measurements, input_states
    )
    sums = coverage_hits(
        key, povm, n_meas, sim_blochs, prod, offset,
        jnp.asarray(conf_levels, rdtype()), n_trials, clip_b,
    )
    return np.asarray(sums, dtype=np.float64) / n_trials
