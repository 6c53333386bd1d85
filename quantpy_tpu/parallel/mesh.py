"""Multi-chip scaling: mesh construction and sharded bootstrap.

The reference is single-process NumPy with sequential loops (SURVEY.md
section 2, "parallelism: absent"). The natural scaling axis for every
workload in this domain is the *experiment/resample batch*: thousands of
independent simulate+estimate problems. This module shards that axis over a
`jax.sharding.Mesh` with `shard_map`, so the per-device program is exactly
the single-device bootstrap and the only collective is the final gather of
distances.

For very large qubit counts the (K, 4^n) weighted-POVM operator can also be
sharded over the measurement axis (`povm_sharded_probabilities`), turning
probability evaluation into a reduce-scattered matmul; with n <= 6 and the
batch axis available this is rarely the right trade, so batch sharding is
the default.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import rdtype
from ..tomography import bootstrap_core

__all__ = [
    "make_mesh",
    "sharded_bootstrap_distances",
    "sharded_kron_bootstrap_distances",
    "sharded_kron_forward_flat",
    "sharded_kron_adjoint_flat",
    "sharded_kron_estimate_lin",
    "sharded_kron_estimate_mle_rhor",
    "sharded_kron_simulate",
    "sharded_process_bootstrap_distances",
    "sharded_coverage",
    "sharded_mhmc_process_chains",
    "sharded_mhmc_state_chains",
    "povm_sharded_probabilities",
]

BATCH_AXIS = "batch"


def make_mesh(n_devices: int | None = None, axis_name: str = BATCH_AXIS) -> Mesh:
    """1-D device mesh over the experiment/resample batch axis."""
    import numpy as np

    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def sharded_bootstrap_distances(
    mesh: Mesh,
    key,
    bloch_est,
    povm_matrix,
    n_measurements,
    n_points: int,
    method: str = "lin",
    dst: str = "hs",
    max_iter: int = 100,
):
    """Bootstrap `n_points` resamples data-parallel over the mesh.

    Each device draws and re-estimates its n_points/n_dev shard with an
    independent fold of `key`; distances are returned fully replicated
    (all_gather).
    """
    n_dev = mesh.devices.size
    if n_points % n_dev:
        raise ValueError(f"n_points={n_points} must divide by {n_dev} devices")
    per_dev = n_points // n_dev
    keys = jax.random.split(key, n_dev)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(BATCH_AXIS), P(), P(), P()),
        out_specs=P(BATCH_AXIS),
        check_vma=False,  # multinomial's internal while_loop carries
        # device-varying state that the VMA checker cannot type
    )
    def run(keys_shard, bloch_est, povm_matrix, n_measurements):
        d = bootstrap_core.bootstrap_distances(
            keys_shard[0],
            bloch_est,
            povm_matrix,
            n_measurements,
            n_points=per_dev,
            method=method,
            dst=dst,
            max_iter=max_iter,
        )
        return d

    return jax.jit(run)(
        keys,
        jnp.asarray(bloch_est, dtype=rdtype()),
        jnp.asarray(povm_matrix, dtype=rdtype()),
        jnp.asarray(n_measurements, dtype=rdtype()),
    )


def sharded_kron_bootstrap_distances(
    mesh: Mesh,
    key,
    bloch_est,
    povm1,
    n_qubits: int,
    n_shots,
    n_points: int,
    method: str = "lin",
    dst: str = "hs",
    max_iter: int = 100,
    chunk: int | None = None,
):
    """Kron-factored bootstrap data-parallel over the mesh — the multi-chip
    path for the 6+ qubit designs whose measurement matrix is never
    materialized. Per-device program = kron_core.kron_bootstrap_distances
    on an n_points/n_dev shard; only the final distance gather crosses devices.
    When the per-device shard exceeds the memory-safe fused batch (9-qubit
    volumes), the per-device program lax.map's over equal chunks — the
    kron_core wrapper detects the traced call and stays on-device.
    """
    from ..tomography import kron_core

    n_dev = mesh.devices.size
    if n_points % n_dev:
        raise ValueError(f"n_points={n_points} must divide by {n_dev} devices")
    per_dev = n_points // n_dev
    keys = jax.random.split(key, n_dev)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(BATCH_AXIS), P(), P()),
        out_specs=P(BATCH_AXIS),
        check_vma=False,  # multinomial's internal while_loop carries
        # device-varying state the VMA checker cannot type
    )
    def run(keys_shard, bloch_est, povm1):
        return kron_core.kron_bootstrap_distances(
            keys_shard[0],
            bloch_est,
            povm1,
            n_qubits,
            n_shots,
            n_points=per_dev,
            method=method,
            dst=dst,
            max_iter=max_iter,
            chunk=chunk,
        )

    return jax.jit(run)(
        keys,
        jnp.asarray(bloch_est, dtype=rdtype()),
        jnp.asarray(povm1, dtype=rdtype()),
    )


def sharded_process_bootstrap_distances(
    mesh: Mesh,
    key,
    choi_bloch,
    out_blochs,
    input_blochs_t,
    povm_matrix,
    n_measurements,
    n_points: int,
    cptp: bool = True,
    dst: str = "hs",
    cp: str = "eigh",
    cptp_iter: int = 2000,
):
    """Process bootstrap (simulate + factored lifp [+ CPTP projection] +
    Choi distance) data-parallel over the mesh.

    The reference's BootstrapProcessInterval loop (interval.py:658-685) is
    embarrassingly parallel over resamples; here every device re-estimates
    its n_points/n_dev shard from its own key fold. All-real signature:
    choi_bloch (16^n,) reference point, out_blochs (S, 4^n) channel output
    states, input_blochs_t (S, 4^n) transposed inputs. `cp`/`cptp_iter`
    select the Dykstra CP engine and iteration cap (cp='ns' with a few
    hundred iterations is the 4+ qubit recipe, as in
    BootstrapProcessInterval)."""
    import math

    from ..tomography import process_core

    n_dev = mesh.devices.size
    if n_points % n_dev:
        raise ValueError(f"n_points={n_points} must divide by {n_dev} devices")
    per_dev = n_points // n_dev
    keys = jax.random.split(key, n_dev)
    n2 = int(round(math.log(jnp.asarray(choi_bloch).shape[-1], 4)))

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(BATCH_AXIS), P(), P(), P(), P(), P()),
        out_specs=P(BATCH_AXIS),
        check_vma=False,  # multinomial's internal while_loop carries
        # device-varying state the VMA checker cannot type
    )
    def run(keys_shard, choi_ref, outs, inputs_t, povm, n_meas):
        counts = process_core.simulate_process_experiment(
            keys_shard[0],
            povm,
            jnp.broadcast_to(outs, (per_dev,) + outs.shape),
            n_meas,
        )
        blochs = process_core.estimate_lifp_factored(
            counts, inputs_t, povm, n_meas, cptp=cptp, cptp_iter=cptp_iter,
            cp=cp,
        )
        return bootstrap_core._distance_batch(dst, blochs, choi_ref, n2)

    return jax.jit(run)(
        keys,
        jnp.asarray(choi_bloch, dtype=rdtype()),
        jnp.asarray(out_blochs, dtype=rdtype()),
        jnp.asarray(input_blochs_t, dtype=rdtype()),
        jnp.asarray(povm_matrix, dtype=rdtype()),
        jnp.asarray(n_measurements, dtype=rdtype()),
    )


def sharded_coverage(
    mesh: Mesh,
    key,
    problem,
    conf_levels,
    n_trials: int,
):
    """Monte-Carlo coverage (polytopes/verification.py) sharded over the
    mesh: each device simulates and tests n_trials/n_dev experiments from
    its own key fold; per-level hit counts ride a psum.

    `problem` is the tuple from verification.qst_problem / qpt_problem.
    Returns per-level coverage (L,), replicated.
    """
    from ..tomography.polytopes import verification

    povm, n_meas, sim_blochs, prod, offset, clip_b = problem
    n_dev = mesh.devices.size
    if n_trials % n_dev:
        raise ValueError(f"n_trials={n_trials} must divide by {n_dev} devices")
    per_dev = n_trials // n_dev
    keys = jax.random.split(key, n_dev)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(BATCH_AXIS), P(), P(), P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    def run(keys_shard, povm, n_meas, sim_blochs, prod, offset, cl):
        sums = verification.coverage_hits(
            keys_shard[0], povm, n_meas, sim_blochs, prod, offset, cl,
            per_dev, clip_b,
        )
        return jax.lax.psum(sums, BATCH_AXIS)

    sums = jax.jit(run)(
        keys,
        jnp.asarray(povm, dtype=rdtype()),
        jnp.asarray(n_meas, dtype=rdtype()),
        jnp.asarray(sim_blochs, dtype=rdtype()),
        jnp.asarray(prod, dtype=rdtype()),
        jnp.asarray(offset, dtype=rdtype()),
        jnp.asarray(conf_levels, dtype=rdtype()),
    )
    import numpy as np

    return np.asarray(sums, dtype=np.float64) / n_trials


def _sharded_chains(
    mesh: Mesh,
    key,
    x_init,
    extra_arrays,
    make_fns,
    step: float,
    n_chains: int,
    n_samples: int,
    burn_steps: int,
    thinning: int,
    jump_distr,
):
    """Shared scaffold for mesh-sharded Metropolis chains.

    Chains are embarrassingly parallel (the reference runs ONE sequential
    Python chain, mhmc.py:80-84; the single-chip extension vmaps them,
    mhmc.sample_chains); here each device runs its n_chains/n_dev share —
    same Metropolis kernel, own key folds, each with its own burn-in — and
    the sample gather is the only cross-device traffic. `make_fns(*extra_arrays)`
    builds the (logpdf, update_rule) pair inside the mapped region from
    the replicated array operands.
    """
    from ..mhmc import _run_chain, resolve_jump_distr

    n_dev = mesh.devices.size
    if n_chains % n_dev:
        raise ValueError(f"n_chains={n_chains} must divide by {n_dev} devices")
    per_dev = n_chains // n_dev
    keys = jax.random.split(key, n_dev)
    total = int(n_samples) * int(thinning) + int(burn_steps)
    jump_fn = resolve_jump_distr(jump_distr)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(BATCH_AXIS), P()) + (P(),) * len(extra_arrays),
        out_specs=(P(BATCH_AXIS), P(BATCH_AXIS)),
        check_vma=False,
    )
    def run(keys_shard, x0, *arrs):
        logpdf, update_rule = make_fns(*arrs)

        def one(k):
            xs, acc = _run_chain(
                k, x0, logpdf, update_rule, jump_fn, step, total, 1
            )
            kept = xs[int(burn_steps) :]
            return kept[int(thinning) - 1 :: int(thinning)], acc

        return jax.vmap(one)(jax.random.split(keys_shard[0], per_dev))

    xs, acc = jax.jit(run)(
        keys,
        jnp.asarray(x_init, dtype=rdtype()),
        *[jnp.asarray(a, dtype=rdtype()) for a in extra_arrays],
    )
    import numpy as np

    return np.asarray(xs), float(np.sum(np.asarray(acc))) / (n_chains * total)


def sharded_mhmc_state_chains(
    mesh: Mesh,
    key,
    x_init,
    povm_flat_w,
    frequencies,
    n_qubits: int,
    scale,
    step: float,
    n_chains: int,
    n_samples: int,
    burn_steps: int = 100,
    thinning: int = 1,
    jump_distr=None,
):
    """Independent state-NLL likelihood chains sharded over the mesh.

    The target is the (optionally count-scaled) state NLL over Cholesky
    parameters (state_core.nll_tril) against the dense weighted design —
    identical to MHMCStateInterval's single-device chain.

    Returns (samples (n_chains, n_samples, dim), acceptance_rate).
    """
    from ..mhmc import normalized_update
    from ..tomography import state_core

    scale = float(scale)

    def make_fns(povm_w, freq):
        def logpdf(x):
            return -scale * state_core.nll_tril(x, povm_w, freq, n_qubits)

        return logpdf, normalized_update

    return _sharded_chains(
        mesh, key, x_init, (povm_flat_w, frequencies), make_fns,
        step, n_chains, n_samples, burn_steps, thinning, jump_distr,
    )


def sharded_mhmc_process_chains(
    mesh: Mesh,
    key,
    x_init,
    input_blochs_t,
    povm_matrix,
    n_measurements,
    flat_counts,
    step: float,
    n_chains: int,
    n_samples: int,
    burn_steps: int = 100,
    thinning: int = 1,
    jump_distr=None,
    cptp_iter: int = 100,
    cp: str | None = None,
):
    """Process-tomography twin of :func:`sharded_mhmc_state_chains`:
    CPTP-projected Metropolis chains over Choi bloch vectors. The target
    is the factored process NLL (the dense (S*K, 16^n) operator is never
    formed) and every proposal is Dykstra-projected into CPTP with the
    same tolerance as the single-device chain
    (ProcessTomograph._cptp_update_rule -> _cptp_tol(1e-12)). `cp` selects
    the CP engine; default matches _cptp_update_rule ('ns' at 4+ qubits).

    Returns (samples (n_chains, n_samples, 16^n), acceptance_rate).
    """
    import math

    import numpy as np

    from ..tomography import process_core, state_core

    tol = process_core.default_cptp_tol(1e-12)
    d2 = np.asarray(x_init).shape[-1]
    if cp is None:
        cp = "ns" if int(round(math.log(d2, 16))) >= 4 else "eigh"

    def make_fns(b, povm, n_meas, flat):
        w = state_core.weighted_povm_flat(povm, n_meas)

        def logpdf(x):
            return -process_core.process_nll_factored(x, b, w, flat)

        def update_rule(x, delta, s):
            return process_core.cptp_project_bloch(x + s * delta, cptp_iter, tol, cp)

        return logpdf, update_rule

    return _sharded_chains(
        mesh, key, x_init,
        (input_blochs_t, povm_matrix, n_measurements, flat_counts), make_fns,
        step, n_chains, n_samples, burn_steps, thinning, jump_distr,
    )


def _kron_factor_shards(povm1, n_qubits: int, n_dev: int):
    """Shared setup of the operator-sharded kron chain: grouped factors
    with the FIRST group's outcome axis destined for the mesh."""
    from ..tomography import kron_core

    povm1 = jnp.asarray(povm1, dtype=rdtype())
    groups, factors = kron_core._grouped_factors(povm1, n_qubits)
    p0 = factors[0].shape[1]
    if p0 % n_dev:
        raise ValueError(
            f"first-group outcome axis {p0} must divide by {n_dev} devices "
            f"(groups {groups}; pick a mesh size dividing p1^{groups[0]})"
        )
    return groups, factors


def sharded_kron_forward_flat(mesh: Mesh, bloch, povm1, n_qubits: int):
    """OPERATOR-sharded kron forward (SURVEY section 2 checklist: "sharding
    the 4^n Pauli-transfer operators over devices for n >= 6"): the FIRST measurement group's outcome axis rides the mesh, so
    each device holds factor slice f0[:, p0_shard, :] and computes its
    (z, M, P/n_dev) slab of the output — the bloch input is replicated
    (4^n reals, e.g. 16 MB at 11 qubits) and NO collective runs in the
    forward. With 8 devices the 6^n output tensor (1.45 GB at 11 qubits,
    8.7 GB at 12) is memory-sharded 8x, which is the principled multi-chip
    answer to the one-device 11-qubit layout wall.

    Returns the flat forward (…, (m1*p1)^n) fully gathered — the matvec
    twin of kron_core.kron_forward_flat (equality-tested at 6 qubits).
    """
    from ..tomography import kron_core

    n_dev = mesh.devices.size
    groups, factors = _kron_factor_shards(povm1, n_qubits, n_dev)
    k = len(groups)
    spec = kron_core._forward_spec(k)
    m1, p1, _ = jnp.asarray(povm1).shape
    m_tot, p_tot = m1**n_qubits, p1**n_qubits
    bloch = jnp.asarray(bloch, dtype=rdtype())
    batch_shape = bloch.shape[:-1]
    x = bloch.reshape((-1,) + tuple(4**g for g in groups))

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(None, BATCH_AXIS, None)) + (P(),) * (k - 1),
        out_specs=P(None, None, BATCH_AXIS),
    )
    def run(xs, f0_loc, *rest):
        out = jnp.einsum(spec, xs, f0_loc, *rest, optimize=True)
        return out.reshape(xs.shape[0], m_tot, -1)

    out = jax.jit(run)(x, factors[0], *factors[1:])
    return out.reshape(batch_shape + (m_tot * p_tot,))


def sharded_kron_adjoint_flat(mesh: Mesh, c, povm1, n_qubits: int):
    """Operator-sharded kron adjoint: each device contracts its outcome
    slab c[..., M, p0_shard, ...] against its factor slice; the only
    collective is the psum of the small (4^n,) results. Twin of
    kron_core.kron_adjoint_flat (equality-tested at 6 qubits)."""
    from ..tomography import kron_core

    n_dev = mesh.devices.size
    groups, factors = _kron_factor_shards(povm1, n_qubits, n_dev)
    k = len(groups)
    spec = kron_core._adjoint_spec(k)
    m1, p1, _ = jnp.asarray(povm1).shape
    m_tot, p_tot = m1**n_qubits, p1**n_qubits
    m_sizes = tuple(f.shape[0] for f in factors)
    p_sizes = tuple(f.shape[1] for f in factors)
    c = jnp.asarray(c, dtype=rdtype())
    batch_shape = c.shape[:-1]
    c3 = c.reshape((-1, m_tot, p_tot))

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, None, BATCH_AXIS), P(None, BATCH_AXIS, None))
        + (P(),) * (k - 1),
        out_specs=P(),
    )
    def run(cs, f0_loc, *rest):
        cl = cs.reshape(
            (cs.shape[0],) + m_sizes + (f0_loc.shape[1],) + p_sizes[1:]
        )
        out = jnp.einsum(spec, cl, f0_loc, *rest, optimize=True)
        return jax.lax.psum(out.reshape(cs.shape[0], -1), BATCH_AXIS)

    out = jax.jit(run)(c3, factors[0], *factors[1:])
    return out.reshape(batch_shape + (4**n_qubits,))


def sharded_kron_estimate_lin(
    mesh: Mesh, counts, povm1, n_qubits: int, physical: bool = True
):
    """Operator-sharded linear inversion: counts live SHARDED on the
    outcome axis (the 6^n tensor is never whole on one device), the
    adjoint psums the (4^n,) right-hand side, and the factored
    Gram solve + feasibility projection run replicated. Same math as
    kron_core.kron_estimate_lin (equality-tested at 6 qubits)."""
    from ..tomography import kron_core

    n_dev = mesh.devices.size
    groups, factors = _kron_factor_shards(povm1, n_qubits, n_dev)
    k = len(groups)
    spec = kron_core._adjoint_spec(k)
    m1, p1, _ = jnp.asarray(povm1).shape
    m_tot, p_tot = m1**n_qubits, p1**n_qubits
    m_sizes = tuple(f.shape[0] for f in factors)
    p_sizes = tuple(f.shape[1] for f in factors)
    gram_invs = kron_core._grouped_gram_inv(
        jnp.asarray(povm1, dtype=rdtype()), groups
    )
    solve_spec = kron_core._solve_spec(k)
    counts = jnp.asarray(counts, dtype=rdtype())
    batch_shape = counts.shape[:-2]
    c3 = counts.reshape((-1, m_tot, p_tot))

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, None, BATCH_AXIS), P(None, BATCH_AXIS, None))
        + (P(),) * (k - 1)
        + (P(),) * k,
        out_specs=P(),
    )
    def run(cs, f0_loc, *rest_and_grams):
        rest = rest_and_grams[: k - 1]
        grams = rest_and_grams[k - 1 :]
        total = jax.lax.psum(
            jnp.sum(cs, axis=(-2, -1), keepdims=True), BATCH_AXIS
        )
        freq = cs / total
        cl = freq.reshape(
            (cs.shape[0],) + m_sizes + (f0_loc.shape[1],) + p_sizes[1:]
        )
        rhs = jnp.einsum(spec, cl, f0_loc, *rest, optimize=True)
        rhs = jax.lax.psum(rhs.reshape(cs.shape[0], -1), BATCH_AXIS)
        x = rhs.reshape((-1,) + tuple(4**g for g in groups))
        sol = jnp.einsum(solve_spec, x, *grams, optimize=True)
        bloch = sol.reshape(cs.shape[0], 4**n_qubits) * m_tot / (2**n_qubits)
        if physical:
            from ..tomography.state_core import make_feasible_bloch

            bloch = make_feasible_bloch(bloch, n_qubits)
        return bloch

    out = jax.jit(run)(c3, factors[0], *factors[1:], *gram_invs)
    return out.reshape(batch_shape + (4**n_qubits,))


def sharded_kron_simulate(mesh: Mesh, key, povm1, bloch, n_shots):
    """Operator-sharded multinomial experiment simulation: each device
    evaluates its (…, M, P/n_dev) probability slab from the replicated
    bloch input and draws ITS OWN outcomes — the 6^n counts tensor is
    born sharded and never whole on any device (8.7 GB total at 12
    qubits ≈ 1.1 GB/device on 8). The marginal counts per first-group
    p0-slice are drawn independently per device, one first-group m-slice
    per lax.map step (one key fold per device and m-slice), which
    samples a DIFFERENT exact joint than the single-chip multinomial:
    per-POVM totals are fixed only in expectation, i.e. this is the
    product-binomial ("Poissonized block") design. For the
    uniform-weight estimators here both designs give the same
    asymptotics; the single-chip twin for bit-exact parity is
    kron_core.kron_simulate. Returns a jax.Array sharded over the mesh's
    outcome axis, suitable for sharded_kron_estimate_{lin,mle_rhor}.

    Reference: quantpy/tomography/state.py:108-114 (sequential per-POVM
    numpy draws).
    """
    from ..ops.sampling import sample_multinomial
    from ..tomography import kron_core

    n_dev = mesh.devices.size
    bloch = jnp.asarray(bloch, dtype=rdtype())
    n_qubits = int(round(math.log(bloch.shape[-1], 4)))
    groups, factors = _kron_factor_shards(povm1, n_qubits, n_dev)
    k = len(groups)
    spec = kron_core._forward_spec(k)
    m1, p1, _ = jnp.asarray(povm1).shape
    m_tot, p_tot = m1**n_qubits, p1**n_qubits
    batch_shape = bloch.shape[:-1]
    x = bloch.reshape((-1,) + tuple(4**g for g in groups))
    n_shots = jnp.asarray(n_shots, dtype=rdtype())
    m0 = factors[0].shape[0]
    m_rest = m_tot // m0

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(None, BATCH_AXIS, None)) + (P(),) * (k - 1),
        out_specs=P(None, None, BATCH_AXIS),
        # jax.random.binomial's internal rejection while_loop trips the vma
        # checker on varying-carry inference (jax 0.9); the draw itself is
        # purely per-device
        check_vma=False,
    )
    def run(k_repl, xs, f0_loc, *rest):
        dev = jax.lax.axis_index(BATCH_AXIS)
        kd = jax.random.fold_in(k_repl, dev)

        # draw one first-group m-slice at a time (lax.map): the binary-
        # split sampler keeps every level's block sums alive, ~4x the
        # probs volume — fused at 12 qubits that peaked past the host's
        # RAM on the virtual mesh (measured); per-slice the
        # transient is 1/27th, while the counts output is unchanged
        def block(k_f0):
            kb, f0_blk = k_f0
            probs = jnp.einsum(spec, xs, f0_blk, *rest, optimize=True)
            probs = jnp.clip(probs * (2**n_qubits), 0.0, 1.0)
            probs = probs.reshape(xs.shape[0], m_rest, -1)
            mass = jnp.sum(probs, axis=-1)
            total_mass = jax.lax.psum(mass, BATCH_AXIS)
            n_loc = n_shots * mass / jnp.where(total_mass > 0, total_mass, 1.0)
            return sample_multinomial(kb, jnp.round(n_loc), probs)

        out = jax.lax.map(
            block, (jax.random.split(kd, m0), f0_loc[:, None, :, :])
        )  # (m0, z, m_rest, p_loc)
        return jnp.moveaxis(out, 0, 1).reshape(xs.shape[0], m_tot, -1)

    out = jax.jit(run)(key, x, factors[0], *factors[1:])
    return out.reshape(batch_shape + (m_tot, p_tot))


def sharded_kron_estimate_mle_rhor(
    mesh: Mesh,
    counts,
    povm1,
    n_qubits: int,
    init_bloch=None,
    max_iter: int = 100,
    tol: float = 1e-6,
):
    """Operator-sharded RrhoR fixed-point MLE — the 12-qubit enabler.

    Same fixed point as kron_core.kron_estimate_mle_rhor (itself the
    factored twin of the reference's update, quantpy/tomography/
    state.py:163-176), with every 6^n-sized tensor sharded over the
    mesh on the first measurement group's outcome axis:

    - per iteration each device evaluates its (z, M, P/n_dev)
      probability slab from the replicated bloch (no collective),
      forms freq/probs locally, and contracts its slab through the
      adjoint chain; the ONLY per-iteration collectives are the psum
      of the small (z, 4^n) R-vector and the row all_gather
      of the sandwich below;
    - the R·rho·R sandwich (the dense 2^n-dim matmuls, where the
      matmul FLOPs are at 12 qubits: 2 x 4096^3 complex) is row-sharded:
      each device computes its (2^n/n_dev, 2^n) row block of
      (R rho) R and the blocks all_gather back to the replicated new
      rho (268 MB at 12q c64 — one all_gather per iteration). When
      n_dev does not divide 2^n the sandwich runs replicated instead.

    counts may be host-resident or already mesh-sharded (e.g. from
    sharded_kron_simulate — at 12 qubits the 8.7 GB tensor should be
    born sharded). Returns the replicated (…, 4^n) bloch estimate.
    """
    from ..ops.paulis import bloch_to_matrix, matrix_to_bloch
    from ..tomography import kron_core

    n_dev = mesh.devices.size
    groups, factors = _kron_factor_shards(povm1, n_qubits, n_dev)
    k = len(groups)
    fwd_spec = kron_core._forward_spec(k)
    adj_spec = kron_core._adjoint_spec(k)
    m1, p1, _ = jnp.asarray(povm1).shape
    m_tot, p_tot = m1**n_qubits, p1**n_qubits
    m_sizes = tuple(f.shape[0] for f in factors)
    p_sizes = tuple(f.shape[1] for f in factors)
    d_groups = tuple(4**g for g in groups)
    dim = 2**n_qubits
    scale = (2**n_qubits) / m_tot
    row_sharded = dim % n_dev == 0
    rows_loc = dim // n_dev if row_sharded else dim

    counts = jnp.asarray(counts, dtype=rdtype())
    batch_shape = counts.shape[:-2]
    c3 = counts.reshape((-1, m_tot, p_tot))

    if init_bloch is None:
        init_bloch = sharded_kron_estimate_lin(
            mesh, counts, povm1, n_qubits, physical=True
        )
    init_bloch = jnp.asarray(init_bloch, dtype=rdtype()).reshape(-1, 4**n_qubits)
    mixed = jnp.zeros_like(init_bloch).at[..., 0].set(1.0 / dim)
    bloch0 = 0.95 * init_bloch + 0.05 * mixed

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(None, None, BATCH_AXIS), P(None, BATCH_AXIS, None))
        + (P(),) * (k - 1),
        out_specs=P(),
        # the all_gather'd sandwich rows are device-identical by
        # construction but the vma checker cannot prove it through the
        # while_loop carry; the 6q equality test below is the proof
        check_vma=False,
    )
    def run(b0, cs, f0_loc, *rest):
        z = cs.shape[0]
        total = jax.lax.psum(
            jnp.sum(cs, axis=(-2, -1), keepdims=True), BATCH_AXIS
        )
        freq = cs / total
        freq_b = freq.reshape((z,) + m_sizes + (f0_loc.shape[1],) + p_sizes[1:])

        def r_vector(bloch):
            xs = bloch.reshape((z,) + d_groups)
            probs = jnp.einsum(fwd_spec, xs, f0_loc, *rest, optimize=True)
            probs = jnp.clip(probs * (2**n_qubits), 0.0, 1.0) / m_tot
            c = freq_b / jnp.clip(probs, kron_core._NLL_EPS, None)
            rhs = jnp.einsum(adj_spec, c, f0_loc, *rest, optimize=True)
            rhs = jax.lax.psum(rhs.reshape(z, -1), BATCH_AXIS)
            return rhs * scale

        def sandwich(r, rho):
            if not row_sharded:
                return r @ rho @ r
            dev = jax.lax.axis_index(BATCH_AXIS)
            r_loc = jax.lax.dynamic_slice_in_dim(r, dev * rows_loc, rows_loc, -2)
            new_loc = (r_loc @ rho) @ r  # (z, rows_loc, dim)
            gathered = jax.lax.all_gather(new_loc, BATCH_AXIS, axis=-2, tiled=True)
            return gathered

        def cond(carry):
            _, it, delta = carry
            return jnp.logical_and(it < max_iter, delta > tol)

        def step(carry):
            bloch, it, _ = carry
            r = bloch_to_matrix(r_vector(bloch), n_qubits)
            rho = bloch_to_matrix(bloch, n_qubits)
            new = sandwich(r, rho)
            tr = jnp.trace(new, axis1=-2, axis2=-1).real
            new_bloch = matrix_to_bloch(new) / tr[..., None]
            delta = jnp.max(jnp.abs(new_bloch - bloch))
            return new_bloch, it + 1, delta

        bloch, _, _ = jax.lax.while_loop(
            cond, step, (b0, jnp.asarray(0), jnp.asarray(jnp.inf, rdtype()))
        )
        return bloch

    out = jax.jit(run)(bloch0, c3, factors[0], *factors[1:])
    return out.reshape(batch_shape + (4**n_qubits,))


def sharded_mhmc_kraus_chains(
    mesh: Mesh,
    key,
    dz_init,
    pack,
    input_blochs_t,
    w_flat,
    flat_counts,
    p_ref,
    scale: float,
    step: float,
    n_chains: int,
    n_samples: int,
    burn_steps: int = 100,
    thinning: int = 1,
    jump_distr=None,
    u_scale=None,
):
    """ANCHORED kraus-factor process chains sharded over the mesh : each device runs its
    share of random-walk chains on the smooth exactly-CPTP anchored-delta
    target (process_core.process_nll_anchored); the chain state is the
    offset dz from the host-f64 anchor in `pack`
    (process_core.np_kraus_anchor_pack). Symmetric proposals only (MALA
    kraus chains parallelize with vmap, as before).

    Returns (samples (n_chains, n_samples, 2*D*D) of OFFSETS dz,
    acceptance_rate) — decode via pack's anchor + kraus_delta_choi_bloch.
    """
    from ..mhmc import basic_update
    from ..tomography import process_core

    scale = float(scale)
    pack_keys = sorted(pack)
    pack_vals = tuple(pack[k] for k in pack_keys)
    has_uscale = u_scale is not None
    extra = (jnp.asarray(u_scale, rdtype()),) if has_uscale else ()

    def make_fns(*arrs):
        pk = dict(zip(pack_keys, arrs[: len(pack_keys)]))
        rest = arrs[len(pack_keys):]
        if has_uscale:
            b_, w_, flat_, p_, us_ = rest
        else:
            b_, w_, flat_, p_ = rest
            us_ = None

        def logpdf(x):
            xx = x * us_ if has_uscale else x
            return -scale * process_core.process_nll_anchored(
                xx, b_, w_, flat_, pk, p_
            )

        return logpdf, basic_update

    return _sharded_chains(
        mesh, key, dz_init,
        pack_vals + (input_blochs_t, w_flat, flat_counts, p_ref) + extra,
        make_fns,
        step, n_chains, n_samples, burn_steps, thinning, jump_distr,
    )


def povm_sharded_probabilities(mesh: Mesh, povm_flat, bloch):
    """Probability evaluation with the measurement axis sharded over the
    mesh: p_k = (W @ bloch)_k computed on the owner of row k. Demonstrates
    the operator-sharded path for large n (SURVEY.md section 2 checklist).
    """
    axis = mesh.axis_names[0]

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(P(axis, None), P()), out_specs=P(axis)
    )
    def run(w_shard, b):
        return w_shard @ b

    return run(jnp.asarray(povm_flat, rdtype()), jnp.asarray(bloch, rdtype()))
