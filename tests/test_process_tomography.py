"""Process tomography: simulation, lifp/pgdb/states estimators, CPTP
projection, reference parity."""

import numpy as np
import pytest

import quantpy_tpu as qt
from quantpy_tpu.channel import amplitude_damping, dephasing, depolarizing
from quantpy_tpu.operator import X
from quantpy_tpu.tomography.process import ProcessTomograph
from quantpy_tpu.tomography import process_core

from .reference_shim import get_reference

ref = get_reference()
needs_ref = pytest.mark.skipif(ref is None, reason="reference unavailable")


def choi_dist(a, b):
    return float(qt.hs_dst(a.choi, b.choi))


def test_experiment_structure():
    tmg = ProcessTomograph(depolarizing(0.3), key=1)
    tmg.experiment(1000, "proj-set")
    assert len(tmg.tomographs) == 4
    assert tmg.results.shape == (4, 3, 2)
    np.testing.assert_allclose(tmg.results.sum(-1), 1000)


@pytest.mark.parametrize("method", ["lifp", "pgdb", "states"])
def test_estimators_recover_channel(method):
    true = dephasing(0.4)
    tmg = ProcessTomograph(true, key=2)
    tmg.experiment(30000, "proj-set")
    est = tmg.point_estimate(method)
    assert choi_dist(est, true) < 0.05, method
    assert est.is_cptp(atol=1e-3)


def test_input_states_must_span():
    with pytest.raises(ValueError):
        ProcessTomograph(depolarizing(0.5), input_states="proj-set")
    # proj-set squeezed has 6 states of 1 qubit -> not a 4-element basis
    # (reference raises the same way, process.py:78-81)


def test_cptp_projection_properties():
    tmg = ProcessTomograph(depolarizing(0.5), key=3)
    # a random non-CPTP "channel"
    rng = np.random.default_rng(0)
    bad = qt.Channel(qt.Qobj(np.diag(rng.uniform(0.2, 1.5, size=4)).astype(complex)))
    proj = tmg.cptp_projection(bad)
    assert proj.is_cptp(atol=1e-5)
    # idempotence
    proj2 = tmg.cptp_projection(proj)
    assert choi_dist(proj, proj2) < 1e-5
    # a CPTP channel is (approximately) a fixed point
    good = dephasing(0.3)
    fixed = tmg.cptp_projection(good)
    assert choi_dist(good, fixed) < 1e-6


def test_cp_projection_newton_schulz_matches_eigh():
    """The matmul-only Newton-Schulz CP projection (the matmul route for
    4096-dim Choi matrices, where a batched eigh is costly) agrees
    with the exact eigh clip."""
    from quantpy_tpu.ops.paulis import np_matrix_to_bloch

    rng = np.random.default_rng(3)
    for d in (4, 16):
        m = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
        a = (m + m.conj().T) / 2
        bloch = np_matrix_to_bloch(a)
        eigh = np.asarray(process_core.cp_project_bloch(bloch))
        ns = np.asarray(process_core.cp_project_bloch_ns(bloch))
        np.testing.assert_allclose(ns, eigh, atol=1e-6 * np.linalg.norm(a))


def test_dykstra_ns_engine_matches_eigh():
    rng = np.random.default_rng(11)
    m = rng.normal(size=(16, 16))
    bad = qt.Qobj(((m + m.T) / 8 + np.eye(16)).astype(complex))
    ref = np.asarray(
        process_core.cptp_project_bloch_host(bad.bloch, max_iter=50, chunk=10)
    )
    ns = np.asarray(
        process_core.cptp_project_bloch_host(
            bad.bloch, max_iter=50, chunk=10, cp="ns"
        )
    )
    np.testing.assert_allclose(ns, ref, atol=1e-5)


def test_cptp_projection_host_chunked_matches_fused():
    # the host-chunked Dykstra (used at 5+ qubits; ROADMAP C1) must agree
    # with the fused while_loop version
    rng = np.random.default_rng(7)
    m = rng.normal(size=(16, 16))
    bad_choi = qt.Qobj(((m + m.T) / 8 + np.eye(16)).astype(complex))
    fused = np.asarray(process_core.cptp_project_bloch(bad_choi.bloch))
    chunked = np.asarray(
        process_core.cptp_project_bloch_host(bad_choi.bloch, chunk=37)
    )
    np.testing.assert_allclose(chunked, fused, atol=1e-7)


def test_lifp_big_n_dispatch_matches_fused(monkeypatch):
    """The big-n lifp branch (host-chunked Dykstra after the factored
    inversion, used at 5+ qubits) must give the same estimate as the fused
    path."""
    true = dephasing(0.4)
    tmg = ProcessTomograph(true, key=6)
    tmg.experiment(5000, "proj-set")
    fused = tmg.point_estimate("lifp", cptp=True)
    monkeypatch.setattr(ProcessTomograph, "BIG_N_QUBITS", 1)
    chunked = tmg.point_estimate("lifp", cptp=True)
    assert choi_dist(fused, chunked) < 1e-4  # Dykstra tolerance scale
    assert chunked.is_cptp(atol=1e-4)


def test_tp_cp_projections():
    tmg = ProcessTomograph(depolarizing(0.5), key=4)
    rng = np.random.default_rng(1)
    m = rng.normal(size=(4, 4))
    bad = qt.Channel(qt.Qobj((m + m.T).astype(complex) / 4 + np.eye(4)))
    tp = tmg.tp_projection(bad)
    rho_in = tp.choi.ptrace((0,))
    np.testing.assert_allclose(rho_in.matrix, np.eye(2), atol=1e-10)
    cp = tmg.cp_projection(bad)
    assert np.all(np.linalg.eigvalsh(cp.choi.matrix) > -1e-10)


@needs_ref
def test_lifp_parity_with_reference():
    """Same measurement records -> same reconstruction as the reference."""
    true = amplitude_damping(0.35)
    tmg = ProcessTomograph(true, key=5)
    tmg.experiment(10000, "proj-set")

    rtmg = ref.ProcessTomograph(ref.channel.amplitude_damping(0.35))
    rtmg.experiment(10000, "proj-set")
    rtmg.results = tmg.results

    ours = tmg.point_estimate("lifp", cptp=False)
    theirs = rtmg.point_estimate("lifp", cptp=False)
    # the reference solves in complex vec space (and its left-inverse uses
    # A.T rather than A^H, reference routines.py:69-71); physically relevant
    # content is the Hermitian part, which must match our bloch solution
    herm = (theirs.choi.matrix + theirs.choi.matrix.conj().T) / 2
    np.testing.assert_allclose(ours.choi.matrix, herm, atol=1e-8)

    # After CPTP projection the results differ at the ~1e-3 level because the
    # reference's Dykstra updates its correction vector with the already-
    # updated iterate (process.py:251-252), a bias our implementation fixes
    # (see process_core.cptp_project_bloch). Check closeness, CPTP-validity,
    # and that OUR projection is at least as close to the unprojected point
    # (the defining property of a projection).
    ours_c = tmg.point_estimate("lifp", cptp=True)
    theirs_c = rtmg.point_estimate("lifp", cptp=True)
    assert float(qt.hs_dst(ours_c.choi, qt.Qobj(theirs_c.choi.matrix))) < 5e-3
    assert ours_c.is_cptp(atol=1e-5)
    d_ours = float(qt.hs_dst(ours_c.choi, ours.choi))
    d_theirs = float(qt.hs_dst(qt.Qobj(theirs_c.choi.matrix), ours.choi))
    assert d_ours <= d_theirs + 1e-6


@needs_ref
def test_states_parity_with_reference():
    true = dephasing(0.25)
    tmg = ProcessTomograph(true, key=6)
    tmg.experiment(20000, "proj-set")

    rtmg = ref.ProcessTomograph(ref.channel.dephasing(0.25))
    rtmg.experiment(20000, "proj-set")
    rtmg.results = tmg.results

    ours = tmg.point_estimate("states", cptp=False, states_est_method="lin")
    theirs = rtmg.point_estimate("states", cptp=False, states_est_method="lin")
    np.testing.assert_allclose(
        ours.choi.matrix, theirs.choi.matrix, atol=1e-8
    )


def test_pgdb_beats_or_matches_lifp_nll():
    true = amplitude_damping(0.5)
    tmg = ProcessTomograph(true, key=7)
    tmg.experiment(5000, "proj-set")
    est_lifp = tmg.point_estimate("lifp", cptp=True)
    est_pgdb = tmg.point_estimate("pgdb", n_iter=300)
    nll_lifp = float(tmg._nll(est_lifp.choi.bloch))
    nll_pgdb = float(tmg._nll(est_pgdb.choi.bloch))
    assert nll_pgdb <= nll_lifp + 1e-6
    assert est_pgdb.is_cptp(atol=1e-3)
    assert choi_dist(est_pgdb, true) < 0.1


def test_dys_matches_pgdb_mle():
    """Davis-Yin splitting reaches the same CPTP maximum-likelihood point
    as projected-gradient pgdb (one eigh per iteration vs a nested Dykstra
    per gradient step)."""
    true = amplitude_damping(0.5)
    tmg = ProcessTomograph(true, key=7)
    tmg.experiment(5000, "proj-set")
    est_pgdb = tmg.point_estimate("pgdb", n_iter=300)
    # compare at EQUAL feasibility: pgdb's returned point violates TP by
    # ~2e-6 (Dykstra tolerance), which lowers its raw NLL below the true
    # constrained optimum; dys's fixed point is TP to machine precision
    import jax.numpy as jnp

    from quantpy_tpu.tomography import process_core

    pgdb_tp = np.asarray(
        process_core.tp_project_bloch(jnp.asarray(est_pgdb.choi.bloch)),
        dtype=np.float64,
    )
    nll_pgdb = float(tmg._nll(pgdb_tp))
    est_dys = tmg.point_estimate("dys")
    nll_dys = float(tmg._nll(est_dys.choi.bloch))
    assert nll_dys <= nll_pgdb + 1e-4 * max(1.0, abs(nll_pgdb))
    assert est_dys.is_cptp(atol=1e-3)
    assert choi_dist(est_dys, true) < 0.1
    assert choi_dist(est_dys, est_pgdb) < 0.05


def test_bootstrap_process_interval_dys():
    true = amplitude_damping(0.5)
    tmg = ProcessTomograph(true, key=17)
    tmg.experiment(2000, "proj-set")
    tmg.point_estimate("dys")
    import quantpy_tpu as qt

    iv = qt.BootstrapProcessInterval(tmg, n_points=8, method="dys")
    d, _ = iv(np.array([0.5, 0.9]))
    d = np.asarray(d)
    assert d.shape == (2,) and np.all(np.isfinite(d)) and d[0] <= d[1] + 1e-9


def test_unitary_channel_reconstruction():
    true = X.as_channel()
    tmg = ProcessTomograph(true, key=8)
    tmg.experiment(50000, "proj-set")
    est = tmg.point_estimate("lifp")
    assert choi_dist(est, true) < 0.05


def test_lifp_factored_matches_dense():
    """Factored linear inversion equals the dense-operator solution."""
    import jax.numpy as jnp

    from quantpy_tpu.tomography import process_core

    true = amplitude_damping(0.3)
    tmg = ProcessTomograph(true, key=9)
    tmg.experiment(5000, "proj-set")
    a = tmg._measurement_operator()
    dense = np.asarray(process_core.estimate_lifp(tmg.results, a, cptp=False))
    t0 = tmg.tomographs[0]
    fact = np.asarray(
        process_core.estimate_lifp_factored(
            tmg.results,
            jnp.asarray(tmg._input_blochs_t()),
            jnp.asarray(t0.povm_matrix),
            jnp.asarray(t0.n_measurements),
            cptp=False,
        )
    )
    np.testing.assert_allclose(fact, dense, atol=1e-10)


def test_three_qubit_process_tomography():
    """3-qubit QPT end to end — the dense operator would be ~0.5 GB."""
    from quantpy_tpu.operator import H as Hgate

    w = Hgate.kron(Hgate).kron(Hgate).as_channel()
    tmg = ProcessTomograph(w, input_states="sic", key=10)
    tmg.experiment(3000, "proj-set")
    est = tmg.point_estimate("lifp", cptp=True)
    assert float(qt.hs_dst(est.choi, w.choi)) < 0.2
    assert est.is_cptp(atol=1e-3)


def test_pgdb_factored_matches_dense():
    import jax.numpy as jnp

    true = dephasing(0.35)
    tmg = ProcessTomograph(true, key=11)
    tmg.experiment(4000, "proj-set")
    a = tmg._measurement_operator()
    dense = np.asarray(
        process_core.estimate_pgdb(tmg.results, a, max_iter=100, tol=1e-12)
    )
    t0 = tmg.tomographs[0]
    fact = np.asarray(
        process_core.estimate_pgdb_factored(
            tmg.results,
            jnp.asarray(tmg._input_blochs_t()),
            jnp.asarray(t0.povm_matrix),
            jnp.asarray(t0.n_measurements),
            max_iter=100,
            tol=1e-12,
        )
    )
    np.testing.assert_allclose(fact, dense, atol=1e-8)


def test_three_qubit_pgdb():
    """3-qubit projected-gradient MLE — impossible with the dense operator."""
    from quantpy_tpu.channel import depolarizing as depol

    true = depol(0.2, n_qubits=3)
    tmg = ProcessTomograph(true, input_states="sic", key=12)
    tmg.experiment(2000, "proj-set")
    est = tmg.point_estimate("pgdb", n_iter=60)
    assert float(qt.hs_dst(est.choi, true.choi)) < 0.15
    assert est.is_cptp(atol=1e-3)


# ------------------------------------------------- QPT scaling (round 2)


def test_choi_transform_bloch_path_matches_kraus():
    """The bloch-space Choi action (Channel.transform for Choi-represented
    channels) equals the Kraus action."""
    for n, p in [(1, 0.3), (2, 0.45), (3, 0.2)]:
        true = depolarizing(p, n)
        choi_channel = qt.Channel(true.choi)  # drops func/kraus: Choi-only
        rng = np.random.default_rng(n)
        v = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
        rho = qt.Qobj(np.outer(v, v.conj()) / np.vdot(v, v))
        out_bloch = choi_channel.transform(rho)
        out_kraus = qt.Channel(choi_channel.kraus).transform(rho)
        np.testing.assert_allclose(
            out_bloch.matrix, out_kraus.matrix, atol=1e-10
        )


def test_process_nll_factored_matches_dense():
    tmg = ProcessTomograph(depolarizing(0.35, 2), key=8)
    tmg.experiment(2000, "proj-set")
    est = tmg.point_estimate("lifp")
    x = np.asarray(est.choi.bloch, dtype=np.float64)
    dense_a = tmg._measurement_operator()
    flat = np.concatenate([t.flat_results for t in tmg.tomographs])
    dense = float(process_core.process_nll(x, dense_a, flat))
    factored = float(tmg._nll(x))
    np.testing.assert_allclose(factored, dense, rtol=1e-10)


@pytest.mark.slow
def test_qpt_4_qubits_end_to_end():
    """4-qubit process tomography: lifp reconstruction + a small factored
    bootstrap run end to end (round-1 wall: everything above 3 qubits
    OOM'd on the dense (S*K, 16^n) operator)."""
    true = depolarizing(0.2, 4)
    tmg = ProcessTomograph(true, key=44)
    tmg.experiment(2000, "proj-set")
    est = tmg.point_estimate("lifp", cptp=True)
    d = choi_dist(est, true)
    # ~5 percent relative error on the ||C||_F ~ 16 Choi at these shot
    # counts; must clearly beat the distance to the wrong (identity)
    # channel, which differs from the truth by the 0.2 depolarization
    assert d < 0.7
    assert d < 0.3 * choi_dist(est, depolarizing(0.0, 4))
    assert est.is_cptp(atol=1e-2)
    iv = qt.BootstrapProcessInterval(tmg, n_points=4, cptp=False)
    dist, _ = iv(np.array([0.5, 0.9]))
    assert np.all(np.isfinite(np.asarray(dist)))


@pytest.mark.slow
def test_mhmc_process_interval_3q():
    """MHMC process sampling at 3 qubits — impossible with the dense NLL
    operator the reference (and round 1) materialized per evaluation."""
    tmg = ProcessTomograph(depolarizing(0.3, 3), key=33)
    tmg.experiment(1000, "proj-set")
    tmg.point_estimate("lifp")
    iv = qt.MHMCProcessInterval(
        tmg, n_points=20, step=0.002, burn_steps=20, use_new_estimate=True
    )
    d, _ = iv(np.array([0.5, 0.9]))
    assert np.all(np.isfinite(np.asarray(d)))
    assert np.all(np.asarray(d) >= 0)


def test_cptp_project_fused_ns_engine_matches_eigh():
    """The fused while_loop Dykstra with cp='ns' (the batched bootstrap /
    MHMC-proposal engine) agrees with the exact eigh engine, batched."""
    rng = np.random.default_rng(31)
    blochs = []
    for _ in range(3):
        m = rng.normal(size=(16, 16))
        blochs.append(qt.Qobj(((m + m.T) / 8 + np.eye(16)).astype(complex)).bloch)
    batch = np.stack(blochs)
    eigh = np.asarray(process_core.cptp_project_bloch(batch, 300))
    ns = np.asarray(process_core.cptp_project_bloch(batch, 300, cp="ns"))
    np.testing.assert_allclose(ns, eigh, atol=1e-4)


def test_bootstrap_process_ns_engine_matches_eigh():
    """Batched Newton-Schulz bootstrap projection (the 4+ qubit default,
    round-2 verdict #1) reproduces the full-tolerance eigh path's distance
    distribution on identical resampled counts (same key)."""
    import jax

    true = amplitude_damping(0.4)
    tmg = ProcessTomograph(true, key=23)
    tmg.experiment(2000, "proj-set")
    tmg.point_estimate("lifp")
    levels = np.linspace(0.1, 0.9, 9)
    d_e, _ = qt.BootstrapProcessInterval(
        tmg, n_points=32, cp_engine="eigh", key=jax.random.key(41)
    )(levels)
    d_n, _ = qt.BootstrapProcessInterval(
        tmg, n_points=32, cp_engine="ns", key=jax.random.key(41)
    )(levels)
    np.testing.assert_allclose(np.asarray(d_n), np.asarray(d_e), atol=5e-3)


def test_dys_ns_prox_matches_eigh():
    """dys with the Newton-Schulz CP prox (the 5+ qubit default) lands on
    the same constrained MLE as the exact eigh prox at 2 qubits."""
    true = amplitude_damping(0.5)
    tmg = ProcessTomograph(true, key=29)
    tmg.experiment(3000, "proj-set")
    t0 = tmg.tomographs[0]
    args = (
        tmg.results, tmg._input_blochs_t(), t0.povm_matrix, t0.n_measurements,
    )
    x_e = np.asarray(process_core.estimate_dys_factored(*args, cp="eigh"))
    x_n = np.asarray(process_core.estimate_dys_factored(*args, cp="ns"))
    from quantpy_tpu.tomography import state_core

    w = state_core.weighted_povm_flat(t0.povm_matrix, t0.n_measurements)
    flat = np.concatenate([t.flat_results for t in tmg.tomographs])
    flat = flat / flat.sum()
    b = tmg._input_blochs_t()
    nll_e = float(process_core.process_nll_factored(x_e, b, w, flat))
    nll_n = float(process_core.process_nll_factored(x_n, b, w, flat))
    assert abs(nll_n - nll_e) <= 1e-5 * abs(nll_e)
    assert np.max(np.abs(x_n - x_e)) < 2e-3


def test_point_estimate_n_iter_honored():
    """An explicitly passed n_iter caps dys (round-2 advisor: the old
    sentinel silently remapped an explicit 1000 to 10000)."""
    tmg = ProcessTomograph(dephasing(0.3), key=37)
    tmg.experiment(500, "proj-set")
    est = tmg.point_estimate("dys", n_iter=3)
    assert est.choi.bloch.shape == (16,)


def test_tp_project_mat_matches_bloch():
    """The matrix-space TP projection (used inside the NS Dykstra chunk)
    equals the bloch-coordinate projection."""
    from quantpy_tpu.ops.paulis import np_bloch_to_matrix, np_matrix_to_bloch

    rng = np.random.default_rng(41)
    bloch = rng.normal(size=(3, 256))
    ref = np.asarray(process_core.tp_project_bloch(bloch))
    mats = np_bloch_to_matrix(bloch, 4)
    out = np.asarray(process_core._tp_project_mat(mats))
    np.testing.assert_allclose(np_matrix_to_bloch(out), ref, atol=1e-10)


def test_kraus_param_exactly_cptp():
    """The smooth factor parametrization lands EXACTLY on CPTP for
    arbitrary inputs: TP coordinates fixed, Choi PSD (no projection)."""
    from quantpy_tpu.ops.paulis import np_bloch_to_matrix

    rng = np.random.default_rng(7)
    y = rng.normal(size=(4, 2, 16, 16))
    cb = np.asarray(process_core.kraus_param_to_choi_bloch(y))
    c = cb.reshape(4, 16, 16)
    np.testing.assert_allclose(c[:, 0, 0], 1 / 4, atol=1e-8)
    np.testing.assert_allclose(c[:, 1:, 0], 0.0, atol=1e-8)
    mats = np_bloch_to_matrix(cb, 4)
    assert np.linalg.eigvalsh(mats).min() >= -1e-10


def test_kraus_param_roundtrip():
    """Surjectivity at CPTP points: X -> M = X^(1/2) -> X round-trips
    (rho = Tr_out X = I there, so the Cholesky congruence is identity)."""
    rng = np.random.default_rng(8)
    raw = rng.normal(size=(256,)) * 0.02
    cb0 = np.asarray(process_core.cptp_project_bloch(raw, 2000))
    y0 = process_core.np_kraus_param_from_choi_bloch(cb0)
    cb1 = np.asarray(process_core.kraus_param_to_choi_bloch(y0))
    np.testing.assert_allclose(cb1, cb0, atol=1e-6)


@pytest.mark.parametrize("proposal", ["rw", "mala"])
def test_mhmc_process_kraus_parametrization(proposal):
    """The kraus-factor chain (smooth exactly-CPTP parametrization) runs
    with both proposals, decodes to CPTP Choi samples, and its distance
    scale agrees with the parametric bootstrap's."""
    import jax

    from quantpy_tpu.ops.paulis import np_bloch_to_matrix

    tmg = ProcessTomograph(depolarizing(0.2, 1), key=3)
    tmg.experiment(1000, "proj-set")
    tmg.point_estimate("lifp")
    iv = qt.MHMCProcessInterval(
        tmg, n_points=300, burn_steps=400, step=0.05,
        parametrization="kraus", proposal=proposal, adapt_step=True,
        n_chains=2, key=11, return_samples=True,
    )
    d, cl, acc, mats = iv.setup()
    d = np.asarray(d)
    assert np.all(np.isfinite(d)) and np.all(d >= 0)
    assert 0.0 < acc <= 1.0
    # decoded samples are CPTP without any projection
    m0 = np.asarray(mats[0])
    tr_out = np.einsum("ibjb->ij", m0.reshape(2, 2, 2, 2))
    np.testing.assert_allclose(tr_out, np.eye(2), atol=1e-6)
    assert np.linalg.eigvalsh(m0).min() >= -1e-8
    db, _ = qt.BootstrapProcessInterval(
        tmg, n_points=300, key=jax.random.key(5)
    )(np.array([0.5]))
    d50 = np.median(d)
    assert 0.3 * db[0] < d50 < 3.0 * db[0], (d50, db[0])


def test_kraus_anchored_delta_decode_exact():
    """The anchored exact-delta decode equals
    full_decode(z_ref + dz) - full_decode(z_ref) in x64, at posterior-sized
    AND large offsets (the large branch takes the chol fallback), batched,
    and its NLL matches the rel form; gradients are finite."""
    import jax
    import jax.numpy as jnp

    from quantpy_tpu.ops.cplx import to_pair

    rng = np.random.default_rng(0)
    d, d_in = 16, 4
    a = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    x = a @ a.conj().T
    x = x / np.trace(x).real * d_in
    w_, v_ = np.linalg.eigh(x)
    m_ref = (v_ * np.sqrt(np.clip(w_, 0, None))) @ v_.conj().T
    al = np.eye(d) + 0.1 * (rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d)))
    ar = np.eye(d) + 0.1 * (rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d)))
    z_ref = np.linalg.solve(al, m_ref) @ np.linalg.inv(ar)
    pack, x_ref_bloch = process_core.np_kraus_anchor_pack(z_ref, al, ar)
    for scale in (0.1, 1e-3, 1e-6):
        dz = scale * (rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d)))
        dbloch = np.asarray(
            process_core.kraus_delta_choi_bloch(
                np.stack([dz.real, dz.imag], 0), pack
            )
        )
        z = z_ref + dz
        full = np.asarray(
            process_core.kraus_param_to_choi_bloch_whitened(
                np.stack([z.real, z.imag], 0), to_pair(al), to_pair(ar)
            )
        )
        direct = full - x_ref_bloch
        np.testing.assert_allclose(
            dbloch, direct, atol=1e-10 * max(np.abs(direct).max(), 1e-12) + 1e-13
        )
    # batched + NLL consistency + grad
    dzb = 1e-2 * (rng.normal(size=(3, d, d)) + 1j * rng.normal(size=(3, d, d)))
    out = np.asarray(
        process_core.kraus_delta_choi_bloch(
            np.stack([dzb.real, dzb.imag], 1), pack
        )
    )
    assert out.shape == (3, d * d)
    S, K = 5, 7
    b = rng.normal(size=(S, d))
    wf = rng.normal(size=(K, d))
    counts = rng.integers(1, 100, size=S * K).astype(np.float64)
    p_ref = np.abs(
        d * np.einsum("sa,ab,kb->sk", b, x_ref_bloch.reshape(d, d), wf)
    ).reshape(-1) + 0.5
    dz = 1e-3 * (rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d)))
    dz_flat = jnp.asarray(np.stack([dz.real, dz.imag], 0).reshape(-1))
    nll = process_core.process_nll_anchored(
        dz_flat, b, wf, counts, pack, jnp.asarray(p_ref)
    )
    dbl = np.asarray(
        process_core.kraus_delta_choi_bloch(
            np.stack([dz.real, dz.imag], 0), pack
        )
    )
    dp = d * np.einsum("sa,ab,kb->sk", b, dbl.reshape(d, d), wf).reshape(-1)
    manual = -np.sum(counts * np.log1p(np.maximum(dp / p_ref, -1 + 1e-7)))
    assert abs(float(nll) - manual) < 1e-8 * max(abs(manual), 1.0)
    # zero offset -> exactly zero target
    assert float(
        process_core.process_nll_anchored(
            jnp.zeros(2 * d * d), b, wf, counts, pack, jnp.asarray(p_ref)
        )
    ) == 0.0
    g = jax.grad(
        lambda zz: process_core.process_nll_anchored(
            zz, b, wf, counts, pack, jnp.asarray(p_ref)
        )
    )(dz_flat)
    assert bool(np.isfinite(np.asarray(g)).all())


def test_sum2f_compensated_reduction():
    """Two-float pairwise-tree sum: near-exact on the canonical Kahan case
    where the plain f32 sum loses every tiny term, batched, padded, and
    with unit gradients."""
    import jax
    import jax.numpy as jnp

    x = np.full(100001, 1e-8, np.float32)
    x[0] = 1.0
    ref = 1.0 + 1e-8 * 100000
    plain = float(jnp.sum(jnp.asarray(x, jnp.float32)))
    comp = float(process_core.sum2f(jnp.asarray(x, jnp.float32)))
    assert abs(comp - ref) < 0.05 * abs(plain - ref)
    assert abs(comp - ref) < 1e-7
    # batched odd-length
    y = np.arange(15, dtype=np.float32).reshape(3, 5)
    np.testing.assert_allclose(
        np.asarray(process_core.sum2f(jnp.asarray(y))), y.sum(-1), rtol=0
    )
    g = jax.grad(lambda v: process_core.sum2f(v))(jnp.ones(10, jnp.float32))
    np.testing.assert_allclose(np.asarray(g), 1.0)


def test_mhmc_kraus_anchored_matches_plain():
    """anchored=True (default) and anchored=False sample the same law —
    the anchored target is the same function re-expressed around a
    host-f64 anchor; in x64 both chains' medians agree."""
    import jax

    tmg = ProcessTomograph(depolarizing(0.2, 1), key=3)
    tmg.experiment(1000, "proj-set")
    tmg.point_estimate("lifp")
    meds = []
    for anchored in (True, False):
        iv = qt.MHMCProcessInterval(
            tmg, n_points=300, burn_steps=400, step=0.05,
            parametrization="kraus", proposal="mala", adapt_step=True,
            n_chains=2, key=13, anchored=anchored,
        )
        d, _ = iv(np.array([0.5]))
        meds.append(float(np.median(np.asarray(iv.cl_to_dist(np.linspace(0.1, 0.9, 9))))))
    assert abs(meds[0] - meds[1]) < 0.5 * max(meds)


def test_kraus_whitened_decode_consistent():
    """Whitened-coordinate decode equals the plain kraus map of
    M = A_L Z A_R (the whitener is a reparametrization, not a new model),
    and the whitened start point z0 = A_L^-1 M0 A_R^-1 round-trips."""
    from quantpy_tpu.ops.cplx import to_pair

    rng = np.random.default_rng(9)
    raw = rng.normal(size=(16,)) * 0.05
    cb0 = np.asarray(process_core.cptp_project_bloch(raw, 2000))
    tmg = ProcessTomograph(depolarizing(0.3, 1), key=5)
    tmg.experiment(500, "proj-set")
    from quantpy_tpu.tomography import state_core

    t0 = tmg.tomographs[0]
    w = np.asarray(state_core.weighted_povm_flat(t0.povm_matrix, t0.n_measurements))
    flat = np.concatenate([t.flat_results for t in tmg.tomographs])
    a_l, a_r, a_l_inv, a_r_inv = process_core.kraus_design_whitener(
        tmg._input_blochs_t(), w, flat, cb0
    )
    np.testing.assert_allclose(a_l @ a_l_inv, np.eye(4), atol=1e-8)
    np.testing.assert_allclose(a_r @ a_r_inv, np.eye(4), atol=1e-8)
    z = rng.normal(size=(2, 4, 4))
    m = a_l @ (z[0] + 1j * z[1]) @ a_r
    y = np.stack([m.real, m.imag])
    direct = np.asarray(process_core.kraus_param_to_choi_bloch(y))
    whitened = np.asarray(
        process_core.kraus_param_to_choi_bloch_whitened(
            z, to_pair(a_l), to_pair(a_r)
        )
    )
    np.testing.assert_allclose(whitened, direct, atol=1e-8)
    # start-point round trip through the whitened coordinates
    y0 = process_core.np_kraus_param_from_choi_bloch(cb0)
    z0 = a_l_inv @ (y0[0] + 1j * y0[1]) @ a_r_inv
    cb1 = np.asarray(
        process_core.kraus_param_to_choi_bloch_whitened(
            np.stack([z0.real, z0.imag]), to_pair(a_l), to_pair(a_r)
        )
    )
    np.testing.assert_allclose(cb1, cb0, atol=1e-6)
