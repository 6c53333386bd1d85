"""Confidence-interval suite: structural checks, statistical sanity, and
reference parity where the reference is runnable without cvxopt."""

import numpy as np
import pytest

import quantpy_tpu as qt
from quantpy_tpu.channel import dephasing, depolarizing
from quantpy_tpu.tomography.polytopes.utils import count_confidence, count_delta

from .reference_shim import get_reference

ref = get_reference()
needs_ref = pytest.mark.skipif(ref is None, reason="reference unavailable")


@pytest.fixture(scope="module")
def state_tmg():
    tmg = qt.StateTomograph(qt.GHZ(2), key=21)
    tmg.experiment(3000, "proj-set")
    tmg.point_estimate("lin")
    return tmg


@pytest.fixture(scope="module")
def process_tmg():
    tmg = qt.ProcessTomograph(dephasing(0.3), key=22)
    tmg.experiment(3000, "proj-set")
    tmg.point_estimate("lifp")
    return tmg


def _check_monotone_interval(interval, conf_levels=None):
    dist, cl = interval(conf_levels)
    dist = np.asarray(dist)
    assert np.all(np.isfinite(dist))
    assert np.all(dist >= 0)
    assert np.all(np.diff(dist) >= -1e-9)  # wider interval at higher confidence
    return dist, cl


# ------------------------------------------------------------------ moment


def test_moment_interval_state(state_tmg):
    dist, _ = _check_monotone_interval(qt.MomentInterval(state_tmg))
    # the 50%-level radius should be small for 3000-shot 2-qubit data
    assert dist[len(dist) // 2] < 0.2


def test_moment_interval_process(process_tmg):
    _check_monotone_interval(qt.MomentInterval(process_tmg))


def test_moment_interval_distr_types(state_tmg):
    for distr in ["gamma", "norm", "exp"]:
        d, _ = qt.MomentInterval(state_tmg, distr_type=distr)(np.array([0.5, 0.9]))
        assert np.all(np.asarray(d) > 0)
    with pytest.raises(NotImplementedError):
        qt.MomentInterval(state_tmg, distr_type="bogus")(np.array([0.5]))


def test_moment_coverage_calibration(state_tmg):
    """The moment CI should cover the true state roughly at its nominal
    level (statistical self-verification, SURVEY.md section 4)."""
    interval = qt.MomentInterval(state_tmg)
    interval.setup()
    n_trials, covered = 60, 0
    for i in range(n_trials):
        t = qt.StateTomograph(state_tmg.state, key=1000 + i)
        t.experiment(3000, "proj-set")
        est = t.point_estimate("lin")
        iv = qt.MomentInterval(t)
        iv.setup()
        d90 = float(iv.cl_to_dist(0.9))
        if float(qt.hs_dst(est, state_tmg.state)) <= d90:
            covered += 1
    assert covered / n_trials >= 0.8  # >= nominal 0.9 minus statistical slack


# --------------------------------------------------- kron-mode analytic CIs


def _kron_twin(tmg):
    """A tomograph carrying the same data as `tmg` but in kron-factored
    mode (povm_matrix=None), to compare dense vs factored interval paths."""
    from quantpy_tpu.measurements import _single_qubit_preset

    twin = qt.StateTomograph(tmg.state, key=0)
    twin.povm_kron = _single_qubit_preset("proj-set")
    twin.povm_matrix = None
    twin.n_measurements = tmg.n_measurements
    twin._results = tmg.results
    return twin


@pytest.fixture(scope="module")
def state_tmg_3q():
    tmg = qt.StateTomograph(qt.GHZ(3), key=31)
    tmg.experiment(2000, "proj-set")
    tmg.point_estimate("lin")
    return tmg


def test_moment_interval_kron_matches_dense(state_tmg_3q):
    dense = qt.MomentInterval(state_tmg_3q)
    dense.setup()
    factored = qt.MomentInterval(_kron_twin(state_tmg_3q))
    factored.setup()
    cl = np.linspace(0.1, 0.99, 25)
    np.testing.assert_allclose(
        factored.cl_to_dist(cl), dense.cl_to_dist(cl), rtol=1e-8
    )


def test_channel_moments_match_dense(process_tmg):
    """The factored two-Kronecker-factor channel moments (interval.py
    channel branch -> kron_analytic.channel_l2_moments) must equal the
    dense (S K, 16^n) pseudo-inverse recipe exactly."""
    from quantpy_tpu.stats import l2_moments_from_factor
    from quantpy_tpu.tomography import kron_analytic

    t0 = process_tmg.tomographs[0]
    dim = 4**process_tmg.channel.n_qubits
    freq = np.vstack(
        [t.results / t.n_measurements[:, None] for t in process_tmg.tomographs]
    )
    povm_flat = t0.povm_matrix.reshape(-1, t0.povm_matrix.shape[-1])
    sm = process_tmg._input_blochs_t()
    cm = np.einsum("sd,pi->spdi", sm, povm_flat).reshape(
        sm.shape[0] * povm_flat.shape[0], -1
    )
    inv = np.linalg.solve(cm.T @ cm, cm.T) / dim
    inv = inv.reshape(-1, freq.shape[0], freq.shape[1])
    m_dense, v_dense = l2_moments_from_factor(inv, freq, t0.n_measurements[0])
    freq3 = np.stack(
        [t.results / t.n_measurements[:, None] for t in process_tmg.tomographs]
    )
    m_fac, v_fac = kron_analytic.channel_l2_moments(
        sm, t0.povm_matrix, freq3, t0.n_measurements[0]
    )
    np.testing.assert_allclose(m_fac, m_dense, rtol=1e-12)
    np.testing.assert_allclose(v_fac, v_dense, rtol=1e-12)


def test_channel_moments_device_path(process_tmg, monkeypatch):
    """The f32 device path for the per-state moment-block Grams (the
    5-qubit enabler on a single-core host) agrees with the f64 host path."""
    from quantpy_tpu.tomography import kron_analytic as ka

    t0 = process_tmg.tomographs[0]
    freq3 = np.stack(
        [t.results / t.n_measurements[:, None] for t in process_tmg.tomographs]
    )
    sm = process_tmg._input_blochs_t()
    m_h, v_h = ka.channel_l2_moments(
        sm, t0.povm_matrix, freq3, t0.n_measurements[0]
    )
    monkeypatch.setattr(ka, "_DEVICE_MOMENTS_THRESHOLD", 1)
    m_d, v_d = ka.channel_l2_moments(
        sm, t0.povm_matrix, freq3, t0.n_measurements[0]
    )
    np.testing.assert_allclose(m_d, m_h, rtol=1e-3)
    np.testing.assert_allclose(v_d, v_h, rtol=1e-3)


@pytest.mark.slow
def test_channel_moment_coverage():
    """The factored channel moment CI should cover the true channel at
    roughly its nominal level (statistical self-verification)."""
    true = depolarizing(0.2, n_qubits=1)
    n_trials, covered = 40, 0
    for i in range(n_trials):
        t = qt.ProcessTomograph(true, key=5000 + i)
        t.experiment(2000, "proj-set")
        est = t.point_estimate("lifp", cptp=False)
        iv = qt.MomentInterval(t)
        iv.setup()
        d90 = float(iv.cl_to_dist(0.9))
        if float(qt.hs_dst(est.choi, true.choi)) <= d90:
            covered += 1
    assert covered / n_trials >= 0.8


def test_moment_interval_process_3q():
    """Analytic process moment interval at 3 qubits — infeasible for the
    dense recipe the reference uses (its channel matrix pseudo-inverse is
    the n >= 3 wall, reference interval.py:76-88)."""
    tmg = qt.ProcessTomograph(depolarizing(0.1, n_qubits=3), key=33)
    tmg.experiment(1000, "proj-set")
    _check_monotone_interval(qt.MomentInterval(tmg))


def test_sugiyama_interval_kron_matches_dense(state_tmg_3q):
    dense = qt.SugiyamaInterval(state_tmg_3q)
    dense.setup()
    factored = qt.SugiyamaInterval(_kron_twin(state_tmg_3q))
    factored.setup()
    cl = np.linspace(0.2, 0.95, 10)
    np.testing.assert_allclose(
        factored.cl_to_dist(cl), dense.cl_to_dist(cl), rtol=1e-8
    )


def test_analytic_intervals_6q_kron_mode():
    """6-qubit kron-mode tomograph produces Moment + Sugiyama radii
    (round-1 gap: only bootstrap CIs existed beyond 5 qubits)."""
    tmg = qt.StateTomograph(qt.GHZ(6), key=61)
    tmg.experiment(1000, "proj-set")
    assert tmg.povm_matrix is None  # really on the factored path
    for iv in (qt.MomentInterval(tmg), qt.SugiyamaInterval(tmg)):
        iv.setup()
        d = np.asarray(iv.cl_to_dist(np.linspace(0.1, 0.99, 20)))
        assert np.all(np.isfinite(d)) and np.all(d >= 0)
        assert np.all(np.diff(d) >= -1e-9)


@pytest.mark.slow
def test_moment_coverage_6q_kron():
    """Calibration at 6 qubits: the kron-mode moment CI covers the true
    state at roughly its nominal level. The moment CI models the
    UNPROJECTED linear-inversion error (the reference CLI pairs it with
    point_estimate(physical=False), scripts/state_interval.py:48); at 64
    dims the eigenvalue-clip feasibility projection is far from a metric
    projection, so the physical estimate is the wrong comparison point."""
    true = qt.GHZ(6)
    n_trials, covered = 20, 0
    for i in range(n_trials):
        t = qt.StateTomograph(true, key=6000 + i)
        t.experiment(1000, "proj-set")
        est = t.point_estimate("lin", physical=False)
        iv = qt.MomentInterval(t)
        iv.setup()
        d95 = float(iv.cl_to_dist(0.95))
        if float(qt.hs_dst(est, true)) <= d95:
            covered += 1
    assert covered / n_trials >= 0.75


# ------------------------------------------------------------- fidelity bands


def test_moment_fidelity_state(state_tmg):
    iv = qt.MomentFidelityStateInterval(state_tmg, target_state=state_tmg.state)
    (fmin, fmax), cl = iv(np.linspace(0.1, 0.95, 10))
    fmin, fmax = np.asarray(fmin), np.asarray(fmax)
    assert np.all(fmin <= fmax + 1e-9)
    true_f = 1 - float(qt.if_dst(state_tmg.reconstructed_state, state_tmg.state))
    # the band should bracket the point-estimate fidelity at high confidence
    assert fmin[-1] - 0.05 <= true_f <= fmax[-1] + 0.05
    # bands widen with confidence
    assert fmax[-1] >= fmax[0] - 1e-9
    assert fmin[-1] <= fmin[0] + 1e-9


def test_moment_fidelity_process(process_tmg):
    iv = qt.MomentFidelityProcessInterval(
        process_tmg, target_process=process_tmg.channel
    )
    (fmin, fmax), _ = iv(np.linspace(0.1, 0.95, 10))
    assert np.all(np.asarray(fmin) <= np.asarray(fmax) + 1e-9)


# ------------------------------------------------------------------ sugiyama


def test_sugiyama_interval(state_tmg):
    dist, _ = _check_monotone_interval(
        qt.SugiyamaInterval(state_tmg), np.linspace(0.1, 0.99, 20)
    )
    with pytest.raises(NotImplementedError):
        qt.SugiyamaInterval(qt.ProcessTomograph(depolarizing(0.5), key=1)).setup()


@needs_ref
def test_sugiyama_parity(state_tmg):
    rtmg = ref.StateTomograph(ref.Qobj(state_tmg.state.matrix))
    rtmg.experiment(3000, "proj-set")
    rtmg.results = state_tmg.results
    theirs = ref.SugiyamaInterval(rtmg)
    theirs.setup()
    ours = qt.SugiyamaInterval(state_tmg)
    ours.setup()
    cl = np.linspace(0.2, 0.95, 10)
    np.testing.assert_allclose(
        ours.cl_to_dist(cl), theirs.cl_to_dist(cl), rtol=1e-6
    )


# ------------------------------------------------------------------ polytopes


def test_count_confidence_and_delta(state_tmg):
    freq = np.clip(
        state_tmg.results / state_tmg.n_measurements[:, None], 1e-15, 1 - 1e-15
    )
    deltas = np.array([0.01, 0.05, 0.2])
    conf = np.asarray(count_confidence(deltas, freq, state_tmg.n_measurements))
    assert np.all(np.diff(conf) >= 0)  # larger margin -> higher confidence
    # bisection inverts count_confidence
    d = float(count_delta(0.9, freq, state_tmg.n_measurements))
    c = float(count_confidence(d, freq, state_tmg.n_measurements))
    assert abs(c - 0.9) < 0.01


@needs_ref
def test_count_confidence_parity(state_tmg):
    from quantpy.tomography.polytopes.utils import (
        count_confidence as ref_conf,
        count_delta as ref_delta,
    )

    freq = np.clip(
        state_tmg.results / state_tmg.n_measurements[:, None], 1e-15, 1 - 1e-15
    )
    for delta in [0.01, 0.03, 0.1]:
        np.testing.assert_allclose(
            float(count_confidence(delta, freq, state_tmg.n_measurements)),
            ref_conf(delta, freq, state_tmg.n_measurements),
            rtol=1e-10,
        )
    for cl in [0.5, 0.9]:
        np.testing.assert_allclose(
            float(count_delta(cl, freq, state_tmg.n_measurements)),
            ref_delta(cl, freq, state_tmg.n_measurements),
            atol=1e-8,
        )


def test_polytope_state_interval(state_tmg):
    iv = qt.PolytopeStateInterval(state_tmg, n_points=40)
    (fmin, fmax), cl = iv(np.linspace(0.2, 0.9, 8))
    fmin, fmax = np.asarray(fmin), np.asarray(fmax)
    assert np.all(fmin <= fmax + 1e-6)
    true_f = 1 - float(qt.if_dst(state_tmg.state, state_tmg.state))  # = 1 vs itself
    # the target here is the true state; its fidelity with itself is 1, and
    # the polytope bound at moderate confidence should bracket the fidelity
    # between truth and any state compatible with the data
    est_f = 1 - float(qt.if_dst(state_tmg.reconstructed_state, state_tmg.state))
    assert fmin[0] - 0.05 <= est_f <= fmax[0] + 0.05
    del true_f


def test_moment_fidelity_kron_mode(monkeypatch):
    """MomentFidelityStateInterval runs on the kron-factored path (the
    ball-slice bound is design-independent; the radius comes from the
    factored moment machinery)."""
    monkeypatch.setattr(qt.StateTomograph, "DENSE_POVM_MAX_ELEMENTS", 1)
    tmg = qt.StateTomograph(qt.GHZ(3), key=50)
    tmg.experiment(3000, "proj-set")
    assert tmg.povm_matrix is None
    iv = qt.MomentFidelityStateInterval(tmg, target_state=qt.GHZ(3))
    (fmin, fmax), _ = iv(np.array([0.5, 0.9]))
    fmin, fmax = np.asarray(fmin), np.asarray(fmax)
    assert np.all(np.isfinite(fmin)) and np.all(fmin <= fmax)
    assert fmin[0] > 0.9  # 3000-shot GHZ data pins fidelity near 1


def test_polytope_state_interval_kron_parity(state_tmg, monkeypatch):
    """Kron-mode polytope CI == dense-mode polytope CI on identical data
    (the factored PDHG applies the same constraint operator)."""
    monkeypatch.setattr(qt.StateTomograph, "DENSE_POVM_MAX_ELEMENTS", 1)
    tmg_k = qt.StateTomograph(qt.GHZ(2), key=21)
    tmg_k.experiment(3000, "proj-set")
    assert tmg_k.povm_matrix is None and tmg_k.povm_kron is not None
    tmg_k.results = np.asarray(state_tmg.results).copy()

    levels = np.linspace(0.2, 0.9, 8)
    (dmin, dmax), _ = qt.PolytopeStateInterval(state_tmg, n_points=40)(levels)
    (kmin, kmax), _ = qt.PolytopeStateInterval(tmg_k, n_points=40)(levels)
    np.testing.assert_allclose(kmin, dmin, atol=2e-5)
    np.testing.assert_allclose(kmax, dmax, atol=2e-5)


def test_polytope_kron_6qubit_smoke():
    """Structural 6-qubit run on the factored LP path (nothing dense is
    ever materialized); tiny grid/iteration budget to stay CPU-fast."""
    tmg = qt.StateTomograph(qt.GHZ(6), key=93)
    tmg.experiment(2000, "proj-set")
    iv = qt.PolytopeStateInterval(tmg, n_points=3)
    iv.LP_ITERS = 500
    (dmin, dmax), _ = iv(np.array([0.5, 0.9]))
    dmin, dmax = np.asarray(dmin), np.asarray(dmax)
    assert dmin.shape == (2,) and np.all(np.isfinite(dmin))
    assert np.all(dmin <= dmax + 1e-6)


def test_polytope_process_interval(process_tmg):
    iv = qt.PolytopeProcessInterval(process_tmg, n_points=30)
    (fmin, fmax), _ = iv(np.linspace(0.2, 0.9, 5))
    assert np.all(np.asarray(fmin) <= np.asarray(fmax) + 1e-6)


def test_polytope_process_factored_matches_dense(process_tmg, monkeypatch):
    """The two-factor matvec path (the 4-qubit enabler: dense the LP
    matrix would be 86 GB there) must reproduce the dense solves."""
    from quantpy_tpu.tomography.interval import _PolytopeBase

    cl = np.linspace(0.2, 0.9, 5)
    dense = qt.PolytopeProcessInterval(process_tmg, n_points=30)
    (dmin, dmax), _ = dense(cl)
    monkeypatch.setattr(_PolytopeBase, "DENSE_LP_MAX_ELEMENTS", 1)
    fact = qt.PolytopeProcessInterval(process_tmg, n_points=30)
    (fmin, fmax), _ = fact(cl)
    np.testing.assert_allclose(fmin, dmin, atol=1e-6)
    np.testing.assert_allclose(fmax, dmax, atol=1e-6)


# ------------------------------------------------------------------ bootstrap


@pytest.mark.parametrize("method", ["lin", "mle-rhor"])
def test_bootstrap_state_interval(state_tmg, method):
    iv = qt.BootstrapStateInterval(state_tmg, n_points=128, method=method)
    dist, _ = _check_monotone_interval(iv, np.linspace(0.05, 0.95, 10))
    assert dist[-1] < 0.3


def test_bootstrap_state_coverage(state_tmg):
    """Bootstrap quantiles approximate the true sampling distribution."""
    iv = qt.BootstrapStateInterval(state_tmg, n_points=256, method="lin")
    iv.setup()
    d90 = float(iv.cl_to_dist(0.9))
    covered = 0
    for i in range(40):
        t = qt.StateTomograph(state_tmg.state, key=3000 + i)
        t.experiment(3000, "proj-set")
        est = t.point_estimate("lin")
        if float(qt.hs_dst(est, state_tmg.state)) <= d90:
            covered += 1
    assert covered / 40 >= 0.75


def test_bootstrap_process_interval(process_tmg):
    iv = qt.BootstrapProcessInterval(process_tmg, n_points=64)
    dist, _ = _check_monotone_interval(iv, np.linspace(0.05, 0.95, 10))
    assert dist[-1] < 0.5


# ------------------------------------------------------------------ MHMC


def test_mhmc_state_interval(state_tmg):
    iv = qt.MHMCStateInterval(
        state_tmg, n_points=300, step=0.01, burn_steps=300, use_new_estimate=True
    )
    dist, _ = _check_monotone_interval(iv, np.linspace(0.05, 0.95, 10))
    assert 0 < iv.acceptance_rate <= 1
    # the default-tempered target is near-flat, so the d95 excursion of a
    # 300-step random walk is a high-variance statistic (measured 0.45-0.71
    # across PRNG streams) — bound it loosely
    assert dist[-1] < 1.0


def test_mhmc_kron_nll_parity(state_tmg, monkeypatch):
    """Kron-mode _nll == dense-mode _nll on identical data (the factored
    forward chain applies the same weighted design)."""
    monkeypatch.setattr(qt.StateTomograph, "DENSE_POVM_MAX_ELEMENTS", 1)
    tmg_k = qt.StateTomograph(qt.GHZ(2), key=21)
    tmg_k.experiment(3000, "proj-set")
    tmg_k.results = np.asarray(state_tmg.results).copy()
    rng = np.random.default_rng(5)
    for _ in range(3):
        x = rng.normal(size=16)
        np.testing.assert_allclose(
            float(tmg_k._nll(x)), float(state_tmg._nll(x)), rtol=1e-10
        )


def test_mhmc_state_interval_kron_mode(monkeypatch):
    """MHMC sampling works on the kron-factored path (no dense design)."""
    monkeypatch.setattr(qt.StateTomograph, "DENSE_POVM_MAX_ELEMENTS", 1)
    tmg = qt.StateTomograph(qt.GHZ(2), key=94)
    tmg.experiment(3000, "proj-set")
    tmg.point_estimate("mle")
    iv = qt.MHMCStateInterval(tmg, n_points=200, step=0.01, burn_steps=200)
    dist, _ = _check_monotone_interval(iv, np.linspace(0.05, 0.95, 10))
    assert 0 < iv.acceptance_rate <= 1
    assert dist[-1] < 1.0  # near-flat tempered target, see above


def test_mhmc_process_interval(process_tmg):
    iv = qt.MHMCProcessInterval(
        process_tmg, n_points=100, step=0.005, burn_steps=100,
        use_new_estimate=True, return_samples=True,
    )
    out = iv.setup()
    dist, cl, rate, mats = out
    assert len(mats) == 100
    assert 0 < rate <= 1
    # every sample is CPTP up to projection tolerance
    choi0 = qt.Channel(qt.Qobj(np.asarray(mats[0])))
    assert choi0.is_cptp(atol=1e-3)


# ------------------------------------------------------------------ Holder


@pytest.mark.parametrize("kind", ["moment", "sugiyama", "bootstrap"])
def test_holder_interval(process_tmg, kind):
    iv = qt.HolderInterval(process_tmg, n_points=64, kind=kind)
    dist, cl = iv(np.linspace(0.5, 0.95, 5))
    dist = np.asarray(dist)
    assert dist.shape == (5,)
    assert np.all(np.isfinite(dist)) and np.all(dist >= 0)
    with pytest.raises(ValueError):
        qt.HolderInterval(process_tmg, kind="wang")()


def test_intervals_reject_wrong_mode(state_tmg, process_tmg):
    with pytest.raises(NotImplementedError):
        qt.BootstrapStateInterval(process_tmg).setup()
    with pytest.raises(NotImplementedError):
        qt.BootstrapProcessInterval(state_tmg).setup()
    with pytest.raises(NotImplementedError):
        qt.MHMCStateInterval(process_tmg).setup()
    with pytest.raises(NotImplementedError):
        qt.HolderInterval(state_tmg).setup()


@pytest.mark.parametrize("method", ["pgdb", "states"])
def test_bootstrap_process_interval_methods(process_tmg, method):
    iv = qt.BootstrapProcessInterval(process_tmg, n_points=32, method=method)
    dist, _ = iv(np.linspace(0.1, 0.9, 5))
    dist = np.asarray(dist)
    assert np.all(np.isfinite(dist)) and np.all(np.diff(dist) >= -1e-9)
    assert dist[-1] < 0.5


def test_holder_mhmc(process_tmg):
    iv = qt.HolderInterval(
        process_tmg, n_points=20, kind="mhmc", burn_steps=20, step=0.02
    )
    dist, cl = iv(np.linspace(0.5, 0.9, 3))
    assert np.all(np.isfinite(np.asarray(dist)))


def test_mhmc_untempered_is_tighter(state_tmg):
    """The true-posterior (count-weighted) MHMC concentrates near the
    estimate; the reference's tempered variant is orders wider."""
    wide = qt.MHMCStateInterval(
        state_tmg, n_points=200, burn_steps=200, use_new_estimate=True,
        temper=True, key=None,
    )
    dw, _ = wide(np.array([0.9]))
    tight = qt.MHMCStateInterval(
        state_tmg, n_points=200, burn_steps=400, step=0.002,
        use_new_estimate=True, temper=False,
    )
    dt, _ = tight(np.array([0.9]))
    assert float(dt[0]) < float(dw[0])
    assert float(dt[0]) < 0.2


def test_mhmc_warns_on_nonconverged_chain(process_tmg):
    """A decisively-unmixed chain must WARN, not silently return quantiles:
    a tiny-step no-burn-in chain's distance series trends away from the
    start, so split R-hat blows past the 1.2 threshold."""
    iv = qt.MHMCProcessInterval(
        process_tmg, n_points=60, step=1e-4, burn_steps=0,
        use_new_estimate=True,
    )
    with pytest.warns(RuntimeWarning, match="NOT converged"):
        iv(np.array([0.9]))
    assert iv.r_hat > 1.2


def test_mhmc_adaptive_step(process_tmg):
    """adapt_step brings the process chain out of the 0-percent-acceptance
    regime the reference's defaults land in."""
    iv = qt.MHMCProcessInterval(
        process_tmg, n_points=100, step=1.0, burn_steps=50,
        use_new_estimate=True, adapt_step=True,
    )
    d, _ = iv(np.array([0.9]))
    assert 0.03 < iv.acceptance_rate < 0.95
    assert np.isfinite(np.asarray(d)).all()


def test_bootstrap_forwards_physical(state_tmg):
    """physical=False must reach the per-resample estimator: raw linear
    inversion of a near-pure state is non-PSD almost surely (the round-1
    code silently dropped the flag and always projected)."""
    import jax

    from quantpy_tpu.ops.paulis import np_bloch_to_matrix
    from quantpy_tpu.tomography import bootstrap_core

    blochs = np.asarray(
        bootstrap_core.bootstrap_blochs(
            jax.random.key(5),
            np.asarray(state_tmg.reconstructed_state.bloch, dtype=np.float64),
            state_tmg.povm_matrix,
            state_tmg.n_measurements,
            n_points=32,
            method="lin",
            physical=False,
        )
    )
    mats = np_bloch_to_matrix(blochs, state_tmg.state.n_qubits)
    min_eig = np.linalg.eigvalsh(mats).min()
    assert min_eig < -1e-6  # non-PSD estimates survive

    # and the interval itself now differs between physical=True/False
    d_phys, _ = qt.BootstrapStateInterval(
        state_tmg, n_points=64, physical=True, key=jax.random.key(7)
    )(np.array([0.5, 0.9]))
    d_raw, _ = qt.BootstrapStateInterval(
        state_tmg, n_points=64, physical=False, key=jax.random.key(7)
    )(np.array([0.5, 0.9]))
    assert not np.allclose(d_phys, d_raw)


def test_mhmc_state_custom_distance(state_tmg):
    """A custom distance callable must actually be applied (round-1 code
    silently fell back to Hilbert-Schmidt)."""
    import jax

    def doubled_hs(a, b):
        return 2.0 * float(qt.hs_dst(a, b))

    tmg2 = qt.StateTomograph(state_tmg.state, dst=doubled_hs, key=77)
    tmg2.povm_matrix = state_tmg.povm_matrix
    tmg2.n_measurements = state_tmg.n_measurements
    tmg2._results = state_tmg.results
    tmg2.point_estimate("mle")
    iv_custom = qt.MHMCStateInterval(
        tmg2, n_points=50, burn_steps=50, key=jax.random.key(3)
    )
    d_custom, _ = iv_custom(np.array([0.5, 0.9]))
    tmg3 = qt.StateTomograph(state_tmg.state, dst="hs", key=77)
    tmg3.povm_matrix = state_tmg.povm_matrix
    tmg3.n_measurements = state_tmg.n_measurements
    tmg3._results = state_tmg.results
    tmg3.point_estimate("mle")
    iv_hs = qt.MHMCStateInterval(
        tmg3, n_points=50, burn_steps=50, key=jax.random.key(3)
    )
    d_hs, _ = iv_hs(np.array([0.5, 0.9]))
    np.testing.assert_allclose(np.asarray(d_custom), 2 * np.asarray(d_hs), rtol=1e-6)


def test_bootstrap_process_custom_distance(process_tmg):
    import jax

    def doubled_hs(a, b):
        return 2.0 * float(qt.hs_dst(a, b))

    iv_hs = qt.BootstrapProcessInterval(
        process_tmg, n_points=16, key=jax.random.key(11)
    )
    d_hs, _ = iv_hs(np.array([0.5, 0.9]))
    process_tmg_custom = qt.ProcessTomograph(process_tmg.channel, key=22)
    process_tmg_custom.dst = doubled_hs
    process_tmg_custom.tomographs = process_tmg.tomographs
    process_tmg_custom.reconstructed_channel = process_tmg.reconstructed_channel
    iv_custom = qt.BootstrapProcessInterval(
        process_tmg_custom, n_points=16, key=jax.random.key(11)
    )
    d_custom, _ = iv_custom(np.array([0.5, 0.9]))
    np.testing.assert_allclose(np.asarray(d_custom), 2 * np.asarray(d_hs), rtol=1e-6)


def test_mhmc_warm_start_reuses_chain(state_tmg):
    iv = qt.MHMCStateInterval(
        state_tmg, n_points=100, burn_steps=100, use_new_estimate=True,
        warm_start=True,
    )
    iv(np.array([0.9]))
    chain1 = iv.chain
    del iv.cl_to_dist
    iv(np.array([0.9]))
    assert iv.chain is chain1  # same chain continued, no re-burn


def test_mhmc_state_interval_multichain(state_tmg):
    iv = qt.MHMCStateInterval(
        state_tmg, n_points=400, step=0.1, burn_steps=1500, thinning=4,
        use_new_estimate=True, n_chains=4,
    )
    dist, _ = _check_monotone_interval(iv, np.linspace(0.05, 0.95, 10))
    assert 0 < iv.acceptance_rate <= 1
    assert np.isfinite(iv.r_hat) and iv.r_hat < 1.2  # chains mixed
    assert iv.ess > 30
    # distribution statistically matches the single-chain interval
    iv1 = qt.MHMCStateInterval(
        state_tmg, n_points=400, step=0.1, burn_steps=1500, thinning=4,
        use_new_estimate=True, n_chains=1,
    )
    d1, _ = iv1(np.linspace(0.05, 0.95, 10))
    med, med1 = float(dist[5]), float(np.asarray(d1)[5])
    assert abs(med - med1) < 0.7 * max(med, med1)


def test_mhmc_process_interval_multichain(process_tmg):
    iv = qt.MHMCProcessInterval(
        process_tmg, n_points=120, step=0.005, burn_steps=60,
        use_new_estimate=True, n_chains=4,
    )
    d, _ = iv(np.array([0.5, 0.9]))
    assert np.all(np.isfinite(np.asarray(d)))
    assert np.isfinite(iv.r_hat)
    assert iv.ess > 4


@pytest.mark.slow
def test_polytope_interval_f32_vs_x64(state_tmg):
    """f32 (the default working precision) polytope bounds agree with x64 — guards
    against PDHG drift over long iteration counts at single precision."""
    import jax

    from quantpy_tpu.config import enable_x64

    cl = np.linspace(0.3, 0.9, 6)
    iv64 = qt.PolytopeStateInterval(state_tmg, n_points=40)
    (fmin64, fmax64), _ = iv64(cl)
    assert max(iv64.lp_iterations) <= iv64.LP_ITERS
    enable_x64(False)
    try:
        iv32 = qt.PolytopeStateInterval(state_tmg, n_points=40)
        (fmin32, fmax32), _ = iv32(cl)
    finally:
        enable_x64(True)
    np.testing.assert_allclose(np.asarray(fmin32), np.asarray(fmin64), atol=5e-3)
    np.testing.assert_allclose(np.asarray(fmax32), np.asarray(fmax64), atol=5e-3)


def test_kron_intervals_reject_nonuniform_counts(monkeypatch):
    """Non-uniform counts injected into a kron-mode tomograph must be
    rejected by the factored interval paths, which fold a uniform row
    weight exactly (round-2 advisor finding)."""
    monkeypatch.setattr(qt.StateTomograph, "DENSE_POVM_MAX_ELEMENTS", 1)
    tmg = qt.StateTomograph(qt.GHZ(2), key=71)
    tmg.experiment(1000, "proj-set")
    assert tmg.povm_matrix is None
    results = np.asarray(tmg.results).copy()
    results[0] *= 3  # row sums now non-uniform
    tmg.results = results
    tmg.point_estimate("lin")
    for iv in (
        qt.MomentInterval(tmg),
        qt.SugiyamaInterval(tmg),
        qt.PolytopeStateInterval(tmg, n_points=5),
        qt.BootstrapStateInterval(tmg, n_points=4),
    ):
        with pytest.raises(NotImplementedError):
            iv(np.array([0.5, 0.9]))


def test_channel_moments_kron_matches_dense():
    """Fully-factored channel moments (the 6+ qubit path): exact mean,
    Hutchinson variance within MC tolerance of the dense recipe at 2q."""
    import jax

    from quantpy_tpu.measurements import _single_qubit_preset
    from quantpy_tpu.tomography import kron_analytic as ka
    from quantpy_tpu.tomography.process import (
        ProcessTomograph,
        _generate_input_states,
    )

    tmg = ProcessTomograph(depolarizing(0.3, 2), key=22)
    tmg.experiment(3000, "proj-set")
    t0 = tmg.tomographs[0]
    freq = np.stack(
        [t.results / t.n_measurements[:, None] for t in tmg.tomographs]
    )
    mean_d, var_d = ka.channel_l2_moments(
        tmg._input_blochs_t(), t0.povm_matrix, freq, t0.n_measurements[0]
    )
    states1_t = np.stack(
        [s.T.bloch for s in _generate_input_states("proj4", 1)]
    )
    mean_k, var_k = ka.channel_l2_moments_kron(
        states1_t, _single_qubit_preset("proj-set"), 2, freq,
        t0.n_measurements[0], n_probes=256, key=jax.random.key(5),
    )
    np.testing.assert_allclose(mean_k, mean_d, rtol=1e-10)
    np.testing.assert_allclose(var_k, var_d, rtol=0.05)


def test_moment_interval_dispatches_stochastic_path(monkeypatch):
    """Above the exact-Gram budget MomentInterval uses the fully-factored
    path and reproduces the dense interval; without tensor-power design
    factors it raises."""
    from quantpy_tpu.tomography import interval as interval_mod
    from quantpy_tpu.tomography.process import ProcessTomograph

    tmg = ProcessTomograph(depolarizing(0.3, 2), key=22)
    tmg.experiment(3000, "proj-set")
    tmg.point_estimate("lifp")
    dist_exact, _ = qt.MomentInterval(tmg)(np.array([0.5, 0.9]))
    monkeypatch.setattr(interval_mod, "_CHANNEL_EXACT_GRAM_MAX", 1)
    dist_stoch, _ = qt.MomentInterval(tmg)(np.array([0.5, 0.9]))
    np.testing.assert_allclose(dist_stoch, dist_exact, rtol=0.05)
    tmg._povm1 = None
    with pytest.raises(NotImplementedError):
        qt.MomentInterval(tmg)(np.array([0.5, 0.9]))


def test_mhmc_process_tempered(process_tmg):
    """temper=True flattens the raw-count process NLL by the total shot
    count (the 4+ qubit sampling recipe); the chain must move and the
    interval stay finite/ordered."""
    iv = qt.MHMCProcessInterval(
        process_tmg, n_points=60, burn_steps=100, step=0.02,
        use_new_estimate=True, temper=True, adapt_step=True, key=3,
    )
    d, _ = iv(np.array([0.5, 0.9]))
    d = np.asarray(d)
    assert np.all(np.isfinite(d)) and d[0] <= d[1] + 1e-9
    assert 0.01 < iv.acceptance_rate < 0.99


def test_mhmc_process_projected_target(process_tmg, monkeypatch):
    """The projected-likelihood formulation (the 4+ qubit route, forced
    here at 1 qubit): chain moves, samples are CPTP after the reported
    projection, interval is finite and ordered."""
    from quantpy_tpu.tomography import process_core

    monkeypatch.setattr(
        qt.MHMCProcessInterval, "PROJECTED_TARGET_QUBITS", 1
    )
    iv = qt.MHMCProcessInterval(
        process_tmg, n_points=60, burn_steps=100, step=0.02,
        use_new_estimate=True, adapt_step=True, key=7,
    )
    d, _ = iv(np.array([0.5, 0.9]))
    d = np.asarray(d)
    assert np.all(np.isfinite(d)) and d[0] <= d[1] + 1e-9
    assert 0.01 < iv.acceptance_rate < 0.999


def test_mhmc_process_mala(process_tmg, monkeypatch):
    """MALA through the differentiable NS projection (forced at 1 qubit):
    the gradient-driven chain moves, and its distance distribution is
    consistent with the random-walk projected-target chain."""
    monkeypatch.setattr(
        qt.MHMCProcessInterval, "PROJECTED_TARGET_QUBITS", 1
    )
    iv = qt.MHMCProcessInterval(
        process_tmg, n_points=80, burn_steps=150, step=0.005,
        use_new_estimate=True, adapt_step=True, proposal="mala", key=9,
    )
    d, _ = iv(np.array([0.5, 0.9]))
    d = np.asarray(d)
    assert np.all(np.isfinite(d)) and d[0] <= d[1] + 1e-9
    assert 0.05 < iv.acceptance_rate <= 1.0
    rw = qt.MHMCProcessInterval(
        process_tmg, n_points=80, burn_steps=150, step=0.02,
        use_new_estimate=True, adapt_step=True, key=9,
    )
    d_rw, _ = rw(np.array([0.5, 0.9]))
    # same posterior, two samplers: agree within MC noise of short chains
    assert abs(d[1] - np.asarray(d_rw)[1]) < 0.5 * max(
        float(np.asarray(d_rw)[1]), 1e-3
    )
    # outside projected-target mode MALA is rejected
    monkeypatch.setattr(
        qt.MHMCProcessInterval, "PROJECTED_TARGET_QUBITS", 99
    )
    with pytest.raises(NotImplementedError):
        qt.MHMCProcessInterval(
            process_tmg, n_points=4, proposal="mala",
            use_new_estimate=True,
        )(np.array([0.5]))


def test_kron_fisher_whitener_roundtrip(process_tmg):
    """The whitening/unwhitening pair is an exact inverse, and the
    whitened Gauss-Newton metric is isotropic: C^T (F_B (x) F_W) C = I
    for C = A_B (x) A_W (the property that makes unit-step MALA in z
    Fisher-preconditioned MALA in x)."""
    from quantpy_tpu.tomography import process_core, state_core

    t0 = process_tmg.tomographs[0]
    w = np.asarray(
        state_core.weighted_povm_flat(t0.povm_matrix, t0.n_measurements)
    )
    flat = np.concatenate([t.flat_results for t in process_tmg.tomographs])
    x_hat = np.asarray(process_tmg.reconstructed_channel.choi.bloch)
    a_b, a_w, l_b, l_w = process_core.kron_fisher_whitener(
        process_tmg._input_blochs_t(), w, flat, x_hat
    )
    d1 = a_b.shape[0]
    rng = np.random.default_rng(5)
    x = rng.normal(size=(d1, d1))
    z = l_b.T @ x @ l_w          # whiten
    x_back = a_b @ z @ a_w.T     # unwhiten
    np.testing.assert_allclose(x_back, x, rtol=1e-9, atol=1e-12)
    # A^T (L L^T) A = I per factor -> kron metric is exactly whitened
    np.testing.assert_allclose(a_b.T @ (l_b @ l_b.T) @ a_b, np.eye(d1), atol=1e-9)
    np.testing.assert_allclose(a_w.T @ (l_w @ l_w.T) @ a_w, np.eye(d1), atol=1e-9)


def test_mhmc_process_mala_unpreconditioned(process_tmg, monkeypatch):
    """precondition=False keeps the raw-coordinate MALA chain; its
    distance distribution agrees with the whitened default at 1 qubit
    (same posterior, two parameterizations)."""
    monkeypatch.setattr(
        qt.MHMCProcessInterval, "PROJECTED_TARGET_QUBITS", 1
    )
    kw = dict(
        n_points=80, burn_steps=150, step=0.005,
        use_new_estimate=True, adapt_step=True, proposal="mala", key=9,
    )
    d_raw, _ = qt.MHMCProcessInterval(
        process_tmg, precondition=False, **kw
    )(np.array([0.5, 0.9]))
    d_pre, _ = qt.MHMCProcessInterval(process_tmg, **kw)(np.array([0.5, 0.9]))
    d_raw, d_pre = np.asarray(d_raw), np.asarray(d_pre)
    assert np.all(np.isfinite(d_raw)) and np.all(np.isfinite(d_pre))
    assert abs(d_pre[1] - d_raw[1]) < 0.5 * max(float(d_raw[1]), 1e-3)


def test_interval_accepts_int_seed(state_tmg):
    """Plain int seeds coerce to PRNG keys in every interval (the
    reference has no key concept — migrating users pass seeds)."""
    import jax

    iv = qt.BootstrapStateInterval(state_tmg, n_points=20, key=99)
    d, _ = iv(np.array([0.5, 0.9]))
    assert np.all(np.isfinite(np.asarray(d)))
    iv2 = qt.BootstrapStateInterval(state_tmg, n_points=20, key=jax.random.key(99))
    d2, _ = iv2(np.array([0.5, 0.9]))
    np.testing.assert_array_equal(np.asarray(d), np.asarray(d2))
