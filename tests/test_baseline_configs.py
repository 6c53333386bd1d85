"""End-to-end runs of the five BASELINE.json benchmark configs (CPU-sized)."""

import jax
import numpy as np

import quantpy_tpu as qt
from quantpy_tpu.channel import depolarizing
from quantpy_tpu.operator import Z
from quantpy_tpu.tomography.bootstrap_core import bootstrap_distances


def test_config1_single_qubit_zero_state():
    """Single-qubit |0> tomography: Pauli POVM, 10k shots, lin + mle."""
    tmg = qt.StateTomograph(qt.zero(1), key=101)
    tmg.experiment(4_000, "proj")
    for method in ["lin", "mle", "mle-rhor"]:
        est = tmg.point_estimate(method)
        assert float(qt.if_dst(est, tmg.state)) < 5e-3, method


def test_config2_bell_state_warm_start_and_ptrace():
    """2-qubit Bell tomography: factorized POVM, partial traces, warm_start."""
    bell = qt.Qobj(np.array([1, 0, 0, 1]) / np.sqrt(2), is_ket=True)
    tmg = qt.StateTomograph(bell, key=102)
    tmg.experiment(2000, "proj-set")
    tmg.experiment(8000, "proj-set", warm_start=True)  # adaptive restart
    est = tmg.point_estimate("mle-rhor")
    assert float(qt.if_dst(est, bell)) < 0.01
    # marginals of the Bell state are maximally mixed
    for k in [(0,), (1,)]:
        np.testing.assert_allclose(
            est.ptrace(k).matrix, np.eye(2) / 2, atol=0.05
        )


def test_config3_process_tomography_with_kraus():
    """1-qubit QPT: Z/depolarizing channels, Choi + Kraus, CPTP projection."""
    for channel in [Z.as_channel(), depolarizing(0.35)]:
        tmg = qt.ProcessTomograph(channel, key=103)
        tmg.experiment(20_000, "proj-set")
        est = tmg.point_estimate("lifp", cptp=True)
        assert est.is_cptp(atol=1e-4)
        assert float(qt.hs_dst(est.choi, channel.choi)) < 0.05
        kraus = est.kraus
        acc = sum(k.matrix.conj().T @ k.matrix for k in kraus)
        np.testing.assert_allclose(acc, np.eye(2), atol=1e-4)


def test_config4_confidence_intervals_2q():
    """Bootstrap + MHMC on 2-qubit states (state_interval.py workload)."""
    tmg = qt.StateTomograph(qt.GHZ(2), key=104)
    tmg.experiment(1000, "proj-set")
    tmg.point_estimate("mle-rhor")
    b, _ = qt.BootstrapStateInterval(tmg, n_points=128, method="mle-rhor")(
        np.array([0.5, 0.9])
    )
    assert 0 < b[0] <= b[1] < 0.5
    m, _ = qt.MHMCStateInterval(
        tmg, n_points=200, burn_steps=200, use_new_estimate=True
    )(np.array([0.5, 0.9]))
    assert 0 < m[0] <= m[1]


def test_config5_5qubit_ghz_batched_mle():
    """5-qubit GHZ: batched vmapped MLE over many simulated experiments +
    CI sweep (scaled down for CPU CI; bench.py runs the full size)."""
    state = qt.GHZ(5)
    tmg = qt.StateTomograph(state, key=105)
    tmg.experiment(2000, "proj-set")
    est = tmg.point_estimate("mle-rhor", max_iter=40)
    assert float(qt.if_dst(est, state)) < 0.05
    d = np.asarray(
        bootstrap_distances(
            jax.random.key(0),
            est.bloch.astype(np.float64),
            tmg.povm_matrix,
            tmg.n_measurements,
            n_points=4,
            method="mle-rhor",
            max_iter=30,
        )
    )
    assert d.shape == (4,)
    assert np.all(np.isfinite(d)) and np.all(d < 0.5)
