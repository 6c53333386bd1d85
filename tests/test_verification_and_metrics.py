"""Coverage verification harness + calibration metrics."""

import numpy as np
import pytest

import quantpy_tpu as qt
from quantpy_tpu.channel import depolarizing
from quantpy_tpu.metrics import get_CL_list_channel, get_CL_list_state
from quantpy_tpu.tomography.polytopes.verification import (
    test_qpt as coverage_qpt,
    test_qst as coverage_qst,
)


def test_qst_coverage_ghz():
    """Polytope coverage must dominate the nominal level (the bound is
    conservative): reproduces the reference's fig1a-style check."""
    conf_levels = np.array([0.5, 0.8, 0.95])
    cov = coverage_qst(qt.GHZ(2), conf_levels, n_measurements=500, n_trials=300)
    assert cov.shape == (3,)
    assert np.all(cov >= conf_levels - 0.05)
    assert np.all(np.diff(cov) >= -0.05)


def test_qpt_coverage_depolarizing():
    conf_levels = np.array([0.5, 0.9])
    cov = coverage_qpt(
        depolarizing(0.4), conf_levels, n_measurements=500, n_trials=200,
        input_states="sic",
    )
    assert np.all(cov >= conf_levels - 0.07)


def test_qpt_problem_factored_prod_matches_dense():
    """qpt_problem's factored polytope_prod (dim * B X[:, 1:] W[:, 1:]^T)
    equals the explicit kron-row construction it replaced — the 4-qubit
    enabler (the dense operator is ~170 GB there)."""
    from quantpy_tpu.measurements import generate_measurement_matrix
    from quantpy_tpu.tomography.polytopes.verification import qpt_problem
    from quantpy_tpu.tomography.process import ProcessTomograph

    channel = depolarizing(0.3, 2)
    _, n_meas, _, prod, _, _ = qpt_problem(channel, 700, "sic")
    tmg = ProcessTomograph(channel, input_states="sic")
    dim = 4**channel.n_qubits
    povm_matrix = generate_measurement_matrix("proj-set", channel.n_qubits)
    m = povm_matrix.shape[0]
    nm = np.full(m, 700.0)
    meas_flat = (povm_matrix * nm[:, None, None] / nm.sum()).reshape(
        -1, povm_matrix.shape[-1]
    ) * m
    states_matrix = tmg._input_blochs_t()
    bloch_indices = [i for i in range(dim**2) if i % dim != 0]
    a_matrix = (
        np.einsum("ia,jb->ijab", states_matrix, meas_flat[:, 1:]) * dim
    ).reshape(states_matrix.shape[0] * meas_flat.shape[0], -1)
    dense_prod = a_matrix @ np.asarray(channel.choi.bloch)[bloch_indices]
    np.testing.assert_allclose(prod, dense_prod, rtol=1e-12, atol=1e-14)


def test_calibration_state_moment():
    levels = get_CL_list_state(
        qt.GHZ(1), interval="moment", n_measurements=800, n_iter=40
    )
    assert levels.shape == (40,)
    assert np.all((0 <= levels) & (levels <= 1))
    # calibrated intervals: achieved levels roughly uniform; mean in (0.2, 0.8)
    assert 0.2 < levels.mean() < 0.8


def test_calibration_channel_moment():
    levels = get_CL_list_channel(
        depolarizing(0.3), interval="moment", n_measurements=800, n_iter=15
    )
    assert levels.shape == (15,)
    assert np.all((0 <= levels) & (levels <= 1))


def test_calibration_unknown_interval():
    with pytest.raises(KeyError):
        get_CL_list_state(qt.GHZ(1), interval="bogus", n_iter=1)


import os
import pickle

REF_PICKLE = "/root/reference/polytopes/results/states_qubits_10k.pkl"


@pytest.mark.skipif(not os.path.exists(REF_PICKLE), reason="no reference pickle")
def test_coverage_matches_published_curve():
    """Reproduce the reference's published GHZ-1 coverage curve
    (arXiv:2109.04734 fig 1a data, polytopes/results/states_qubits_10k.pkl)
    within Monte-Carlo tolerance (the full 10^4-trial comparison in
    PARITY.md reaches <= 0.011 on every curve)."""
    with open(REF_PICKLE, "rb") as f:
        ref_data = pickle.load(f)
    conf = np.asarray(ref_data["cl"])
    published = np.asarray(ref_data["results"][0])
    ours = coverage_qst(qt.GHZ(1), conf, n_measurements=10_000, n_trials=1500)
    assert np.max(np.abs(ours - published)) < 0.035
