"""Kron-factored measurement paths vs the dense reference paths."""

import jax
import numpy as np
import pytest

import quantpy_tpu as qt
from quantpy_tpu.tomography import kron_core, state_core
from quantpy_tpu.measurements import _single_qubit_preset


@pytest.fixture(scope="module", params=[2, 3])
def problem(request):
    n = request.param
    state = qt.GHZ(n)
    tmg = qt.StateTomograph(state, key=77)
    tmg.experiment(5000, "proj-set")
    counts = np.asarray(tmg.simulate_batch(6))
    povm1 = _single_qubit_preset("proj-set")
    return n, tmg, counts, povm1


def test_kron_probs_match_dense(problem):
    n, tmg, counts, povm1 = problem
    bloch = tmg.state.bloch
    dense = np.asarray(state_core.experiment_probabilities(tmg.povm_matrix, bloch))
    kron = np.asarray(kron_core.kron_probs(povm1, n, bloch))
    np.testing.assert_allclose(kron, dense, atol=1e-10)


def test_chunked_chain_matches_fused(problem, monkeypatch):
    """The m-block-chunked grouped chains (the 11-qubit enabler) compute
    the same forward/adjoint as the fused einsum — forced
    here by dropping the volume threshold to 0."""
    n, tmg, counts, povm1 = problem
    bloch = np.stack([tmg.state.bloch, np.asarray(tmg.state.bloch) * 0.5])
    fused_p = np.asarray(kron_core.kron_probs(povm1, n, bloch))
    fused_f = np.asarray(kron_core.kron_forward_flat(povm1, n, bloch))
    c = counts[:2].astype(np.float64)
    fused_a = np.asarray(kron_core.kron_apply_adjoint(povm1, n, c))
    monkeypatch.setattr(kron_core, "CHUNKED_CHAIN_VOLUME", 0)
    np.testing.assert_allclose(
        np.asarray(kron_core.kron_probs(povm1, n, bloch)), fused_p, atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(kron_core.kron_forward_flat(povm1, n, bloch)),
        fused_f,
        atol=1e-10,
    )
    np.testing.assert_allclose(
        np.asarray(kron_core.kron_apply_adjoint(povm1, n, c)), fused_a,
        atol=1e-10,
    )


def test_kron_adjoint_matches_dense(problem):
    n, tmg, counts, povm1 = problem
    c = counts[0] / counts[0].sum()
    dense_flat = tmg.povm_matrix.reshape(-1, 4**n)
    expected = dense_flat.T @ c.reshape(-1)
    got = np.asarray(kron_core.kron_apply_adjoint(povm1, n, c))
    np.testing.assert_allclose(got, expected, atol=1e-10)


@pytest.mark.parametrize("physical", [False, True])
def test_kron_lin_matches_dense(problem, physical):
    n, tmg, counts, povm1 = problem
    dense = np.asarray(
        state_core.estimate_lin(counts, tmg.povm_matrix, tmg.n_measurements,
                                physical=physical)
    )
    kron = np.asarray(kron_core.kron_estimate_lin(counts, povm1, n,
                                                  physical=physical))
    np.testing.assert_allclose(kron, dense, atol=1e-8)


def test_kron_mle_matches_dense(problem):
    n, tmg, counts, povm1 = problem
    dense = np.asarray(
        state_core.estimate_mle_rhor(counts, tmg.povm_matrix,
                                     tmg.n_measurements, max_iter=80, tol=0.0)
    )
    kron = np.asarray(
        kron_core.kron_estimate_mle_rhor(counts, povm1, n, max_iter=80, tol=0.0)
    )
    np.testing.assert_allclose(kron, dense, atol=1e-7)


def test_kron_simulate_statistics(problem):
    n, tmg, counts, povm1 = problem
    c = np.asarray(kron_core.kron_simulate(jax.random.key(5), povm1,
                                           tmg.state.bloch, 10000))
    assert c.shape == (3**n, 2**n)
    np.testing.assert_allclose(c.sum(-1), 10000)
    probs = np.asarray(kron_core.kron_probs(povm1, n, tmg.state.bloch))
    assert np.max(np.abs(c / 10000 - probs)) < 0.03


def test_kron_6qubit_lin_smoke():
    """6-qubit linear inversion without materializing the 0.8 GB POVM
    (the reference takes ~45 s on the dense one, BASELINE.md)."""
    n = 6
    state = qt.GHZ(n)
    povm1 = _single_qubit_preset("proj-set")
    counts = kron_core.kron_simulate(jax.random.key(6), povm1, state.bloch, 4_000)
    assert counts.shape == (729, 64)
    bloch = np.asarray(kron_core.kron_estimate_lin(counts, povm1, n))
    est = qt.Qobj(bloch)
    assert abs(est.trace().real - 1) < 1e-6
    d = float(qt.hs_dst(est, state))
    d_mixed = float(qt.hs_dst(qt.fully_mixed(n), state))
    assert d < 0.3 and d < d_mixed / 2, (d, d_mixed)


@pytest.mark.slow
def test_kron_8qubit_smoke():
    """8-qubit pipeline: groups (3, 3, 2), counts (6561, 256), 65,536-dim
    bloch. Correctness at CPU scale."""
    n = 8
    state = qt.GHZ(n)
    povm1 = _single_qubit_preset("proj-set")
    counts = kron_core.kron_simulate(
        jax.random.key(8), povm1, state.bloch, 10_000
    )
    assert counts.shape == (6561, 256)
    est = kron_core.kron_estimate_mle_rhor(counts, povm1, n, max_iter=5)
    d = float(qt.hs_dst(qt.Qobj(np.asarray(est, np.float64)), state))
    assert d < 0.05, d


def test_state_tomograph_kron_mode():
    """StateTomograph transparently switches to kron mode for big designs."""
    tmg = qt.StateTomograph(qt.GHZ(6), key=88)
    tmg.experiment(4_000, "proj-set")
    assert tmg.povm_matrix is None and tmg.povm_kron is not None
    assert tmg.results.shape == (729, 64)
    est = tmg.point_estimate("lin")
    assert float(qt.hs_dst(est, tmg.state)) < 0.3
    est2 = tmg.point_estimate("mle-rhor", max_iter=30)
    assert float(qt.hs_dst(est2, tmg.state)) < 0.3
    # 'mle-constr' aliases to the trace-normalized MLE (round-3); methods
    # with no kron-path equivalent still raise
    with pytest.raises(NotImplementedError):
        tmg.point_estimate("bogus-method")
    # same-design kron warm_start merges counts (round-2 extension);
    # a different design still raises
    before = float(np.sum(tmg.results))  # 729 POVMs x 4000 shots
    tmg.experiment(1000, "proj-set", warm_start=True)
    np.testing.assert_allclose(float(np.sum(tmg.results)), before * 5000 / 4000)
    with pytest.raises(NotImplementedError):
        tmg.experiment(1000, "sic", warm_start=True)
    # small designs still use the dense path
    t2 = qt.StateTomograph(qt.GHZ(2), key=89)
    t2.experiment(1000, "proj-set")
    assert t2.povm_matrix is not None


def test_kron_bootstrap_interval():
    """BASELINE config 5 at structural scale: GHZ bootstrap CI on the
    kron-factored design."""
    tmg = qt.StateTomograph(qt.GHZ(6), key=90)
    tmg.experiment(2000, "proj-set")
    tmg.point_estimate("lin")
    iv = qt.BootstrapStateInterval(tmg, n_points=4, method="lin")
    d, _ = iv(np.array([0.5, 0.9]))
    d = np.asarray(d)
    assert d.shape == (2,) and np.all(np.isfinite(d)) and d[0] <= d[1]
    assert d[1] < 0.5


def test_kron_simulate_chunked_matches_design():
    """The host-chunked simulate (the 11-qubit draw; ROADMAP C1)
    samples the same design as the fused draw: exact per-POVM totals,
    same estimator quality on the same truth (streams differ by the
    documented per-block key folds)."""
    import jax

    from quantpy_tpu.measurements import _single_qubit_preset

    povm1 = np.asarray(_single_qubit_preset("proj-set"))
    truth = qt.GHZ(4).bloch.astype(np.float32)
    c_fused = np.asarray(
        kron_core.kron_simulate(jax.random.key(7), povm1, truth, 2000.0)
    )
    c_chunk = np.asarray(
        kron_core.kron_simulate_chunked(
            jax.random.key(7), povm1, truth, 2000.0, n_calls=5
        )
    )
    assert c_chunk.shape == c_fused.shape == (81, 16)
    np.testing.assert_array_equal(c_chunk.sum(axis=-1), 2000.0)
    e_f = np.asarray(kron_core.kron_estimate_lin(c_fused, povm1, 4))
    e_c = np.asarray(kron_core.kron_estimate_lin(c_chunk, povm1, 4))
    d_f = np.linalg.norm(e_f - truth)
    d_c = np.linalg.norm(e_c - truth)
    assert d_c < 3 * max(d_f, 1e-3), (d_c, d_f)


def test_kron_bootstrap_chunking_consistent():
    """The host-chunked bootstrap wrapper returns the requested number of
    finite distances and is deterministic in the key (the 9-qubit memory
    cliff motivates the auto rule; here chunking is forced at small n)."""
    import jax

    from quantpy_tpu.measurements import _single_qubit_preset

    povm1 = np.asarray(_single_qubit_preset("proj-set"))
    est = np.zeros(16)
    est[0] = 0.25
    d1 = np.asarray(
        kron_core.kron_bootstrap_distances(
            jax.random.key(5), est, povm1, 2, 500.0, n_points=6,
            method="lin", chunk=2,
        )
    )
    d2 = np.asarray(
        kron_core.kron_bootstrap_distances(
            jax.random.key(5), est, povm1, 2, 500.0, n_points=6,
            method="lin", chunk=2,
        )
    )
    assert d1.shape == (6,)
    assert np.isfinite(d1).all() and (d1 >= 0).all()
    np.testing.assert_array_equal(d1, d2)
