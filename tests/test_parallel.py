"""Sharded bootstrap over the 8-device virtual CPU mesh."""

import jax
import numpy as np
import pytest

import quantpy_tpu as qt
from quantpy_tpu.parallel import (
    make_mesh,
    povm_sharded_probabilities,
    sharded_bootstrap_distances,
)
from quantpy_tpu.tomography.bootstrap_core import bootstrap_distances
from quantpy_tpu.tomography.state import StateTomograph


@pytest.fixture(scope="module")
def design():
    tmg = StateTomograph(qt.GHZ(2), key=11)
    tmg.experiment(2000, "proj-set")
    est = tmg.point_estimate("lin")
    return tmg, est


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8


@pytest.mark.parametrize("method", ["lin", "mle-rhor"])
def test_sharded_bootstrap_matches_statistics(design, method):
    tmg, est = design
    mesh = make_mesh()
    d_sharded = np.asarray(
        sharded_bootstrap_distances(
            mesh,
            jax.random.key(0),
            est.bloch,
            tmg.povm_matrix,
            tmg.n_measurements,
            n_points=64,
            method=method,
        )
    )
    assert d_sharded.shape == (64,)
    assert np.all(d_sharded >= 0) and np.all(d_sharded < 0.5)
    # statistically consistent with the single-device bootstrap
    d_single = np.asarray(
        bootstrap_distances(
            jax.random.key(1),
            est.bloch,
            tmg.povm_matrix,
            tmg.n_measurements,
            n_points=64,
            method=method,
        )
    )
    assert abs(np.median(d_sharded) - np.median(d_single)) < 0.05


def test_sharded_kron_bootstrap(design):
    """Kron-factored bootstrap sharded over the mesh matches the
    single-device kron bootstrap statistically."""
    from quantpy_tpu.measurements import _single_qubit_preset
    from quantpy_tpu.parallel import sharded_kron_bootstrap_distances
    from quantpy_tpu.tomography import kron_core

    tmg, est = design
    n = tmg.state.n_qubits
    povm1 = _single_qubit_preset("proj-set")
    mesh = make_mesh()
    d_sharded = np.asarray(
        sharded_kron_bootstrap_distances(
            mesh, jax.random.key(3), est.bloch, povm1, n, 1000.0,
            n_points=64, method="mle",
        )
    )
    assert d_sharded.shape == (64,)
    assert np.all(np.isfinite(d_sharded)) and np.all(d_sharded >= 0)
    d_single = np.asarray(
        kron_core.kron_bootstrap_distances(
            jax.random.key(4), est.bloch, povm1, n, 1000.0,
            n_points=64, method="mle",
        )
    )
    assert abs(np.median(d_sharded) - np.median(d_single)) < 0.05


def test_sharded_kron_bootstrap_chunked(design):
    """Regression: when the per-device resample shard exceeds the fused
    chunk (the 9-qubit memory rule), the kron wrapper runs under the
    shard_map trace — it must lax.map on-device instead of raising
    TracerArrayConversionError from host chunking."""
    from quantpy_tpu.measurements import _single_qubit_preset
    from quantpy_tpu.parallel import sharded_kron_bootstrap_distances
    from quantpy_tpu.tomography import kron_core

    tmg, est = design
    n = tmg.state.n_qubits
    povm1 = _single_qubit_preset("proj-set")
    mesh = make_mesh()
    # 64/8 devices = 8 per device, chunk=3 -> 3 lax.map chunks per device
    d_sharded = np.asarray(
        sharded_kron_bootstrap_distances(
            mesh, jax.random.key(7), est.bloch, povm1, n, 1000.0,
            n_points=64, method="lin", chunk=3,
        )
    )
    assert d_sharded.shape == (64,)
    assert np.all(np.isfinite(d_sharded)) and np.all(d_sharded >= 0)
    d_single = np.asarray(
        kron_core.kron_bootstrap_distances(
            jax.random.key(8), est.bloch, povm1, n, 1000.0,
            n_points=64, method="lin",
        )
    )
    assert abs(np.median(d_sharded) - np.median(d_single)) < 0.05


def test_operator_sharded_kron_chain_6q():
    """The OPERATOR-sharded kron transforms (first-group outcome axis over
    the mesh) equal the single-device chains at 6 qubits —
    the multi-chip answer to the 11-qubit single-chip layout wall."""
    from quantpy_tpu.measurements import _single_qubit_preset
    from quantpy_tpu.parallel import (
        sharded_kron_adjoint_flat,
        sharded_kron_estimate_lin,
        sharded_kron_forward_flat,
    )
    from quantpy_tpu.tomography import kron_core

    n = 6
    mesh = make_mesh()
    povm1 = _single_qubit_preset("proj-set")
    bloch = np.stack(
        [np.asarray(qt.GHZ(n).bloch), np.asarray(qt.fully_mixed(n).bloch)]
    )
    fwd_single = np.asarray(kron_core.kron_forward_flat(povm1, n, bloch))
    fwd_sharded = np.asarray(
        sharded_kron_forward_flat(mesh, bloch, povm1, n)
    )
    np.testing.assert_array_equal(fwd_sharded, fwd_single)
    counts = np.asarray(
        kron_core.kron_simulate(jax.random.key(2), povm1, bloch, 1000.0)
    )
    c_flat = counts.reshape(2, -1)
    adj_single = np.asarray(kron_core.kron_adjoint_flat(povm1, n, c_flat))
    adj_sharded = np.asarray(
        sharded_kron_adjoint_flat(mesh, c_flat, povm1, n)
    )
    np.testing.assert_allclose(adj_sharded, adj_single, rtol=1e-12, atol=1e-15)
    lin_single = np.asarray(kron_core.kron_estimate_lin(counts, povm1, n))
    lin_sharded = np.asarray(
        sharded_kron_estimate_lin(mesh, counts, povm1, n)
    )
    np.testing.assert_allclose(lin_sharded, lin_single, rtol=1e-10, atol=1e-13)
    # divisibility guard: a 7-qubit proj-set first group still has p0 = 8
    with pytest.raises(ValueError):
        sharded_kron_forward_flat(
            make_mesh(3), bloch, povm1, n
        )


def test_operator_sharded_kron_mle_6q():
    """The operator-sharded RrhoR MLE (sharded iteration on
    the sharded design, the 12-qubit route) reaches the same fixed point as
    the single-device kron MLE on identical counts, and the born-sharded
    simulate feeds it end to end."""
    from quantpy_tpu.measurements import _single_qubit_preset
    from quantpy_tpu.parallel import (
        sharded_kron_estimate_mle_rhor,
        sharded_kron_simulate,
    )
    from quantpy_tpu.tomography import kron_core

    n = 6
    mesh = make_mesh()
    povm1 = _single_qubit_preset("proj-set")
    truth = np.asarray(qt.GHZ(n).bloch)
    bloch = np.stack([truth, np.asarray(qt.fully_mixed(n).bloch)])
    counts = np.asarray(
        kron_core.kron_simulate(jax.random.key(5), povm1, bloch, 1000.0)
    )
    mle_single = np.asarray(
        kron_core.kron_estimate_mle_rhor(counts, povm1, n, max_iter=40)
    )
    mle_sharded = np.asarray(
        sharded_kron_estimate_mle_rhor(mesh, counts, povm1, n, max_iter=40)
    )
    np.testing.assert_allclose(mle_sharded, mle_single, rtol=1e-8, atol=1e-10)
    # born-sharded counts (product-binomial design, different stream) give
    # an estimate of the same quality end to end
    counts_sh = sharded_kron_simulate(
        mesh, jax.random.key(6), povm1, truth, 1000.0
    )
    assert counts_sh.shape == (3**n, 2**n)
    est = np.asarray(
        sharded_kron_estimate_mle_rhor(mesh, counts_sh, povm1, n, max_iter=40)
    )
    d_sh = float(np.linalg.norm((est - truth)) )
    d_ref = float(np.linalg.norm(mle_single[0] - truth))
    assert d_sh < 3 * max(d_ref, 1e-3), (d_sh, d_ref)


def test_sharded_kraus_chains():
    """Mesh-sharded ANCHORED kraus-factor process chains (the round-3
    vmap-only fence lifted): 8 chains over 8 devices agree
    with the vmapped chains statistically."""
    from quantpy_tpu.channel import depolarizing
    from quantpy_tpu.tomography.process import ProcessTomograph

    tmg = ProcessTomograph(depolarizing(0.2, 1), key=3)
    tmg.experiment(1000, "proj-set")
    tmg.point_estimate("lifp")
    mesh = make_mesh()
    iv = qt.MHMCProcessInterval(
        tmg, n_points=240, burn_steps=200, step=0.05,
        parametrization="kraus", adapt_step=True, n_chains=8, key=21,
        mesh=mesh,
    )
    d, _ = iv(np.array([0.5]))
    assert np.isfinite(np.asarray(d)).all()
    assert 0.0 < iv.acceptance_rate <= 1.0
    iv_v = qt.MHMCProcessInterval(
        tmg, n_points=240, burn_steps=200, step=0.05,
        parametrization="kraus", adapt_step=True, n_chains=8, key=22,
    )
    d_v, _ = iv_v(np.array([0.5]))
    m, m_v = float(np.median(iv.cl_to_dist(np.linspace(0.1, 0.9, 9)))), float(
        np.median(iv_v.cl_to_dist(np.linspace(0.1, 0.9, 9)))
    )
    assert abs(m - m_v) < 0.7 * max(m, m_v), (m, m_v)


def test_sharded_bootstrap_validates_divisibility(design):
    tmg, est = design
    mesh = make_mesh()
    with pytest.raises(ValueError):
        sharded_bootstrap_distances(
            mesh, jax.random.key(0), est.bloch, tmg.povm_matrix,
            tmg.n_measurements, n_points=63,
        )


def test_povm_sharded_probabilities(design):
    tmg, est = design
    mesh = make_mesh()
    from quantpy_tpu.tomography.state_core import weighted_povm_flat

    w = np.asarray(weighted_povm_flat(tmg.povm_matrix, tmg.n_measurements))
    # pad rows to a multiple of 8 for even sharding
    pad = (-w.shape[0]) % 8
    w_pad = np.vstack([w, np.zeros((pad, w.shape[1]))])
    p = np.asarray(povm_sharded_probabilities(mesh, w_pad, est.bloch))
    np.testing.assert_allclose(p, w_pad @ est.bloch, atol=1e-10)


def test_sharded_process_bootstrap(design):
    """Process bootstrap sharded over the mesh: per-device lifp re-estimates
    match the statistics of the single-device path."""
    from quantpy_tpu.channel import depolarizing
    from quantpy_tpu.parallel import sharded_process_bootstrap_distances
    from quantpy_tpu.tomography.process import ProcessTomograph

    true = depolarizing(0.4)
    tmg = ProcessTomograph(true, key=13)
    tmg.experiment(2000, "proj-set")
    est = tmg.point_estimate("lifp")
    mesh = make_mesh()
    out_blochs = np.stack(
        [est.transform(s).bloch for s in tmg.input_basis.elements]
    )
    d = np.asarray(
        sharded_process_bootstrap_distances(
            mesh,
            jax.random.key(2),
            np.asarray(est.choi.bloch, dtype=np.float64),
            out_blochs,
            tmg._input_blochs_t(),
            tmg.tomographs[0].povm_matrix,
            tmg.tomographs[0].n_measurements,
            n_points=64,
        )
    )
    assert d.shape == (64,)
    assert np.isfinite(d).all() and (d >= 0).all()
    # statistics agree with the single-device bootstrap interval
    iv = qt.BootstrapProcessInterval(tmg, n_points=64, key=jax.random.key(3))
    iv.setup()
    d_single = iv.cl_to_dist(np.linspace(0.05, 0.95, 10))
    assert abs(np.median(d) - np.median(d_single)) < 0.5 * np.median(d_single)


def test_sharded_coverage_matches_single_device():
    from quantpy_tpu.parallel import sharded_coverage
    from quantpy_tpu.tomography.polytopes import verification

    conf = np.array([0.5, 0.8, 0.95])
    problem = verification.qst_problem(qt.GHZ(2), 500)
    mesh = make_mesh()
    cov = sharded_coverage(mesh, jax.random.key(4), problem, conf, n_trials=320)
    assert cov.shape == conf.shape
    assert np.all((0 <= cov) & (cov <= 1))
    single = verification.test_qst(
        qt.GHZ(2), conf, n_measurements=500, n_trials=320, key=jax.random.key(5)
    )
    # same experiment, different random streams: Monte-Carlo agreement
    np.testing.assert_allclose(cov, single, atol=0.12)
    # coverage should be at least the nominal level (conservative polytopes)
    assert np.all(cov >= conf - 0.1)


def test_sharded_coverage_qpt_problem():
    from quantpy_tpu.channel import depolarizing
    from quantpy_tpu.parallel import sharded_coverage
    from quantpy_tpu.tomography.polytopes import verification

    conf = np.array([0.6, 0.9])
    problem = verification.qpt_problem(depolarizing(0.3), 400)
    mesh = make_mesh()
    cov = sharded_coverage(mesh, jax.random.key(6), problem, conf, n_trials=160)
    assert cov.shape == conf.shape
    assert np.all((0 <= cov) & (cov <= 1))
    assert np.all(cov >= conf - 0.15)


def test_sharded_mhmc_chains_match_local(design):
    """Mesh-sharded MHMC chains sample the same posterior as the local
    vmapped multichain run (same kernel, different key streams)."""
    tmg, est = design
    mesh = make_mesh()
    cl = np.linspace(0.1, 0.9, 5)
    kw = dict(n_points=640, burn_steps=400, n_chains=8, use_new_estimate=True,
              temper=False, adapt_step=True)
    iv_local = qt.MHMCStateInterval(tmg, **kw)
    d_local, _ = iv_local(cl)
    iv_mesh = qt.MHMCStateInterval(tmg, **kw, mesh=mesh)
    d_mesh, _ = iv_mesh(cl)
    assert 0 < iv_mesh.acceptance_rate < 1
    rel = np.abs(np.asarray(d_mesh) - np.asarray(d_local)) / np.asarray(d_local)
    assert float(rel.max()) < 0.3  # Monte-Carlo agreement


def test_sharded_mhmc_chains_divisibility(design):
    tmg, est = design
    mesh = make_mesh()
    iv = qt.MHMCStateInterval(
        tmg, n_points=30, n_chains=3, use_new_estimate=True, mesh=mesh
    )
    with pytest.raises(ValueError):
        iv(np.array([0.5]))


def test_sharded_mhmc_process_chains_match_local():
    """Mesh-sharded CPTP-projected process chains sample the same posterior
    as the local vmapped multichain run."""
    from quantpy_tpu.channel import dephasing

    tmg = qt.ProcessTomograph(dephasing(0.3), key=22)
    tmg.experiment(3000, "proj-set")
    tmg.point_estimate("lifp")
    mesh = make_mesh()
    cl = np.array([0.5])
    kw = dict(n_points=400, burn_steps=200, n_chains=8, adapt_step=True)
    iv_local = qt.MHMCProcessInterval(tmg, **kw)
    d_local, _ = iv_local(cl)
    iv_mesh = qt.MHMCProcessInterval(tmg, **kw, mesh=mesh)
    d_mesh, _ = iv_mesh(cl)
    assert 0 < iv_mesh.acceptance_rate < 1
    # median agreement within Monte-Carlo noise of short projected chains
    assert abs(float(d_mesh[0]) - float(d_local[0])) < 0.5 * float(d_local[0])
