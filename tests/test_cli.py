"""CLI entry points: JSON round trips, reference fixture, parity."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import quantpy_tpu as qt
from quantpy_tpu.cli import process_interval, state_interval

REF_FIXTURE = "/root/reference/input.json"


@pytest.fixture
def state_fixture(tmp_path):
    """Synthesize a QST record like a real experiment would produce."""
    # pure target: the CLI's fidelity band is the linear functional
    # Tr(rho sigma), which reaches 1 only for pure targets
    tmg = qt.StateTomograph(qt.Qobj(np.array([1, 1], dtype=float) / np.sqrt(2),
                                    is_ket=True), key=33)
    tmg.experiment(10000, "proj-set")
    doc = {
        "povm_matrix": tmg.povm_matrix.tolist(),
        "outcomes": tmg.results.astype(int).tolist(),
        "target_state": tmg.state.bloch.tolist(),
        "conf_levels": [0.5, 0.9, 0.99],
    }
    p = tmp_path / "state.json"
    p.write_text(json.dumps(doc))
    return p, tmg


def test_state_cli_roundtrip(state_fixture, tmp_path):
    path, tmg = state_fixture
    out_path = tmp_path / "out.json"
    state_interval.main(["-i", str(path), "-o", str(out_path)])
    out = json.loads(out_path.read_text())
    assert set(out) == {"state", "fidelity_min", "fidelity_max", "hs_radius"}
    est = qt.Qobj(np.asarray(out["state"]))
    assert float(qt.hs_dst(est, tmg.state)) < 0.05
    fmin, fmax = np.asarray(out["fidelity_min"]), np.asarray(out["fidelity_max"])
    assert np.all(fmin <= fmax) and np.all((0 <= fmin) & (fmax <= 1))
    # target is the true state: bands should contain a value near 1
    assert fmax[-1] > 0.97
    assert len(out["hs_radius"]) == 3


def test_state_cli_no_ci(state_fixture, tmp_path):
    path, _ = state_fixture
    out_path = tmp_path / "out.json"
    state_interval.main(["-i", str(path), "-o", str(out_path), "--no-ci"])
    out = json.loads(out_path.read_text())
    assert set(out) == {"state"}


@pytest.mark.skipif(not os.path.exists(REF_FIXTURE), reason="no reference fixture")
def test_process_cli_dys_method(tmp_path):
    """The 'dys' CPTP-MLE estimator (no reference counterpart) is wired
    through the CLI method selector."""
    out_path = tmp_path / "out.json"
    process_interval.main(["-i", REF_FIXTURE, "-o", str(out_path), "--method", "dys"])
    out = json.loads(out_path.read_text())
    choi_bloch = np.asarray(out["process"])
    assert choi_bloch.shape == (16,)
    assert abs(choi_bloch[0] - 0.5) < 0.05


@pytest.mark.skipif(not os.path.exists(REF_FIXTURE), reason="no reference fixture")
def test_process_cli_reference_fixture(tmp_path):
    """Run the reference's worked 1-qubit QPT example end to end."""
    out_path = tmp_path / "out.json"
    process_interval.main(["-i", REF_FIXTURE, "-o", str(out_path)])
    out = json.loads(out_path.read_text())
    assert set(out) == {"process", "fidelity_min", "fidelity_max", "hs_radius"}
    choi_bloch = np.asarray(out["process"])
    assert choi_bloch.shape == (16,)
    # trace-preservation coordinate of the reconstruction
    assert abs(choi_bloch[0] - 0.5) < 0.05
    fmin, fmax = np.asarray(out["fidelity_min"]), np.asarray(out["fidelity_max"])
    assert np.all(fmin <= fmax)
    # the fixture's records are ~98%-fidelity measurements of the target
    # process, so the upper band must be high at every level
    assert np.all(fmax > 0.9)


def test_cli_as_module(state_fixture, tmp_path):
    """`python -m quantpy_tpu.cli.state_interval` works as a console tool."""
    path, _ = state_fixture
    out_path = tmp_path / "out.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_ENABLE_COMPILATION_CACHE="false")
    res = subprocess.run(
        [sys.executable, "-m", "quantpy_tpu.cli.state_interval",
         "-i", str(path), "-o", str(out_path), "--no-ci"],
        capture_output=True, text=True, timeout=300, cwd="/root/repo", env=env,
    )
    assert res.returncode == 0, res.stderr
    assert "state" in json.loads(out_path.read_text())


def test_cli_rejects_malformed_records(tmp_path):
    """Schema validation fails fast with actionable messages."""
    doc = {"povm_matrix": [[[0.5, 0.5, 0, 0], [0.5, -0.5, 0, 0]]],
           "outcomes": [[1, 2, 3]]}
    p = tmp_path / "bad.json"
    p.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="outcomes"):
        state_interval.main(["-i", str(p)])
    doc = {"povm_matrix": [[0.5, 0.5, 0, 0]], "outcomes": [[1, 2]]}
    p.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="povm_matrix"):
        state_interval.main(["-i", str(p)])


@pytest.mark.parametrize("interval", ["sugiyama", "bootstrap", "mhmc", "polytope"])
def test_state_cli_interval_selector(state_fixture, tmp_path, interval):
    path, tmg = state_fixture
    out_path = tmp_path / f"out_{interval}.json"
    state_interval.main(
        ["-i", str(path), "-o", str(out_path), "--interval", interval,
         "--n-points", "64", "--method", "mle-rhor"]
    )
    out = json.loads(out_path.read_text())
    r = np.asarray(out["hs_radius"])
    assert r.shape == (3,)
    assert np.all(np.isfinite(r)) and np.all(r >= 0)
    fmin, fmax = np.asarray(out["fidelity_min"]), np.asarray(out["fidelity_max"])
    assert np.all(fmin <= fmax + 1e-6)


def test_state_cli_kron_record(tmp_path):
    """A 5-qubit kron-mode record runs the full pipeline without ever
    materializing the measurement matrix (round-2 plan item)."""
    from quantpy_tpu.measurements import _single_qubit_preset
    from quantpy_tpu.tomography import kron_core

    import jax

    n = 5
    block = _single_qubit_preset("proj-set")
    state = qt.GHZ(n)
    counts = np.asarray(
        kron_core.kron_simulate(
            jax.random.key(55), block, np.asarray(state.bloch, np.float64), 2000.0
        )
    )
    doc = {
        "povm_kron": block.tolist(),
        "n_qubits": n,
        "outcomes": counts.astype(int).tolist(),
        "target_state": np.asarray(state.bloch).tolist(),
        "conf_levels": [0.5, 0.9],
    }
    p = tmp_path / "kron.json"
    p.write_text(json.dumps(doc))
    out_path = tmp_path / "kron_out.json"
    state_interval.main(
        ["-i", str(p), "-o", str(out_path), "--method", "mle-rhor",
         "--interval", "bootstrap", "--n-points", "32"]
    )
    out = json.loads(out_path.read_text())
    est = qt.Qobj(np.asarray(out["state"]))
    assert float(qt.hs_dst(est, state)) < 0.2
    assert np.all(np.isfinite(out["hs_radius"]))
    fmin, fmax = np.asarray(out["fidelity_min"]), np.asarray(out["fidelity_max"])
    assert np.all(fmin <= fmax + 1e-6)
    # sugiyama + moment radii also work on the factored record
    out2 = state_interval.run(doc, interval="sugiyama", method="lin")
    assert np.all(np.isfinite(out2["hs_radius"]))
    # mhmc needs the dense design: actionable error, not a crash
    with pytest.raises(ValueError, match="mhmc"):
        state_interval.run(doc, interval="mhmc")


def test_process_cli_method_selector(tmp_path):
    """--method pgdb/states on a synthesized 1-qubit QPT record."""
    from quantpy_tpu.channel import depolarizing

    tmg = qt.ProcessTomograph(depolarizing(0.35), key=71)
    tmg.experiment(4000, "proj-set")
    doc = {
        "povm_matrix": tmg.tomographs[0].povm_matrix.tolist(),
        "input_states": [np.asarray(s.bloch).tolist()
                         for s in tmg.input_basis.elements],
        "outcomes": [t.results.astype(int).tolist() for t in tmg.tomographs],
        "target_process": np.asarray(depolarizing(0.35).choi.bloch).tolist(),
        "conf_levels": [0.5, 0.9],
    }
    for method, interval in [("pgdb", "moment"), ("states", "bootstrap")]:
        out = process_interval.run(
            doc, method=method, interval=interval, n_points=16
        )
        choi = np.asarray(out["process"])
        assert abs(choi[0] - 0.5) < 0.05  # TP coordinate
        assert np.all(np.isfinite(out["hs_radius"]))
