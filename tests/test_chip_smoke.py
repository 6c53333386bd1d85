"""chip_smoke.py on the CPU: its device check, its float64 RrhoR reference,
and a tiny rehearsal of its phases (called directly, past the device
check)."""

import json

import numpy as np
import pytest

import chip_smoke
import quantpy_tpu as qt
from quantpy_tpu.config import enable_x64
from quantpy_tpu.tomography import state_core


class _Device:
    def __init__(self, platform):
        self.platform = platform


def test_device_check_refuses_cpu():
    import jax

    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.require_gpu(jax.devices())
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu([])
    gpus = [_Device("gpu")]
    assert chip_smoke.require_gpu(gpus) == gpus


def test_main_exits_before_any_phase_without_gpu(capsys):
    with pytest.raises(SystemExit):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


@pytest.fixture(scope="module")
def flagship_counts():
    """Flagship-shaped 4-qubit counts: proj-set, 10^4 shots, 8 resamples."""
    import jax

    tmg = qt.StateTomograph(qt.GHZ(4), key=55)
    tmg.experiment(10_000, "proj-set")
    counts = np.asarray(tmg.simulate_batch(8, key=jax.random.key(3)))
    return tmg, counts


@pytest.mark.parametrize("x64, atol", [(True, 1e-10), (False, 5e-5)])
def test_rhor_reference_matches_estimate_mle_rhor(flagship_counts, x64, atol):
    """float64 NumPy RrhoR vs state_core.estimate_mle_rhor, 40 iterations,
    tol=0 (no early stop). f32 is held to the flagship bar of 5e-5."""
    tmg, counts = flagship_counts
    enable_x64(x64)
    try:
        dtype = np.float64 if x64 else np.float32
        init = np.asarray(
            state_core.estimate_lin(
                counts.astype(dtype), tmg.povm_matrix, tmg.n_measurements
            )
        )
        ours = np.asarray(
            state_core.estimate_mle_rhor(
                counts.astype(dtype), tmg.povm_matrix, tmg.n_measurements,
                init_bloch=init, max_iter=40, tol=0.0,
            )
        )
    finally:
        enable_x64(True)
    ref = chip_smoke.rhor_reference(
        counts, tmg.povm_matrix, tmg.n_measurements, init, 40
    )
    assert ours.shape == ref.shape == (8, 256)
    np.testing.assert_allclose(ours, ref, atol=atol)
    np.testing.assert_allclose(ref[:, 0], 1 / 16, atol=1e-12)


def test_flagship_phase_rehearsal():
    out = chip_smoke.phase_flagship(
        "cpu", n_qubits=2, n_shots=1000, n_points=16, max_iter=20, n_calls=1
    )
    assert out["rate"] > 0 and len(out["times"]) == 1
    assert 0.0 < out["median"] <= out["p95"] < 0.1
    mle = chip_smoke.phase_mle_reference(
        "cpu", out["tmg"], n_resamples=4, max_iter=20, tf32=False
    )
    assert mle["max_err"] <= chip_smoke.MLE_REFERENCE_ATOL


@pytest.mark.parametrize("dim", [16, 32])
def test_kernel_phase_rehearsal(dim):
    out = chip_smoke.phase_kernel(
        "cpu", n_resamples=8, dim=dim, interpret=True, n_calls=2
    )
    assert out["max_err"] <= 1e-6


def test_cli_phase_rehearsal(tmp_path):
    out_path = tmp_path / "cli.json"
    out = chip_smoke.phase_cli("cpu", out_path=out_path)
    assert json.loads(out_path.read_text()) == out
    assert len(out["state"]) == 16 and len(out["hs_radius"]) >= 1
