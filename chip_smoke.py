"""Smoke run of the tomography main path on NVIDIA GPUs.

    python chip_smoke.py               # one card: phases 1-6 below
    python chip_smoke.py --devices 4   # four cards: device check + mesh phase

Phases, in one process:

1. device check: refuse anything but a GPU; print the card, its power
   limit, the JAX version and the matmul precision in force;
2. the flagship state bootstrap (GHZ(4), proj-set, 10^4 shots per POVM,
   16,384 resamples of RrhoR-60): set-up and steady-state time, rate,
   distance quantiles, peak device memory;
3. the compiled RrhoR sandwich kernel against its XLA twin at every width
   it takes, and the flagship RrhoR-60 against a plain float64 NumPy RrhoR on
   256 resamples (max |delta bloch| <= 5e-5), and that maximum under TF32;
4. the 4-qubit process bootstrap (depolarizing(0.1), 2000 shots, 256
   resamples);
5. the kron-factored path at 10 qubits: simulate, lin, MLE-60, bootstrap;
6. the state CLI on examples/data/ghz2_state_record.json.

With ``--devices N`` only the mesh phase runs: the sharded flagship
bootstrap and the operator-sharded kron estimators against their one-card
twins, then ``__graft_entry__.dryrun_multichip(N)``.

Any failed check raises, so the process exits non-zero. The last line of
standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CLI_RECORD = ROOT / "examples" / "data" / "ghz2_state_record.json"
CLI_OUT = ROOT / "smoke_out" / "chip_smoke_cli.json"

#: flagship agreement bar, f32 at 'highest' against float64 NumPy
MLE_REFERENCE_ATOL = 5e-5


def require_gpu(devices):
    """Return `devices` if the first is a GPU; otherwise exit non-zero.

    There is no CPU fallback: a smoke run that finds no card has nothing
    to report."""
    devices = list(devices)
    if not devices or devices[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU found; JAX sees {devices}")
    return devices


def card_lines() -> list[str]:
    """`name, power.limit` of every card, from nvidia-smi (a child process
    that does not import JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def _timed(fn, *args, **kwargs):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kwargs))
    return out, time.perf_counter() - t0


def _peak_bytes(device) -> int | None:
    stats = device.memory_stats()
    return None if stats is None else int(stats.get("peak_bytes_in_use", 0))


def _pauli_strings(dim: int) -> np.ndarray:
    """(dim^2, dim, dim) Pauli strings, I/X/Y/Z per qubit, first qubit
    most significant."""
    one = np.array(
        [[[1, 0], [0, 1]], [[0, 1], [1, 0]], [[0, -1j], [1j, 0]], [[1, 0], [0, -1]]],
        dtype=np.complex128,
    )
    basis = np.ones((1, 1, 1), dtype=np.complex128)
    while basis.shape[-1] < dim:
        d = basis.shape[-1] * 2
        basis = np.einsum("aij,bkl->abikjl", basis, one).reshape(-1, d, d)
    return basis


def rhor_reference(counts, povm_matrix, n_measurements, init_bloch, n_iter: int):
    """Plain float64 NumPy RrhoR MLE, batched over the leading axis.

    Effects E_k are the POVM rows weighted by each POVM's shot share, so
    they sum to the identity; from rho_0 = 0.95 rho_init + 0.05 I/d,
    R = sum_k (f_k / p_k) E_k and rho <- R rho R / tr, for exactly
    `n_iter` steps. Returns bloch vectors (b_i = Re tr(P_i rho) / d)."""
    counts = np.asarray(counts, np.float64)
    povm = np.asarray(povm_matrix, np.float64)
    n_meas = np.asarray(n_measurements, np.float64)
    init = np.asarray(init_bloch, np.float64)
    dim = int(round(np.sqrt(povm.shape[-1])))
    paulis = _pauli_strings(dim)
    w = n_meas / n_meas.sum()
    effects = np.einsum("mod,dij->moij", povm * w[:, None, None], paulis)
    effects = effects.reshape(-1, dim, dim)
    freq = counts.reshape(counts.shape[0], -1)
    freq = freq / freq.sum(-1, keepdims=True)
    rho = 0.95 * np.einsum("bd,dij->bij", init, paulis) + 0.05 * np.eye(dim) / dim
    for _ in range(n_iter):
        probs = np.einsum("kji,bij->bk", effects, rho).real
        r = np.einsum("bk,kij->bij", freq / np.clip(probs, 1e-10, None), effects)
        rho = r @ rho @ r
        rho = rho / np.trace(rho, axis1=1, axis2=2).real[:, None, None]
    return np.einsum("dji,bij->bd", paulis, rho).real / dim


def phase_flagship(label: str, n_qubits=4, n_shots=10_000, n_points=16_384,
                   max_iter=60, n_calls=3, seed=2026):
    """StateTomograph + point estimates + bootstrap_distances at the
    flagship size. Returns the tomograph and the numbers it printed."""
    import jax
    import jax.numpy as jnp

    import quantpy_tpu as qt
    from quantpy_tpu.tomography.bootstrap_core import bootstrap_distances

    tmg = qt.StateTomograph(qt.GHZ(n_qubits), key=seed)
    tmg.experiment(n_shots, "proj-set")
    lin = tmg.point_estimate("lin")
    est = tmg.point_estimate("mle-rhor")
    if_lin = float(qt.if_dst(lin, tmg.state))
    if_mle = float(qt.if_dst(est, tmg.state))
    print(f"[{label}] flagship point estimates: infidelity lin {if_lin:.3e}, "
          f"mle-rhor {if_mle:.3e}")
    assert np.isfinite(if_mle) and if_mle < 0.1, if_mle

    args = (
        jnp.asarray(est.bloch, jnp.float32),
        jnp.asarray(tmg.povm_matrix, jnp.float32),
        jnp.asarray(tmg.n_measurements, jnp.float32),
    )
    static = dict(n_points=n_points, method="mle-rhor", dst="hs", max_iter=max_iter)
    t0 = time.perf_counter()
    bootstrap_distances.lower(jax.random.key(0), *args, **static).compile()
    compile_s = time.perf_counter() - t0
    _, first_s = _timed(bootstrap_distances, jax.random.key(0), *args, **static)
    times = []
    for i in range(1, n_calls + 1):
        d, dt = _timed(bootstrap_distances, jax.random.key(i), *args, **static)
        times.append(dt)
    d = np.asarray(d)
    assert d.shape == (n_points,) and np.isfinite(d).all(), d
    step_s = float(np.median(times))
    rate = n_points / step_s
    median, p95 = float(np.median(d)), float(np.quantile(d, 0.95))
    assert 0.0 < median < 0.1, median
    peak = _peak_bytes(jax.devices()[0])
    print(f"[{label}] flagship bootstrap {n_qubits}q x {n_points} resamples, "
          f"RrhoR-{max_iter}: compile {compile_s:.2f} s (set-up), first call "
          f"{first_s:.3f} s, steady {[f'{t:.4f}' for t in times]} s/call")
    print(f"[{label}] flagship rate {rate:.1f} resamples/s (median of "
          f"{n_calls} calls); distance median {median:.5f} p95 {p95:.5f}; "
          f"peak_bytes_in_use {peak}")
    return {
        "tmg": tmg, "compile_s": compile_s, "times": times, "rate": rate,
        "median": median, "p95": p95, "peak_bytes": peak,
    }


def phase_mle_reference(label: str, tmg, n_resamples=256, max_iter=60, seed=1,
                        tf32: bool = True):
    """Flagship RrhoR in f32 at the precision in force against the
    float64 NumPy reference, on one shared draw of counts."""
    import jax

    from quantpy_tpu.tomography import state_core

    counts = tmg.simulate_batch(n_resamples, key=jax.random.key(seed))
    povm, n_meas = tmg.povm_matrix, tmg.n_measurements
    lin_init = state_core.estimate_lin(counts, povm, n_meas, physical=True)

    def run():
        return state_core.estimate_mle_rhor(
            counts, povm, n_meas, init_bloch=lin_init, max_iter=max_iter, tol=0.0
        )

    ours = np.asarray(jax.block_until_ready(run()))
    ref = rhor_reference(counts, povm, n_meas, lin_init, max_iter)
    err = float(np.abs(ours - ref).max())
    print(f"[{label}] RrhoR-{max_iter} f32 ({jax.config.jax_default_matmul_precision}) "
          f"vs float64 NumPy on {n_resamples} resamples: max |d bloch| {err:.3e} "
          f"(bar {MLE_REFERENCE_ATOL:.0e})")
    err_tf32 = None
    if tf32:
        with jax.default_matmul_precision("tensorfloat32"):
            ours_tf32 = np.asarray(jax.block_until_ready(run()))
        err_tf32 = float(np.abs(ours_tf32 - ref).max())
        print(f"[{label}] same under tensorfloat32 (not asserted): "
              f"max |d bloch| {err_tf32:.3e}")
    assert err <= MLE_REFERENCE_ATOL, err
    return {"max_err": err, "max_err_tf32": err_tf32}


def phase_kernel(label: str, n_resamples=16_384, dim=16, seed=3, interpret=False,
                 n_calls=20):
    """The compiled RrhoR sandwich kernel against its XLA twin at width
    `dim` (16 is the flagship's), on well-conditioned Hermitian re/im
    pairs; times are medians of `n_calls` calls after a warm-up."""
    import functools

    import jax
    import jax.numpy as jnp

    from quantpy_tpu.ops.rhor_sandwich import rhor_sandwich, rhor_sandwich_xla

    k = jax.random.split(jax.random.key(seed), 4)
    shape = (n_resamples, dim, dim)

    def part(key, scale, sign):
        a = jax.random.normal(key, shape, jnp.float32)
        return scale * (a + sign * jnp.swapaxes(a, -1, -2))

    eye = jnp.eye(dim, dtype=jnp.float32)
    args = (eye + part(k[0], 0.05, 1), part(k[1], 0.05, -1),
            eye / dim + part(k[2], 0.01, 1), part(k[3], 0.01, -1))
    def median_s(fn):
        out, _ = _timed(fn, *args)
        return out, float(np.median([_timed(fn, *args)[1] for _ in range(n_calls)]))

    ours, t_kernel = median_s(functools.partial(rhor_sandwich, interpret=interpret))
    ref, t_xla = median_s(jax.jit(rhor_sandwich_xla))
    err = max(float(jnp.abs(a - b).max()) for a, b in zip(ours, ref))
    print(f"[{label}] sandwich kernel ({n_resamples} x {dim}x{dim}): "
          f"{1e3 * t_kernel:.4f} ms vs XLA {1e3 * t_xla:.4f} ms (median of "
          f"{n_calls} calls each, host clock); max |kernel - XLA| {err:.3e} "
          f"(bar 1e-6)")
    assert err <= 1e-6, err
    return {"max_err": err}


def phase_process(label: str, n_qubits=4, n_shots=2000, n_points=256, seed=7):
    """ProcessTomograph + lifp + BootstrapProcessInterval: the first
    interval pays the compile, the second is timed in steady state."""
    import jax

    import quantpy_tpu as qt
    from quantpy_tpu.channel import depolarizing

    ptmg = qt.ProcessTomograph(depolarizing(0.1, n_qubits), key=seed)
    ptmg.experiment(n_shots)
    ptmg.point_estimate("lifp")
    t0 = time.perf_counter()
    qt.BootstrapProcessInterval(
        ptmg, n_points=n_points, key=jax.random.key(seed + 1)
    ).setup()
    first_s = time.perf_counter() - t0
    iv = qt.BootstrapProcessInterval(
        ptmg, n_points=n_points, key=jax.random.key(seed + 2)
    )
    t0 = time.perf_counter()
    iv.setup()
    steady_s = time.perf_counter() - t0
    levels = iv.cl_to_dist(np.linspace(0.0, 1.0, n_points))
    finite = bool(np.isfinite(levels).all())
    median = float(iv.cl_to_dist(0.5))
    print(f"[{label}] process bootstrap {n_qubits}q x {n_points}: first interval "
          f"(compile + run) {first_s:.2f} s, second {steady_s:.3f} s "
          f"({n_points / steady_s:.1f} resamples/s); distances finite {finite}, "
          f"median {median:.5f}")
    assert finite and 0.0 < median < 1.0, (finite, median)
    return {"first_s": first_s, "steady_s": steady_s, "median": median}


def _hs_to_truth(est, truth, n_qubits: int) -> float:
    diff = np.asarray(est, np.float64) - np.asarray(truth, np.float64)
    return float(np.sqrt((2**n_qubits) * np.sum(diff**2) / 2.0))


def phase_kron(label: str, n_qubits=10, n_shots=10_000.0, n_points=16,
               max_iter=60, seed=6):
    """kron_simulate / kron_estimate_lin / kron_estimate_mle_rhor /
    kron_bootstrap_distances at `n_qubits` on one card."""
    import jax
    import jax.numpy as jnp

    import quantpy_tpu as qt
    from quantpy_tpu.measurements import _single_qubit_preset
    from quantpy_tpu.tomography import kron_core

    povm1 = jnp.asarray(_single_qubit_preset("proj-set"), jnp.float32)
    truth = jnp.asarray(qt.GHZ(n_qubits).bloch, jnp.float32)
    out = {}
    counts, out["simulate_s"] = _timed(
        kron_core.kron_simulate, jax.random.key(seed), povm1, truth, n_shots
    )
    lin, out["lin_first_s"] = _timed(kron_core.kron_estimate_lin, counts, povm1, n_qubits)
    lin, out["lin_s"] = _timed(kron_core.kron_estimate_lin, counts, povm1, n_qubits)
    mle, out["mle_first_s"] = _timed(
        kron_core.kron_estimate_mle_rhor, counts, povm1, n_qubits, max_iter=max_iter
    )
    mle, out["mle_s"] = _timed(
        kron_core.kron_estimate_mle_rhor, counts, povm1, n_qubits, max_iter=max_iter
    )
    out["lin_hs"] = _hs_to_truth(lin, truth, n_qubits)
    out["mle_hs"] = _hs_to_truth(mle, truth, n_qubits)

    def boot(key):
        return kron_core.kron_bootstrap_distances(
            key, mle, povm1, n_qubits, n_shots, n_points=n_points,
            method="mle", dst="hs", max_iter=max_iter,
        )

    _, out["boot_first_s"] = _timed(boot, jax.random.key(seed + 1))
    d, out["boot_s"] = _timed(boot, jax.random.key(seed + 2))
    d = np.asarray(d)
    print(f"[{label}] kron {n_qubits}q: simulate {out['simulate_s']:.3f} s, lin "
          f"{out['lin_s']:.4f} s (first {out['lin_first_s']:.2f}), MLE-{max_iter} "
          f"{out['mle_s']:.4f} s (first {out['mle_first_s']:.2f}); hs-to-truth lin "
          f"{out['lin_hs']:.4f}, mle {out['mle_hs']:.4f}")
    print(f"[{label}] kron {n_qubits}q bootstrap x {n_points}: {out['boot_s']:.3f} s "
          f"(first {out['boot_first_s']:.2f}), {n_points / out['boot_s']:.2f} "
          f"resamples/s, distance median {np.median(d):.5f}")
    assert np.isfinite(np.asarray(mle)).all() and out["mle_hs"] < 0.5, out
    assert d.shape == (n_points,) and np.isfinite(d).all(), d
    return out


def phase_cli(label: str, record=CLI_RECORD, out_path=CLI_OUT):
    """state_interval.main on a real-record fixture, in this process."""
    from quantpy_tpu.cli import state_interval

    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    state_interval.main(["-i", str(record), "-o", str(out_path)])
    elapsed = time.perf_counter() - t0
    out = json.loads(out_path.read_text())
    assert {"state", "hs_radius"} <= set(out), sorted(out)
    assert np.isfinite(out["state"]).all() and np.isfinite(out["hs_radius"]).all()
    print(f"[{label}] state CLI on {Path(record).name}: {elapsed:.2f} s, "
          f"keys {sorted(out)}, hs_radius {out['hs_radius']}")
    return out


def _device_ids(arr) -> list[int]:
    return sorted(s.device.id for s in arr.addressable_shards)


def phase_mesh(label: str, n_devices=4, n_qubits=4, n_shots=10_000,
               n_points=16_384, max_iter=60, kron_qubits=10, seed=11):
    """The mesh paths of parallel/mesh.py against their one-card twins."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__
    import quantpy_tpu as qt
    from quantpy_tpu.measurements import _single_qubit_preset
    from quantpy_tpu.parallel import (
        make_mesh,
        sharded_bootstrap_distances,
        sharded_kron_estimate_lin,
        sharded_kron_estimate_mle_rhor,
        sharded_kron_simulate,
    )
    from quantpy_tpu.tomography import kron_core
    from quantpy_tpu.tomography.bootstrap_core import bootstrap_distances

    mesh = make_mesh(n_devices)
    assert mesh.devices.size == n_devices, mesh

    # data-parallel flagship bootstrap: n_points / n_devices per card
    tmg = qt.StateTomograph(qt.GHZ(n_qubits), key=seed)
    tmg.experiment(n_shots, "proj-set")
    est = tmg.point_estimate("mle-rhor")
    args = (
        jnp.asarray(est.bloch, jnp.float32),
        jnp.asarray(tmg.povm_matrix, jnp.float32),
        jnp.asarray(tmg.n_measurements, jnp.float32),
    )
    d_sh, first_s = _timed(
        sharded_bootstrap_distances, mesh, jax.random.key(seed), *args,
        n_points=n_points, method="mle-rhor", max_iter=max_iter,
    )
    d_sh, sh_s = _timed(
        sharded_bootstrap_distances, mesh, jax.random.key(seed + 1), *args,
        n_points=n_points, method="mle-rhor", max_iter=max_iter,
    )
    sh_devices = _device_ids(d_sh)
    d_1, one_s = _timed(
        bootstrap_distances, jax.random.key(seed + 2), *args,
        n_points=n_points, method="mle-rhor", max_iter=max_iter,
    )
    d_1, one_s = _timed(
        bootstrap_distances, jax.random.key(seed + 3), *args,
        n_points=n_points, method="mle-rhor", max_iter=max_iter,
    )
    med_sh, med_1 = float(np.median(np.asarray(d_sh))), float(np.median(np.asarray(d_1)))
    rel = abs(med_sh - med_1) / med_1
    # parallel/mesh.py jits a fresh closure on every call, so the second
    # sharded call still traces and lowers (its compile comes from cache)
    print(f"[{label}] sharded bootstrap {n_qubits}q x {n_points} on {n_devices} "
          f"devices (shards on {sh_devices}): second call {sh_s:.4f} s incl. "
          f"retrace (first {first_s:.2f} s); one card steady "
          f"{one_s:.4f} s ({n_points / one_s:.1f} resamples/s); medians "
          f"{med_sh:.5f} vs {med_1:.5f} (rel diff {rel:.4f}, bar 0.05)")
    assert len(sh_devices) == n_devices, sh_devices
    assert np.isfinite(np.asarray(d_sh)).all() and rel < 0.05, (med_sh, med_1)

    # operator-sharded kron estimators: the counts are born sharded
    povm1 = jnp.asarray(_single_qubit_preset("proj-set"), jnp.float32)
    truth = jnp.asarray(qt.GHZ(kron_qubits).bloch, jnp.float32)
    counts_sh, sim_s = _timed(
        sharded_kron_simulate, mesh, jax.random.key(seed + 4), povm1, truth,
        float(n_shots),
    )
    counts_devices = _device_ids(counts_sh)
    shard_shapes = sorted({tuple(s.data.shape) for s in counts_sh.addressable_shards})
    print(f"[{label}] sharded kron simulate {kron_qubits}q: {sim_s:.3f} s, counts "
          f"{tuple(counts_sh.shape)} sharded on devices {counts_devices} as "
          f"{shard_shapes}")
    assert len(counts_devices) == n_devices, counts_devices
    counts = np.asarray(counts_sh)
    lin_sh, lin_sh_s = _timed(sharded_kron_estimate_lin, mesh, counts, povm1, kron_qubits)
    lin_1, lin_1_s = _timed(kron_core.kron_estimate_lin, counts, povm1, kron_qubits)
    lin_sh, lin_1 = np.asarray(lin_sh), np.asarray(lin_1)
    mle_sh, mle_sh_s = _timed(
        sharded_kron_estimate_mle_rhor, mesh, counts, povm1, kron_qubits,
        max_iter=max_iter, tol=0.0,
    )
    mle_1, mle_1_s = _timed(
        kron_core.kron_estimate_mle_rhor, counts, povm1, kron_qubits,
        max_iter=max_iter, tol=0.0,
    )
    mle_sh, mle_1 = np.asarray(mle_sh), np.asarray(mle_1)
    print(f"[{label}] sharded kron {kron_qubits}q lin {lin_sh_s:.3f} s vs one card "
          f"{lin_1_s:.3f} s, max|diff| {np.abs(lin_sh - lin_1).max():.3e}; "
          f"MLE-{max_iter} {mle_sh_s:.3f} s vs {mle_1_s:.3f} s, max|diff| "
          f"{np.abs(mle_sh - mle_1).max():.3e} (first calls, compile included)")
    np.testing.assert_allclose(lin_sh, lin_1, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(mle_sh, mle_1, rtol=1e-5, atol=1e-7)

    peaks = [_peak_bytes(dev) for dev in mesh.devices.flat]
    print(f"[{label}] peak_bytes_in_use per device: {peaks}")
    if all(p is not None for p in peaks):
        assert all(p > 0 for p in peaks), peaks

    __graft_entry__.dryrun_multichip(n_devices)
    return {"median_rel": rel, "devices": sh_devices}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--devices", type=int, default=1,
        help="1: the one-card phases; N > 1: only the mesh phase on N cards",
    )
    args = parser.parse_args(argv)

    import jax

    devices = require_gpu(jax.devices())
    if len(devices) < args.devices:
        raise SystemExit(f"chip_smoke: {args.devices} devices asked, {len(devices)} found")
    cards = card_lines()
    label = cards[0]
    print(f"device: {devices[0].device_kind} x {len(devices)} "
          f"(using {args.devices}); nvidia-smi name, power.limit:")
    for line in cards:
        print(f"  {line}")

    import quantpy_tpu  # noqa: F401  (pins matmul precision to 'highest')
    from quantpy_tpu.config import use_compile_cache

    cache = use_compile_cache()
    print(f"jax {jax.__version__}; matmul precision "
          f"{jax.config.jax_default_matmul_precision}; compile cache {cache}")

    if args.devices > 1:
        phase_mesh(label, n_devices=args.devices)
    else:
        from quantpy_tpu.ops.rhor_sandwich import KERNEL_DIMS

        flagship = phase_flagship(label)
        for dim in KERNEL_DIMS:
            phase_kernel(label, dim=dim)
        phase_mle_reference(label, flagship["tmg"])
        phase_process(label)
        phase_kron(label)
        phase_cli(label)

    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": args.devices,
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
