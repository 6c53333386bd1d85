"""Flagship benchmark: bootstrapped 4-qubit MLE reconstructions per second.

Reference baseline (BASELINE.md): a single 4-qubit MLE reconstruction takes
~18 s (scipy BFGS, finite differences) => ~0.055 rec/s; a 1000-resample
bootstrap takes ~5 h.

Workload (matches the reference's own time-test config,
examples/state_tomography.ipynb cells 12-16): proj-set POVM (81 POVMs x 16
outcomes), 10^4 shots per POVM, 4-qubit GHZ state. Each bootstrap resample =
simulate a full experiment + maximum-likelihood reconstruction (RrhoR
fixed-point, 60 iterations) + Hilbert-Schmidt distance.

Needs a GPU. Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "reconstructions/sec", "vs_baseline": N,
   "device": {...}, "extras": {...}}
vs_baseline is the speedup over the reference's ~0.055 rec/s. A failed
secondary section is recorded in `extras` as "<name>_error" and makes the
run exit non-zero after the JSON line.
"""

import json
import sys
import time

import numpy as np

N_QUBITS = 4
N_SHOTS = 10_000
N_POINTS = 16384  # bootstrap resamples per timed call
MLE_ITERS = 60
REFERENCE_REC_PER_SEC = 1.0 / 18.0  # BASELINE.md: ~18 s per 4-qubit MLE


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def timed(fn, *args, **kwargs):
    """(result, seconds), the result waited for with block_until_ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kwargs))
    return out, time.perf_counter() - t0


def secondary_kron_6q(extras):
    """6-qubit kron-factored linear inversion and MLE bootstrap."""
    import jax
    import jax.numpy as jnp

    import quantpy_tpu as qt
    from quantpy_tpu.measurements import _single_qubit_preset
    from quantpy_tpu.tomography import kron_core

    povm1 = jnp.asarray(_single_qubit_preset("proj-set"), jnp.float32)
    b6 = jnp.asarray(qt.GHZ(6).bloch, jnp.float32)
    c6 = kron_core.kron_simulate(jax.random.key(6), povm1, b6, 10_000.0)
    r, _ = timed(kron_core.kron_estimate_lin, c6, povm1, 6)  # compile
    _, lin6_s = timed(kron_core.kron_estimate_lin, c6, povm1, 6)
    extras["state_lin_6q_ms"] = round(1000 * lin6_s, 3)
    log(f"secondary: 6-qubit linear inversion {1000 * lin6_s:.3f} ms")

    def run6(key):
        return kron_core.kron_bootstrap_distances(
            key, r, povm1, 6, 10_000.0,
            n_points=256, method="mle", dst="hs", max_iter=60,
        )

    timed(run6, jax.random.key(60))  # compile
    _, boot_s = timed(run6, jax.random.key(61))
    extras["state_boot_6q_mle_rec_s"] = round(256 / boot_s, 1)
    log(f"secondary: 6-qubit MLE bootstrap {256 / boot_s:.1f} rec/s (256 resamples)")


def secondary_scaling(extras):
    """State scaling rows (2-11 qubits): one kron-factored lin + MLE-60
    reconstruction each, steady state."""
    import jax
    import jax.numpy as jnp

    import quantpy_tpu as qt
    from quantpy_tpu.measurements import _single_qubit_preset
    from quantpy_tpu.tomography import kron_core
    from quantpy_tpu.tomography.bootstrap_core import _distance_batch

    povm1 = jnp.asarray(_single_qubit_preset("proj-set"), jnp.float32)
    scaling = {}
    for n in (2, 4, 6, 8, 10, 11):
        bn = jnp.asarray(qt.GHZ(n).bloch, jnp.float32)
        row = {}
        key = jax.random.key(100 + n)
        if 6**n > kron_core.CHUNKED_CHAIN_VOLUME:
            # the host-chunked draw StateTomograph.experiment uses above
            # this volume (ROADMAP C1)
            cn, sim_s = timed(kron_core.kron_simulate_chunked, key, povm1, bn, 10_000.0)
            row["simulate_chunked_s"] = round(sim_s, 3)
        else:
            cn = kron_core.kron_simulate(key, povm1, bn, 10_000.0)
        timed(kron_core.kron_estimate_lin, cn, povm1, n)  # compile
        _, lin_s = timed(kron_core.kron_estimate_lin, cn, povm1, n)
        row["lin_ms"] = round(1000 * lin_s, 3)
        timed(kron_core.kron_estimate_mle_rhor, cn, povm1, n, max_iter=60)  # compile
        est_n, mle_s = timed(kron_core.kron_estimate_mle_rhor, cn, povm1, n, max_iter=60)
        row["mle60_ms"] = round(1000 * mle_s, 3)
        row["mle_hs"] = round(float(np.asarray(_distance_batch("hs", est_n, bn, n))), 4)
        scaling[str(n)] = row
        log(f"secondary: {n}-qubit lin {row['lin_ms']} ms, "
            f"MLE-60 {row['mle60_ms']} ms, hs-to-truth {row['mle_hs']}")
    extras["state_scaling_kron"] = scaling


def secondary_boot_10q(extras):
    """10-qubit kron-factored MLE bootstrap throughput (16 resamples)."""
    import jax
    import jax.numpy as jnp

    import quantpy_tpu as qt
    from quantpy_tpu.measurements import _single_qubit_preset
    from quantpy_tpu.tomography import kron_core

    povm1 = jnp.asarray(_single_qubit_preset("proj-set"), jnp.float32)
    b10 = jnp.asarray(qt.GHZ(10).bloch, jnp.float32)
    c10 = kron_core.kron_simulate(jax.random.key(110), povm1, b10, 10_000.0)
    r10 = jax.block_until_ready(kron_core.kron_estimate_lin(c10, povm1, 10))

    def run10(key):
        return kron_core.kron_bootstrap_distances(
            key, r10, povm1, 10, 10_000.0,
            n_points=16, method="mle", dst="hs", max_iter=60,
        )

    timed(run10, jax.random.key(120))  # compile
    d10, boot_s = timed(run10, jax.random.key(121))
    extras["state_boot_10q_mle_rec_s"] = round(16 / boot_s, 3)
    log(f"secondary: 10-qubit MLE bootstrap {16 / boot_s:.3f} rec/s "
        f"(16 resamples, d50={np.median(np.asarray(d10)):.4f})")


def secondary_process_4q(extras):
    """4-qubit process bootstrap: 81 POVMs x 2000 shots per input state,
    256 resamples. The first setup() pays the compile; the second interval
    is timed in steady state."""
    import jax

    import quantpy_tpu as qt
    from quantpy_tpu.channel import depolarizing
    from quantpy_tpu.tomography.process import ProcessTomograph

    ptmg = ProcessTomograph(depolarizing(0.1, 4), key=7)
    ptmg.experiment(2_000)
    ptmg.point_estimate("lifp")
    qt.BootstrapProcessInterval(ptmg, n_points=256, key=jax.random.key(8)).setup()
    iv = qt.BootstrapProcessInterval(ptmg, n_points=256, key=jax.random.key(9))
    t0 = time.perf_counter()
    iv.setup()
    rec_p = 256 / (time.perf_counter() - t0)
    extras["process_boot_4q_rec_s"] = round(rec_p, 2)
    log(f"secondary: 4-qubit process bootstrap {rec_p:.2f} rec/s "
        "(256 resamples, steady state)")


SECONDARIES = (
    ("kron_6q", secondary_kron_6q),
    ("scaling", secondary_scaling),
    ("boot_10q", secondary_boot_10q),
    ("process_4q", secondary_process_4q),
)


def main():
    import jax
    import jax.numpy as jnp

    import chip_smoke
    import quantpy_tpu as qt
    from quantpy_tpu.config import use_compile_cache
    from quantpy_tpu.tomography.bootstrap_core import bootstrap_distances
    from quantpy_tpu.tomography.state import StateTomograph

    devices = chip_smoke.require_gpu(jax.devices())
    cards = chip_smoke.card_lines()
    log(f"device: {devices[0].device_kind} x {len(devices)}; card: {cards[0]}")
    use_compile_cache()

    state = qt.GHZ(N_QUBITS)
    tmg = StateTomograph(state, key=2026)
    tmg.experiment(N_SHOTS, "proj-set")
    est = tmg.point_estimate("mle-rhor")
    log(f"point estimate infidelity vs truth: {float(qt.if_dst(est, state)):.2e}")

    bloch = jnp.asarray(est.bloch, jnp.float32)
    povm = jnp.asarray(tmg.povm_matrix, jnp.float32)
    n_meas = jnp.asarray(tmg.n_measurements, jnp.float32)

    def run(key):
        return bootstrap_distances(
            key, bloch, povm, n_meas,
            n_points=N_POINTS, method="mle-rhor", dst="hs", max_iter=MLE_ITERS,
        )

    _, first_s = timed(run, jax.random.key(0))
    log(f"compile + first run: {first_s:.2f} s")
    times = []
    for i in range(1, 4):
        d, dt = timed(run, jax.random.key(i))
        times.append(dt)
    best = min(times)
    value = N_POINTS / best
    d = np.asarray(d)
    log(f"steady-state times [{cards[0]}]: {[f'{t:.4f}' for t in times]}")
    log(
        f"bootstrap distance stats: median={np.median(d):.4f} "
        f"p95={np.quantile(d, 0.95):.4f} (all finite: {bool(np.isfinite(d).all())})"
    )

    extras = {
        "mle_iters": MLE_ITERS,
        "n_points": N_POINTS,
        "first_call_s": round(first_s, 3),
        "steady_s": [round(t, 5) for t in times],
    }
    failed = []
    for name, section in SECONDARIES:
        try:
            section(extras)
        except Exception as e:  # recorded, and the run exits non-zero
            extras[f"{name}_error"] = repr(e)
            failed.append(name)
            log(f"secondary {name} FAILED: {e!r}")

    print(
        json.dumps(
            {
                "metric": "bootstrapped 4-qubit MLE reconstructions/sec (proj-set, 10k shots/POVM, RrhoR-60)",
                "value": round(value, 1),
                "unit": "reconstructions/sec",
                "vs_baseline": round(value / REFERENCE_REC_PER_SEC, 1),
                "device": {
                    "platform": devices[0].platform,
                    "kind": devices[0].device_kind,
                    "count": len(devices),
                    "card": cards[0],
                },
                "extras": extras,
            }
        )
    )
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
