"""Large-n process tomography walkthrough: the 4/5/6-qubit QPT recipes.

Runs the 4/5/6-qubit process-tomography recipes: a Walsh-Hadamard target
channel, a proj-set
experiment, factored linear inversion, and the appropriate CPTP
treatment per size —

- n <= 4: fused lifp + Dykstra (and optionally the 'dys' CPTP MLE),
- n == 5: lifp with the host-chunked Dykstra projection,
- n == 6: lifp with a SHORT Dykstra cleanup (20 iterations): clipping the
  negative eigenspectrum of the noisy rank-1 Choi removes ~92% of the
  linear-inversion error at a fraction of the full projection cost.

The reference lineage cannot form any of these objects past ~3 qubits
(its dense lifp operator is 16^n-sized, reference process.py:197-211).

Run:  python examples/qpt_scaling.py [--qubits 3] [--shots 2000]
On CPU set JAX_PLATFORMS=cpu; 5-6 qubits want an accelerator (their wall
times on the H100 are not measured).
"""

from __future__ import annotations

import argparse
import functools
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

import quantpy_tpu as qt
from quantpy_tpu.operator import H


def walsh_hadamard_channel(n: int) -> qt.Channel:
    u = functools.reduce(np.kron, [H.matrix] * n)
    return qt.Channel(
        lambda rho: qt.Qobj(u @ rho.matrix @ u.conj().T), n_qubits=n
    )


def hs_to_truth(est_bloch: np.ndarray, true_bloch: np.ndarray, n: int) -> float:
    # hs distance directly in Choi-bloch space (the Choi lives on 2n qubits)
    return float(np.linalg.norm(est_bloch - true_bloch)) * np.sqrt(
        2 ** (2 * n) / 2
    )


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--qubits", type=int, default=3)
    parser.add_argument("--shots", type=int, default=2000)
    parser.add_argument(
        "--cleanup-iters", type=int, default=20,
        help="Dykstra iterations for the n >= 6 short cleanup",
    )
    args = parser.parse_args()
    n = args.qubits

    channel = walsh_hadamard_channel(n)
    true_bloch = np.asarray(channel.choi.bloch, dtype=np.float64)
    c_norm = 2.0**n  # ||C||_F of a unitary channel's Choi

    t0 = time.time()
    tmg = qt.ProcessTomograph(channel, key=6)
    print(f"constructor: {time.time() - t0:.1f}s", flush=True)

    t1 = time.time()
    tmg.experiment(args.shots, "proj-set")
    print(f"experiment ({args.shots} shots/POVM): {time.time() - t1:.1f}s", flush=True)

    if n <= 5:
        t2 = time.time()
        est = tmg.point_estimate("lifp", cptp=True)
        d = hs_to_truth(np.asarray(est.choi.bloch, float), true_bloch, n)
        print(
            f"lifp + CPTP: {time.time() - t2:.1f}s, "
            f"hs-to-truth {d:.3f} (||C||_F = {c_norm:.0f})",
            flush=True,
        )
    else:
        from quantpy_tpu.tomography import process_core

        t2 = time.time()
        est = tmg.point_estimate("lifp", cptp=False)
        raw = np.asarray(est.choi.bloch, dtype=np.float64)
        d_raw = hs_to_truth(raw, true_bloch, n)
        print(
            f"lifp (raw): {time.time() - t2:.1f}s, hs-to-truth {d_raw:.2f}",
            flush=True,
        )
        t3 = time.time()
        cleaned = np.asarray(
            process_core.cptp_project_bloch_host(
                raw, max_iter=args.cleanup_iters, chunk=5, cp="ns"
            ),
            dtype=np.float64,
        )
        d_clean = hs_to_truth(cleaned, true_bloch, n)
        print(
            f"{args.cleanup_iters}-iteration Dykstra cleanup: "
            f"{time.time() - t3:.1f}s, hs-to-truth {d_clean:.2f} "
            f"(||C||_F = {c_norm:.0f})",
            flush=True,
        )
    print(f"total: {time.time() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
