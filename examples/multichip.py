"""Multi-chip scaling over a jax.sharding mesh.

The reference (nordmtr/quantpy) is single-process NumPy with sequential
loops — there is no parallel story to port, so this is a capability
beyond parity (SURVEY.md §2 checklist). Two sharding modes:

1. RESAMPLE sharding — thousands of independent simulate+estimate
   problems ride the mesh's batch axis; the per-device program is
   exactly the single-chip bootstrap and the only collective is the
   final gather (`sharded_bootstrap_distances`).
2. OPERATOR sharding — for 11+ qubits, where the 6^n outcome tensor
   outgrows one device (8.7 GB at 12 qubits): the first measurement
   group's outcome axis rides the mesh, counts are BORN sharded
   (`sharded_kron_simulate`), linear inversion psums only the (4^n,)
   right-hand side, and the RrhoR MLE iteration runs on the sharded
   design with one psum and one row-block all_gather per iteration
   (`sharded_kron_estimate_mle_rhor`). This is the path meant to carry
   12-qubit tomography.

Runs on the devices JAX finds (at least two). To rehearse without
accelerators, ask for a virtual CPU mesh explicitly:

Run:  python examples/multichip.py               # the real devices
      python examples/multichip.py --cpu-mesh 8  # 8 virtual CPU devices
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np


def main() -> None:
    parser = argparse.ArgumentParser(description="multi-device tomography demo")
    parser.add_argument(
        "--cpu-mesh", type=int, default=0, metavar="N",
        help="run on N virtual CPU devices instead of the accelerators",
    )
    args = parser.parse_args()
    if args.cpu_mesh:
        # must happen before JAX initializes its backends
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.cpu_mesh}"
        ).strip()

    import jax

    if len(jax.devices()) < 2:
        raise SystemExit(
            f"need at least 2 devices for a mesh, found {jax.devices()}; "
            "pass --cpu-mesh N for a virtual CPU mesh"
        )

    import jax.numpy as jnp

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
    from quantpy_tpu.tomography.bootstrap_core import _distance_batch
    from quantpy_tpu.tomography.state import StateTomograph

    n_dev = len(jax.devices())
    mesh = make_mesh()
    print(f"mesh: {n_dev} x {jax.devices()[0].platform}")

    # --- 1. resample-sharded bootstrap (2 qubits, MLE re-estimates) ---
    tmg = StateTomograph(qt.GHZ(2), key=11)
    tmg.experiment(2000, "proj-set")
    est = tmg.point_estimate("lin")
    n_boot = 16 * n_dev
    d = np.asarray(
        sharded_bootstrap_distances(
            mesh,
            jax.random.key(0),
            est.bloch.astype(np.float32),
            tmg.povm_matrix,
            tmg.n_measurements,
            n_points=n_boot,
            method="mle-rhor",
            max_iter=40,
        )
    )
    print(
        f"resample-sharded bootstrap: {n_boot} resamples over {n_dev} "
        f"devices, d50={np.median(d):.4f} d90={np.quantile(d, 0.9):.4f}"
    )

    # --- 2. operator-sharded pipeline (6 qubits here; same code at 12) ---
    n = 6
    povm1 = jnp.asarray(_single_qubit_preset("proj-set"), jnp.float32)
    truth = jnp.asarray(qt.GHZ(n).bloch, jnp.float32)
    counts = sharded_kron_simulate(mesh, jax.random.key(1), povm1, truth, 2000.0)
    print(
        f"operator-sharded simulate: counts {counts.shape} born sharded "
        f"({counts.sharding.spec})"
    )
    lin = sharded_kron_estimate_lin(mesh, counts, povm1, n)
    mle = sharded_kron_estimate_mle_rhor(
        mesh, counts, povm1, n, init_bloch=lin, max_iter=40
    )
    d_lin = float(np.asarray(_distance_batch("hs", lin, truth, n)))
    d_mle = float(np.asarray(_distance_batch("hs", mle, truth, n)))
    # single-device twin on the same (gathered) counts — identical math
    mle_1 = kron_core.kron_estimate_mle_rhor(
        np.asarray(counts), povm1, n, max_iter=40
    )
    gap = float(np.max(np.abs(np.asarray(mle_1) - np.asarray(mle))))
    print(
        f"operator-sharded {n}q: lin hs-to-truth {d_lin:.4f}, MLE-40 "
        f"{d_mle:.4f}; sharded-vs-single MLE max|diff| {gap:.2e}"
    )


if __name__ == "__main__":
    main()
