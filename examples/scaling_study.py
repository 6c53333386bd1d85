"""Qubit-count scaling study: factored vs dense measurement paths.

The reference's dense linear inversion hits ~45 s at 6 qubits
(BASELINE.md); the kron-factored paths (tomography/kron_core.py) never
materialize anything larger than the outcome counts, so the pipeline
reaches 10 qubits.

Run:  python examples/scaling_study.py [--max-qubits 10]
"""

from __future__ import annotations

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np

import quantpy_tpu as qt
from quantpy_tpu.measurements import _single_qubit_preset
from quantpy_tpu.tomography import kron_core


def main(max_qubits: int) -> None:
    povm1 = jnp.asarray(_single_qubit_preset("proj-set"))
    rows = []
    print(f"{'n':>2} | {'counts shape':>14} | {'simulate':>9} | {'lin':>9} | "
          f"{'mle-60':>9} | {'mle hs-to-truth':>15}")
    for n in range(2, max_qubits + 1):
        state = qt.GHZ(n)
        bloch = jnp.asarray(state.bloch)

        def run_sim(k):
            return kron_core.kron_simulate(k, povm1, bloch, 10_000.0)

        def sync(x):
            jax.block_until_ready(x)

        counts = run_sim(jax.random.key(n))
        sync(counts)
        t0 = time.time()
        counts = run_sim(jax.random.key(n + 50))
        sync(counts)
        t_sim = time.time() - t0

        def run_lin(c):
            return kron_core.kron_estimate_lin(c, povm1, n)

        sync(run_lin(counts))
        t0 = time.time()
        sync(run_lin(counts))
        t_lin = time.time() - t0

        def run_mle(c):
            return kron_core.kron_estimate_mle_rhor(c, povm1, n, max_iter=60)

        est = run_mle(counts)
        sync(est)
        t0 = time.time()
        est = run_mle(counts)
        sync(est)
        t_mle = time.time() - t0
        d = float(qt.hs_dst(qt.Qobj(np.asarray(est, np.float64)), state))
        print(f"{n:>2} | {str(tuple(counts.shape)):>14} | {t_sim*1e3:>7.1f}ms | "
              f"{t_lin*1e3:>7.1f}ms | {t_mle*1e3:>7.1f}ms | {d:>15.4f}")
        rows.append((n, t_sim, t_lin, t_mle))

    import _viz

    if _viz.figures_enabled() and rows:
        fig, ax = _viz.new_axes(
            "Kron-factored tomography scaling (10k shots, proj-set)",
            "qubits",
            "wall time per call (s)",
        )
        ns = [r[0] for r in rows]
        for idx, (label, col) in enumerate(
            [("simulate", 1), ("linear inversion", 2), ("MLE (60 iters)", 3)]
        ):
            ax.semilogy(
                ns, [r[col] for r in rows], color=_viz.PALETTE[idx],
                linewidth=2, marker="o", markersize=4, label=label, zorder=3,
            )
        # reference comparison points (BASELINE.md, dense single-core CPU)
        ax.semilogy(
            [5, 6], [0.65, 45.0], color=_viz.TEXT2, linewidth=0,
            marker="x", markersize=7, label="reference lin (BASELINE.md)",
            zorder=3,
        )
        ax.set_xticks(ns)
        _viz.legend(ax)
        _viz.save(fig, "scaling_study")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--max-qubits", type=int, default=10)
    args = parser.parse_args()
    print("devices:", jax.devices())
    main(args.max_qubits)
