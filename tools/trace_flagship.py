"""Device-time breakdown of one steady-state flagship bootstrap call.

    python tools/trace_flagship.py [--out smoke_out/trace_flagship]

Compiles and warms up ``bootstrap_distances`` at the flagship size (GHZ(4),
proj-set, 10^4 shots per POVM, 16,384 resamples, RrhoR-60), traces
`--calls` steady-state calls with ``jax.profiler``, and attributes the
device time of every kernel to the named scopes of
``state_core.estimate_mle_rhor``:

    rhor_contract  the two (B, K) x (K, D) contractions and the ratio f/p
    rhor_ptm       the six (B, D) x (D, D) Pauli-transfer products
    rhor_sandwich  the batched d x d complex sandwich R rho R
    other          simulate, linear-inversion init, distance, loop control

A kernel's scope is read from the ``op_name`` metadata of its HLO
instruction in the compiled module. Prints the shares of device busy time
and of the RrhoR loop, and writes the per-kernel table, the compiled HLO
and the trace under `--out`. Run it with
``XLA_FLAGS=--xla_gpu_enable_command_buffer=``: inside a command buffer
every kernel reports ``hlo_op=command_buffer`` and cannot be attributed.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import re
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SCOPES = ("rhor_contract", "rhor_ptm", "rhor_sandwich")
_INSTR = re.compile(r"%?([\w.\-]+) = .*?metadata=\{[^}]*op_name=\"([^\"]*)\"")


def hlo_scopes(hlo_text: str) -> dict[str, str]:
    """HLO instruction name -> scope, from each instruction's op_name."""
    out = {}
    for name, op_name in _INSTR.findall(hlo_text):
        out[name] = next((s for s in SCOPES if s in op_name), "other")
    return out


def _union_ns(intervals) -> float:
    total, end = 0.0, -np.inf
    for start, stop in sorted(intervals):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def device_kernels(xplane_path: str, scopes: dict[str, str]):
    """Per-kernel device time from a trace: (table, busy_ns, window_ns).

    Kernels are the events with an `hlo_op` stat on the device planes
    (named /device:...)."""
    from jax.profiler import ProfileData

    table = collections.defaultdict(lambda: {"count": 0, "ns": 0.0})
    intervals = []
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                hlo_op = stats.get("hlo_op")
                if hlo_op is None:
                    continue
                scope = scopes.get(str(hlo_op), "unattributed")
                row = table[(scope, str(hlo_op), ev.name)]
                row["count"] += 1
                row["ns"] += ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not intervals:
        raise SystemExit(f"no device kernel events in {xplane_path}")
    window = max(b for _, b in intervals) - min(a for a, _ in intervals)
    return table, _union_ns(intervals), window


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=str(ROOT / "smoke_out" / "trace_flagship"))
    parser.add_argument("--calls", type=int, default=2)
    args = parser.parse_args(argv)

    import jax
    import jax.numpy as jnp

    import chip_smoke
    import quantpy_tpu as qt
    from quantpy_tpu.config import use_compile_cache
    from quantpy_tpu.tomography.bootstrap_core import bootstrap_distances

    devices = chip_smoke.require_gpu(jax.devices())
    label = chip_smoke.card_lines()[0]
    use_compile_cache()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    tmg = qt.StateTomograph(qt.GHZ(4), key=2026)
    tmg.experiment(10_000, "proj-set")
    est = tmg.point_estimate("mle-rhor")
    call_args = (
        jnp.asarray(est.bloch, jnp.float32),
        jnp.asarray(tmg.povm_matrix, jnp.float32),
        jnp.asarray(tmg.n_measurements, jnp.float32),
    )
    static = dict(n_points=16_384, method="mle-rhor", dst="hs", max_iter=60)
    compiled = bootstrap_distances.lower(jax.random.key(0), *call_args, **static).compile()
    hlo = compiled.as_text()
    (out / "bootstrap_flagship.hlo.txt").write_text(hlo)
    scopes = hlo_scopes(hlo)
    for i in range(2):
        jax.block_until_ready(bootstrap_distances(jax.random.key(i), *call_args, **static))

    trace_dir = out / "trace"
    jax.profiler.start_trace(str(trace_dir))
    t0 = time.perf_counter()
    for i in range(args.calls):
        jax.block_until_ready(bootstrap_distances(jax.random.key(10 + i), *call_args, **static))
    host_s = time.perf_counter() - t0
    jax.profiler.stop_trace()
    xplane = sorted(glob.glob(str(trace_dir / "plugins" / "profile" / "*" / "*.xplane.pb")))[-1]

    table, busy_ns, window_ns = device_kernels(xplane, scopes)
    by_scope = collections.Counter()
    for (scope, _, _), row in table.items():
        by_scope[scope] += row["ns"]
    kernel_ns = sum(by_scope.values())
    loop_ns = sum(by_scope[s] for s in SCOPES)
    print(f"[{label}] {devices[0].device_kind}: {args.calls} traced flagship calls, "
          f"host {host_s:.4f} s; device busy {busy_ns / 1e6:.2f} ms of a "
          f"{window_ns / 1e6:.2f} ms window (idle share "
          f"{1 - busy_ns / window_ns:.4f}); kernel time {kernel_ns / 1e6:.2f} ms")
    for scope in SCOPES + ("other", "unattributed"):
        ns = by_scope.get(scope, 0.0)
        loop_share = ns / loop_ns if scope in SCOPES and loop_ns else float("nan")
        print(f"[{label}]   {scope:13s} {ns / 1e6 / args.calls:9.3f} ms/call  "
              f"{ns / kernel_ns:7.4f} of kernel time  {loop_share:7.4f} of RrhoR loop")
    rows = sorted(table.items(), key=lambda kv: -kv[1]["ns"])
    print(f"[{label}] top kernels (scope, hlo_op, kernel, count, ms/call):")
    for (scope, hlo_op, name), row in rows[:25]:
        print(f"  {scope:13s} {hlo_op:28s} {name[:60]:60s} {row['count']:6d} "
              f"{row['ns'] / 1e6 / args.calls:9.3f}")
    (out / "kernels.json").write_text(json.dumps(
        [{"scope": s, "hlo_op": h, "kernel": k, **row} for (s, h, k), row in rows],
        indent=1,
    ))
    return 0


if __name__ == "__main__":
    sys.exit(main())
