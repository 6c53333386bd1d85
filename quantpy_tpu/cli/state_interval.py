"""CLI: point estimate + confidence intervals from real QST records.

Counterpart of reference scripts/state_interval.py:10-72. Reads a JSON
document with `povm_matrix` (or a kron-mode `povm_kron` block for large
qubit counts) and `outcomes`, seeds a StateTomograph with the measurement
design, injects the real counts through the `results` setter, and emits the
bloch vector of the estimate plus (optionally) fidelity bands and
Hilbert-Schmidt radii.

Extensions over the reference script: `--method` selects the
estimator (lin/mle/mle-rhor/mle-constr), `--interval` the CI family
(moment/sugiyama/bootstrap/mhmc/polytope), and kron-mode records run the
whole pipeline without materializing the measurement matrix.
"""

from __future__ import annotations

import math

import numpy as np

from ..config import use_compile_cache
from ..qobj import Qobj, fully_mixed
from ..tomography.interval import (
    BootstrapStateInterval,
    MHMCStateInterval,
    MomentFidelityStateInterval,
    MomentInterval,
    PolytopeStateInterval,
    SugiyamaInterval,
)
from ..tomography.state import StateTomograph
from .common import build_parser, emit, load_input, validate_record


def _build_tomograph(input_data: dict) -> StateTomograph:
    results = np.asarray(input_data["outcomes"], dtype=np.float64)
    if "povm_kron" in input_data:
        n_qubits = int(input_data["n_qubits"])
        tmg = StateTomograph(fully_mixed(n_qubits))
        tmg.povm_kron = np.asarray(input_data["povm_kron"], dtype=np.float64)
        tmg.povm_matrix = None
    else:
        povm_matrix = np.asarray(input_data["povm_matrix"], dtype=np.float64)
        n_qubits = int(round(math.log2(povm_matrix.shape[-1]) / 2))
        tmg = StateTomograph(fully_mixed(n_qubits))
        tmg.povm_matrix = povm_matrix
    tmg.results = results
    return tmg


def _radius_interval(tmg, name: str, method: str, n_points: int):
    if name in ("moment", "polytope"):
        # polytope emits bands, not radii — moment is the radius fallback
        # (mirrors the reference's MomentInterval fallback, script line 59)
        return MomentInterval(tmg)
    if name == "sugiyama":
        return SugiyamaInterval(tmg)
    if name == "bootstrap":
        boot_method = "mle-rhor" if method in ("mle", "mle-constr") else method
        return BootstrapStateInterval(tmg, n_points=n_points, method=boot_method)
    if name == "mhmc":
        if tmg.povm_matrix is None:
            raise ValueError(
                "--interval mhmc needs a dense-POVM record (the NLL is "
                "evaluated against the materialized design); use "
                "moment/sugiyama/bootstrap for kron-mode records"
            )
        # fresh physical MLE start: the CLI's physical=False point estimate
        # can be non-PSD, which the Cholesky chain start cannot take
        return MHMCStateInterval(tmg, n_points=n_points, use_new_estimate=True)
    raise ValueError(f"Unknown interval family {name!r}")


def run(
    input_data: dict,
    no_ci: bool = False,
    method: str = "lin",
    interval: str = "moment",
    n_points: int = 500,
) -> dict:
    validate_record(input_data, "state")
    tmg = _build_tomograph(input_data)

    output: dict = {}
    output["state"] = [
        float(x) for x in tmg.point_estimate(method=method, physical=False).bloch
    ]
    if no_ci:
        return output

    conf_levels = np.asarray(input_data.get("conf_levels", [0.95]))
    if "target_state" in input_data:
        target = Qobj(np.asarray(input_data["target_state"]))
        if interval == "polytope":
            band = PolytopeStateInterval(
                tmg, n_points=n_points, target_state=target
            )
        else:
            band = MomentFidelityStateInterval(tmg, target_state=target)
        (fmin, fmax), _ = band(conf_levels)
        output["fidelity_min"] = [float(x) for x in np.maximum(fmin, 0)]
        output["fidelity_max"] = [float(x) for x in np.minimum(fmax, 1)]

    radius = _radius_interval(tmg, interval, method, n_points)
    dist, _ = radius(conf_levels)
    output["hs_radius"] = [float(x) for x in np.atleast_1d(dist)]
    return output


def main(args=None):
    use_compile_cache()
    parsed = build_parser(__doc__).parse_args(args)
    emit(
        run(
            load_input(parsed.input),
            no_ci=parsed.no_ci,
            method=parsed.method,
            interval=parsed.interval,
            n_points=parsed.n_points,
        ),
        parsed.output,
    )


if __name__ == "__main__":
    main()
