"""Shared CLI plumbing for the interval entry points.

JSON document schema (matching the reference's scripts/*.py and its worked
example input.json:1-26):
  povm_matrix   : (m, p, 4^n) bloch rows
  outcomes      : measured counts, (m, p) for states, (S, m, p) for processes
  input_states  : (S, 4^n) bloch vectors (process only)
  conf_levels   : list of confidence levels (optional)
  target_state / target_process : bloch vector of the target (optional)

Kron-mode state records (extension for large qubit counts,
where the dense POVM would be GBs): instead of `povm_matrix`, give
  povm_kron     : (m1, p1, 4) single-qubit POVM block
  n_qubits      : number of qubits
  outcomes      : (m1^n, p1^n) counts with UNIFORM per-POVM shot totals
and the whole pipeline (estimate + moment/sugiyama/bootstrap intervals)
runs on the factored paths without materializing the design.
"""

from __future__ import annotations

import json
from argparse import ArgumentParser


def build_parser(
    description: str,
    methods: tuple = ("lin", "mle", "mle-rhor", "mle-constr"),
    intervals: tuple = ("moment", "sugiyama", "bootstrap", "mhmc", "polytope"),
) -> ArgumentParser:
    parser = ArgumentParser(description=description)
    parser.add_argument(
        "-i", "--input", type=str, required=True, help="path to input data file"
    )
    parser.add_argument(
        "-o", "--output", type=str, default=None, help="path to output file"
    )
    parser.add_argument(
        "--no-ci", default=False, action="store_true",
        help="skip confidence intervals",
    )
    parser.add_argument(
        "--method", type=str, default=methods[0], choices=list(methods),
        help="point-estimation method",
    )
    parser.add_argument(
        "--interval", type=str, default="moment", choices=list(intervals),
        help="confidence-interval family for the radius/band",
    )
    parser.add_argument(
        "--n-points", type=int, default=500,
        help="resamples/samples for bootstrap/mhmc/polytope intervals",
    )
    return parser


def load_input(path: str) -> dict:
    with open(path) as fp:
        return json.load(fp)


def validate_record(doc: dict, kind: str) -> None:
    """Fail fast with actionable messages on malformed records (the numeric
    layers otherwise surface shape mismatches as einsum internals)."""
    import numpy as np

    if kind == "state" and "povm_kron" in doc:
        block = np.asarray(doc["povm_kron"], dtype=float)
        if block.ndim != 3 or block.shape[-1] != 4:
            raise ValueError(
                "`povm_kron` must be a (m1, p1, 4) single-qubit POVM block; "
                f"got {block.shape}"
            )
        if "n_qubits" not in doc:
            raise ValueError("kron-mode records must give `n_qubits`")
        n = int(doc["n_qubits"])
        m1, p1, _ = block.shape
        outcomes = np.asarray(doc["outcomes"], dtype=float)
        if outcomes.shape != (m1**n, p1**n):
            raise ValueError(
                f"`outcomes` must be (m1^n, p1^n) = {(m1**n, p1**n)} for the "
                f"kron design; got {outcomes.shape}"
            )
        totals = outcomes.sum(-1)
        if not np.allclose(totals, totals[0]):
            raise ValueError(
                "kron-mode records need UNIFORM per-POVM shot totals (the "
                "factored estimators exploit the product structure)"
            )
        return

    povm = np.asarray(doc.get("povm_matrix", None), dtype=object)
    if povm.ndim == 0 or np.asarray(doc["povm_matrix"]).ndim != 3:
        raise ValueError(
            "`povm_matrix` must be a 3-D (n_povms, n_outcomes, 4^n) array "
            "of bloch rows"
        )
    povm = np.asarray(doc["povm_matrix"], dtype=float)
    outcomes = np.asarray(doc["outcomes"], dtype=float)
    expected_nd = 2 if kind == "state" else 3
    if outcomes.ndim != expected_nd or outcomes.shape[-2:] != povm.shape[:2]:
        raise ValueError(
            f"`outcomes` must have shape {'(S,) + ' if kind == 'process' else ''}"
            f"(n_povms, n_outcomes) = {povm.shape[:2]} to match `povm_matrix`; "
            f"got {outcomes.shape}"
        )
    if kind == "process":
        states = np.asarray(doc["input_states"], dtype=float)
        if states.ndim != 2 or states.shape[-1] != povm.shape[-1]:
            raise ValueError(
                "`input_states` must be (S, 4^n) bloch vectors matching the "
                f"POVM dimension {povm.shape[-1]}; got {states.shape}"
            )
        if outcomes.shape[0] != states.shape[0]:
            raise ValueError(
                f"`outcomes` has {outcomes.shape[0]} state blocks but "
                f"`input_states` lists {states.shape[0]} states"
            )


def emit(output: dict, path: str | None) -> None:
    if path:
        with open(path, "w") as fp:
            json.dump(output, fp, indent=4)
    else:
        from pprint import pprint

        pprint(output)
