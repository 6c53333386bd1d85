"""tools/trace_flagship.py: attribution of HLO instructions to the RrhoR
loop's named scopes."""

import importlib.util
from pathlib import Path

import jax
import numpy as np

import quantpy_tpu as qt
from quantpy_tpu.tomography import state_core

_spec = importlib.util.spec_from_file_location(
    "trace_flagship",
    Path(__file__).resolve().parent.parent / "tools" / "trace_flagship.py",
)
trace_flagship = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(trace_flagship)


def test_hlo_scopes_find_every_loop_stage():
    tmg = qt.StateTomograph(qt.GHZ(4), key=9)
    tmg.experiment(1000, "proj-set")
    counts = np.asarray(tmg.simulate_batch(2, key=jax.random.key(1)))
    hlo = (
        state_core.estimate_mle_rhor.lower(
            counts, tmg.povm_matrix, tmg.n_measurements, max_iter=3
        )
        .compile()
        .as_text()
    )
    scopes = trace_flagship.hlo_scopes(hlo)
    assert set(trace_flagship.SCOPES) <= set(scopes.values())
    assert "other" in scopes.values()


def test_union_of_overlapping_intervals():
    assert trace_flagship._union_ns([(0, 10), (5, 15), (20, 25)]) == 20
    assert trace_flagship._union_ns([(0, 10), (2, 3)]) == 10
