"""quantpy-tpu: a batched JAX quantum tomography framework.

Public API parity with the reference quantpy package (quantpy/__init__.py:1-23)
plus the batched functional layer under `quantpy_tpu.ops`,
`quantpy_tpu.tomography.*` and `quantpy_tpu.parallel`.

Architecture: quantum objects (Qobj/Operator/Channel) are lightweight host
handles; all batched computation — experiment simulation, estimation,
confidence intervals — runs as jitted, vmapped device code with real
(bloch-vector) arrays at its boundaries.
"""

from . import config

config.set_matmul_precision("highest")  # see config.set_matmul_precision

from . import basis, channel, geometry, measurements, metrics, mhmc, operator, ops, qobj, routines, stats  # noqa: E402
from .base import BaseQuantum
from .basis import Basis
from .channel import Channel
from .measurements import generate_measurement_matrix
from .operator import Operator
from .ops.geometry import hs_dst, if_dst, product, trace_dst
from .ops.paulis import generate_pauli
from .qobj import GHZ, Qobj, fully_mixed, zero
from .tomography.interval import (
    BootstrapProcessInterval,
    BootstrapStateInterval,
    HolderInterval,
    MHMCProcessInterval,
    MHMCStateInterval,
    MomentFidelityProcessInterval,
    MomentFidelityStateInterval,
    MomentInterval,
    PolytopeProcessInterval,
    PolytopeStateInterval,
    SugiyamaInterval,
)
from .tomography.process import ProcessTomograph
from .tomography.state import StateTomograph

from .routines import join_gates, kron  # noqa: E402

__version__ = "0.1.0"


__all__ = [
    "BaseQuantum",
    "Basis",
    "BootstrapProcessInterval",
    "BootstrapStateInterval",
    "Channel",
    "GHZ",
    "HolderInterval",
    "MHMCProcessInterval",
    "MHMCStateInterval",
    "MomentFidelityProcessInterval",
    "MomentFidelityStateInterval",
    "MomentInterval",
    "Operator",
    "PolytopeProcessInterval",
    "PolytopeStateInterval",
    "ProcessTomograph",
    "Qobj",
    "StateTomograph",
    "SugiyamaInterval",
    "basis",
    "channel",
    "geometry",
    "measurements",
    "metrics",
    "mhmc",
    "routines",
    "stats",
    "config",
    "fully_mixed",
    "generate_measurement_matrix",
    "generate_pauli",
    "hs_dst",
    "if_dst",
    "join_gates",
    "kron",
    "operator",
    "ops",
    "product",
    "qobj",
    "trace_dst",
    "zero",
]
