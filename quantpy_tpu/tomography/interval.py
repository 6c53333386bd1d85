"""Confidence intervals for state and process tomography.

Counterpart of reference quantpy/tomography/interval.py:19-865 — the full
functor suite:

- MomentInterval + MomentFidelityState/ProcessInterval (moments of the
  multinomial L2 error; fidelity bands via *closed-form* sliced-ball
  optimization instead of the reference's per-level cvxopt SOCPs)
- SugiyamaInterval (Hoeffding bound, arXiv:1306.4191)
- PolytopeState/ProcessInterval (confidence polytopes, arXiv:2109.04734;
  batched PDHG LPs instead of per-level cvxopt LPs)
- BootstrapState/ProcessInterval (parametric bootstrap — one jitted device
  program for the entire resample loop)
- MHMCState/ProcessInterval (likelihood sampling via the lax.scan chain)
- HolderInterval (process bound composed from per-input-state intervals)

Every interval is a functor: `interval(conf_levels) -> (distances, levels)`
after a lazily-invoked `setup()` (reference interval.py:41-52).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from enum import Enum, auto

import numpy as np
import scipy.stats as sts

from ..convex import (
    linear_bounds_on_ball_slice,
    solve_lp_batch,
    solve_lp_batch_factors,
    solve_lp_batch_kron,
)
from ..mhmc import MHMC, normalized_update
from ..ops.cholesky import np_matrix_to_real_tril_vec
from ..ops.geometry import hs_dst, if_dst, trace_dst
from ..ops.paulis import np_bloch_to_matrix
from ..stats import l2_moments_from_factor
from . import bootstrap_core
from .polytopes.utils import count_confidence, count_delta

__all__ = [
    "ConfidenceInterval",
    "MomentInterval",
    "MomentFidelityStateInterval",
    "MomentFidelityProcessInterval",
    "SugiyamaInterval",
    "PolytopeStateInterval",
    "PolytopeProcessInterval",
    "BootstrapStateInterval",
    "BootstrapProcessInterval",
    "MHMCStateInterval",
    "MHMCProcessInterval",
    "HolderInterval",
    "Mode",
]


class Mode(Enum):
    STATE = auto()
    CHANNEL = auto()


def _interp1d(x, y):
    """Monotone linear interpolant (reference uses scipy interp1d;
    np.interp clamps at the range ends instead of raising — documented
    divergence that removes a footgun for conf levels 0/1)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    order = np.argsort(x)
    xs, ys = x[order], y[order]

    def f(q):
        return np.interp(np.asarray(q, dtype=np.float64), xs, ys)

    return f


from ..routines import _left_inv as _left_inv_np  # noqa: E402

#: split-R-hat above this triggers the non-convergence warning on MHMC
#: intervals (the standard Vehtari et al. practical threshold is 1.01-1.1;
#: 1.2 flags only the decisively-unmixed chains)
RHAT_WARN_THRESHOLD = 1.2


def _warn_if_nonconverged(interval_name: str, r_hat: float, ess: float):
    """Make a non-converged chain LOUD: the r_hat/ess
    attributes are surfaced on every chain, but a user who asks for the
    interval without reading them would otherwise get quantiles of a
    non-stationary sample. The 4+ qubit raw-count process posterior is the
    known case (f32-precision-bound): chains there ship R-hat 1.9-3.5."""
    import warnings

    if np.isfinite(r_hat) and r_hat > RHAT_WARN_THRESHOLD:
        warnings.warn(
            f"{interval_name}: chains have NOT converged "
            f"(split R-hat {r_hat:.2f} > {RHAT_WARN_THRESHOLD}, "
            f"ESS {ess:.0f}); the returned distances are quantiles of a "
            "non-stationary sample and are not a valid confidence "
            "interval. Increase n_points/burn_steps, use "
            "parametrization='kraus' with proposal='mala' (<= 3 qubits), "
            "or prefer the bootstrap interval (the recommended 4+ qubit "
            "process CI).",
            RuntimeWarning,
            stacklevel=3,
        )


def _require_uniform_kron_shots(tmg, what: str):
    """The kron-factored interval recipes fold a UNIFORM per-POVM shot
    weight exactly (n_m / sum * m == 1); a user can inject non-uniform
    counts into a kron-mode tomograph through the results setter
    (n_measurements becomes row sums), which the factored paths would
    silently mis-weight — reject instead."""
    n = np.asarray(tmg.n_measurements, dtype=np.float64)
    if n.ndim and not np.allclose(n, n.flat[0]):
        raise NotImplementedError(
            f"{what} on the kron-factored path assumes uniform per-POVM "
            "shot counts; non-uniform injected results need a dense design"
        )


class ConfidenceInterval(ABC):
    """Functor base (reference interval.py:19-56): detects STATE/CHANNEL
    mode from the tomograph and maps confidence levels to distances."""

    EPS = 1e-15

    def __init__(self, tmg, **kwargs):
        self.tmg = tmg
        if hasattr(tmg, "state"):
            self.mode = Mode.STATE
        elif hasattr(tmg, "channel"):
            self.mode = Mode.CHANNEL
        else:
            raise ValueError("Tomograph must expose `state` or `channel`")
        for name, value in kwargs.items():
            if name == "key" and isinstance(value, (int, np.integer)):
                # accept plain int seeds (the reference has no key concept —
                # its RNG is the global NumPy state, interval.py:600-609 —
                # so migrating users reasonably pass seeds here)
                import jax

                value = jax.random.key(value)
            setattr(self, name, value)

    def __call__(self, conf_levels=None):
        if conf_levels is None:
            conf_levels = np.linspace(1e-3, 1 - 1e-3, 1000)
        if not hasattr(self, "cl_to_dist"):
            self.setup()
        return self.cl_to_dist(conf_levels), conf_levels

    @abstractmethod
    def setup(self):
        """Compute the confidence-level -> distance map."""


# --------------------------------------------------------------------------
# Moment-based intervals
# --------------------------------------------------------------------------


#: above this many (states x Mp-block) elements the channel moment path
#: switches to the fully-factored exact-mean + Hutchinson-variance recipe
#: (5 qubits = 2^30 stays exact; 6 qubits = 2^36 would need ~26 PFLOP and
#: ~275 GB on the exact Gram)
_CHANNEL_EXACT_GRAM_MAX = 1 << 32


class MomentInterval(ConfidenceInterval):
    """CI from the exact multinomial moments of the weighted L2 error
    (reference interval.py:59-110)."""

    def __init__(self, tmg, distr_type: str = "gamma"):
        super().__init__(tmg, distr_type=distr_type)

    def setup(self):
        if self.mode == Mode.STATE:
            dim = 2**self.tmg.state.n_qubits
            n_measurements = self.tmg.n_measurements
            freq = self.tmg.results / n_measurements[:, None]
            if self.tmg.povm_matrix is None:
                if getattr(self.tmg, "povm_kron", None) is None:
                    raise NotImplementedError(
                        "moment intervals need a measurement design; run "
                        "`experiment` or set `results` first"
                    )
                # kron-factored design: exact factored moments, no POVM /
                # pseudo-inverse / weights-tensor materialization
                _require_uniform_kron_shots(self.tmg, "MomentInterval")
                from . import kron_analytic

                mean, variance = kron_analytic.kron_l2_moments(
                    self.tmg.povm_kron,
                    self.tmg.state.n_qubits,
                    freq,
                    n_measurements[0],
                )
            else:
                # `_design_inv` lets a caller that builds MANY intervals on
                # the same measurement design (HolderInterval: one per input
                # state) share one pseudo-inverse instead of refactorizing
                # per child
                inv = getattr(self, "_design_inv", None)
                if inv is None:
                    povm_flat = self.tmg.povm_matrix.reshape(
                        -1, self.tmg.povm_matrix.shape[-1]
                    )
                    inv = _left_inv_np(povm_flat) / dim
                inv = inv.reshape(-1, freq.shape[0], freq.shape[1])
                mean, variance = l2_moments_from_factor(
                    inv, freq, n_measurements[0]
                )
        else:
            n_ch = self.tmg.channel.n_qubits
            dim = 4**n_ch
            t0 = self.tmg.tomographs[0]
            n_measurements = t0.n_measurements
            # the process design is kron(states_matrix, povm_flat); the
            # factored moments never build it or its (S K, 16^n) pseudo-
            # inverse (the reference's n >= 3 wall, interval.py:76-88) —
            # exact-equality-tested against the dense path at 1-2 qubits,
            # and the enabler for analytic 4-5 qubit process intervals
            from . import kron_analytic

            freq3 = np.stack(
                [t.results / t.n_measurements[:, None] for t in self.tmg.tomographs]
            )
            n_states = freq3.shape[0]
            if n_states * dim * dim > _CHANNEL_EXACT_GRAM_MAX:
                # 6+ qubits: even the per-state moment blocks are (4^n)^2;
                # the fully-factored path needs the single-qubit design
                # factors (exact mean + Hutchinson Frobenius term,
                # channel_l2_moments_kron)
                states1_t = getattr(self.tmg, "_states1_t", None)
                povm1 = getattr(self.tmg, "_povm1", None)
                if states1_t is None or povm1 is None:
                    raise NotImplementedError(
                        "channel moment intervals at this size need a "
                        "tensor-power design (preset input states and a "
                        "single-qubit POVM block)"
                    )
                mean, variance = kron_analytic.channel_l2_moments_kron(
                    states1_t, povm1, n_ch, freq3, n_measurements[0]
                )
            else:
                mean, variance = kron_analytic.channel_l2_moments(
                    self.tmg._input_blochs_t(),
                    t0.povm_matrix,
                    freq3,
                    n_measurements[0],
                )
        if self.distr_type == "norm":
            distr = sts.norm(loc=mean, scale=np.sqrt(variance))
        elif self.distr_type == "gamma":
            scale = variance / mean
            distr = sts.gamma(a=mean / scale, scale=scale)
        elif self.distr_type == "exp":
            distr = sts.expon(scale=mean)
        else:
            raise NotImplementedError(
                f"Unsupported distribution type {self.distr_type}"
            )
        if self.tmg.dst is hs_dst:
            alpha = np.sqrt(dim / 2)
        elif self.tmg.dst is trace_dst:
            alpha = dim / 2
        else:
            raise NotImplementedError("MomentInterval supports hs/trace distances")
        self.cl_to_dist = lambda cl: np.sqrt(distr.ppf(cl)) * alpha


class _MomentFidelityBase(MomentInterval):
    """Shared fidelity-band logic: for each confidence radius, bound
    <target, x> over the ball of bloch vectors around the point estimate,
    intersected with the trace/TP affine slice. Closed form — replaces the
    two-cvxopt-SOCPs-per-level loop (reference interval.py:134-158)."""

    #: conf-level grid of the reference (interval.py:134)
    _GRID = np.concatenate(
        (np.arange(1e-7, 0.8, 0.01), np.linspace(0.8, 1 - 1e-7, 200))
    )

    def __call__(self, conf_levels=None):
        if conf_levels is None:
            conf_levels = np.linspace(1e-3, 1 - 1e-3, 1000)
        if not hasattr(self, "cl_to_dist_max"):
            self.setup()
        return (
            (self.cl_to_dist_min(conf_levels), self.cl_to_dist_max(conf_levels)),
            conf_levels,
        )

    def _setup_bands(self, c, center, alpha, fixed_idx, fixed_vals, scale):
        dist_list = self.cl_to_dist(self._GRID)
        mins, maxs = linear_bounds_on_ball_slice(
            c, center, dist_list * alpha, fixed_idx, fixed_vals
        )
        # reference fallback: degenerate solves report 1 (interval.py:149-157)
        mins = np.where(np.isnan(mins), 1.0, mins * scale)
        maxs = np.where(np.isnan(maxs), 1.0, maxs * scale)
        self.cl_to_dist_min = _interp1d(self._GRID, mins)
        self.cl_to_dist_max = _interp1d(self._GRID, maxs)


class MomentFidelityStateInterval(_MomentFidelityBase):
    """Fidelity band w.r.t. a target state (reference interval.py:113-160)."""

    def __init__(self, tmg, distr_type: str = "gamma", target_state=None):
        self.target_state = target_state
        super().__init__(tmg, distr_type=distr_type)

    def setup(self):
        MomentInterval.setup(self)
        if not hasattr(self.tmg, "reconstructed_state"):
            self.tmg.point_estimate(physical=False)
        if self.target_state is None:
            self.target_state = self.tmg.reconstructed_state
        dim = 2**self.tmg.state.n_qubits
        self._setup_bands(
            c=self.target_state.bloch,
            center=self.tmg.reconstructed_state.bloch,
            alpha=np.sqrt(2 / dim),
            fixed_idx=np.array([0]),
            fixed_vals=np.array([1 / dim]),
            scale=dim,
        )


class MomentFidelityProcessInterval(_MomentFidelityBase):
    """Fidelity band w.r.t. a target process (reference interval.py:163-216)."""

    def __init__(self, tmg, distr_type: str = "gamma", target_process=None):
        self.target_process = target_process
        super().__init__(tmg, distr_type=distr_type)

    def setup(self):
        MomentInterval.setup(self)
        if not hasattr(self.tmg, "reconstructed_channel"):
            self.tmg.point_estimate(cptp=False)
        if self.target_process is None:
            self.target_process = self.tmg.reconstructed_channel
        n = self.tmg.channel.n_qubits
        dim_in, dim_out = 2**n, 2**n
        dim = dim_in * dim_out
        trivial = np.arange(0, dim**2, dim_out**2)
        fixed_vals = np.zeros(trivial.shape[0])
        fixed_vals[0] = 1 / dim_in
        self._setup_bands(
            c=self.target_process.choi.bloch,
            center=self.tmg.reconstructed_channel.choi.bloch,
            alpha=np.sqrt(2 / dim),
            fixed_idx=trivial,
            fixed_vals=fixed_vals,
            scale=1.0,
        )


# --------------------------------------------------------------------------
# Sugiyama (Hoeffding) interval
# --------------------------------------------------------------------------


class SugiyamaInterval(ConfidenceInterval):
    """Non-asymptotic CI from Hoeffding's inequality, arXiv:1306.4191
    (reference interval.py:219-265). State tomography only."""

    def __init__(self, tmg, n_points: int = 1000, max_confidence: float = 0.999):
        super().__init__(tmg, n_points=n_points, max_confidence=max_confidence)

    def setup(self):
        if self.mode == Mode.CHANNEL:
            raise NotImplementedError(
                "Sugiyama interval works only for state tomography"
            )
        dim = 2**self.tmg.state.n_qubits
        dist = np.linspace(0, 1, self.n_points)
        if self.tmg.povm_matrix is None:
            if getattr(self.tmg, "povm_kron", None) is None:
                raise NotImplementedError(
                    "Sugiyama intervals need a measurement design; run "
                    "`experiment` or set `results` first"
                )
            # kron-factored design: exact c_alpha from the per-qubit
            # interval-arithmetic fold (uniform shots -> constant ratio m)
            _require_uniform_kron_shots(self.tmg, "SugiyamaInterval")
            from . import kron_analytic

            m = self.tmg.n_measurements.shape[0]
            c_alpha = (
                kron_analytic.kron_sugiyama_c_alpha(
                    self.tmg.povm_kron, self.tmg.state.n_qubits
                )
                * m
                + self.EPS
            )
        else:
            m, p, _ = self.tmg.povm_matrix.shape
            povm_flat = self.tmg.povm_matrix.reshape(
                -1, 4 ** self.tmg.state.n_qubits
            )
            povm_flat = povm_flat * dim / np.sqrt(2 * dim)
            inv = _left_inv_np(povm_flat).reshape(-1, m, p)
            ratios = self.tmg.n_measurements.sum() / self.tmg.n_measurements
            c_alpha = (
                np.sum(
                    (inv.max(axis=-1) - inv.min(axis=-1)) ** 2 * ratios[None, :],
                    axis=-1,
                )
                + self.EPS
            )
        if self.tmg.dst is hs_dst:
            b = 8 / (dim**2 - 1)
        elif self.tmg.dst is trace_dst:
            b = 16 / (dim**2 - 1) / dim
        elif self.tmg.dst is if_dst:
            b = 4 / (dim**2 - 1) / dim
        else:
            raise NotImplementedError("Unsupported distance")
        conf_levels = 1 - 2 * np.sum(
            np.exp(
                -b * dist[:, None] ** 2 * self.tmg.n_measurements.sum() / c_alpha[None]
            ),
            axis=1,
        )
        self.cl_to_dist = _interp1d(conf_levels, dist)


# --------------------------------------------------------------------------
# Confidence polytopes (arXiv:2109.04734)
# --------------------------------------------------------------------------


class _PolytopeBase(ConfidenceInterval):
    LP_ITERS = 20000
    #: dense constraint-matrix element budget; beyond it the process LP
    #: runs on the two-factor matvec path (solve_lp_batch_factors)
    DENSE_LP_MAX_ELEMENTS = 2**25

    def __call__(self, conf_levels=None):
        if conf_levels is None:
            conf_levels = np.linspace(1e-3, 1 - 1e-3, 1000)
        if not hasattr(self, "cl_to_dist_max"):
            self.setup()
        return (
            (self.cl_to_dist_min(conf_levels), self.cl_to_dist_max(conf_levels)),
            conf_levels,
        )

    def _solve(self, c, a_matrix, b_batch, lo_affine, scale):
        """Batched min/max of <c, x> over {A x <= b}; maps degenerate solves
        to 1 like the reference (interval.py:321-329). Surfaces the PDHG
        iteration counts as `lp_iterations` (min-solve, max-solve)."""
        return self._solve_with(
            lambda cc: solve_lp_batch(cc, a_matrix, b_batch, self.LP_ITERS),
            c, lo_affine, scale,
        )

    def _solve_with(self, solver, c, lo_affine, scale):
        """Shared min/max post-processing over a one-sided LP `solver`."""
        x, obj_min, viol_min, it_min = solver(c)
        x, obj_max_neg, viol_max, it_max = solver(-np.asarray(c))
        self.lp_iterations = (int(it_min), int(it_max))
        obj_min = np.asarray(obj_min, dtype=np.float64)
        obj_max = -np.asarray(obj_max_neg, dtype=np.float64)
        bad = (np.asarray(viol_min) > 1e-3) | (np.asarray(viol_max) > 1e-3)
        dist_min = np.where(bad, 1.0, lo_affine + obj_min * scale)
        dist_max = np.where(bad, 1.0, lo_affine + obj_max * scale)
        return dist_min, dist_max


class PolytopeStateInterval(_PolytopeBase):
    """Fidelity bounds from confidence polytopes (reference
    interval.py:268-335)."""

    def __init__(self, tmg, n_points: int = 1000, target_state=None):
        super().__init__(tmg, n_points=n_points, target_state=target_state)

    def setup(self):
        if self.mode == Mode.CHANNEL:
            raise NotImplementedError("This interval works only for state tomography")
        kron_mode = self.tmg.povm_matrix is None
        if kron_mode and getattr(self.tmg, "povm_kron", None) is None:
            raise NotImplementedError(
                "polytope intervals need a measurement design (dense or "
                "kron-factored); run experiment() or set results first"
            )
        if self.target_state is None:
            self.target_state = self.tmg.state
        dim = 2**self.tmg.state.n_qubits
        freq = np.clip(
            self.tmg.results / self.tmg.n_measurements[:, None],
            self.EPS,
            1 - self.EPS,
        )
        if kron_mode:
            # kron-factored design (uniform shots): the LP constraint matrix
            # 2^n * rows[:, 1:] is never materialized — solve_lp_batch_kron
            # applies it as the factored forward/adjoint chains. Weighted
            # row scaling reduces to the identity here (uniform shots:
            # n_m / sum * m == 1), matching the dense branch below.
            _require_uniform_kron_shots(self.tmg, "PolytopeStateInterval")
            from . import kron_core

            row0 = kron_core.kron_row_component(
                self.tmg.povm_kron, self.tmg.state.n_qubits
            )
            c = np.asarray(self.target_state.bloch[1:], dtype=np.float64)
        else:
            m = self.tmg.povm_matrix.shape[0]
            povm_flat = (
                self.tmg.povm_matrix
                * self.tmg.n_measurements[:, None, None]
                / self.tmg.n_measurements.sum()
            ).reshape(-1, self.tmg.povm_matrix.shape[-1]) * m
            a_matrix = povm_flat[:, 1:] * dim
            row0 = povm_flat[:, 0]
            c = np.asarray(self.target_state.bloch[1:], dtype=np.float64)

        max_delta = float(count_delta(1 - 1e-7, freq, self.tmg.n_measurements))
        min_delta = float(count_delta(0.0, freq, self.tmg.n_measurements))
        deltas = np.linspace(min_delta, max_delta, self.n_points)
        b_batch = (
            np.clip(freq.reshape(-1)[None, :] + deltas[:, None], self.EPS, 1 - self.EPS)
            - row0[None, :]
        )
        if kron_mode:
            dist_min, dist_max = self._solve_with(
                lambda cc: solve_lp_batch_kron(
                    cc,
                    self.tmg.povm_kron,
                    self.tmg.state.n_qubits,
                    b_batch,
                    self.LP_ITERS,
                ),
                c, 1 / dim, dim,
            )
        else:
            dist_min, dist_max = self._solve(c, a_matrix, b_batch, 1 / dim, dim)
        conf = np.asarray(count_confidence(deltas, freq, self.tmg.n_measurements))
        self.cl_to_dist_min = _interp1d(conf, dist_min)
        self.cl_to_dist_max = _interp1d(conf, dist_max)


class PolytopeProcessInterval(_PolytopeBase):
    """Process fidelity bounds from confidence polytopes (reference
    interval.py:338-417)."""

    def __init__(self, tmg, n_points: int = 1000, target_channel=None):
        super().__init__(tmg, n_points=n_points, target_channel=target_channel)

    def setup(self):
        channel = self.tmg.channel
        dim_in = dim_out = 2**channel.n_qubits
        dim = dim_in * dim_out
        bloch_indices = [i for i in range(dim**2) if i % dim_out**2 != 0]
        if self.target_channel is None:
            self.target_channel = channel
        t0 = self.tmg.tomographs[0]
        povm_matrix, n_meas = t0.povm_matrix, t0.n_measurements
        freq = np.stack(
            [
                np.clip(t.results / t.n_measurements[:, None], self.EPS, 1 - self.EPS)
                for t in self.tmg.tomographs
            ]
        )
        m = povm_matrix.shape[0]
        meas_flat = (
            povm_matrix * n_meas[:, None, None] / n_meas.sum()
        ).reshape(-1, povm_matrix.shape[-1]) * m
        states_matrix = self.tmg._input_blochs_t()
        c = np.asarray(self.target_channel.choi.bloch, dtype=np.float64)[bloch_indices]

        max_delta = float(count_delta(1 - 1e-7, freq, n_meas))
        min_delta = float(count_delta(0.0, freq, n_meas))
        deltas = np.linspace(min_delta, max_delta, self.n_points)
        b_base = freq.reshape(-1) - np.tile(meas_flat[:, 0], states_matrix.shape[0])
        b_batch = b_base[None, :] + deltas[:, None]
        n_rows = states_matrix.shape[0] * meas_flat.shape[0]
        if n_rows * (dim**2 - dim) > self.DENSE_LP_MAX_ELEMENTS:
            # the constraint matrix is exactly kron(states, weighted povm
            # rows); at 4 qubits dense it would be 86 GB — apply it as the
            # two-factor matvec instead (equality-tested vs dense at 2q)
            b3 = b_batch.reshape(
                len(deltas), states_matrix.shape[0], meas_flat.shape[0]
            )
            dist_min, dist_max = self._solve_with(
                lambda cc: solve_lp_batch_factors(
                    np.asarray(cc).reshape(dim, dim - 1),
                    states_matrix,
                    meas_flat[:, 1:] * dim,
                    b3,
                    self.LP_ITERS,
                ),
                c, 1 / dim, 1.0,
            )
        else:
            a_matrix = (
                np.einsum("ia,jb->ijab", states_matrix, meas_flat[:, 1:]) * dim
            ).reshape(n_rows, -1)
            dist_min, dist_max = self._solve(c, a_matrix, b_batch, 1 / dim, 1.0)
        conf = np.asarray(count_confidence(deltas, freq, n_meas))
        self.cl_to_dist_min = _interp1d(conf, dist_min)
        self.cl_to_dist_max = _interp1d(conf, dist_max)


# --------------------------------------------------------------------------
# Parametric bootstrap
# --------------------------------------------------------------------------


class BootstrapStateInterval(ConfidenceInterval):
    """Empirical CDF of distances over re-simulated experiments — one jitted
    device program (reference interval.py:542-612 loops in Python)."""

    def __init__(
        self,
        tmg,
        n_points: int = 1000,
        method: str = "lin",
        physical: bool = True,
        init: str = "lin",
        tol: float = 1e-3,
        max_iter: int = 100,
        state=None,
        key=None,
    ):
        super().__init__(
            tmg, n_points=n_points, method=method, physical=physical,
            init=init, tol=tol, max_iter=max_iter, state=state, key=key,
        )

    def setup(self):
        import jax

        if self.mode == Mode.CHANNEL:
            raise NotImplementedError("This interval works only for state tomography")
        if self.state is None:
            if hasattr(self.tmg, "reconstructed_state"):
                self.state = self.tmg.reconstructed_state
            else:
                self.state = self.tmg.point_estimate(
                    method=self.method, physical=self.physical,
                    init=self.init, tol=self.tol, max_iter=self.max_iter,
                )
        dst_name = {hs_dst: "hs", trace_dst: "trace", if_dst: "if"}.get(self.tmg.dst)
        key = self.key if self.key is not None else jax.random.key(17)
        if (
            self.tmg.povm_matrix is None
            and getattr(self.tmg, "povm_kron", None) is not None
        ):
            if dst_name is None:
                raise NotImplementedError(
                    "custom distance callables are not supported on the "
                    "kron-factored bootstrap path (hs/trace/if only)"
                )
            _require_uniform_kron_shots(self.tmg, "BootstrapStateInterval")
            from . import kron_core

            dist = np.asarray(
                kron_core.kron_bootstrap_distances(
                    key,
                    np.asarray(self.state.bloch, dtype=np.float64),
                    self.tmg.povm_kron,
                    self.tmg.state.n_qubits,
                    float(self.tmg.n_measurements[0]),
                    n_points=self.n_points,
                    method=self.method,
                    dst=dst_name,
                    max_iter=self.max_iter,
                    physical=self.physical,
                    init=self.init,
                ),
                dtype=np.float64,
            )
        elif dst_name is not None:
            dist = np.asarray(
                bootstrap_core.bootstrap_distances(
                    key,
                    np.asarray(self.state.bloch, dtype=np.float64),
                    self.tmg.povm_matrix,
                    self.tmg.n_measurements,
                    n_points=self.n_points,
                    method=self.method,
                    dst=dst_name,
                    max_iter=self.max_iter,
                    physical=self.physical,
                    init=self.init,
                    tol=self.tol,
                ),
                dtype=np.float64,
            )
        else:  # custom host distance: device estimates, host metric
            blochs = np.asarray(
                bootstrap_core.bootstrap_blochs(
                    key,
                    np.asarray(self.state.bloch, dtype=np.float64),
                    self.tmg.povm_matrix,
                    self.tmg.n_measurements,
                    n_points=self.n_points,
                    method=self.method,
                    max_iter=self.max_iter,
                    physical=self.physical,
                    init=self.init,
                    tol=self.tol,
                ),
                dtype=np.float64,
            )
            from ..qobj import Qobj

            dist = np.asarray(
                [self.tmg.dst(Qobj(b), self.state) for b in blochs]
            )
        dist = np.sort(dist)
        self.cl_to_dist = _interp1d(np.linspace(0, 1, len(dist)), dist)


class BootstrapProcessInterval(ConfidenceInterval):
    """Process bootstrap: batched simulate + lifp(+CPTP) + Choi distance on
    device (reference interval.py:615-685 loops in Python).

    At 4+ qubit channels the lifp re-estimation projects ALL resamples at
    once with the matmul-only Newton-Schulz Dykstra engine
    (`cp_engine='ns'`, host-chunked iterations): it runs on batched
    matmuls where the eigh engine runs a batched eigh per resample chunk.
    `cp_engine` forces the engine ('eigh'/'ns'); `cptp_iter` caps the
    Dykstra iterations of the bootstrap projection (default on the NS
    path: 50 at <= 4 qubits, 100 above: at 4 qubits the d50/d90 quantiles
    under caps 50/100/200/400 and under the full-tolerance eigh path agree
    to 4e-4 while cap 25 shifts them +0.9 percent; at 5 qubits the deeper
    1024-dim spectrum DOES need 100 — cap 50 shifts d50/d90 +4.3 percent
    there. Also equality-tested against eigh at 2 qubits).

    The NS-Dykstra projection dominated the 4-qubit pipeline on the
    earlier target, so time per resample should scale ~1/cptp_iter (not
    measured on the H100); a cap of 37 shifts d50/d90 by +0.4 percent,
    25 by +1.8. The default stays at the agreement bar above."""

    def __init__(
        self,
        tmg,
        n_points: int = 1000,
        method: str = "lifp",
        cptp: bool = True,
        tol: float = 1e-10,
        channel=None,
        states_est_method: str = "lin",
        states_physical: bool = True,
        states_init: str = "lin",
        key=None,
        cp_engine: str | None = None,
        cptp_iter: int | None = None,
    ):
        super().__init__(
            tmg, n_points=n_points, method=method, cptp=cptp, tol=tol,
            channel=channel, states_est_method=states_est_method,
            states_physical=states_physical, states_init=states_init, key=key,
            cp_engine=cp_engine, cptp_iter=cptp_iter,
        )

    def setup(self):
        import jax
        import jax.numpy as jnp

        from ..config import rdtype
        from . import process_core

        if self.mode == Mode.STATE:
            raise NotImplementedError(
                "This interval works only for process tomography"
            )
        if self.channel is None:
            if hasattr(self.tmg, "reconstructed_channel"):
                self.channel = self.tmg.reconstructed_channel
            else:
                self.channel = self.tmg.point_estimate(
                    method=self.method, cptp=self.cptp,
                    states_est_method=self.states_est_method,
                    states_physical=self.states_physical,
                    states_init=self.states_init,
                )
        key = self.key if self.key is not None else jax.random.key(19)
        t0 = self.tmg.tomographs[0]
        # output states of the bootstrap channel on the input basis
        out_blochs = np.stack(
            [
                self.channel.transform(s).bloch
                for s in self.tmg.input_basis.elements
            ]
        )
        n_points = self.n_points
        counts = process_core.simulate_process_experiment(
            key,
            jnp.asarray(t0.povm_matrix, dtype=rdtype()),
            jnp.broadcast_to(
                jnp.asarray(out_blochs, dtype=rdtype()),
                (n_points,) + out_blochs.shape,
            ),
            jnp.asarray(t0.n_measurements, dtype=rdtype()),
        )
        input_blochs_t = jnp.asarray(self.tmg._input_blochs_t(), dtype=rdtype())
        povm = jnp.asarray(t0.povm_matrix, dtype=rdtype())
        n_meas = jnp.asarray(t0.n_measurements, dtype=rdtype())
        n_ch = self.tmg.channel.n_qubits

        cp = self.cp_engine or ("ns" if n_ch >= 4 else "eigh")

        def estimate_chunk(c):
            if self.method == "lifp":
                if cp == "ns":
                    # whole-batch path: raw factored inversion, then ONE
                    # host-chunked Newton-Schulz Dykstra over every resample
                    # at once (batched matmuls, no per-resample eigh) — the
                    # iteration cap is ample feasibility at the bootstrap's
                    # statistical distance scale
                    raw = process_core.estimate_lifp_factored(
                        c, input_blochs_t, povm, n_meas, cptp=False
                    )
                    if not self.cptp:
                        return raw
                    # iteration chunk scaled so one device call stayed under
                    # a single-execution time limit of the earlier target
                    # (ROADMAP C1): per-call work grows as n_points * dim^3
                    # (batched NS matmuls), so normalize the 4-qubit-tuned
                    # budget (12800 iter-resamples at dim 256) by the cubed
                    # dimension ratio
                    dim_factor = (2.0 ** (2 * n_ch) / 256.0) ** 3
                    it_chunk = int(np.clip(
                        12800.0 / (max(n_points, 1) * dim_factor), 1, 100
                    ))
                    return process_core.cptp_project_bloch_host(
                        raw,
                        max_iter=self.cptp_iter or (50 if n_ch <= 4 else 100),
                        chunk=it_chunk,
                        cp="ns",
                    )
                return process_core.estimate_lifp_factored(
                    c, input_blochs_t, povm, n_meas, cptp=self.cptp,
                    cptp_iter=self.cptp_iter or 2000,
                )
            if self.method == "pgdb":
                pgdb = (
                    process_core.estimate_pgdb_factored_host
                    if n_ch >= 4
                    else process_core.estimate_pgdb_factored
                )
                return pgdb(c, input_blochs_t, povm, n_meas)
            if self.method == "dys":
                return process_core.estimate_dys_factored(
                    c, input_blochs_t, povm, n_meas
                )
            if self.method == "states":
                from . import state_core
                from ..ops.cplx import to_pair

                est_blochs = state_core.estimate(
                    c, t0.povm_matrix, t0.n_measurements,
                    method=self.states_est_method,
                    physical=self.states_physical, init=self.states_init,
                )
                dec_pair = to_pair(self.tmg._decomposed_single_entries)
                blochs = process_core.states_to_choi_bloch(est_blochs, dec_pair)
                if self.cptp:
                    # unconditional batched projection (the reference
                    # projects only samples failing is_cptp,
                    # process.py:325-327; projecting a CPTP point is a
                    # no-op up to tolerance)
                    blochs = process_core.cptp_project_bloch(blochs)
                return blochs
            raise ValueError("Incorrect value for argument `method`")

        # 4+ qubit channels: chunk the resample batch so the Dykstra-heavy
        # re-estimation stayed under a single-execution time limit of the
        # earlier target (ROADMAP C1). The lifp+NS path needs no resample
        # chunking — its projection host-chunks the Dykstra ITERATIONS over
        # the whole batch instead.
        whole_batch = n_ch < 4 or (self.method == "lifp" and cp == "ns")
        chunk = n_points if whole_batch else 8
        if chunk >= n_points:
            choi_blochs = estimate_chunk(counts)
        else:
            choi_blochs = jnp.concatenate(
                [
                    estimate_chunk(counts[lo : lo + chunk])
                    for lo in range(0, n_points, chunk)
                ]
            )
        ref_bloch = jnp.asarray(self.channel.choi.bloch, dtype=rdtype())
        n2 = 2 * self.tmg.channel.n_qubits
        dst_name = {hs_dst: "hs", trace_dst: "trace", if_dst: "if"}.get(self.tmg.dst)
        if dst_name is not None:
            dist = np.asarray(
                bootstrap_core._distance_batch(dst_name, choi_blochs, ref_bloch, n2),
                dtype=np.float64,
            )
        else:  # custom host distance callable: decode Choi samples host-side
            from ..qobj import Qobj

            mats = np_bloch_to_matrix(
                np.asarray(choi_blochs, dtype=np.float64), n2
            )
            dist = np.asarray(
                [self.tmg.dst(Qobj(m), self.channel.choi) for m in mats]
            )
        dist = np.sort(dist)
        self.cl_to_dist = _interp1d(np.linspace(0, 1, len(dist)), dist)


# --------------------------------------------------------------------------
# MHMC likelihood-sampling intervals
# --------------------------------------------------------------------------


class MHMCStateInterval(ConfidenceInterval):
    """Distances of likelihood samples (Cholesky parametrization) to the
    point estimate (reference interval.py:688-759)."""

    def __init__(
        self,
        tmg,
        n_points: int = 1000,
        step: float = 0.01,
        burn_steps: int = 1000,
        thinning: int = 1,
        warm_start: bool = False,
        use_new_estimate: bool = False,
        state=None,
        verbose: bool = False,
        key=None,
        temper: bool = True,
        adapt_step: bool = False,
        n_chains: int = 1,
        jump_distr=None,
        mesh=None,
        jump_logpdf=None,
    ):
        """`temper=True` (default) samples exp(-NLL/N) like the reference
        (its _nll is frequency-normalized, state.py:217-229) — a posterior
        flattened by the total shot count, giving very wide intervals.
        `temper=False` samples the true count-weighted likelihood.
        `adapt_step=True` tunes the proposal scale during burn-in toward a
        ~25 percent acceptance rate (see MHMC.adapt_step).
        `n_chains > 1` runs that many independent chains vmapped in
        parallel (each with its own burn-in) and reports the split-R-hat
        and effective-sample-size diagnostics (`r_hat`, `ess` attributes)
        of the distance series. `jump_distr` selects the proposal (see
        MHMC); an ASYMMETRIC proposal additionally needs `jump_logpdf`
        (callable(delta) -> log q(delta)) for the Hastings correction
        (reference mhmc.py:99-103). `mesh` (a jax.sharding.Mesh) shards
        the chains of an `n_chains > 1` run over the mesh devices (dense
        designs, symmetric proposals only); `adapt_step` still tunes the
        proposal locally before dispatch."""
        super().__init__(
            tmg, n_points=n_points, step=step, burn_steps=burn_steps,
            thinning=thinning, warm_start=warm_start,
            use_new_estimate=use_new_estimate, state=state, verbose=verbose,
            key=key, temper=temper, adapt_step=adapt_step,
            n_chains=n_chains, jump_distr=jump_distr, mesh=mesh,
            jump_logpdf=jump_logpdf,
        )

    def setup(self):
        from ..mhmc import effective_sample_size, split_rhat

        if self.mode == Mode.CHANNEL:
            raise NotImplementedError("This interval works only for state tomography")
        if not self.use_new_estimate:
            self.state = self.tmg.reconstructed_state
        elif self.state is None:
            self.state = self.tmg.point_estimate(method="mle", physical=True)

        dim = 4**self.tmg.state.n_qubits
        if not (self.warm_start and hasattr(self, "chain")):
            # jitter for a strictly-PD Cholesky start (the feasibility
            # projection floors eigenvalues at 1e-15)
            mat = self.state.matrix + 1e-7 * np.eye(self.state.matrix.shape[0])
            mat = mat / np.trace(mat).real
            x_init = np_matrix_to_real_tril_vec(mat)
            scale = 1.0 if self.temper else float(np.sum(self.tmg.n_measurements))
            self.chain = MHMC(
                lambda x: -scale * self.tmg._nll(x),
                jump_distr=self.jump_distr,
                step=self.step,
                burn_steps=self.burn_steps,
                dim=dim,
                update_rule=normalized_update,
                symmetric=self.jump_logpdf is None,
                jump_logpdf=self.jump_logpdf,
                x_init=x_init,
                key=self.key,
            )
            if self.adapt_step:
                self.chain.adapt_step()
        if self.n_chains > 1 and self.mesh is not None:
            if self.tmg.povm_matrix is None:
                raise NotImplementedError(
                    "mesh-sharded MHMC chains need a dense design"
                )
            if self.jump_logpdf is not None:
                raise NotImplementedError(
                    "mesh-sharded chains support symmetric proposals only"
                )
            from ..parallel import sharded_mhmc_state_chains
            from .state_core import weighted_povm_flat

            per_chain = -(-self.n_points // self.n_chains)
            flat = self.tmg.flat_results
            scale = 1.0 if self.temper else float(np.sum(self.tmg.n_measurements))
            samples, self.acceptance_rate = sharded_mhmc_state_chains(
                self.mesh,
                self.chain._next_key(),
                self.chain.x_t,
                weighted_povm_flat(
                    self.tmg.povm_matrix, self.tmg.n_measurements
                ),
                flat / flat.sum(),
                self.tmg.state.n_qubits,
                scale,
                self.chain.step,
                self.n_chains,
                per_chain,
                burn_steps=self.burn_steps,
                thinning=self.thinning,
                jump_distr=self.jump_distr,
            )
            chain_shape = samples.shape[:2]
            samples = samples.reshape(-1, samples.shape[-1])
        elif self.n_chains > 1:
            per_chain = -(-self.n_points // self.n_chains)
            samples, self.acceptance_rate = self.chain.sample_chains(
                per_chain, self.n_chains, self.thinning
            )
            chain_shape = samples.shape[:2]  # (n_chains, per_chain)
            samples = samples.reshape(-1, samples.shape[-1])
        else:
            samples, self.acceptance_rate = self.chain.sample(
                self.n_points, self.thinning, verbose=self.verbose
            )
            chain_shape = (1, samples.shape[0])
        dst_name = {hs_dst: "hs", trace_dst: "trace", if_dst: "if"}.get(self.tmg.dst)
        if dst_name is not None:
            dist = np.asarray(
                bootstrap_core.tril_samples_distance(
                    dst_name,
                    samples,
                    np.asarray(self.state.bloch, dtype=np.float64),
                    self.tmg.state.n_qubits,
                )
            )
        else:  # custom host distance callable: decode samples host-side
            from ..ops.cholesky import np_real_tril_vec_to_matrix
            from ..qobj import Qobj

            rho = np_real_tril_vec_to_matrix(np.asarray(samples, dtype=np.float64))
            tr = np.trace(rho, axis1=-2, axis2=-1).real
            rho = rho / tr[..., None, None]
            dist = np.asarray([self.tmg.dst(Qobj(r), self.state) for r in rho])
        # convergence diagnostics on the distance series
        per_chain_dist = dist.reshape(chain_shape)
        self.r_hat = split_rhat(per_chain_dist)
        self.ess = effective_sample_size(per_chain_dist)
        _warn_if_nonconverged(type(self).__name__, self.r_hat, self.ess)
        dist = np.sort(dist)
        self.cl_to_dist = _interp1d(np.linspace(0, 1, len(dist)), dist)


class MHMCProcessInterval(ConfidenceInterval):
    """Likelihood sampling over Choi matrices with CPTP-projected proposals
    (reference interval.py:762-850). Samples live in the real Choi-bloch
    space (the reference samples complex vecs; every proposal is CPTP-
    projected in both versions, so the support is identical). At
    `PROJECTED_TARGET_QUBITS`+ the chain switches to the projected-
    likelihood formulation (see setup) — the reference scheme freezes
    there (measured)."""

    #: from this qubit count on, sample the projected-likelihood target
    PROJECTED_TARGET_QUBITS = 4

    def __init__(
        self,
        tmg,
        n_points: int = 1000,
        step: float = 0.01,
        burn_steps: int = 1000,
        thinning: int = 1,
        warm_start: bool = False,
        method: str = "lifp",
        states_est_method: str = "lin",
        states_physical: bool = True,
        states_init: str = "lin",
        use_new_estimate: bool = False,
        channel=None,
        verbose: bool = False,
        return_samples: bool = False,
        key=None,
        adapt_step: bool = False,
        n_chains: int = 1,
        jump_distr=None,
        mesh=None,
        jump_logpdf=None,
        temper: bool = False,
        proposal: str = "rw",
        precondition: bool = True,
        parametrization: str = "bloch",
        mode_seek: int | None = None,
        anchored: bool = True,
        curv_probes: int = 32,
    ):
        """`temper=False` (the default) samples exp(-NLL) with the
        raw-count NLL exactly like the reference (process.py:310-314) —
        at 4+ qubits the ~10^7-count posterior is so peaked that a
        random-walk chain needs microscopic steps and mixes glacially.
        `temper=True` divides the NLL by the total count (the same
        flattening MHMCStateInterval applies by default); measured at 4
        qubits it over-flattens — prefer the default.
        `proposal='mala'` (projected-target mode only) drives the chain
        with the gradient of the projected-likelihood target through the
        differentiable NS projection (MALA with the exact state-dependent
        Hastings ratio) — the measured route to actual mixing at 65k
        dimensions, where the random walk's autocorrelation time is ~7k
        steps. `precondition=True` (the default)
        runs the MALA chain in Kronecker-Fisher-whitened coordinates
        (process_core.kron_fisher_whitener) — unpreconditioned MALA's
        stable step is set by the stiffest Hessian direction and the
        chain barely moves (measured: R-hat 7.9).
        `parametrization='kraus'` samples a SMOOTH exactly-CPTP
        parametrization instead of projecting at all: the chain lives in
        the real/imag entries of a factor M with
        Choi = (L^{-1} (x) I) MM^H (L^{-H} (x) I), L = chol(Tr_out MM^H)
        (process_core.kraus_param_to_choi_bloch) — both constraints hold
        by construction, the target is C^inf so MALA works, and each step
        is ~100x cheaper than a projected-target step (no 100-iteration
        Dykstra). The sampled law is the pushforward of exp(-NLL) through
        the parametrization (the reference's project-the-proposal scheme,
        interval.py:839, is likewise not measure-exact — and freezes at 4
        qubits). Works at any qubit count and with
        either proposal. With `precondition=True` the kraus chain runs in
        M-space design-whitened coordinates
        (process_core.kraus_design_whitener: measured-operator Gram on the
        left index, floored Choi estimate on the right) — without it the
        stable step is set by the stiffest raw-count curvature direction.
        `mode_seek` (kraus mode; default 500 there, 0 otherwise) first
        ascends the smooth target with that many Adam steps
        (mhmc.maximize_logpdf): the projected linear inversion is NOT the
        smooth target's mode (measured 4q gap: ~1.2e5 NLL), and a chain
        adapted in that transient freezes at a transient-sized step.
        `anchored=True` (default, kraus mode) evaluates the target with
        the ANCHORED EXACT-DELTA decode
        (process_core.np_kraus_anchor_pack): the chain state is the offset
        dz = z - z_ref from a host-f64 anchor (re-anchored at the mode
        after mode_seek) and every state-dependent quantity is an exact
        function of dz — the f32 rounding field then scales with the
        posterior-sized |dX| instead of |X|. Measured on the 4q config:
        the round-3 target's deterministic rounding field (max ~10, rms
        ~3 over a DNLL~300 line — the wall that froze 4q chains) drops to
        max 0.011 / rms 0.003, ~30x under the ~0.3 log-ratio budget of a
        4e7-count posterior. `anchored=False` restores the round-3
        full-decode rel-form target.
        `curv_probes` (anchored kraus mode; 0 disables) estimates the
        diagonal of the target's Hessian AT THE ANCHOR with that many
        Hutchinson HVP probes and runs the chain in the rescaled
        coordinates u = dz * sqrt(diag H): the structured design whitener
        leaves residual curvature anisotropy that otherwise sets the
        stable step from the stiffest direction alone (measured 4q:
        curvature ~2-4e6 along the gradient in 'unit-rms' whitened
        coordinates while MALA acceptance was 0.00 already at step 1e-4,
        and adaptation collapsed the step to 1.5e-7 where the chain
        could not traverse the posterior within any feasible budget).

        **Choosing a process CI at 4+ qubits:**
        this sampler is precision-clean (anchored df32 target) and
        convergent through 3 qubits, but at 4 qubits the posterior
        geometry itself is the wall — a measured, two-seed-reproduced
        Lanczos spectrum of the whitened target Hessian shows ~12,600
        stiff directions spanning [1e2, 1e6) curvature (top-100 Ritz
        values converged), so no
        low-rank+diagonal metric fits the MALA step budget and a dense
        metric does not fit the machine. Use
        :class:`BootstrapProcessInterval` at 4+ qubits; this class's
        R-hat/ESS RuntimeWarning will fire if you
        sample a 4+ qubit chain anyway. The reference's sampler
        (interval.py:762-850) faces the same geometry and additionally
        freezes outright at 4 qubits (projection scheme)."""
        super().__init__(
            tmg, n_points=n_points, step=step, burn_steps=burn_steps,
            thinning=thinning, warm_start=warm_start, method=method,
            states_est_method=states_est_method,
            states_physical=states_physical, states_init=states_init,
            use_new_estimate=use_new_estimate, channel=channel,
            verbose=verbose, return_samples=return_samples, key=key,
            adapt_step=adapt_step, n_chains=n_chains, jump_distr=jump_distr,
            mesh=mesh, jump_logpdf=jump_logpdf, temper=temper,
            proposal=proposal, precondition=precondition,
            parametrization=parametrization, mode_seek=mode_seek,
            anchored=anchored, curv_probes=curv_probes,
        )
        if parametrization not in ("bloch", "kraus"):
            raise ValueError(
                "parametrization must be 'bloch' (projected chains) or "
                "'kraus' (smooth exactly-CPTP factor chains)"
            )

    def setup(self):
        from ..mhmc import effective_sample_size, split_rhat

        if self.mode == Mode.STATE:
            raise NotImplementedError(
                "This interval works only for process tomography"
            )
        if not self.use_new_estimate:
            self.channel = self.tmg.reconstructed_channel
        elif self.channel is None:
            self.channel = self.tmg.point_estimate(
                self.method,
                states_est_method=self.states_est_method,
                states_physical=self.states_physical,
                states_init=self.states_init,
            )
        dim = 16**self.tmg.channel.n_qubits
        big = self.tmg.channel.n_qubits >= self.PROJECTED_TARGET_QUBITS
        if not (self.warm_start and hasattr(self, "chain")):
            self._to_x = None
            self._decode_kraus = None
            x_init = np.asarray(self.channel.choi.bloch, dtype=np.float64)
            # (a numeric-temper sqrt(T) rescale was built and MEASURED
            # invalid here: the CPTP boundary truncates the T-widened
            # posterior, so radii grow slower than sqrt(T) in a 2q T-scan.
            # Only the reference-style bool temper ships.)
            scale = (
                1.0 / float(sum(np.sum(t.n_measurements) for t in self.tmg.tomographs))
                if self.temper
                else 1.0
            )
            if self.parametrization == "kraus":
                # smooth exactly-CPTP factor chain — no projection in the
                # target or the decode (see the class docstring); the chain
                # state is the flattened re/im pair of the factor M
                import jax
                import jax.numpy as jnp

                from . import process_core, state_core
                from ..config import rdtype
                from ..mhmc import basic_update

                d_choi = 4**self.tmg.channel.n_qubits
                self._proj = None
                self._decode_kraus = d_choi
                y0 = process_core.np_kraus_param_from_choi_bloch(x_init)
                t0 = self.tmg.tomographs[0]
                b_dev = jnp.asarray(self.tmg._input_blochs_t(), rdtype())
                w_dev = state_core.weighted_povm_flat(
                    t0.povm_matrix, t0.n_measurements
                )
                flat_np = np.concatenate(
                    [t.flat_results for t in self.tmg.tomographs]
                )
                # anchor the NLL at the point estimate in DELTA form
                # (process_nll_factored_rel docstring: two f32 failure
                # modes measured at 4 qubits); p_ref is computed with the
                # SAME dtype/forward as the chain's delta form
                x_ref_dev = jnp.asarray(x_init, rdtype())
                p_ref = d_choi * jnp.einsum(
                    "sa,ab,kb->sk",
                    b_dev,
                    x_ref_dev.reshape(d_choi, d_choi),
                    w_dev,
                ).reshape(-1)
                flat_dev = jnp.asarray(flat_np, rdtype())
                self._kraus_whiten = None
                a_l_np = a_r_np = None
                if self.precondition:
                    # M-space design-curvature whitening (see
                    # process_core.kraus_design_whitener): the raw-count
                    # NLL's stiffest M directions otherwise set the stable
                    # step for the WHOLE 2*16^n-dim chain
                    from ..ops.cplx import to_pair

                    a_l, a_r, a_l_inv, a_r_inv = (
                        process_core.kraus_design_whitener(
                            self.tmg._input_blochs_t(),
                            np.asarray(w_dev),
                            flat_np,
                            x_init,
                        )
                    )
                    m0 = y0[0] + 1j * y0[1]
                    z0 = a_l_inv @ m0 @ a_r_inv
                    # normalize the whitened coordinates to unit rms: the
                    # Gram factors carry the raw count scale, leaving z0 at
                    # ~O(1e2-1e7) magnitude where f32 cannot represent
                    # posterior-sized moves (measured: proposals rounded to
                    # no-ops and 'acceptance' was accept-coin-flips on
                    # x' == x)
                    s_norm = float(np.sqrt(np.mean(np.abs(z0) ** 2)))
                    if s_norm > 0:
                        a_l = a_l * s_norm
                        z0 = z0 / s_norm
                    y0 = np.stack([z0.real, z0.imag], axis=0)
                    a_l_np, a_r_np = a_l, a_r
                    al_pair = to_pair(a_l)
                    ar_pair = to_pair(a_r)
                    self._kraus_whiten = (al_pair, ar_pair)

                    def _decode_z(zf):
                        return process_core.kraus_param_to_choi_bloch_whitened(
                            zf.reshape(2, d_choi, d_choi), al_pair, ar_pair
                        )

                else:

                    def _decode_z(zf):
                        return process_core.kraus_param_to_choi_bloch(
                            zf.reshape(2, d_choi, d_choi)
                        )

                self._kraus_decode = _decode_z
                self._kraus_anchor = None
                seek = 500 if self.mode_seek is None else int(self.mode_seek)
                b_np = np.asarray(self.tmg._input_blochs_t(), np.float64)
                w_np = np.asarray(w_dev, np.float64)
                if self.anchored:
                    # anchored exact-delta target (see the class docstring
                    # and process_core.np_kraus_anchor_pack): chain state =
                    # offset dz from a host-f64 anchor; re-anchored at the
                    # mode after mode_seek so the chain's bulk stays in the
                    # smallest-|dz| (most accurate) region
                    z_ref = y0[0] + 1j * y0[1]

                    def _make_anchor(z_ref_c):
                        pack, x_ref_b = process_core.np_kraus_anchor_pack(
                            z_ref_c, a_l_np, a_r_np
                        )
                        p_ref_a = jnp.asarray(
                            d_choi
                            * np.einsum(
                                "sa,ab,kb->sk",
                                b_np,
                                x_ref_b.reshape(d_choi, d_choi),
                                w_np,
                            ).reshape(-1),
                            rdtype(),
                        )

                        def tgt(dzf):
                            return -scale * process_core.process_nll_anchored(
                                dzf, b_dev, w_dev, flat_dev, pack, p_ref_a
                            )

                        return pack, x_ref_b, p_ref_a, tgt

                    pack, x_ref_b, p_ref_a, target = _make_anchor(z_ref)
                    rms_ref = float(np.sqrt(np.mean(y0**2))) or 1.0
                    x_init = np.zeros(2 * d_choi * d_choi, dtype=np.float64)
                    dim = x_init.shape[0]
                    if seek > 0:
                        from ..mhmc import maximize_logpdf

                        dz_mode = np.asarray(
                            maximize_logpdf(
                                target, x_init, n_steps=seek, lr=3e-3 * rms_ref
                            ),
                            dtype=np.float64,
                        )
                        z_ref = z_ref + (
                            dz_mode.reshape(2, d_choi, d_choi)[0]
                            + 1j * dz_mode.reshape(2, d_choi, d_choi)[1]
                        )
                        pack, x_ref_b, p_ref_a, target = _make_anchor(z_ref)
                    self._kraus_anchor = (pack, x_ref_b)
                    self._kraus_uscale = None
                    if self.curv_probes:
                        # measured-curvature diagonal rescale (see the
                        # class docstring): Hutchinson diag-Hessian at the
                        # anchor, chain runs in u = dz / s with
                        # s = 1/sqrt(diag H) so unit coordinate curvature
                        n_probe = int(self.curv_probes)
                        zdim = 2 * d_choi * d_choi
                        _neg = lambda dzf: -target(dzf)  # noqa: E731
                        _gfun = jax.grad(_neg)
                        _zero = jnp.zeros(zdim, rdtype())

                        @jax.jit
                        def _diag_est(k):
                            def body(acc, kk):
                                v = jax.random.rademacher(
                                    kk, (zdim,), rdtype()
                                )
                                hv = jax.jvp(_gfun, (_zero,), (v,))[1]
                                return acc + v * hv, None

                            acc, _ = jax.lax.scan(
                                body, _zero, jax.random.split(k, n_probe)
                            )
                            return acc / n_probe

                        h_diag = np.asarray(
                            _diag_est(jax.random.key(2024)), np.float64
                        )
                        pos = h_diag[h_diag > 0]
                        med = float(np.median(pos)) if pos.size else 1.0
                        # floor: Hutchinson off-diagonal noise makes some
                        # entries ~0/negative (and exact-gauge directions
                        # of M -> M U have zero curvature); cap the scale
                        # amplification at 100x the median direction
                        h_safe = np.clip(h_diag, 1e-4 * med, None)
                        s_u = 1.0 / np.sqrt(h_safe)
                        s_dev = jnp.asarray(s_u, rdtype())
                        _anchored_target = target

                        def _target_u(uf):
                            return _anchored_target(uf * s_dev)

                        target = _target_u
                        self._kraus_uscale = s_u
                    # context for the mesh-sharded chain dispatch
                    self._kraus_sharded_ctx = (
                        pack, b_dev, w_dev, flat_dev, p_ref_a, scale
                    )
                else:
                    x_init = y0.reshape(-1)
                    dim = x_init.shape[0]

                    def _target_kraus(yf):
                        return -scale * process_core.process_nll_factored_rel(
                            _decode_z(yf), b_dev, w_dev, flat_dev,
                            x_ref_dev, p_ref,
                        )

                    target = _target_kraus
                    if seek > 0:
                        # ascend to the smooth target's mode before sampling —
                        # the projected linear inversion is a transient start
                        # (see the class docstring)
                        from ..mhmc import maximize_logpdf

                        rms0 = float(np.sqrt(np.mean(x_init**2))) or 1.0
                        x_init = np.asarray(
                            maximize_logpdf(
                                target, x_init, n_steps=seek, lr=3e-3 * rms0
                            ),
                            dtype=np.float64,
                        )
                drift_fn = (
                    jax.grad(target) if self.proposal == "mala" else None
                )
                update_rule = basic_update
            elif big:
                # projected-likelihood target: sample UNCONSTRAINED y
                # against exp(-NLL(P(y))) with P the (NS) CPTP projection,
                # and report P(y). The reference scheme (project the
                # proposal, then compare raw NLLs, interval.py:839 +
                # process.py:280-282) freezes at 4 qubits: a truncated
                # projection's output is not a fixed point of the
                # projection, so project(x + tiny) jumps by the retained
                # infeasibility residual and the ~1e7-count NLL amplifies
                # that into certain rejection (measured: acceptance 0.000
                # at step 1e-9). NLL(P(y)) is continuous in y, so small
                # steps accept and standard adaptation works; the sampled
                # law is the projection pushforward of the same
                # likelihood. Documented divergence at 4+ qubits only.
                from . import process_core, state_core
                from ..mhmc import basic_update

                cptp_tol = process_core.default_cptp_tol(1e-12)

                def _proj(y):
                    return process_core.cptp_project_bloch(
                        y, 100, cptp_tol, "ns"
                    )

                self._proj = _proj
                drift_fn = None
                unwhiten = None
                if self.precondition:
                    # Kronecker-Fisher whitening (both proposals): the
                    # 65k-dim posterior is strongly anisotropic and the
                    # stiffness is not axis-aligned (a diagonal Fisher
                    # preconditioner did not cut R-hat; unpreconditioned
                    # MALA's stable step is set by the stiffest Hessian
                    # direction — measured). Running
                    # the SAME chain in the whitened coordinates
                    # z = (L_B^T (x) L_W^T) x is exactly a chain with
                    # proposal covariance ~ H^-1 of the K-FAC Gauss-Newton
                    # metric (kron_fisher_whitener): two d1 x d1 matmuls
                    # per target call, negligible next to the 100-step NS
                    # projection.
                    import jax.numpy as jnp

                    from ..config import rdtype

                    t0 = self.tmg.tomographs[0]
                    a_b, a_w, l_b, l_w = process_core.kron_fisher_whitener(
                        self.tmg._input_blochs_t(),
                        np.asarray(
                            state_core.weighted_povm_flat(
                                t0.povm_matrix, t0.n_measurements
                            )
                        ),
                        np.concatenate(
                            [t.flat_results for t in self.tmg.tomographs]
                        ),
                        x_init,
                    )
                    d1 = a_b.shape[0]
                    a_b_dev = jnp.asarray(a_b, rdtype())
                    a_w_t_dev = jnp.asarray(a_w.T, rdtype())

                    def unwhiten(z):
                        return (
                            a_b_dev @ z.reshape(d1, d1) @ a_w_t_dev
                        ).reshape(-1)

                    def _to_x(zs):
                        z3 = np.asarray(zs, np.float64).reshape(-1, d1, d1)
                        return (a_b @ (z3 @ a_w.T)).reshape(z3.shape[0], -1)

                    self._to_x = _to_x
                    # chain state lives in z: whiten the start point
                    x_init = (
                        l_b.T @ x_init.reshape(d1, d1) @ l_w
                    ).reshape(-1)
                if self.proposal == "mala":
                    # MALA on the projected-likelihood target: the NS
                    # Dykstra projection is fixed-length scanned matmuls,
                    # so grad flows through it
                    # (process_core.cptp_project_bloch_diff); drift and
                    # logpdf use the SAME differentiable projection so the
                    # chain is exact for its target
                    import jax

                    if unwhiten is not None:

                        def _target_d(z):
                            return -scale * self.tmg._nll(
                                process_core.cptp_project_bloch_diff(
                                    unwhiten(z), 100
                                )
                            )

                    else:

                        def _target_d(y):
                            return -scale * self.tmg._nll(
                                process_core.cptp_project_bloch_diff(y, 100)
                            )

                    target = _target_d
                    drift_fn = jax.grad(_target_d)
                elif unwhiten is not None:
                    target = lambda z: -scale * self.tmg._nll(_proj(unwhiten(z)))  # noqa: E731
                else:
                    target = lambda y: -scale * self.tmg._nll(_proj(y))  # noqa: E731
                if (
                    not self.precondition
                    and self.proposal != "mala"
                    and self.jump_distr is None
                ):
                    # legacy diagonal Fisher proposal (precondition=False):
                    # per-axis scales ~ 1/sqrt(diag(A^T A)) with
                    # diag(A^T A) = 16^n colsq(B) (x) colsq(W) — still a
                    # symmetric proposal (fixed scales, no Hastings term).
                    # Kept as the fallback the K-FAC whitening superseded
                    # (measured: the diagonal did not reduce R-hat).
                    import jax.numpy as jnp

                    from ..config import rdtype

                    t0 = self.tmg.tomographs[0]
                    bsq = np.sum(
                        np.asarray(self.tmg._input_blochs_t()) ** 2, axis=0
                    )
                    w = np.asarray(
                        state_core.weighted_povm_flat(
                            t0.povm_matrix, t0.n_measurements
                        )
                    )
                    wsq = np.sum(w**2, axis=0)
                    fisher_diag = np.kron(bsq, wsq)
                    scales = 1.0 / np.sqrt(
                        fisher_diag + 1e-6 * fisher_diag.max()
                    )
                    scales = scales / np.median(scales)
                    scales_dev = jnp.asarray(scales, rdtype())

                    def _precond_jump(key, shape, dtype):
                        import jax

                        return jax.random.normal(key, shape, dtype) * scales_dev

                    self.jump_distr = _precond_jump
                update_rule = basic_update
            else:
                if self.proposal == "mala":
                    raise NotImplementedError(
                        "proposal='mala' is the projected-target mode "
                        f"(>= {self.PROJECTED_TARGET_QUBITS} qubits)"
                    )
                self._proj = None
                drift_fn = None
                target = lambda y: -scale * self.tmg._nll(y)  # noqa: E731
                update_rule = self.tmg._cptp_update_rule
            # non-anchored kraus-mode f32 targets carry O(1) evaluation
            # noise (count-amplified rounding); stored-logp chains stick on
            # +noise flukes there — refresh the current-state logp every
            # step (see mhmc._run_chain). Exact (x64) and anchored targets
            # (rounding field rms ~3e-3, measured) keep the cheaper
            # stored-logp chain.
            from ..config import rdtype as _rdtype

            refresh = (
                self.parametrization == "kraus"
                and not self.anchored
                and np.dtype(_rdtype()) == np.dtype(np.float32)
            )
            self.chain = MHMC(
                target,
                jump_distr=self.jump_distr,
                step=self.step,
                burn_steps=self.burn_steps,
                dim=dim,
                update_rule=update_rule,
                symmetric=self.jump_logpdf is None,
                jump_logpdf=self.jump_logpdf,
                x_init=x_init,
                key=self.key,
                drift_fn=drift_fn,
                refresh_logp=refresh,
            )
            if self.tmg.channel.n_qubits >= 4:
                # host-chunk the chain: a fused multi-thousand-step scan
                # of NS-projected proposals (MALA: ~3x, two gradient
                # passes) exceeded a single-execution time limit of the
                # earlier target (ROADMAP C1). Kraus-factor steps carry no
                # Dykstra (3 matmuls + the factored NLL), so their
                # per-call budget is ~10x larger.
                if self.parametrization == "kraus":
                    budget = 4000 if self.proposal == "mala" else 12000
                else:
                    budget = 400 if self.proposal == "mala" else 1200
                self.chain.max_steps_per_call = max(
                    50, budget // max(self.n_chains, 1)
                )
            if self.adapt_step:
                # the Choi bloch space is 16^n-dimensional; reaching a ~25
                # percent acceptance from a generic starting scale can take
                # 15+ halvings at 4 qubits; the projected-target path uses
                # a window centered on the classic 25% RW-MH optimum (MALA:
                # the 57% Roberts-Rosenthal optimum)
                if self.proposal == "mala":
                    bounds = (0.4, 0.7)
                elif big or self.parametrization == "kraus":
                    bounds = (0.15, 0.4)
                else:
                    bounds = (0.05, 0.5)
                self.chain.adapt_step(
                    segment=100, max_rounds=24, confirm=2, bounds=bounds,
                )
        if self.n_chains > 1 and self.mesh is not None:
            if self.jump_logpdf is not None:
                raise NotImplementedError(
                    "mesh-sharded chains support symmetric proposals only"
                )
            if self.proposal == "mala":
                raise NotImplementedError(
                    "mesh-sharded chains run the random-walk proposal; "
                    "MALA chains parallelize with n_chains alone (vmap)"
                )
            per_chain = -(-self.n_points // self.n_chains)
            if self.parametrization == "kraus":
                if not self.anchored:
                    raise NotImplementedError(
                        "mesh-sharded kraus chains run the anchored-delta "
                        "target (anchored=True); the full-decode target "
                        "parallelizes with n_chains alone (vmap)"
                    )
                from ..parallel import sharded_mhmc_kraus_chains

                pack, b_dev, w_dev, flat_dev, p_ref_a, k_scale = (
                    self._kraus_sharded_ctx
                )
                samples, self.acceptance_rate = sharded_mhmc_kraus_chains(
                    self.mesh,
                    self.chain._next_key(),
                    self.chain.x_t,
                    pack,
                    b_dev,
                    w_dev,
                    flat_dev,
                    p_ref_a,
                    k_scale,
                    self.chain.step,
                    self.n_chains,
                    per_chain,
                    burn_steps=self.burn_steps,
                    thinning=self.thinning,
                    jump_distr=self.jump_distr,
                    u_scale=getattr(self, "_kraus_uscale", None),
                )
                chain_shape = samples.shape[:2]
                samples = samples.reshape(-1, samples.shape[-1])
            elif big:
                raise NotImplementedError(
                    "mesh-sharded bloch chains implement the project-the-"
                    "proposal scheme, which freezes at "
                    f">= {self.PROJECTED_TARGET_QUBITS} qubits; "
                    "use parametrization='kraus' "
                    "(anchored, mesh-shardable) or n_chains without a mesh "
                    "there"
                )
            else:
                from ..parallel import sharded_mhmc_process_chains

                t0 = self.tmg.tomographs[0]
                samples, self.acceptance_rate = sharded_mhmc_process_chains(
                    self.mesh,
                    self.chain._next_key(),
                    self.chain.x_t,
                    self.tmg._input_blochs_t(),
                    t0.povm_matrix,
                    t0.n_measurements,
                    np.concatenate(
                        [t.flat_results for t in self.tmg.tomographs]
                    ),
                    self.chain.step,
                    self.n_chains,
                    per_chain,
                    burn_steps=self.burn_steps,
                    thinning=self.thinning,
                    jump_distr=self.jump_distr,
                )
                chain_shape = samples.shape[:2]
                samples = samples.reshape(-1, samples.shape[-1])
        elif self.n_chains > 1:
            per_chain = -(-self.n_points // self.n_chains)
            samples, self.acceptance_rate = self.chain.sample_chains(
                per_chain, self.n_chains, self.thinning
            )
            chain_shape = samples.shape[:2]
            samples = samples.reshape(-1, samples.shape[-1])
        else:
            samples, self.acceptance_rate = self.chain.sample(
                self.n_points, self.thinning, verbose=self.verbose
            )
            chain_shape = (1, samples.shape[0])
        if getattr(self, "_decode_kraus", None):
            # kraus-factor samples decode to exactly-CPTP Choi blochs
            # (batched device map, host-chunked)
            from . import process_core

            d_choi = self._decode_kraus
            whiten = getattr(self, "_kraus_whiten", None)
            ys = np.asarray(samples, dtype=np.float64)
            if getattr(self, "_kraus_uscale", None) is not None:
                # curvature-rescaled chains live in u = dz / s; decode dz
                ys = ys * self._kraus_uscale
            ys = ys.reshape(-1, 2, d_choi, d_choi)
            chunk = max(1, (1 << 24) // (d_choi * d_choi))
            if getattr(self, "_kraus_anchor", None) is not None:
                # anchored chains store offsets dz; decode as the f64
                # anchor bloch plus the exact-delta image (same accuracy
                # argument as the target)
                a_pack, a_x_ref = self._kraus_anchor

                def _decode_batch(zz):
                    return a_x_ref + np.asarray(
                        process_core.kraus_delta_choi_bloch(zz, a_pack),
                        dtype=np.float64,
                    )

            elif whiten is not None:
                al_pair, ar_pair = whiten

                def _decode_batch(zz):
                    return process_core.kraus_param_to_choi_bloch_whitened(
                        zz, al_pair, ar_pair
                    )

            else:
                _decode_batch = process_core.kraus_param_to_choi_bloch
            samples = np.concatenate(
                [
                    np.asarray(
                        _decode_batch(ys[lo : lo + chunk]),
                        dtype=np.float64,
                    )
                    for lo in range(0, ys.shape[0], chunk)
                ]
            )
        if getattr(self, "_to_x", None) is not None:
            # preconditioned-MALA samples live in the whitened z space;
            # map back to Choi bloch before the reported projection
            samples = self._to_x(samples)
        if getattr(self, "_proj", None) is not None:
            # projected-likelihood samples live in the unconstrained space;
            # report their CPTP projections (host-chunked batch)
            from . import process_core

            samples = np.asarray(
                process_core.cptp_project_bloch_host(
                    samples, max_iter=100, chunk=25, cp="ns"
                ),
                dtype=np.float64,
            )
        n2 = 2 * self.tmg.channel.n_qubits
        mats = np_bloch_to_matrix(samples, n2)
        dist = np.asarray(self.tmg.dst(mats, self.channel.choi.matrix))
        per_chain_dist = dist.reshape(chain_shape)
        self.r_hat = split_rhat(per_chain_dist)
        self.ess = effective_sample_size(per_chain_dist)
        _warn_if_nonconverged(type(self).__name__, self.r_hat, self.ess)
        dist = np.sort(dist)
        conf_levels = np.linspace(0, 1, len(dist))
        if self.return_samples:
            self.cl_to_dist = _interp1d(conf_levels, dist)
            return dist, conf_levels, self.acceptance_rate, list(mats)
        self.cl_to_dist = _interp1d(conf_levels, dist)


# --------------------------------------------------------------------------
# Holder composition interval
# --------------------------------------------------------------------------


class HolderInterval(ConfidenceInterval):
    """Process CI composed from per-input-state intervals via a Holder-type
    bound (reference interval.py:421-539).

    `kind` selects the per-state interval family: 'moment', 'mhmc',
    'bootstrap' (alias 'boot'), or 'sugiyama'. (The reference's docstring
    also advertises 'wang', which its setup() never implemented — documented
    divergence: we reject it explicitly.)
    """

    def __init__(
        self,
        tmg,
        n_points: int = 1000,
        kind: str = "moment",
        max_confidence: float = 0.999,
        method: str = "lin",
        physical: bool = True,
        init: str = "lin",
        tol: float = 1e-3,
        max_iter: int = 100,
        step: float = 0.01,
        burn_steps: int = 1000,
        thinning: int = 1,
    ):
        super().__init__(
            tmg, n_points=n_points, kind=kind, max_confidence=max_confidence,
            method=method, physical=physical, init=init, tol=tol,
            max_iter=max_iter, step=step, burn_steps=burn_steps,
            thinning=thinning,
        )

    def __call__(self, conf_levels=None):
        if conf_levels is None:
            conf_levels = np.linspace(1e-3, 1 - 1e-3, 1000)
        if not hasattr(self, "intervals"):
            self.setup()
        state_results = [interval(conf_levels) for interval in self.intervals]
        state_deltas = np.asarray([r[0] for r in state_results])
        conf_levels = np.asarray(state_results[0][1]) ** self.tmg.input_basis.dim
        dec = self.tmg._decomposed_single_entries
        coef = np.abs(np.einsum("ij,ik->jk", dec, dec.conj()))
        composition = np.einsum("ik,jk->ijk", state_deltas, state_deltas)
        dist = np.sqrt(np.einsum("ijk,ij->k", composition, coef))
        return dist, conf_levels

    def setup(self):
        if self.mode == Mode.STATE:
            raise NotImplementedError("Holder interval works only for process tomography")
        kind = "bootstrap" if self.kind == "boot" else self.kind
        if kind == "moment":
            self.intervals = [MomentInterval(t) for t in self.tmg.tomographs]
            # all children share one measurement design: factorize its
            # pseudo-inverse once (at 4 qubits per-child refactorization is
            # ~a minute of redundant LU on a single-core host)
            t0 = self.tmg.tomographs[0]
            if t0.povm_matrix is not None:
                dim = 2**t0.state.n_qubits
                shared_inv = (
                    _left_inv_np(
                        t0.povm_matrix.reshape(-1, t0.povm_matrix.shape[-1])
                    )
                    / dim
                )
                for iv in self.intervals:
                    iv._design_inv = shared_inv
        elif kind == "mhmc":
            if any(t.povm_matrix is None for t in self.tmg.tomographs):
                raise NotImplementedError(
                    "kind='mhmc' needs dense per-state POVMs (the NLL is "
                    "evaluated against the materialized design); use "
                    "kind='moment'/'sugiyama'/'bootstrap' for kron-mode "
                    "child tomographs"
                )
            self.intervals = [
                MHMCStateInterval(
                    t, self.n_points, self.step, self.burn_steps, self.thinning,
                    use_new_estimate=True,
                )
                for t in self.tmg.tomographs
            ]
        elif kind == "bootstrap":
            self.intervals = [
                BootstrapStateInterval(
                    t, self.n_points, self.method, physical=self.physical,
                    init=self.init, tol=self.tol, max_iter=self.max_iter,
                )
                for t in self.tmg.tomographs
            ]
        elif kind == "sugiyama":
            self.intervals = [
                SugiyamaInterval(t, self.n_points, self.max_confidence)
                for t in self.tmg.tomographs
            ]
        else:
            raise ValueError("Incorrect value for argument `kind`.")
        for interval in self.intervals:
            interval.setup()
