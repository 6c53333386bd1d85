"""StateTomograph — quantum state tomography with the reference's API.

API parity with reference quantpy/tomography/state.py:11-253:
`experiment` (incl. warm_start accumulation), the `results` setter for
injecting real experimental data, `point_estimate('lin'|'mle'|'mle-constr')`,
and the `dst` distance selection. All numerics delegate to the jitted,
batched functional core (state_core.py); randomness is explicit
`jax.random` keys instead of the reference's global unseeded NumPy RNG
(state.py:111).

Extensions:
- `point_estimate` accepts method='mle-rhor' (fixed-point MLE, fastest)
- `simulate_batch` / `estimate_batch`: thousands of experiments at once
"""

from __future__ import annotations

import math

import numpy as np

from ..measurements import generate_measurement_matrix
from ..ops.geometry import resolve_distance
from ..qobj import Qobj
from . import state_core

__all__ = ["StateTomograph"]


def _kron_draw(key, povm1, bloch, shots):
    """Dispatch the experiment draw: above CHUNKED_CHAIN_VOLUME the
    host-chunked per-m-slice draw runs instead of the fused one (same
    design, per-block key folds). The chunking guarded a single-execution
    time limit of the earlier target (ROADMAP C1)."""
    from . import kron_core

    m1, p1, _ = np.asarray(povm1).shape
    n = int(round(math.log(np.asarray(bloch).shape[-1], 4)))
    if (m1 * p1) ** n > kron_core.CHUNKED_CHAIN_VOLUME:
        return kron_core.kron_simulate_chunked(key, povm1, bloch, shots)
    return kron_core.kron_simulate(key, povm1, bloch, shots)



def _uniform_shots(n_measurements):
    """A scalar shot count as float, or None if `n_measurements` is not a
    scalar integer. Integral floats (1000.0) are accepted alongside
    Python/NumPy integers — the value is consumed as float everywhere."""
    if np.issubdtype(type(n_measurements), np.integer):
        return float(n_measurements)
    if isinstance(n_measurements, float) and n_measurements.is_integer():
        return n_measurements
    return None


class StateTomograph:
    """Simulate state-tomography experiments and reconstruct states.

    Parameters
    ----------
    state : Qobj
        True state used by `experiment` simulations.
    dst : str or callable, default='hs'
        'hs', 'trace', 'if', or a custom (A, B) -> float distance.
    key : jax PRNG key or int seed, optional
        Randomness source for simulations (defaults to seed 0).
    """

    def __init__(self, state, dst="hs", key=None):
        import jax

        self.state = state
        self.dst = resolve_distance(dst)
        if key is None:
            key = 0
        self._key = jax.random.key(key) if isinstance(key, int) else key
        self._results = None
        self.povm_matrix = None
        self.n_measurements = None

    def _next_key(self):
        import jax

        self._key, sub = jax.random.split(self._key)
        return sub

    # -- experiment simulation ------------------------------------------------

    #: dense-POVM element budget; beyond it the experiment runs in
    #: kron-factored mode and never materializes the measurement matrix
    #: (proj-set at 6 qubits is 0.8 GB dense; see kron_core)
    DENSE_POVM_MAX_ELEMENTS = 2**25

    def experiment(self, n_measurements, povm="proj-set", warm_start: bool = False):
        """Simulate a tomography experiment
        (reference state.py:71-128).

        warm_start=True merges the new POVM block with the previous one,
        reweighting rows by shot counts (reference state.py:116-124).

        For single-qubit-block designs whose tensor power exceeds
        `DENSE_POVM_MAX_ELEMENTS`, the experiment runs on the kron-factored
        path: `povm_matrix` stays None, `povm_kron` holds the (m1, p1, 4)
        block, and estimation uses the factored estimators (uniform shots
        only). Kron-mode warm_start repeats the SAME design and merges the
        multinomial counts — statistically identical to the reference's
        row stacking for identical designs.
        """
        n = self.state.n_qubits
        povm_block = None
        if isinstance(povm, str):
            from ..measurements import _single_qubit_preset

            povm_block = _single_qubit_preset(povm)
        elif isinstance(povm, np.ndarray) and povm.shape[-1] == 4 and n > 1:
            povm_block = povm if povm.ndim == 3 else povm[None]
        kron_mode = (
            self.povm_matrix is None
            and getattr(self, "povm_kron", None) is not None
        )
        if warm_start and kron_mode:
            # kron-mode warm start: for the SAME factored design with
            # uniform shots, concatenating reweighted POVM rows (the
            # reference recipe, state.py:116-124) is statistically
            # identical to summing the multinomial counts — every
            # estimator consumes only the weighted frequency table.
            # Documented divergence: merged counts instead of stacked
            # rows (the design is never materialized to stack).
            block = (
                None
                if povm_block is None
                else np.asarray(povm_block, dtype=np.float64)
            )
            if (
                block is None
                or block.shape != self.povm_kron.shape
                or not np.allclose(block, self.povm_kron)
            ):
                raise NotImplementedError(
                    "kron-mode warm_start supports only repeating the same "
                    "factored design; pass the identical single-qubit block"
                )
            shots = _uniform_shots(n_measurements)
            if shots is None:
                raise NotImplementedError(
                    "kron-mode warm_start needs uniform integral shots"
                )
            counts = _kron_draw(
                self._next_key(),
                self.povm_kron,
                self.state.bloch_device(),
                shots,
            )
            self._results = self._results + np.asarray(counts, dtype=np.float64)
            self.n_measurements = self.n_measurements + shots
            return
        if povm_block is not None:
            m1, p1, _ = povm_block.shape
            dense_elements = (m1 * p1 * 4) ** n
            shots = _uniform_shots(n_measurements)
            if dense_elements > self.DENSE_POVM_MAX_ELEMENTS and shots is not None:
                if warm_start:
                    raise NotImplementedError(
                        "warm_start into kron-factored mode needs a prior "
                        "kron-mode experiment with the same design"
                    )
                self.povm_kron = np.asarray(povm_block, dtype=np.float64)
                self.povm_matrix = None
                counts = _kron_draw(
                    self._next_key(),
                    self.povm_kron,
                    self.state.bloch_device(),
                    shots,
                )
                self._results = np.asarray(counts, dtype=np.float64)
                self.n_measurements = np.full(self._results.shape[0], shots)
                return
        self.povm_kron = None
        povm_matrix = generate_measurement_matrix(povm, self.state.n_qubits)
        n_povms = povm_matrix.shape[0]
        if _uniform_shots(n_measurements) is not None:
            n_measurements = np.full(
                n_povms, _uniform_shots(n_measurements), dtype=np.float64
            )
        else:
            n_measurements = np.asarray(n_measurements, dtype=np.float64)
            if n_measurements.shape[0] != n_povms:
                raise ValueError("Wrong length for argument `n_measurements`")

        counts = state_core.simulate_experiment(
            self._next_key(),
            povm_matrix,
            self.state.bloch_device(),
            n_measurements,
        )
        counts = np.asarray(counts, dtype=np.float64)

        if warm_start:
            prev_total = float(np.sum(self.n_measurements))
            new_total = float(np.sum(n_measurements))
            self.povm_matrix = np.vstack(
                [
                    self.povm_matrix * prev_total,
                    povm_matrix * new_total,
                ]
            ) / (prev_total + new_total)
            self.n_measurements = np.concatenate([self.n_measurements, n_measurements])
            self._results = np.vstack([self._results, counts])
        else:
            self.povm_matrix = np.asarray(povm_matrix, dtype=np.float64)
            self.n_measurements = n_measurements
            self._results = counts

    # -- results access (reference state.py:130-141) ---------------------------

    @property
    def results(self):
        return self._results

    @results.setter
    def results(self, results):
        """Inject (real) experimental outcome counts; recomputes
        n_measurements from row sums (reference state.py:138-141)."""
        self._results = np.asarray(results, dtype=np.float64)
        self.n_measurements = self._results.sum(-1)

    @property
    def flat_results(self):
        return self._results.reshape(-1)

    # -- estimation -------------------------------------------------------------

    def point_estimate(
        self,
        method: str = "lin",
        physical: bool = True,
        init: str = "lin",
        max_iter: int = 100,
        tol: float = 1e-3,
    ) -> Qobj:
        """Reconstruct a density matrix (reference state.py:143-189).

        Methods: 'lin', 'mle', 'mle-constr' (reference) plus 'mle-rhor'
        (batched fixed-point MLE). Returns a Qobj and caches it as
        `reconstructed_state`.
        """
        if self._results is None:
            raise RuntimeError("Run `experiment` or set `results` first")
        if self.povm_matrix is None and getattr(self, "povm_kron", None) is not None:
            from . import kron_core

            n = self.state.n_qubits
            if method == "lin":
                bloch = kron_core.kron_estimate_lin(
                    self._results, self.povm_kron, n, physical=physical
                )
            elif method in ("mle", "mle-rhor", "mle-constr"):
                # 'mle-constr' aliases to the trace-normalized MLE exactly
                # as on the dense path (state_core.estimate:385): the
                # Cholesky parametrization + normalization already encodes
                # the reference's unit-trace SLSQP constraint
                # (state.py:231-253) — documented equivalence.
                rhor_tol = max(
                    float(np.finfo(np.float32).eps) * 10, tol * 1e-3
                )
                bloch = kron_core.kron_estimate_mle_rhor(
                    self._results, self.povm_kron, n, max_iter=max_iter,
                    tol=rhor_tol,
                )
            else:
                raise NotImplementedError(
                    f"method {method!r} is not available on the kron-factored path"
                )
        else:
            bloch = state_core.estimate(
                self._results,
                self.povm_matrix,
                self.n_measurements,
                method=method,
                physical=physical,
                init=init,
                max_iter=max_iter,
                tol=tol,
            )
        self.reconstructed_state = Qobj(np.asarray(bloch, dtype=np.float64))
        return self.reconstructed_state

    # -- batch API ---------------------------------------------------------------

    def simulate_batch(self, n_experiments: int, state=None, key=None):
        """Simulate `n_experiments` independent repetitions of the current
        experiment design in one device call. Returns (n_experiments, m, p)
        counts (a device array)."""
        import jax.numpy as jnp

        from ..config import rdtype

        if self.povm_matrix is None and getattr(self, "povm_kron", None) is None:
            raise RuntimeError("Run `experiment` first to fix the design")
        bloch = (state or self.state).bloch_device()
        blochs = jnp.broadcast_to(bloch, (n_experiments,) + bloch.shape)
        k = key if key is not None else self._next_key()
        if self.povm_matrix is None:
            from . import kron_core

            return kron_core.kron_simulate(
                k, jnp.asarray(self.povm_kron, dtype=rdtype()), blochs,
                float(self.n_measurements[0]),
            )
        return state_core.simulate_experiment(
            k,
            jnp.asarray(self.povm_matrix, dtype=rdtype()),
            blochs,
            self.n_measurements,
        )

    def estimate_batch(self, counts, method: str = "lin", **kwargs):
        """Estimate a batch of experiments at once; returns bloch vectors
        (batch, 4^n) as a device array."""
        if self.povm_matrix is None and getattr(self, "povm_kron", None) is not None:
            from . import kron_core

            n = self.state.n_qubits
            if method == "lin":
                return kron_core.kron_estimate_lin(
                    counts, self.povm_kron, n,
                    physical=kwargs.get("physical", True),
                )
            if method in ("mle", "mle-rhor", "mle-constr"):
                # 'mle-constr' alias: see point_estimate
                return kron_core.kron_estimate_mle_rhor(
                    counts, self.povm_kron, n,
                    max_iter=kwargs.get("max_iter", 100),
                    tol=kwargs.get("tol", 1e-6),
                )
            raise NotImplementedError(
                f"method {method!r} is not available on the kron-factored path"
            )
        return state_core.estimate(
            counts, self.povm_matrix, self.n_measurements, method=method, **kwargs
        )

    def _nll(self, tril_vec):
        """NLL of a Cholesky parameter vector under the current data
        (reference state.py:217-229); used by MHMC intervals. On the
        kron-factored path the probabilities run through the factored
        forward chain (uniform row weights 1/m), so MHMC sampling works at
        6+ qubits without materializing the design."""
        import jax.numpy as jnp

        from ..config import rdtype

        freq = self.flat_results / self.flat_results.sum()
        freq = jnp.asarray(freq, dtype=rdtype())
        tril_vec = jnp.asarray(tril_vec, dtype=rdtype())
        if self.povm_matrix is None and getattr(self, "povm_kron", None) is not None:
            from . import kron_core

            return kron_core.kron_nll_tril(
                tril_vec,
                jnp.asarray(self.povm_kron, dtype=rdtype()),
                self.state.n_qubits,
                freq,
                self._results.shape[0],
            )
        a = state_core.weighted_povm_flat(self.povm_matrix, self.n_measurements)
        return state_core.nll_tril(tril_vec, a, freq, self.state.n_qubits)
