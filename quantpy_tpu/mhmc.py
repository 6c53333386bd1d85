"""Metropolis-Hastings sampling as a lax.scan chain — on device, vmappable.

Counterpart of reference quantpy/mhmc.py:6-119. The reference steps its chain
in a Python loop with the global NumPy RNG and a tqdm.notebook progress bar
(mhmc.py:78-84); here the whole chain (burn-in + sampling + thinning) is one
jitted `lax.scan`, randomness comes from explicit keys, and several chains
can run vmapped in parallel (`n_chains`).

The proposal is an isotropic normal (the reference's default
multivariate_normal, mhmc.py:41); `update_rule(x, delta, step)` maps a
proposal displacement to the proposed point and must be jax-traceable
(e.g. `normalized_update`, or ProcessTomograph._cptp_update_rule).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .config import rdtype

__all__ = [
    "MHMC",
    "basic_update",
    "normalized_update",
    "resolve_jump_distr",
    "split_rhat",
    "effective_sample_size",
    "maximize_logpdf",
]


def maximize_logpdf(logpdf, x0, n_steps: int = 500, lr: float = 3e-3,
                    chunk: int = 100):
    """Ascend a jax-traceable log-density with Adam (host-chunked scans).

    Mode-seeking warm start for MCMC: a chain started in the transient
    region adapts its step against the huge transient gradient, not the
    equilibrium curvature, and the adapted step is then orders of
    magnitude too small to ever mix (measured on 4-qubit process chains:
    the projected linear inversion sits ~1.2e5 NLL above the smooth
    target's mode, and MALA adapted to step 8e-8 from there vs ~1e-2 at
    the mode). Returns the ascended point (same shape/dtype as x0)."""
    import optax

    opt = optax.adam(lr)

    @functools.partial(jax.jit, static_argnames=("n",))
    def run(x, opt_state, n):
        def body(carry, _):
            x, st = carry
            g = jax.grad(lambda xx: -logpdf(xx))(x)
            up, st = opt.update(g, st)
            return (optax.apply_updates(x, up), st), None

        (x, opt_state), _ = jax.lax.scan(
            body, (x, opt_state), None, length=n
        )
        return x, opt_state

    x = jnp.asarray(x0, dtype=rdtype())
    state = opt.init(x)
    done = 0
    while done < n_steps:
        n = min(chunk, n_steps - done)
        x, state = run(x, state, n)
        done += n
    return x


def basic_update(x, delta, step):
    """x + step * delta (reference mhmc.py:113-114)."""
    return x + step * delta


def normalized_update(x, delta, step):
    """Renormalized step, keeps ||x|| = 1 (reference mhmc.py:117-119)."""
    x_new = x + step * delta
    return x_new / jnp.linalg.norm(x_new, axis=-1, keepdims=True)


#: named symmetric proposal samplers: callable(key, shape, dtype) -> delta.
#: The reference accepts any scipy frozen distribution (mhmc.py:30-48);
#: here proposals must be jax-traceable, so custom distributions are passed
#: as samplers with this signature (documented divergence). An asymmetric
#: sampler additionally needs `jump_logpdf` + symmetric=False on MHMC for
#: the Hastings correction.
_JUMP_DISTRS = {
    "normal": lambda key, shape, dtype: jax.random.normal(key, shape, dtype),
    "uniform": lambda key, shape, dtype: jax.random.uniform(
        key, shape, dtype, minval=-1.0, maxval=1.0
    ),
    "laplace": lambda key, shape, dtype: jax.random.laplace(key, shape, dtype),
    "cauchy": lambda key, shape, dtype: jax.random.cauchy(key, shape, dtype),
}


#: scipy frozen-distribution families the adapter maps onto jax samplers:
#: name -> (sampler(key, shape, dtype, *shape_args),
#:          standardized logpdf(z, *shape_args)).
_SCIPY_FAMILIES = {
    "norm": (
        lambda key, shape, dtype: jax.random.normal(key, shape, dtype),
        lambda z: -0.5 * z**2 - 0.5 * jnp.log(2 * jnp.pi),
    ),
    "laplace": (
        lambda key, shape, dtype: jax.random.laplace(key, shape, dtype),
        lambda z: -jnp.abs(z) - jnp.log(2.0),
    ),
    "cauchy": (
        lambda key, shape, dtype: jax.random.cauchy(key, shape, dtype),
        lambda z: -jnp.log(jnp.pi * (1.0 + z**2)),
    ),
    "logistic": (
        lambda key, shape, dtype: jax.random.logistic(key, shape, dtype),
        lambda z: -z - 2.0 * jnp.log1p(jnp.exp(-z)),
    ),
    "t": (
        lambda key, shape, dtype, df: jax.random.t(key, df, shape, dtype),
        lambda z, df: (
            jax.scipy.special.gammaln((df + 1) / 2)
            - jax.scipy.special.gammaln(df / 2)
            - 0.5 * jnp.log(df * jnp.pi)
            - (df + 1) / 2 * jnp.log1p(z**2 / df)
        ),
    ),
}


def from_scipy_frozen(frozen):
    """Adapt a scipy frozen distribution to a device chain: returns
    (sampler(key, shape, dtype), jump_logpdf(delta) -> scalar, symmetric).

    The reference's MHMC takes any scipy rv with .rvs/.pdf and calls them
    on the host per step (quantpy/mhmc.py:41, :99-103); a lax.scan chain
    needs jax-traceable equivalents, so the common frozen families
    (norm/uniform/laplace/cauchy/logistic/t, any loc/scale) are translated
    here — sampling AND the Hastings density, with `symmetric` derived
    from the parameters so asymmetric proposals are corrected exactly like
    the reference's pdf(-delta)/pdf(delta) branch. Unsupported families
    raise with the traceable-callable escape hatch."""
    name = getattr(getattr(frozen, "dist", None), "name", None)
    shapes, loc_, scale_ = frozen.dist._parse_args(*frozen.args, **frozen.kwds)
    shape_args = tuple(float(a) for a in shapes)
    loc, scale = float(loc_), float(scale_)
    if name == "uniform":
        lo, hi = loc, loc + scale

        def sampler(key, shape, dtype):
            return jax.random.uniform(key, shape, dtype, minval=lo, maxval=hi)

        def jump_logpdf(delta):
            inside = jnp.all((delta >= lo) & (delta <= hi))
            return jnp.where(
                inside, -delta.size * jnp.log(scale), -jnp.inf
            )

        return sampler, jump_logpdf, bool(abs(lo + hi) < 1e-12 * abs(scale))
    if name not in _SCIPY_FAMILIES:
        raise NotImplementedError(
            f"scipy frozen family {name!r} has no jax adapter; supported: "
            f"{sorted(_SCIPY_FAMILIES) + ['uniform']}. Pass a jax-traceable "
            "callable(key, shape, dtype) (+ jump_logpdf if asymmetric) "
            "instead."
        )
    base_sample, base_logpdf = _SCIPY_FAMILIES[name]

    def sampler(key, shape, dtype):
        return loc + scale * base_sample(key, shape, dtype, *shape_args)

    def jump_logpdf(delta):
        z = (delta - loc) / scale
        return jnp.sum(base_logpdf(z, *shape_args)) - delta.size * jnp.log(
            scale
        )

    return sampler, jump_logpdf, loc == 0.0


def _is_scipy_frozen(obj) -> bool:
    return hasattr(obj, "dist") and hasattr(obj, "rvs") and hasattr(obj, "kwds")


def resolve_jump_distr(jump_distr):
    """Map a proposal spec (None / name / scipy frozen / callable) to a
    sampler callable, with the shared validation message (used by MHMC and
    the mesh-sharded chain helpers)."""
    if jump_distr is None:
        return _JUMP_DISTRS["normal"]
    if isinstance(jump_distr, str):
        if jump_distr not in _JUMP_DISTRS:
            raise ValueError(
                f"Unknown jump_distr {jump_distr!r}; available: "
                f"{sorted(_JUMP_DISTRS)} or a callable(key, shape, dtype)"
            )
        return _JUMP_DISTRS[jump_distr]
    if _is_scipy_frozen(jump_distr):
        return from_scipy_frozen(jump_distr)[0]
    if callable(jump_distr):
        return jump_distr
    raise NotImplementedError(
        "jump_distr must be None, a name, a scipy frozen distribution "
        "(adapted via from_scipy_frozen), or a jax-traceable "
        "callable(key, shape, dtype)"
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "logpdf", "update_rule", "jump_fn", "n_steps", "keep_every",
        "jump_logpdf", "drift_fn", "refresh_logp",
    ),
)
def _run_chain(
    key, x0, logpdf, update_rule, jump_fn, step, n_steps, keep_every,
    jump_logpdf=None, drift_fn=None, refresh_logp=False,
):
    """Scan a Metropolis chain for n_steps; return every keep_every-th
    state (post-hoc thinning) and the acceptance count.

    `jump_logpdf` (optional, jax-traceable callable(delta) -> scalar log
    density of the proposal displacement) enables the Hastings correction
    for ASYMMETRIC proposals: the acceptance ratio is multiplied by
    q(-delta)/q(delta), exactly the reference's
    `jump_distr.pdf(-delta)/pdf(delta)` branch (quantpy/mhmc.py:99-103).
    None (the default) means a symmetric proposal — no correction.

    `drift_fn` (optional, callable(x) -> grad log pi(x)) switches the
    chain to MALA: proposal x' = x + (step^2/2) drift(x) + step * xi with
    xi standard normal, accepted with the exact state-dependent Hastings
    ratio q(x|x')/q(x'|x). `update_rule`/`jump_logpdf` are ignored and
    `jump_fn` must sample standard normals in MALA mode.

    `refresh_logp=True` re-evaluates logpdf at the CURRENT state every
    step instead of carrying the stored value. For an exact (noiseless)
    target this is a wasted evaluation; for an f32 target whose
    evaluation noise sigma is O(1) (measured ~2.5 on 4-qubit process
    targets: count-amplified rounding inside the likelihood graph) the
    stored-logp chain sticks on +noise flukes — long-run acceptance drops
    toward exp(-sigma^2) at EVERY step size and step adaptation collapses
    (measured). Fresh evaluations restore ordinary MH behavior at the
    cost of a pseudo-marginal-style O(sigma^2) flattening bias,
    documented where enabled."""

    if drift_fn is not None:
        half = 0.5 * step * step

        def mala_step(carry, key_t):
            x, logp_x, drift_x = carry
            if refresh_logp:
                logp_x = logpdf(x)
            k1, k2 = jax.random.split(key_t)
            xi = jump_fn(k1, x.shape, x.dtype)
            mu_x = x + half * drift_x
            x_prime = mu_x + step * xi
            logp_prime = logpdf(x_prime)
            drift_prime = drift_fn(x_prime)
            # reverse-proposal residual in the RESIDUAL form:
            #   (x - mu_xp)/step = -(xi + (step/2)(drift_x + drift')),
            # never differencing x and x' — the naive (x - mu_xp)/step is
            # pure f32 rounding noise once step < eps * |x| (measured at 4
            # qubits: a 2e-9 step turned lq_bwd into ~-4e5 of noise and
            # froze the chain at acceptance 0.000)
            bwd_res = xi + (0.5 * step) * (drift_x + drift_prime)
            lq_fwd = -0.5 * jnp.sum(xi**2)
            lq_bwd = -0.5 * jnp.sum(bwd_res**2)
            log_ratio = logp_prime - logp_x + lq_bwd - lq_fwd
            accept = jnp.log(jax.random.uniform(k2, dtype=x.dtype)) <= log_ratio
            x_new = jnp.where(accept, x_prime, x)
            logp_new = jnp.where(accept, logp_prime, logp_x)
            drift_new = jnp.where(accept, drift_prime, drift_x)
            return (x_new, logp_new, drift_new), (x_new, accept)

        keys = jax.random.split(key, n_steps)
        (_, _, _), (xs, accepts) = jax.lax.scan(
            mala_step, (x0, logpdf(x0), drift_fn(x0)), keys
        )
        return xs[keep_every - 1 :: keep_every], jnp.sum(accepts)

    def mh_step(carry, key_t):
        x, logp_x = carry
        if refresh_logp:
            logp_x = logpdf(x)
        k1, k2 = jax.random.split(key_t)
        delta = jump_fn(k1, x.shape, x.dtype)
        x_prime = update_rule(x, delta, step)
        logp_prime = logpdf(x_prime)
        log_ratio = logp_prime - logp_x
        if jump_logpdf is not None:
            log_ratio = log_ratio + jump_logpdf(-delta) - jump_logpdf(delta)
        accept = jnp.log(jax.random.uniform(k2, dtype=x.dtype)) <= log_ratio
        x_new = jnp.where(accept, x_prime, x)
        logp_new = jnp.where(accept, logp_prime, logp_x)
        return (x_new, logp_new), (x_new, accept)

    keys = jax.random.split(key, n_steps)
    (_, _), (xs, accepts) = jax.lax.scan(
        mh_step, (x0, logpdf(x0)), keys
    )
    return xs[keep_every - 1 :: keep_every], jnp.sum(accepts)


def split_rhat(chains) -> float:
    """Split-R-hat convergence diagnostic (Gelman et al.) of a scalar
    series per chain: chains (n_chains, n_samples). Values near 1 indicate
    the chains have mixed; > ~1.05 flags non-convergence."""
    x = np.asarray(chains, dtype=np.float64)
    m, n = x.shape
    half = n // 2
    if half < 2:
        return float("nan")
    x = np.concatenate([x[:, :half], x[:, half : 2 * half]], axis=0)
    m, n = x.shape
    chain_means = x.mean(axis=1)
    b = n * chain_means.var(ddof=1)
    w = x.var(axis=1, ddof=1).mean()
    if w == 0:
        return 1.0
    var_plus = (n - 1) / n * w + b / n
    return float(np.sqrt(var_plus / w))


def effective_sample_size(chains) -> float:
    """Multi-chain effective sample size of a scalar series via FFT
    autocorrelations with Geyer's initial-positive-sequence truncation."""
    x = np.asarray(chains, dtype=np.float64)
    m, n = x.shape
    if n < 4:
        return float(m * n)
    x = x - x.mean(axis=1, keepdims=True)
    # per-chain autocorrelation via FFT
    size = 2 ** int(np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(x, size, axis=1)
    acov = np.fft.irfft(f * np.conj(f), size, axis=1)[:, :n].real
    acov /= np.arange(n, 0, -1)[None, :]
    denom = acov[:, 0].mean()
    if denom == 0:
        return float(m * n)
    rho = acov.mean(axis=0) / denom
    # Geyer: sum consecutive pairs while positive
    tau = 1.0
    t = 1
    while t + 1 < n:
        pair = rho[t] + rho[t + 1]
        if pair < 0:
            break
        tau += 2 * pair
        t += 2
    return float(m * n / max(tau, 1e-12))


class MHMC:
    """Metropolis-Hastings sampler over an unnormalized log-density.

    Parameters (matching reference mhmc.py:30-48)
    ----------
    target_logpdf : callable(x) -> scalar, jax-traceable
    jump_distr : None, str, scipy frozen distribution, or callable —
        proposal sampler. None = isotropic normal (the reference default).
        A name from {'normal', 'uniform', 'laplace', 'cauchy'}, a scipy
        FROZEN distribution (norm/uniform/laplace/cauchy/logistic/t with
        any loc/scale — adapted to jax by `from_scipy_frozen`, with the
        Hastings correction auto-enabled when the frozen proposal is
        asymmetric, matching reference mhmc.py:30-48, :99-103), or any
        jax-traceable callable(key, shape, dtype) -> delta. Callable
        proposals are assumed SYMMETRIC unless symmetric=False +
        jump_logpdf are passed.
    step : float — proposal scale
    burn_steps : int
    dim : int — state dimension
    update_rule : callable or None (default: basic_update)
    symmetric : bool — True (default) skips the Hastings correction. For an
        ASYMMETRIC proposal pass symmetric=False together with
        `jump_logpdf`; the acceptance ratio is then multiplied by
        q(-delta)/q(delta) like the reference's
        `jump_distr.pdf(-delta)/pdf(delta)` branch (mhmc.py:99-103).
    jump_logpdf : callable(delta) -> scalar or None — jax-traceable log
        density of the proposal displacement, required when
        symmetric=False (the reference reads .pdf off the scipy frozen
        distribution; a device chain needs the traceable callable —
        documented divergence).
    x_init : array or None — start point (default: uniform random)
    key : jax key or int seed
    """

    def __init__(
        self,
        target_logpdf,
        jump_distr=None,
        step: float = 0.01,
        burn_steps: int = 100,
        dim: int = 1,
        update_rule=None,
        symmetric: bool = True,
        x_init=None,
        key=None,
        jump_logpdf=None,
        drift_fn=None,
        refresh_logp: bool = False,
    ):
        if _is_scipy_frozen(jump_distr):
            # scipy frozen proposal: adapt sampler + Hastings density; an
            # asymmetric frozen (loc != 0) auto-enables the correction the
            # reference applies via .pdf (quantpy/mhmc.py:99-103)
            sampler, logq, sym = from_scipy_frozen(jump_distr)
            jump_distr = sampler
            if not sym:
                symmetric = False
                if jump_logpdf is None:
                    jump_logpdf = logq
        self.jump_fn = resolve_jump_distr(jump_distr)
        if not symmetric and jump_logpdf is None:
            raise ValueError(
                "symmetric=False needs `jump_logpdf`: a jax-traceable "
                "callable(delta) -> log q(delta) for the Hastings "
                "correction (reference quantpy/mhmc.py:99-103)"
            )
        if drift_fn is not None and jump_distr is not None:
            raise ValueError(
                "MALA (drift_fn) requires the standard-normal proposal; "
                "leave jump_distr=None"
            )
        self.jump_logpdf = None if symmetric else jump_logpdf
        self.drift_fn = drift_fn
        self.refresh_logp = bool(refresh_logp)
        self.target_logpdf = target_logpdf
        self.step = step
        self.burn_steps = burn_steps
        self.dim = dim
        self.update_rule = update_rule if update_rule is not None else basic_update
        if key is None:
            key = 0
        self._key = jax.random.key(key) if isinstance(key, int) else key
        if x_init is None:
            self._key, sub = jax.random.split(self._key)
            x_init = jax.random.uniform(sub, (dim,), dtype=rdtype())
        self.x_t = jnp.asarray(x_init, dtype=rdtype())
        self.burned = False

    #: optional cap on chain steps per device call — long projected chains
    #: (4-qubit process proposals run a 100-iteration NS Dykstra each) are
    #: host-chunked so that each call stayed under a single-execution time
    #: limit of the earlier target (ROADMAP C1); intervals set this to
    #: host-chunk the scan. None = one call (the default).
    max_steps_per_call: int | None = None

    def _next_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    def _run_span(self, key, x0, n_steps, keep_every, n_chains=None):
        """`_run_chain`, host-chunked to `max_steps_per_call` steps per
        device call (the chain state resumes across calls; each chunk is a
        multiple of keep_every so thinning is unaffected). With `n_chains`
        the span runs vmapped over leading axes of x0 / per-chain keys.
        Returns (kept samples, total accepted, final state)."""
        total = int(n_steps)
        keep = int(keep_every)
        cap = self.max_steps_per_call or total
        if keep >= cap:
            # burn-style span: callers only use the final state — keep one
            # sample per call instead of fusing the whole span
            keep_mode_burn = True
        else:
            keep_mode_burn = False
            cap = max(keep, (cap // keep) * keep)
        xs_parts = []
        accepted = 0.0
        x = x0
        remaining = total
        while remaining > 0:
            step_n = min(cap, remaining)
            keep = step_n if keep_mode_burn else keep
            key, sub = jax.random.split(key)
            if n_chains is None:
                xs, acc = _run_chain(
                    sub, x, self.target_logpdf, self.update_rule,
                    self.jump_fn, self.step, step_n, keep,
                    jump_logpdf=self.jump_logpdf, drift_fn=self.drift_fn,
                    refresh_logp=self.refresh_logp,
                )
                x = xs[-1]
            else:
                chain_keys = jax.random.split(sub, n_chains)

                def one(k, x1):
                    return _run_chain(
                        k, x1, self.target_logpdf, self.update_rule,
                        self.jump_fn, self.step, step_n, keep,
                        jump_logpdf=self.jump_logpdf, drift_fn=self.drift_fn,
                        refresh_logp=self.refresh_logp,
                    )

                xs, acc = jax.vmap(one)(chain_keys, x)
                x = xs[:, -1]
                acc = jnp.sum(acc)
            xs_parts.append(xs)
            accepted += float(acc)
            remaining -= step_n
        axis = 0 if n_chains is None else 1
        return jnp.concatenate(xs_parts, axis=axis), accepted, x

    def adapt_step(
        self,
        target_rate: float = 0.25,
        segment: int = 200,
        max_rounds: int = 12,
        bounds: tuple = (0.05, 0.5),
        confirm: int = 1,
    ) -> float:
        """Tune the proposal scale during burn-in toward an acceptance-rate
        window (an extension; the reference has no adaptation and
        its defaults easily land at ~0 or ~100 percent acceptance).

        Runs short chain segments, doubling/halving `step` until the
        acceptance rate lies in `bounds` for `confirm` consecutive
        segments (confirm > 1 guards against the descent-phase mirage: a
        chain started away from the mode accepts most downhill proposals,
        so a single in-window segment can reflect transient descent rather
        than equilibrium acceptance — measured on 4-qubit process chains).
        Leaves the chain warm (burned) at the adapted scale and returns
        the final step.
        """
        lo, hi = bounds
        streak = 0
        step0 = self.step
        for _ in range(max_rounds):
            _, accepted, self.x_t = self._run_span(
                self._next_key(), self.x_t, segment, 1
            )
            rate = float(accepted) / segment
            if rate < lo:
                self.step /= 2.0
                streak = 0
            elif rate > hi:
                # growth is capped: on a near-flat target (e.g. a heavily
                # tempered posterior) acceptance stays ~1 at ANY scale and
                # unbounded doubling blasts the chain out of the feasible
                # region faster than a projected update can recover
                # (measured: 24 doublings -> step 1.7e5, samples 4e6 away)
                self.step = min(self.step * 2.0, 64.0 * step0)
                streak = 0
            else:
                streak += 1
                if streak >= confirm:
                    break
        self.burned = True
        return self.step

    def sample(self, n_samples: int, thinning: int = 1, verbose: bool = False):
        """Generate samples (burning in first if needed).

        Returns (samples (n_samples, dim) numpy array, acceptance_rate),
        like reference mhmc.py:50-88. `verbose` is accepted for API parity
        (progress is a single device call here, nothing to show).
        """
        del verbose
        if not self.burned and self.burn_steps > 0:
            _, _, self.x_t = self._run_span(
                self._next_key(), self.x_t, int(self.burn_steps),
                max(int(self.burn_steps), 1),
            )
            self.burned = True
        total = int(n_samples) * int(thinning)
        xs, accepted, self.x_t = self._run_span(
            self._next_key(), self.x_t, total, int(thinning)
        )
        return np.asarray(xs), accepted / total

    def sample_chains(self, n_samples: int, n_chains: int, thinning: int = 1):
        """Extension: `n_chains` independent chains vmapped in
        parallel from the current point, each with its own burn-in.
        Returns (samples (n_chains, n_samples, dim), acceptance_rate)."""
        x0 = jnp.broadcast_to(self.x_t, (n_chains,) + self.x_t.shape)
        burn = int(self.burn_steps)
        acc_total = 0.0
        if burn > 0:
            _, acc_b, x0 = self._run_span(
                self._next_key(), x0, burn, max(burn, 1), n_chains=n_chains
            )
            acc_total += acc_b
        total = int(n_samples) * int(thinning)
        xs, acc_s, _ = self._run_span(
            self._next_key(), x0, total, int(thinning), n_chains=n_chains
        )
        acc_total += acc_s
        return np.asarray(xs), acc_total / (n_chains * (total + burn))
