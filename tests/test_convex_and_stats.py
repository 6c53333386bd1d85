"""Convex solvers (vs scipy), stats moments (vs reference), MHMC sampler."""

import numpy as np
import pytest
import scipy.optimize

from quantpy_tpu.convex import linear_bounds_on_ball_slice, solve_lp_batch
from quantpy_tpu.stats import l2_mean, l2_variance

from .reference_shim import get_reference

ref = get_reference()
needs_ref = pytest.mark.skipif(ref is None, reason="reference unavailable")


def test_ball_slice_vs_scipy(rng):
    """Closed-form sliced-ball bounds match an SLSQP solve."""
    d = 8
    c = rng.normal(size=d)
    center = rng.normal(size=d) * 0.1
    fixed_idx = np.array([0, 3])
    fixed_vals = np.array([0.5, 0.0])
    radii = np.array([0.3, 0.8, 2.0])
    mins, maxs = linear_bounds_on_ball_slice(c, center, radii, fixed_idx, fixed_vals)

    for r, lo, hi in zip(radii, mins, maxs):
        cons = [
            {"type": "eq", "fun": lambda x: x[fixed_idx] - fixed_vals},
            {"type": "ineq", "fun": lambda x: r**2 - np.sum((x - center) ** 2)},
        ]
        res_min = scipy.optimize.minimize(lambda x: c @ x, center.copy(), constraints=cons)
        res_max = scipy.optimize.minimize(lambda x: -(c @ x), center.copy(), constraints=cons)
        if np.isnan(lo):
            assert not res_min.success or r**2 < np.sum((center[fixed_idx] - fixed_vals) ** 2)
        else:
            np.testing.assert_allclose(lo, res_min.fun, atol=1e-5)
            np.testing.assert_allclose(hi, -res_max.fun, atol=1e-5)


def test_lp_batch_vs_scipy(rng):
    """PDHG LP solutions match scipy.linprog on bounded random polytopes."""
    d, k = 6, 30
    a = rng.normal(size=(k, d))
    a = np.vstack([a, -a])  # guarantee boundedness
    c = rng.normal(size=d)
    b_batch = np.stack([rng.uniform(0.5, 1.5, size=2 * k) for _ in range(5)])
    x, obj, viol, iters = solve_lp_batch(c, a, b_batch, n_iter=30000)
    obj = np.asarray(obj)
    viol = np.asarray(viol)
    assert np.all(viol < 1e-4)
    assert 0 < int(iters) <= 30000
    for i in range(5):
        res = scipy.optimize.linprog(c, A_ub=a, b_ub=b_batch[i], bounds=(None, None))
        assert res.success
        np.testing.assert_allclose(obj[i], res.fun, atol=2e-3)


def test_lp_batch_early_stop(rng):
    """The duality-gap stop fires well before the iteration cap on an easy
    problem, and a loose cap still reports its count."""
    d, k = 4, 12
    a = rng.normal(size=(k, d))
    a = np.vstack([a, -a])
    c = rng.normal(size=d)
    b = rng.uniform(1.0, 2.0, size=(3, 2 * k))
    x, obj, viol, iters = solve_lp_batch(c, a, b, n_iter=100000, tol=1e-8)
    assert int(iters) < 100000  # stopped early on the gap criterion
    res = scipy.optimize.linprog(c, A_ub=a, b_ub=b[0], bounds=(None, None))
    np.testing.assert_allclose(np.asarray(obj)[0], res.fun, atol=1e-4)


@needs_ref
def test_stats_moments_parity(rng):
    from quantpy.stats import l2_mean as ref_mean, l2_variance as ref_var

    freq = rng.uniform(0.05, 1.0, size=(3, 4))
    freq /= freq.sum(axis=1, keepdims=True)
    w = rng.normal(size=(3, 4, 3, 4))
    w = w + w.transpose(2, 3, 0, 1)  # symmetric weights
    np.testing.assert_allclose(
        l2_mean(freq, 500, w), ref_mean(freq, 500, w), rtol=1e-12
    )
    np.testing.assert_allclose(
        l2_variance(freq, 500, w), ref_var(freq, 500, w), rtol=1e-10
    )


def test_stats_factor_form_matches_weights_form(rng):
    """l2_moments_from_factor (W = V^T V, no weights tensor) equals the
    4-index-tensor formulas."""
    from quantpy_tpu.stats import l2_moments_from_factor

    freq = rng.uniform(0.05, 1.0, size=(4, 3))
    freq /= freq.sum(axis=1, keepdims=True)
    v = rng.normal(size=(7, 4, 3))
    w = np.einsum("dai,dbj->aibj", v, v)
    mean, var = l2_moments_from_factor(v, freq, 800)
    np.testing.assert_allclose(mean, l2_mean(freq, 800, w), rtol=1e-12)
    np.testing.assert_allclose(var, l2_variance(freq, 800, w), rtol=1e-10)


def test_stats_moments_match_monte_carlo(rng):
    """Property test: the analytic mean/variance of Q = ||f_obs - f||_W^2
    match brute-force multinomial sampling (provenance check for the
    quadratic-form derivation)."""
    m, p, n_trials = 3, 4, 2000
    probs = rng.uniform(0.1, 1.0, size=(m, p))
    probs /= probs.sum(axis=1, keepdims=True)
    v = rng.normal(size=(6, m, p))
    w = np.einsum("dai,dbj->aibj", v, v)

    n_mc = 40000
    counts = np.stack(
        [rng.multinomial(n_trials, probs[a], size=n_mc) for a in range(m)],
        axis=1,
    )  # (n_mc, m, p)
    x = counts / n_trials - probs  # centered frequencies
    q = np.einsum("saj,ajbk,sbk->s", x, w, x)

    mean = l2_mean(probs, n_trials, w)
    var = l2_variance(probs, n_trials, w)
    # CLT-level agreement: the formulas are the Gaussian approximation
    np.testing.assert_allclose(q.mean(), mean, rtol=0.05)
    np.testing.assert_allclose(q.var(), var, rtol=0.1)


def test_mhmc_samples_gaussian():
    """The sampler reproduces a known distribution."""
    import jax.numpy as jnp

    from quantpy_tpu.mhmc import MHMC

    logpdf = lambda x: -0.5 * jnp.sum(x**2 / jnp.asarray([1.0, 4.0]))
    chain = MHMC(logpdf, step=1.0, burn_steps=500, dim=2, key=5)
    samples, rate = chain.sample(4000, thinning=2)
    assert samples.shape == (4000, 2)
    assert 0.1 < rate < 0.9
    np.testing.assert_allclose(samples.mean(0), [0, 0], atol=0.25)
    np.testing.assert_allclose(samples.std(0), [1.0, 2.0], rtol=0.2)


def test_mhmc_multichain():
    import jax.numpy as jnp

    from quantpy_tpu.mhmc import MHMC

    logpdf = lambda x: -0.5 * jnp.sum(x**2)
    chain = MHMC(logpdf, step=0.8, burn_steps=200, dim=3, key=6)
    samples, rate = chain.sample_chains(500, n_chains=8)
    assert samples.shape == (8, 500, 3)
    np.testing.assert_allclose(samples.reshape(-1, 3).std(0), 1.0, rtol=0.15)


def test_mhmc_normalized_update():
    import jax.numpy as jnp

    from quantpy_tpu.mhmc import MHMC, normalized_update

    logpdf = lambda x: jnp.asarray(0.0)  # uniform on the sphere
    chain = MHMC(
        logpdf, step=0.3, burn_steps=100, dim=4,
        update_rule=normalized_update, x_init=np.array([1.0, 0, 0, 0]), key=7,
    )
    samples, _ = chain.sample(200)
    np.testing.assert_allclose(np.linalg.norm(samples, axis=1), 1.0, atol=1e-5)


def test_mhmc_jump_distrs():
    import jax
    import jax.numpy as jnp

    from quantpy_tpu.mhmc import MHMC

    logpdf = lambda x: -0.5 * jnp.sum(x**2)
    for distr in ["uniform", "laplace"]:
        chain = MHMC(logpdf, jump_distr=distr, step=1.0, burn_steps=200, dim=2, key=8)
        samples, rate = chain.sample(2000)
        assert 0.05 < rate < 0.95, distr
        np.testing.assert_allclose(samples.std(0), 1.0, rtol=0.2)
    # custom traceable sampler
    custom = lambda key, shape, dtype: 0.5 * jax.random.normal(key, shape, dtype)
    chain = MHMC(logpdf, jump_distr=custom, step=1.0, burn_steps=200, dim=2, key=9)
    samples, _ = chain.sample(2000)
    np.testing.assert_allclose(samples.std(0), 1.0, rtol=0.2)
    with pytest.raises(ValueError):
        MHMC(logpdf, jump_distr="bogus")
    with pytest.raises(NotImplementedError):
        MHMC(logpdf, jump_distr=3.14)


def test_mhmc_diagnostics():
    from quantpy_tpu.mhmc import effective_sample_size, split_rhat

    rng = np.random.default_rng(1)
    mixed = rng.normal(size=(4, 500))
    assert abs(split_rhat(mixed) - 1.0) < 0.05
    # iid samples: ESS close to the actual count
    assert effective_sample_size(mixed) > 1000
    # badly separated chains
    bad = mixed + np.arange(4)[:, None] * 5.0
    assert split_rhat(bad) > 1.5


def test_mhmc_hastings_asymmetric_proposal():
    """Asymmetric proposal + Hastings correction recovers the target that
    the uncorrected chain skews (reference quantpy/mhmc.py:99-103)."""
    import jax
    import jax.numpy as jnp

    from quantpy_tpu.mhmc import MHMC

    logpdf = lambda x: -0.5 * jnp.sum(x**2)  # N(0, 1)
    shift = 0.8
    sampler = lambda key, shape, dtype: (
        jax.random.normal(key, shape, dtype) + shift
    )
    jump_logpdf = lambda d: -0.5 * jnp.sum((d - shift) ** 2)

    corrected = MHMC(
        logpdf, jump_distr=sampler, jump_logpdf=jump_logpdf,
        symmetric=False, step=1.0, burn_steps=500, dim=1, key=12,
    )
    s1, rate = corrected.sample(6000)
    assert 0.05 < rate < 0.95
    assert abs(float(s1.mean())) < 0.15
    np.testing.assert_allclose(float(s1.std()), 1.0, rtol=0.2)

    # the same proposal WITHOUT the correction drifts the chain upward —
    # this is the bias the reference's pdf-ratio branch removes
    skewed = MHMC(
        logpdf, jump_distr=sampler, step=1.0, burn_steps=500, dim=1, key=13
    )
    s2, _ = skewed.sample(6000)
    assert float(s2.mean()) > 0.2

    with pytest.raises(ValueError):
        MHMC(logpdf, jump_distr=sampler, symmetric=False)


def test_mhmc_scipy_frozen_proposals():
    """scipy frozen distributions adapt to device chains (reference
    quantpy/mhmc.py:41 takes any rv with .rvs/.pdf).
    Symmetric frozen proposals sample the target; an asymmetric frozen
    (loc != 0) auto-enables the Hastings correction."""
    import jax.numpy as jnp
    import scipy.stats as st

    from quantpy_tpu.mhmc import MHMC, from_scipy_frozen

    logpdf = lambda x: -0.5 * jnp.sum(x**2)  # N(0, 1)
    for frozen in (st.norm(scale=1.5), st.laplace(), st.uniform(-1, 2),
                   st.t(df=4), st.logistic(scale=0.7)):
        chain = MHMC(
            logpdf, jump_distr=frozen, step=1.0, burn_steps=300, dim=2, key=21
        )
        samples, rate = chain.sample(3000)
        assert 0.05 < rate < 0.98, frozen.dist.name
        np.testing.assert_allclose(
            samples.std(0), 1.0, rtol=0.25, err_msg=frozen.dist.name
        )
    # asymmetric frozen: Hastings auto-correction keeps the target centered
    biased = st.norm(loc=0.8)
    chain = MHMC(logpdf, jump_distr=biased, step=1.0, burn_steps=500, dim=1, key=22)
    assert chain.jump_logpdf is not None  # correction wired automatically
    s, rate = chain.sample(12000)
    assert 0.05 < rate < 0.95
    assert abs(float(s.mean())) < 0.15
    # the adapter's density matches scipy's
    _, logq, sym = from_scipy_frozen(st.norm(loc=0.8, scale=1.3))
    assert not sym
    for d in (-0.5, 0.0, 1.7):
        np.testing.assert_allclose(
            float(logq(jnp.asarray([np.float32(d)]))),
            st.norm(loc=0.8, scale=1.3).logpdf(d),
            rtol=1e-5,
        )
    # unsupported family raises with the escape hatch
    with pytest.raises(NotImplementedError):
        from_scipy_frozen(st.gamma(2.0))
