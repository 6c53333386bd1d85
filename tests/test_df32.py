"""Double-float (ops/df32.py) accuracy tests against float64.

These run in the suite's x64-enabled CPU config but build f32 inputs and
compare the df32 (hi, lo) results against numpy float64 — the check that
matters on an accelerator whose hardware divide / log1p are a few ulp off,
where the df correction must survive XLA."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantpy_tpu.ops import df32


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def test_two_sum_exact(rng):
    a = rng.normal(size=1024).astype(np.float32) * 1e6
    b = rng.normal(size=1024).astype(np.float32)
    s, e = jax.jit(df32.two_sum)(jnp.asarray(a), jnp.asarray(b))
    s, e = np.asarray(s, np.float64), np.asarray(e, np.float64)
    np.testing.assert_array_equal(s + e, a.astype(np.float64) + b)


def test_two_prod_exact(rng):
    a = rng.normal(size=1024).astype(np.float32) * 1e3
    b = rng.normal(size=1024).astype(np.float32)
    p, e = jax.jit(df32.two_prod)(jnp.asarray(a), jnp.asarray(b))
    p, e = np.asarray(p, np.float64), np.asarray(e, np.float64)
    np.testing.assert_array_equal(p + e, a.astype(np.float64) * b)


def test_df_div_accuracy(rng):
    a = rng.normal(size=4096).astype(np.float32)
    b = np.abs(rng.normal(size=4096)).astype(np.float32) + 1e-6
    hi, lo = jax.jit(df32.df_div_ff)(jnp.asarray(a), jnp.asarray(b))
    got = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    want = a.astype(np.float64) / b
    rel = np.abs(got - want) / np.abs(want)
    assert rel.max() < 1e-13, rel.max()


def test_df_log1p_accuracy():
    # span the NLL ratio's clamp range, both signs, including near -1
    r = np.concatenate(
        [
            -1.0 + np.logspace(-7, -0.31, 400),
            np.logspace(-8, 11.9, 400),
            -np.logspace(-8, -0.31, 200),
            np.zeros(1),
        ]
    ).astype(np.float32)
    hi, lo = jax.jit(df32.df_log1p_f)(jnp.asarray(r))
    got = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    want = np.log1p(r.astype(np.float64))
    err = np.abs(got - want)
    # relative where the value is O(1)+, absolute floor from the 2^K
    # argument-reduction scale
    tol = 3e-12 * np.maximum(np.abs(want), 1.0)
    assert np.all(err < tol), (err / tol).max()


def test_df_log1p_grad_flows():
    g = jax.grad(lambda r: df32.df_log1p_f(r)[0])(jnp.float32(0.5))
    assert np.isfinite(float(g))
    np.testing.assert_allclose(float(g), 1.0 / 1.5, rtol=1e-3)


def test_rel_nll_from_dp_matches_f64(rng):
    from quantpy_tpu.tomography import process_core as pc

    n = 5000
    p_ref = rng.dirichlet(np.ones(n)).astype(np.float32) + 1e-6
    dp = (rng.normal(size=n) * 0.02 * p_ref).astype(np.float32)
    counts = rng.integers(0, 2000, size=n).astype(np.float32)
    got = float(
        jax.jit(pc._rel_nll_from_dp)(
            jnp.asarray(dp), jnp.asarray(counts), jnp.asarray(p_ref)
        )
    )
    r64 = np.maximum(
        dp.astype(np.float64) / np.maximum(p_ref.astype(np.float64), 1e-12),
        -1.0 + 1e-7,
    )
    want = -np.sum(counts.astype(np.float64) * np.log1p(r64))
    # the f64 reference uses the f32-rounded ratio clamp; agreement to the
    # df32 budget (2^-48-relative elementwise + compensated tree sum)
    assert abs(got - want) < 1e-6 * max(abs(want), 1.0) + 1e-4, (got, want)


def test_rel_nll_grad_matches_f64(rng):
    from quantpy_tpu.tomography import process_core as pc

    n = 512
    p_ref = rng.dirichlet(np.ones(n)).astype(np.float32) + 1e-6
    dp = (rng.normal(size=n) * 0.02 * p_ref).astype(np.float32)
    counts = rng.integers(0, 2000, size=n).astype(np.float32)
    g = np.asarray(
        jax.grad(
            lambda d: pc._rel_nll_from_dp(d, jnp.asarray(counts), jnp.asarray(p_ref))
        )(jnp.asarray(dp))
    )
    want = -counts.astype(np.float64) / (
        p_ref.astype(np.float64) + dp.astype(np.float64)
    )
    np.testing.assert_allclose(g, want, rtol=2e-3)
