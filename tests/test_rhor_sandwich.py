"""The fused R rho R sandwich kernel (ops/rhor_sandwich.py): interpret mode
against its XLA twin, the wrapper's shapes, the choice of kernel, and the
compiled kernel on a GPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import quantpy_tpu as qt
from quantpy_tpu.config import enable_x64
from quantpy_tpu.ops import rhor_sandwich as rs
from quantpy_tpu.tomography.bootstrap_core import bootstrap_distances


def _pairs(batch_shape, d, seed=0):
    """Hermitian R and a positive-definite rho as f32 re/im pairs."""
    rng = np.random.default_rng(seed)

    def herm(scale):
        a = rng.normal(size=batch_shape + (d, d)) + 1j * rng.normal(
            size=batch_shape + (d, d)
        )
        return scale * (a + np.conj(np.swapaxes(a, -1, -2)))

    r = np.eye(d) + herm(0.05)
    p = np.eye(d) / d + herm(0.01)
    return [jnp.asarray(x, jnp.float32) for x in (r.real, r.imag, p.real, p.imag)]


@pytest.fixture
def f32():
    enable_x64(False)
    try:
        yield
    finally:
        enable_x64(True)


@pytest.mark.parametrize("d", rs.KERNEL_DIMS)
def test_interpret_kernel_matches_xla(f32, d):
    args = _pairs((6,), d)
    tre, tim = rs.rhor_sandwich(*args, interpret=True)
    ref_re, ref_im = rs.rhor_sandwich_xla(*args)
    np.testing.assert_allclose(np.asarray(tre), np.asarray(ref_re), atol=1e-6)
    np.testing.assert_allclose(np.asarray(tim), np.asarray(ref_im), atol=1e-6)
    # unit trace, and T = R rho R stays Hermitian: re symmetric, im antisymmetric
    np.testing.assert_allclose(np.trace(np.asarray(tre), axis1=-2, axis2=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(tim), -np.swapaxes(np.asarray(tim), -1, -2), atol=1e-6)


def test_xla_sandwich_matches_complex_product():
    args = [np.asarray(x, np.float64) for x in _pairs((3,), 16, seed=4)]
    r = args[0] + 1j * args[1]
    rho = args[2] + 1j * args[3]
    t = r @ rho @ r
    t = t / np.trace(t, axis1=-2, axis2=-1)[:, None, None]
    tre, tim = rs.rhor_sandwich_xla(*args)
    np.testing.assert_allclose(np.asarray(tre) + 1j * np.asarray(tim), t, atol=1e-12)


@pytest.mark.parametrize("batch_shape", [(), (2, 3)])
def test_wrapper_keeps_batch_shape(f32, batch_shape):
    args = _pairs(batch_shape, 16, seed=1)
    tre, tim = rs.rhor_sandwich(*args, interpret=True)
    assert tre.shape == tim.shape == batch_shape + (16, 16)
    assert tre.dtype == tim.dtype == jnp.float32
    ref_re, _ = rs.rhor_sandwich_xla(*args)
    np.testing.assert_allclose(np.asarray(tre), np.asarray(ref_re), atol=1e-6)


@pytest.mark.parametrize("d", [8, 64])
def test_wrapper_rejects_unsupported_dims(d):
    args = _pairs((2,), d)
    with pytest.raises(ValueError, match="sandwich kernel"):
        rs.rhor_sandwich(*args, interpret=True)


@pytest.mark.parametrize("d", rs.KERNEL_DIMS)
def test_kernel_lowers_to_triton_for_cuda(f32, d):
    spec = jax.ShapeDtypeStruct((64, d, d), jnp.float32)
    lowered = jax.jit(rs.rhor_sandwich).trace(spec, spec, spec, spec).lower(
        lowering_platforms=("cuda",)
    )
    text = lowered.as_text()
    assert "xla.gpu.triton" in text
    assert f"num_warps = {rs.NUM_WARPS[d]} : i32" in text


@pytest.mark.parametrize(
    "backend, dim, x64, applies",
    [
        ("gpu", 16, False, True),
        ("gpu", 32, False, True),
        ("gpu", 64, False, False),
        ("gpu", 8, False, False),
        ("gpu", 16, True, False),
        ("cpu", 16, False, False),
    ],
)
def test_kernel_choice(monkeypatch, backend, dim, x64, applies):
    monkeypatch.setattr(rs.jax, "default_backend", lambda: backend)
    dtype = jnp.float64 if x64 else jnp.float32
    assert rs.sandwich_kernel_applies(dim, dtype) is applies


@pytest.mark.parametrize("backend, n_calls", [("cpu", 0), ("gpu", 1)])
def test_flagship_bootstrap_program_uses_kernel_only_on_gpu(
    f32, monkeypatch, backend, n_calls
):
    """The 4-qubit mle-rhor bootstrap traces to plain XLA off the GPU and
    to exactly one pallas_call (the sandwich) on it."""
    monkeypatch.setattr(rs.jax, "default_backend", lambda: backend)
    jax.clear_caches()
    tmg = qt.StateTomograph(qt.GHZ(4), key=5)
    tmg.experiment(1000, "proj-set")
    fn = functools.partial(
        bootstrap_distances, n_points=4, method="mle-rhor", max_iter=3
    )
    try:
        jaxpr = jax.make_jaxpr(fn)(
            jax.random.key(0),
            np.asarray(tmg.state.bloch, np.float32),
            np.asarray(tmg.povm_matrix, np.float32),
            np.asarray(tmg.n_measurements, np.float32),
        )
    finally:
        jax.clear_caches()
    assert str(jaxpr).count("pallas_call") == n_calls


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.gpu
@pytest.mark.parametrize("d", rs.KERNEL_DIMS)
def test_compiled_kernel_matches_xla_on_gpu(gpu, f32, d):
    args = _pairs((16_384,), d, seed=2)
    ours = rs.rhor_sandwich(*args)
    ref = jax.jit(rs.rhor_sandwich_xla)(*args)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)
