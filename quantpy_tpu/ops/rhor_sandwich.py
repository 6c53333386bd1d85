"""Fused R rho R sandwich of the RrhoR MLE step, as a Pallas kernel for GPUs.

One step of ``state_core.estimate_mle_rhor`` forms, for every resample, the
complex product T = R rho R of two Hermitian d x d matrices held as re/im
pairs, then renormalises T to unit trace. Written as XLA ops that is eight
batched real d x d matmuls and their adds, each a separate pass over HBM.
:func:`rhor_sandwich` does it in one kernel through Pallas' Triton route:
one program per resample keeps its four d x d operands on the chip, runs the
eight products with ``pl.dot`` at full f32 precision, fuses the complex adds
and the trace normalisation, and writes T once.

:func:`rhor_sandwich_xla` is the same arithmetic in plain ``jax.numpy``: the
path on every other backend and the reference the kernel is tested against.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

__all__ = ["rhor_sandwich", "rhor_sandwich_xla", "sandwich_kernel_applies"]

#: warps per program (one resample per program) for each matrix size that
#: takes the kernel, the fastest of 1/2/4/8 on an H100. pl.dot needs every
#: dimension >= 16; the kernel beat XLA end to end at d = 16 and 32, and
#: lost at d = 64 (18x on the step at 8 warps), which XLA's gemms keep.
NUM_WARPS = {16: 1, 32: 4}
KERNEL_DIMS = tuple(NUM_WARPS)


def sandwich_kernel_applies(dim: int, dtype) -> bool:
    """Whether :func:`rhor_sandwich` runs the kernel for d x d matrices of
    `dtype` on the default backend (float32 on a GPU)."""
    return (
        dim in KERNEL_DIMS
        and jnp.dtype(dtype) == jnp.float32
        and jax.default_backend() == "gpu"
    )


def rhor_sandwich_xla(rre, rim, pre, pim):
    """(T_re, T_im) of T = R rho R / tr(R rho R), batched over leading axes."""
    sre = rre @ pre - rim @ pim
    sim = rre @ pim + rim @ pre
    tre = sre @ rre - sim @ rim
    tim = sre @ rim + sim @ rre
    tr = jnp.trace(tre, axis1=-2, axis2=-1)[..., None, None]
    return tre / tr, tim / tr


def _sandwich_kernel(rre_ref, rim_ref, pre_ref, pim_ref, tre_ref, tim_ref):
    dot = functools.partial(pl.dot, precision=jax.lax.Precision.HIGHEST)
    rre, rim = rre_ref[...], rim_ref[...]
    pre, pim = pre_ref[...], pim_ref[...]
    sre = dot(rre, pre) - dot(rim, pim)
    sim = dot(rre, pim) + dot(rim, pre)
    tre = dot(sre, rre) - dot(sim, rim)
    tim = dot(sre, rim) + dot(sim, rre)
    d = tre.shape[-1]
    diag = jax.lax.broadcasted_iota(jnp.int32, (d, d), 0) == jax.lax.broadcasted_iota(
        jnp.int32, (d, d), 1
    )
    tr = jnp.sum(jnp.where(diag, tre, 0.0))
    tre_ref[...] = tre / tr
    tim_ref[...] = tim / tr


@functools.partial(jax.jit, static_argnames=("interpret",))
def rhor_sandwich(rre, rim, pre, pim, interpret: bool = False):
    """Kernel form of :func:`rhor_sandwich_xla`: (..., d, d) float32 re/im
    pairs in, the unit-trace (T_re, T_im) out. `interpret=True` runs the
    kernel body on the CPU (tests)."""
    batch_shape, d = rre.shape[:-2], rre.shape[-1]
    if d not in KERNEL_DIMS:
        raise ValueError(f"sandwich kernel takes d in {KERNEL_DIMS}, got {d}")
    flat = [x.reshape((-1, d, d)).astype(jnp.float32) for x in (rre, rim, pre, pim)]
    n = flat[0].shape[0]
    spec = pl.BlockSpec((None, d, d), lambda i: (i, 0, 0))
    out = jax.ShapeDtypeStruct((n, d, d), jnp.float32)
    tre, tim = pl.pallas_call(
        _sandwich_kernel,
        out_shape=(out, out),
        grid=(n,),
        in_specs=[spec] * 4,
        out_specs=(spec, spec),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS[d]),
        interpret=interpret,
        name="rhor_sandwich",
    )(*flat)
    return tre.reshape(batch_shape + (d, d)), tim.reshape(batch_shape + (d, d))
