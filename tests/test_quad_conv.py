"""Quadrature-interpolation convection kernel (fem/device_conv.py
QuadConvKernel): must reproduce the per-element tensor ConvKernel to
roundoff — same degree-5 rule, restructured as 4 large SpMMs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from optconpy_tpu.fem.device_conv import ConvKernel, QuadConvKernel
from optconpy_tpu.models import cavity_stokes_setup
from optconpy_tpu.solvers.steady import solve_steady_nse_host


@pytest.fixture(scope="module")
def kernels():
    np_ops, sys, cond = cavity_stokes_setup(nx=6)
    np_ops["vbar_full"], _ = solve_steady_nse_host(np_ops["full"], cond)
    ref = ConvKernel.build(np_ops["full"], cond, dtype=jnp.float64)
    quad = QuadConvKernel.build(np_ops["full"], cond, dtype=jnp.float64)
    return np_ops, cond, ref, quad


def test_quad_conv_matches_tensor_single(kernels):
    np_ops, cond, ref, quad = kernels
    rng = np.random.default_rng(0)
    v = jnp.asarray(
        cond.restrict(np_ops["vbar_full"])
        + 0.1 * rng.standard_normal(ref.n_free)
    )
    a = np.asarray(ref.conv_inner(v))
    b = np.asarray(quad.conv_inner(v))
    assert np.abs(a - b).max() < 1e-12 * max(np.abs(a).max(), 1), (
        np.abs(a - b).max()
    )


def test_quad_conv_matches_tensor_batch(kernels):
    np_ops, cond, ref, quad = kernels
    rng = np.random.default_rng(1)
    vb = jnp.asarray(
        cond.restrict(np_ops["vbar_full"])[None]
        + 0.1 * rng.standard_normal((5, ref.n_free))
    )
    a = np.asarray(ref.conv_inner_batch(vb))
    b = np.asarray(quad.conv_inner_batch(vb))
    assert np.abs(a - b).max() < 1e-12 * max(np.abs(a).max(), 1)


def test_conv_inner_batch_f32_matches_f64_loop(kernels):
    """The f32 batch-last kernel against the f64 per-scenario conv_inner.

    Tolerance 1e-5 of max|N(v)v|: each output sums at most a few
    elements' 72-term f32 contractions, so f32 rounding (eps 1.2e-7)
    stays below ~1e-6 relative; 1e-5 leaves room for the summation order.
    """
    np_ops, cond, ref64, _ = kernels
    k32 = ref64.astype(jnp.float32)
    rng = np.random.default_rng(5)
    vb = (
        cond.restrict(np_ops["vbar_full"])[None]
        + 0.1 * rng.standard_normal((6, ref64.n_free))
    )
    want = np.stack([np.asarray(ref64.conv_inner(jnp.asarray(v)))
                     for v in vb])
    got = np.asarray(k32.conv_inner_batch(jnp.asarray(vb, jnp.float32)))
    assert got.dtype == np.float32 and got.shape == want.shape
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 1e-5, rel


@pytest.mark.parametrize("b", [1, 70])
def test_conv_triton_kernel_interpret_matches_xla(kernels, b):
    """The GPU element kernel (ops/conv_triton.py) in the Pallas
    interpreter, plus ConvKernel's scatter-sum, against the plain XLA
    path; b=70 is not a multiple of the kernel's column tile (padding)."""
    from optconpy_tpu.ops.conv_triton import conv_local_triton

    _, _, ref, _ = kernels
    rng = np.random.default_rng(6)
    v = jnp.asarray(rng.standard_normal((2 * ref.ns, b)))
    out = conv_local_triton(
        v, ref.t0p, ref.dofs_p, ns=ref.ns, interpret=True
    )
    assert out.shape == (2, 6, ref.t0p.shape[1], b)
    got = np.asarray(
        out.reshape(2, -1, b)[:, ref.slots_nm].sum(axis=2)
    ).reshape(2 * ref.ns, b)
    want = np.asarray(ref.conv_full_batch_xla(v))
    assert np.abs(got - want).max() < 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("b, platform, want", [
    (64, "cuda", False), (65, "cuda", True), (1024, "cpu", False),
])
def test_conv_full_batch_kernel_choice(kernels, b, platform, want):
    """The Triton kernel is lowered only for CUDA and batches wider than
    one column tile; lowering for CUDA needs no GPU."""
    _, _, ref, _ = kernels
    k32 = ref.astype(jnp.float32)
    v = jnp.zeros((2 * k32.ns, b), jnp.float32)
    hlo = jax.jit(k32.conv_full_batch).trace(v).lower(
        lowering_platforms=(platform,)
    ).as_text()
    assert ("triton" in hlo.lower()) == want


def test_conv_triton_pack_slots(kernels):
    """Node-major slots address the same (element, node) pairs as the
    element-major ones, and the sentinel lands on an all-zero element."""
    from optconpy_tpu.ops.conv_triton import E_TILE

    _, _, ref, _ = kernels
    nt = ref.tri_dofs.shape[0]
    nt_pad = ref.t0p.shape[1]
    assert nt_pad % E_TILE == 0 and nt_pad > nt
    assert not np.asarray(ref.t0p)[:, nt:].any()
    em = np.asarray(ref.scatter_slots)
    nm = np.asarray(ref.slots_nm)
    real = em < nt * 6
    e, i = np.divmod(em[real], 6)
    np.testing.assert_array_equal(nm[real], i * nt_pad + e)
    np.testing.assert_array_equal(nm[~real], nt)


def test_quad_conv_in_fused_rollout(kernels):
    """Swapping the kernel inside the fused closed loop changes
    nothing (beyond roundoff) — the bench path contract."""
    from optconpy_tpu.mpc.nse_rollout import (
        batched_nse_closed_loop_fused,
        build_nse_fused,
    )

    np_ops, cond, ref, quad = kernels
    import optconpy_tpu.models as _m

    # rebuild a DAE system for the rollout signature
    from optconpy_tpu.fem.dae import dae_from_scipy

    sys = dae_from_scipy(
        np_ops["M"], np_ops["A"], np_ops["J"], np_ops["B"], np_ops["C"]
    ).astype(jnp.float64)
    dt, nts, s = 0.02, 5, 3
    cache = build_nse_fused(np_ops, cond, dt, dtype=jnp.float64)
    rng = np.random.default_rng(2)
    n, m = sys.b.shape
    v0 = jnp.asarray(
        np.asarray(cache.vbar)[None] + 1e-2 * rng.standard_normal((s, n))
    )
    ks = jnp.asarray(1e-3 * rng.standard_normal((nts + 1, m, n)))
    ws = jnp.zeros((nts + 1, n))
    va, _, _ = batched_nse_closed_loop_fused(
        sys, ref, cache, ks, ws, v0, 1e-2
    )
    vb, _, _ = batched_nse_closed_loop_fused(
        sys, quad, cache, ks, ws, v0, 1e-2
    )
    va, vb = np.asarray(va), np.asarray(vb)
    assert np.abs(va - vb).max() < 1e-11 * max(np.abs(va).max(), 1)
