"""Fused GEMM rollout path vs the reference step decomposition.

The fused step (mpc/nse_rollout.py NSEFusedCache) re-associates the
IMEX step — one precontracted (n, n) GEMM + batch-last convection —
and must agree with the op-by-op path (mass SpMV + L1 GEMM + saddle
inverse apply + per-scenario convection) to roundoff; likewise the
batch-last convection kernel vs vmap of the per-scenario one.
Residual-style oracle per SURVEY.md SS4; runs on CPU/f64 (conftest).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from optconpy_tpu.fem.device_conv import ConvKernel
from optconpy_tpu.models.cylinder import cylinder_setup
from optconpy_tpu.mpc import (
    batched_nse_closed_loop,
    build_nse_fused,
    build_nse_stepper,
)

RE = 60.0
DT = 0.01
NTS = 10
ALPHA = 1e-2


@pytest.fixture(scope="module")
def cyl():
    return cylinder_setup(re=RE, refinement=1)


def test_conv_batch_matches_vmap(cyl):
    np_ops, sys64, cond = cyl
    conv = ConvKernel.build(np_ops["full"], cond, dtype=jnp.float64)
    rng = np.random.default_rng(3)
    vb = jnp.asarray(rng.standard_normal((6, conv.n_free)))
    ref = jax.vmap(conv.conv_inner)(vb)
    out = conv.conv_inner_batch(vb)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-12, atol=1e-14)


@pytest.mark.slow
@pytest.mark.parametrize("feedback", ["explicit", "implicit"])
def test_fused_rollout_matches_unfused(cyl, feedback):
    np_ops, sys64, cond = cyl
    conv = ConvKernel.build(np_ops["full"], cond, dtype=jnp.float64)
    n, m = sys64.b.shape
    rng = np.random.default_rng(0)
    cache_ref = build_nse_stepper(
        np_ops, cond, DT, dtype=jnp.float64, solver="inverse"
    )
    cache_fused = build_nse_fused(np_ops, cond, DT, dtype=jnp.float64)
    ks = jnp.asarray(rng.standard_normal((NTS + 1, m, n)) * 1e-3)
    ws = jnp.asarray(rng.standard_normal((NTS + 1, n)) * 1e-3)
    v0 = jnp.asarray(
        np.asarray(cache_fused.vbar)[None]
        + 1e-3 * rng.standard_normal((4, n))
    )
    ref = batched_nse_closed_loop(
        sys64, conv, cache_ref, ks, ws, v0, ALPHA, DT, feedback=feedback
    )
    out = batched_nse_closed_loop(
        sys64, conv, cache_fused, ks, ws, v0, ALPHA, DT, feedback=feedback
    )
    for name, x, y in zip(("vs", "us", "ys"), ref, out):
        assert x.shape == y.shape, name
        scale = float(jnp.abs(x).max())
        err = float(jnp.abs(x - y).max()) / scale
        assert err < 1e-10, (name, err)
