"""Matrix-free saddle solves (solvers/matfree.py): block-Jacobi +
pressure-Schur FGMRES must reproduce the dense-LU saddle caches without
ever forming an (n+np)^2 factor (SURVEY.md SS7 layers 1/3, VERDICT r1
item 1). Residual-oracle pattern per SURVEY.md SS4.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from optconpy_tpu.fem.device_conv import ConvKernel
from optconpy_tpu.models import cavity_stokes_setup
from optconpy_tpu.models.cylinder import cylinder_setup
from optconpy_tpu.mpc import (
    batched_nse_closed_loop,
    build_nse_stepper,
    build_nse_stepper_matfree,
)
from optconpy_tpu.riccati import (
    build_dre_cache_dae,
    build_dre_cache_dae_matfree,
    cycled_shifts,
    dre_backward_sweep,
    dre_shift_schedule_dae,
    lowrank_adi,
    spectral_interval_dae,
    wachspress_shifts,
)
from optconpy_tpu.solvers import SaddleMatfreeCache, SaddleShiftedLUCache


@pytest.fixture(scope="module")
def cavity():
    return cavity_stokes_setup(nx=5)


@pytest.fixture(scope="module")
def shifted(cavity):
    np_ops, sys, _ = cavity
    a_min, a_max = spectral_interval_dae(
        np_ops["A"], np_ops["M"], np_ops["J"]
    )
    sig = wachspress_shifts(a_min, a_max, 6)
    mf = SaddleMatfreeCache.build(
        np_ops["A"].T.tocsr(), np_ops["M"], np_ops["J"], sig,
        dtype=jnp.float64, block=64, m_krylov=30, max_cycles=12,
        tol=1e-11,
    )
    m_d, a_d, j_d = sys.dense()
    lu = SaddleShiftedLUCache.build(a_d.T, m_d, j_d, jnp.asarray(sig))
    return np_ops, sys, sig, mf, lu


def test_matfree_matches_lu_all_shifts(shifted):
    np_ops, sys, sig, mf, lu = shifted
    rng = np.random.default_rng(0)
    rhs = jnp.asarray(rng.standard_normal((sys.n, 3)))
    for i in range(len(sig)):
        x_lu = np.asarray(lu.solve(jnp.int32(i), rhs))
        x_mf = np.asarray(mf.solve(jnp.int32(i), rhs))
        rel = np.abs(x_mf - x_lu).max() / np.abs(x_lu).max()
        assert rel < 1e-8, (i, rel)
    # constraint feasibility without any explicit projection,
    # scaled by the solution magnitude (ADVICE r2: the earlier bound
    # degenerated to an absolute 1e-9 by referencing |jx| itself)
    x_mf = np.asarray(mf.solve(jnp.int32(2), rhs))
    jx = np_ops["J"] @ x_mf
    assert np.abs(jx).max() < 1e-9 * max(1.0, np.abs(x_mf).max())


def test_matfree_apply_full_residual(shifted):
    """apply_full solves the FULL saddle system incl. pressure rhs —
    the SaddleLU contract used by the transient stepper (BC rhs fp)."""
    np_ops, sys, sig, mf, _ = shifted
    rng = np.random.default_rng(1)
    rhs_v = rng.standard_normal((sys.n, 2))
    rhs_p = rng.standard_normal((sys.n_p, 2))
    i = 1
    v, p = mf.apply_full(jnp.asarray(rhs_v), jnp.asarray(rhs_p), i=i)
    v, p = np.asarray(v), np.asarray(p)
    f = np_ops["A"].T + sig[i] * np_ops["M"]
    res_v = f @ v + np_ops["J"].T @ p - rhs_v
    res_p = np_ops["J"] @ v - rhs_p
    scale = max(np.abs(rhs_v).max(), np.abs(rhs_p).max())
    assert np.abs(res_v).max() < 1e-8 * scale
    assert np.abs(res_p).max() < 1e-8 * scale


def test_matfree_smw_matches_lu(shifted):
    np_ops, sys, sig, mf, lu = shifted
    rng = np.random.default_rng(2)
    u = jnp.asarray(rng.standard_normal((sys.n, sys.m_in)) * 0.1)
    rhs = jnp.asarray(rng.standard_normal((sys.n, 2)))
    x_lu = np.asarray(lu.solve_smw(jnp.int32(3), u, sys.b, rhs))
    x_mf = np.asarray(mf.solve_smw(jnp.int32(3), u, sys.b, rhs))
    rel = np.abs(x_mf - x_lu).max() / np.abs(x_lu).max()
    assert rel < 1e-7, rel


def test_matfree_adi_matches_lu(shifted):
    """The projected low-rank ADI factor is identical through the
    matrix-free cache and the per-shift LU cache."""
    np_ops, sys, sig, mf, lu = shifted
    n_adi = 12
    sigma_seq = jnp.asarray(cycled_shifts(np.asarray(sig), n_adi))
    idx_seq = jnp.asarray(
        cycled_shifts(np.arange(len(sig), dtype=np.int32), n_adi)
    )
    smw_u = jnp.zeros((sys.n, sys.m_in))
    args = dict(
        smw_u=smw_u, smw_v=sys.b, mass=sys.mass, w=sys.c.T,
        sigma_seq=sigma_seq, idx_seq=idx_seq,
    )
    z_lu = np.asarray(lowrank_adi(lu, **args))
    z_mf = np.asarray(lowrank_adi(mf, **args))
    rel = np.abs(z_mf - z_lu).max() / np.abs(z_lu).max()
    assert rel < 1e-6, rel


@pytest.mark.slow
def test_matfree_dre_sweep_matches_lu(cavity):
    """Full backward DRE sweep: matrix-free gains == dense-LU gains."""
    np_ops, sys, _ = cavity
    dt, nts = 0.05, 4
    sig, sigma_seq, idx_seq = dre_shift_schedule_dae(
        np_ops["A"], np_ops["M"], np_ops["J"], dt,
        num_shifts=6, n_adi=12,
    )
    lu_cache = build_dre_cache_dae(sys, dt, sig)
    mf_cache = build_dre_cache_dae_matfree(
        sys, dt, sig, dtype=jnp.float64, block=64,
        max_cycles=12, tol=1e-11,
    )
    kw = dict(
        alpha=1e-2, dt=dt, nts=nts,
        sigma_seq=jnp.asarray(sigma_seq), idx_seq=jnp.asarray(idx_seq),
        n_newton=2, r_max=24,
    )
    _, ks_lu = dre_backward_sweep(sys, lu_cache, **kw)
    _, ks_mf = dre_backward_sweep(sys, mf_cache, **kw)
    ks_lu, ks_mf = np.asarray(ks_lu), np.asarray(ks_mf)
    rel = np.abs(ks_mf - ks_lu).max() / np.abs(ks_lu).max()
    assert rel < 1e-6, rel


@pytest.mark.slow
@pytest.mark.parametrize("feedback", ["explicit", "implicit"])
def test_matfree_rollout_matches_lu(feedback):
    """Matrix-free batched NSE rollout == dense-SaddleLU rollout
    (cylinder refinement 1, both IMEX Oseen) — the config-3 forward
    path without the (n+np)^2 step factor."""
    dt, nts, s_batch, alpha = 0.02, 6, 3, 1e-2
    np_ops, sys64, cond = cylinder_setup(re=60.0, refinement=1)
    sys = sys64.astype(jnp.float64)
    n, m = sys.b.shape

    conv = ConvKernel.build(np_ops["full"], cond, dtype=jnp.float64)
    lu_cache = build_nse_stepper(np_ops, cond, dt, dtype=jnp.float64)
    mf_cache = build_nse_stepper_matfree(
        np_ops, cond, dt, dtype=jnp.float64, block=512,
        max_cycles=15, tol=1e-12,
    )

    rng = np.random.default_rng(0)
    vbar = np.asarray(lu_cache.vbar)
    v0 = jnp.asarray(
        vbar[None] + 1e-3 * rng.standard_normal((s_batch, n))
    )
    ks = jnp.asarray(
        np.broadcast_to(
            1e-3 * rng.standard_normal((m, n)), (nts + 1, m, n)
        )
    )
    ws = jnp.zeros((nts + 1, n))

    vs_lu, us_lu, ys_lu = batched_nse_closed_loop(
        sys, conv, lu_cache, ks, ws, v0, alpha, dt, feedback=feedback
    )
    vs_mf, us_mf, ys_mf = batched_nse_closed_loop(
        sys, conv, mf_cache, ks, ws, v0, alpha, dt, feedback=feedback
    )
    for a, b, name in [
        (vs_lu, vs_mf, "v"), (us_lu, us_mf, "u"), (ys_lu, ys_mf, "y"),
    ]:
        a, b = np.asarray(a), np.asarray(b)
        rel = np.abs(b - a).max() / max(np.abs(a).max(), 1e-30)
        assert rel < 1e-7, (name, rel)


def test_refresh_operator_matches_full_build(cavity):
    """refresh_operator (the receding-horizon per-macro value refresh,
    VERDICT r3 item 4) must solve the NEW operator to the same FGMRES
    tolerance as a from-scratch build — the kept (stale) block-Jacobi
    preconditioner may only change iteration counts, never accuracy."""
    np_ops, sys, _ = cavity
    a_min, a_max = spectral_interval_dae(
        np_ops["A"], np_ops["M"], np_ops["J"]
    )
    sig = wachspress_shifts(a_min, a_max, 4)
    base = SaddleMatfreeCache.build(
        np_ops["A"].T.tocsr(), np_ops["M"], np_ops["J"], sig,
        dtype=jnp.float64, block=64, m_krylov=30, max_cycles=12,
        tol=1e-11,
    )
    # Perturbed operator: a convection-sized asymmetric shift of A^T.
    import scipy.sparse as sp

    at = np_ops["A"].T.tocsr()
    pert = sp.csr_matrix(
        (0.05 * np.sign(at.data) * at.data, at.indices, at.indptr),
        shape=at.shape,
    )
    at_new = (at + pert.T).tocsr()
    refreshed = base.refresh_operator(at_new)
    full = SaddleMatfreeCache.build(
        at_new, np_ops["M"], np_ops["J"], sig,
        dtype=jnp.float64, block=64, m_krylov=30, max_cycles=12,
        tol=1e-11,
    )
    rng = np.random.default_rng(1)
    rhs = jnp.asarray(rng.standard_normal((sys.n, 3)))
    for i in range(len(sig)):
        x_r = np.asarray(refreshed.solve(jnp.int32(i), rhs))
        x_f = np.asarray(full.solve(jnp.int32(i), rhs))
        rel = np.abs(x_r - x_f).max() / np.abs(x_f).max()
        assert rel < 1e-8, (i, rel)
    # f32-preconditioner refresh variant: same solves (preconditioner
    # precision is invisible at the FGMRES tolerance).
    refreshed32 = base.refresh_operator(at_new, m_sp=np_ops["M"])
    x_r32 = np.asarray(refreshed32.solve(jnp.int32(0), rhs))
    x_f0 = np.asarray(full.solve(jnp.int32(0), rhs))
    rel = np.abs(x_r32 - x_f0).max() / np.abs(x_f0).max()
    assert rel < 1e-8, rel


def test_sharded_matfree_rollout_matches_unsharded(cavity):
    """The matfree FGMRES rollout under the scenario shard_map
    partition == the unsharded batched rollout (VERDICT r3 weak 6:
    config-3/4 production solvers under the multi-device dryrun)."""
    import jax

    from optconpy_tpu.parallel import scenario_mesh, sharded_nse_rollout
    from optconpy_tpu.solvers.steady import solve_steady_nse_host

    np_ops, sys64, cond = cavity_stokes_setup(nx=4)
    np_ops["vbar_full"], _ = solve_steady_nse_host(np_ops["full"], cond)
    sys = sys64.astype(jnp.float64)
    conv = ConvKernel.build(np_ops["full"], cond, dtype=jnp.float64)
    dt, alpha, nts, s_batch = 0.02, 1e-4, 4, 8
    cache = build_nse_stepper_matfree(
        np_ops, cond, dt, dtype=jnp.float64, block=64,
        max_cycles=12, tol=1e-11,
    )
    n, m = sys.b.shape
    rng = np.random.default_rng(2)
    v0 = jnp.asarray(
        np.asarray(cache.vbar)[None]
        + 1e-3 * rng.standard_normal((s_batch, n))
    )
    ks = jnp.asarray(np.broadcast_to(
        1e-3 * rng.standard_normal((m, n)), (nts + 1, m, n)
    ))
    ws = jnp.zeros((nts + 1, n))
    vs_u, us_u, ys_u = batched_nse_closed_loop(
        sys, conv, cache, ks, ws, v0, alpha, dt
    )
    mesh = scenario_mesh(jax.devices("cpu")[:8])
    ys_s, stats = sharded_nse_rollout(
        mesh, sys, conv, cache, ks, ws, v0, alpha, dt
    )
    a, b = np.asarray(ys_u), np.asarray(ys_s)
    rel = np.abs(b - a).max() / max(np.abs(a).max(), 1e-30)
    # sharded FGMRES solves see a different column blocking (S/n_dev
    # columns per device) -> different rounding at the solve tol.
    assert rel < 1e-8, rel
    ref_cost = (
        np.sum(np.asarray(ys_u) ** 2) * dt
        + alpha * np.sum(np.asarray(us_u) ** 2) * dt
    ) / s_batch
    np.testing.assert_allclose(
        float(stats["mean_cost"]), ref_cost, rtol=1e-6
    )
