"""Receding-horizon MPC (config 4 structure) + device re-linearization.

Runs on the cavity (small, CPU-f64-feasible); the cylinder-scale run is
scripts/config3_cylinder.py / bench.py territory.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from optconpy_tpu.fem.device_conv import ConvKernel
from optconpy_tpu.fem.taylor_hood import convection_matrices
from optconpy_tpu.models import cavity_stokes_setup
from optconpy_tpu.mpc import RHConfig, receding_horizon_mpc
from optconpy_tpu.riccati import (
    cycled_shifts,
    dre_shift_schedule_dae,
)
from optconpy_tpu.solvers.steady import solve_steady_nse_host


@pytest.fixture(scope="module")
def cavity():
    np_ops, sys, cond = cavity_stokes_setup(nx=6)
    # True steady NSE state: the nonlinear plant's fixed point, so
    # regulation distances below measure decay to the real equilibrium.
    np_ops["vbar_full"], _ = solve_steady_nse_host(np_ops["full"], cond)
    return np_ops, sys, cond


def test_linearized_dense_matches_host(cavity):
    """Device re-linearization == host convection_matrices (L1, L1+L2)."""
    np_ops, sys, cond = cavity
    conv = ConvKernel.build(np_ops["full"], cond, dtype=jnp.float64)
    v_full = np_ops["vbar_full"]
    l1_h, l2_h = convection_matrices(np_ops["full"], v_full)
    l1_d = np.asarray(
        conv.linearized_dense(jnp.asarray(v_full), include_l2=False)
    )
    np.testing.assert_allclose(l1_d, l1_h.toarray(), atol=1e-12)
    l12_d = np.asarray(
        conv.linearized_dense(jnp.asarray(v_full), include_l2=True)
    )
    np.testing.assert_allclose(
        l12_d, (l1_h + l2_h).toarray(), atol=1e-12
    )


def test_receding_horizon_regulates(cavity):
    """MPC loop drives perturbed scenarios back toward the steady state
    faster than the open-loop plant; all quantities finite."""
    np_ops, sys64, cond = cavity
    sys = sys64.astype(jnp.float64)
    conv = ConvKernel.build(np_ops["full"], cond, dtype=jnp.float64)
    cfg = RHConfig(horizon=8, apply=4, dt=0.02, alpha=1e-8, r_max=24)
    sig, sigma_seq, idx_seq = dre_shift_schedule_dae(
        np_ops["A"], np_ops["M"], np_ops["J"], cfg.dt,
        num_shifts=8, n_adi=16,
    )
    rng = np.random.default_rng(0)
    n = sys.n
    vbar = cond.restrict(np_ops["vbar_full"])
    v0 = jnp.asarray(
        vbar[None] + 1e-2 * rng.standard_normal((4, n))
    )
    out = receding_horizon_mpc(
        sys, conv, np_ops, cond, cfg, sig, sigma_seq, idx_seq,
        v0, n_macro=3,
    )
    vs = np.asarray(out["vs"])
    assert np.isfinite(vs).all()
    assert vs.shape[1] == 3 * cfg.apply + 1
    d0 = np.linalg.norm(vs[:, 0] - vbar[None], axis=1).mean()
    dT = np.linalg.norm(vs[:, -1] - vbar[None], axis=1).mean()
    # Stokes cavity decays by itself; MPC must do at least clearly
    # better than the open-loop decay over the same window.
    cfg0 = RHConfig(
        horizon=8, apply=4, dt=0.02, alpha=1e-8, r_max=24, n_newton=0
    )
    out0 = receding_horizon_mpc(
        sys, conv, np_ops, cond, cfg0, sig, sigma_seq, idx_seq,
        v0, n_macro=3,
    )
    vs0 = np.asarray(out0["vs"])
    dT0 = np.linalg.norm(vs0[:, -1] - vbar[None], axis=1).mean()
    assert dT < dT0
    assert dT < d0


def test_warm_start_reduces_newton_need(cavity):
    """With k_init warm start, a 1-Newton DRE reaches (nearly) the same
    gain as 3-Newton from scratch — the warm-start contract the MPC
    loop relies on."""
    import jax

    np_ops, sys64, cond = cavity
    sys = sys64.astype(jnp.float64)
    from optconpy_tpu.riccati import (
        build_dre_cache_dae,
        dre_backward_sweep,
    )

    dt, alpha, nts = 0.02, 1e-8, 8
    sig, sigma_seq, idx_seq = dre_shift_schedule_dae(
        np_ops["A"], np_ops["M"], np_ops["J"], dt, num_shifts=8, n_adi=16
    )
    cache = build_dre_cache_dae(sys, dt, sig)
    args = (sys, cache, alpha, dt, nts,
            jnp.asarray(sigma_seq), jnp.asarray(idx_seq))
    _, ks_ref = dre_backward_sweep(*args, n_newton=3, r_max=24)
    k_ref = np.asarray(ks_ref[0])
    _, ks_warm = dre_backward_sweep(
        *args, n_newton=1, r_max=24, k_init=jnp.asarray(k_ref)
    )
    k_warm = np.asarray(ks_warm[0])
    rel = np.linalg.norm(k_warm - k_ref) / np.linalg.norm(k_ref)
    # Measured 2.9e-9 on this fixture (r3); 1e-6 leaves two orders of
    # headroom while still failing on any real warm-start regression
    # (VERDICT r2 weak 3: the old 5e-2 let a half-wrong gain pass).
    assert rel < 1e-6, rel


def test_receding_gains_and_cost_quantitative(cavity):
    """Quantitative MPC oracle (VERDICT r2 item 7): with a frozen
    linearization, (a) every macro-step gain matches the quasi-steady
    full-horizon DRE gain within a stated tolerance (the 1.4e-3
    measured floor is the n_newton=1 Newton residual of the horizon-8
    sweep), and (b) the receding-horizon closed-loop cost is within 1%
    of the cost under the FULL-horizon time-varying LQR gains — the
    optimal linear policy over the same window."""
    np_ops, sys64, cond = cavity
    sys = sys64.astype(jnp.float64)
    conv = ConvKernel.build(np_ops["full"], cond, dtype=jnp.float64)
    dt, alpha = 0.02, 1e-8
    h, apply, n_macro = 8, 4, 3
    cfg = RHConfig(
        horizon=h, apply=apply, dt=dt, alpha=alpha, r_max=24,
        n_newton=1, relinearize=False,
    )
    sig, sigma_seq, idx_seq = dre_shift_schedule_dae(
        np_ops["A"], np_ops["M"], np_ops["J"], dt,
        num_shifts=8, n_adi=16,
    )
    rng = np.random.default_rng(0)
    n = sys.n
    vbar = cond.restrict(np_ops["vbar_full"])
    v0 = jnp.asarray(vbar[None] + 1e-2 * rng.standard_normal((4, n)))
    out = receding_horizon_mpc(
        sys, conv, np_ops, cond, cfg, sig, sigma_seq, idx_seq,
        v0, n_macro=n_macro,
    )

    from optconpy_tpu.mpc import batched_nse_closed_loop, build_nse_stepper
    from optconpy_tpu.riccati import build_dre_cache_dae, dre_backward_sweep

    cache = build_dre_cache_dae(sys, dt, sig)
    ss, ii = jnp.asarray(sigma_seq), jnp.asarray(idx_seq)
    # (a) gain sequence vs the quasi-steady full-horizon DRE gain.
    _, ks_q = dre_backward_sweep(
        sys, cache, alpha, dt, 40, ss, ii, n_newton=3, r_max=24
    )
    kq = np.asarray(ks_q[0])
    for i, k_rh in enumerate(np.asarray(out["ks"])):
        rel = np.linalg.norm(k_rh - kq) / np.linalg.norm(kq)
        assert rel < 5e-3, (i, rel)

    # (b) closed-loop cost vs the full-horizon LQR-optimal rollout.
    nts = n_macro * apply
    _, ks_full = dre_backward_sweep(
        sys, cache, alpha, dt, nts, ss, ii, n_newton=3, r_max=24
    )
    stepper = build_nse_stepper(np_ops, cond, dt, dtype=jnp.float64)
    ws = jnp.zeros((nts + 1, n))
    vs_opt, us_opt, _ = batched_nse_closed_loop(
        sys, conv, stepper, ks_full, ws, v0, alpha, dt,
        feedback="implicit",
    )

    def cost(vs, us):
        d = np.asarray(vs) - vbar[None, None, :]
        mdm = np.einsum(
            "stn,stn->s", d,
            np.asarray(jax.vmap(jax.vmap(sys.mass.matvec))(jnp.asarray(d))),
        )
        return float(
            mdm.mean() * dt
            + alpha * (np.asarray(us) ** 2).sum(axis=(1, 2)).mean() * dt
        )

    j_rh = cost(out["vs"], out["us"])
    j_opt = cost(vs_opt, us_opt)
    assert j_rh < 1.01 * j_opt, (j_rh, j_opt)


def test_receding_checkpoint_resume(cavity, tmp_path):
    """Per-macro-step checkpointing (SURVEY.md SS5.3): a run killed
    after 2 of 3 macro steps resumes from the checkpoint and reaches
    the same final state as the uninterrupted run."""
    np_ops, sys64, cond = cavity
    sys = sys64.astype(jnp.float64)
    conv = ConvKernel.build(np_ops["full"], cond, dtype=jnp.float64)
    cfg = RHConfig(horizon=6, apply=3, dt=0.02, alpha=1e-6, r_max=24)
    sig, sigma_seq, idx_seq = dre_shift_schedule_dae(
        np_ops["A"], np_ops["M"], np_ops["J"], cfg.dt,
        num_shifts=6, n_adi=12,
    )
    rng = np.random.default_rng(3)
    vbar = cond.restrict(np_ops["vbar_full"])
    v0 = jnp.asarray(vbar[None] + 1e-2 * rng.standard_normal((2, sys.n)))
    args = (sys, conv, np_ops, cond, cfg, sig, sigma_seq, idx_seq, v0)

    ref = receding_horizon_mpc(*args, n_macro=3)
    ckpt = str(tmp_path / "mpc_state.npz")
    part = receding_horizon_mpc(*args, n_macro=2, checkpoint=ckpt)
    assert part["resumed_from"] == 0
    resumed = receding_horizon_mpc(*args, n_macro=3, checkpoint=ckpt)
    assert resumed["resumed_from"] == 2
    np.testing.assert_allclose(
        np.asarray(resumed["v_final"]), np.asarray(ref["v_final"]),
        rtol=0, atol=1e-12,
    )
    # Fully-completed checkpoint: nothing left to do, state preserved.
    again = receding_horizon_mpc(*args, n_macro=3, checkpoint=ckpt)
    assert again["resumed_from"] == 3
    np.testing.assert_allclose(
        np.asarray(again["v_final"]), np.asarray(ref["v_final"]),
        rtol=0, atol=1e-12,
    )


def test_receding_checkpoint_rejects_foreign_config(cavity, tmp_path):
    """A checkpoint written under one config must refuse to resume a
    run with a different one (ADVICE r2: silent stale-state resume)."""
    np_ops, sys64, cond = cavity
    sys = sys64.astype(jnp.float64)
    conv = ConvKernel.build(np_ops["full"], cond, dtype=jnp.float64)
    cfg = RHConfig(horizon=6, apply=3, dt=0.02, alpha=1e-6, r_max=24)
    sig, sigma_seq, idx_seq = dre_shift_schedule_dae(
        np_ops["A"], np_ops["M"], np_ops["J"], cfg.dt,
        num_shifts=6, n_adi=12,
    )
    rng = np.random.default_rng(3)
    vbar = cond.restrict(np_ops["vbar_full"])
    v0 = jnp.asarray(vbar[None] + 1e-2 * rng.standard_normal((2, sys.n)))
    ckpt = str(tmp_path / "mpc_state.npz")
    receding_horizon_mpc(
        sys, conv, np_ops, cond, cfg, sig, sigma_seq, idx_seq, v0,
        n_macro=1, checkpoint=ckpt,
    )
    import dataclasses

    cfg2 = dataclasses.replace(cfg, dt=0.04)
    with pytest.raises(ValueError, match="fingerprint"):
        receding_horizon_mpc(
            sys, conv, np_ops, cond, cfg2, sig, sigma_seq, idx_seq, v0,
            n_macro=2, checkpoint=ckpt,
        )


@pytest.mark.slow
def test_receding_matfree_matches_lu(cavity):
    """The matrix-free macro loop (sparse host re-linearization +
    SaddleMatfreeCache rebuilds) reproduces the dense-LU macro loop's
    trajectories and gains — a strong oracle for the config-4 path."""
    np_ops, sys64, cond = cavity
    sys = sys64.astype(jnp.float64)
    conv = ConvKernel.build(np_ops["full"], cond, dtype=jnp.float64)
    base = dict(horizon=6, apply=3, dt=0.02, alpha=1e-6, r_max=24)
    cfg_lu = RHConfig(**base, solver="lu")
    cfg_mf = RHConfig(
        **base, solver="matfree",
        fgmres_tol=1e-11, fgmres_cycles=12,
    )
    sig, sigma_seq, idx_seq = dre_shift_schedule_dae(
        np_ops["A"], np_ops["M"], np_ops["J"], base["dt"],
        num_shifts=6, n_adi=12,
    )
    rng = np.random.default_rng(1)
    vbar = cond.restrict(np_ops["vbar_full"])
    v0 = jnp.asarray(vbar[None] + 1e-2 * rng.standard_normal((3, sys.n)))
    out_lu = receding_horizon_mpc(
        sys, conv, np_ops, cond, cfg_lu, sig, sigma_seq, idx_seq,
        v0, n_macro=2,
    )
    out_mf = receding_horizon_mpc(
        sys, conv, np_ops, cond, cfg_mf, sig, sigma_seq, idx_seq,
        v0, n_macro=2,
    )
    for key in ("vs", "us", "ks"):
        a = np.asarray(out_lu[key])
        b = np.asarray(out_mf[key])
        scale = np.abs(a - (vbar[None, None] if key == "vs" else 0)).max()
        rel = np.abs(b - a).max() / max(scale, 1e-30)
        assert rel < 1e-6, (key, rel)


def test_dense_ns_matches_matfree_receding():
    """RHConfig.solver='dense_ns' (device NS-refreshed dense DRE
    stack, r5) reproduces the matfree receding loop's gains and
    trajectories to solver precision on the cavity NSE."""
    import jax.numpy as jnp

    from optconpy_tpu.fem.device_conv import ConvKernel
    from optconpy_tpu.models import cavity_stokes_setup
    from optconpy_tpu.mpc import RHConfig, receding_horizon_mpc
    from optconpy_tpu.riccati import dre_shift_schedule_dae
    from optconpy_tpu.solvers.steady import solve_steady_nse_host

    np_ops, dsys64, cond = cavity_stokes_setup(nx=4)
    np_ops["vbar_full"], _ = solve_steady_nse_host(
        np_ops["full"], cond
    )
    dsys = dsys64.astype(jnp.float64)
    dt, alpha = 0.02, 1e-6
    sig, sseq, iseq = dre_shift_schedule_dae(
        np_ops["A"], np_ops["M"], np_ops["J"], dt,
        num_shifts=3, n_adi=6,
    )
    conv = ConvKernel.build(np_ops["full"], cond, dtype=jnp.float64)
    n = dsys.n
    rng = np.random.default_rng(0)
    vbar = cond.restrict(np_ops["vbar_full"])
    v0 = jnp.asarray(vbar[None] + 1e-3 * rng.standard_normal((4, n)))
    outs = {}
    for solver in ("matfree", "dense_ns"):
        cfg = RHConfig(
            horizon=3, apply=3, dt=dt, alpha=alpha, n_newton=1,
            r_max=8, solver=solver, warm_n_adi=4,
            fgmres_tol=1e-10, fgmres_cycles=12,
        )
        outs[solver] = receding_horizon_mpc(
            dsys, conv, np_ops, cond, cfg, sig, sseq, iseq, v0,
            n_macro=3,
        )
        assert np.isfinite(np.asarray(outs[solver]["vs"])).all()
    kd = np.abs(
        np.asarray(outs["dense_ns"]["ks"])
        - np.asarray(outs["matfree"]["ks"])
    ).max() / max(np.abs(np.asarray(outs["matfree"]["ks"])).max(), 1e-30)
    vd = np.abs(
        np.asarray(outs["dense_ns"]["vs"])
        - np.asarray(outs["matfree"]["vs"])
    ).max() / np.abs(np.asarray(outs["matfree"]["vs"])).max()
    assert kd < 1e-6, kd
    assert vd < 1e-8, vd
