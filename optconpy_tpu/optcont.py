"""optcon_nse — the end-to-end experiment driver (L5).

Parity with the reference's optcont_main.optcon_nse (SURVEY.md SS2 row
1, SS3.1): assemble -> steady state -> B/C operators -> target y* ->
backward DRE sweep (gain factors per timestep) -> feedforward sweep ->
forward closed-loop sweep -> outputs. Differences are the device-first
redesign: the backward/forward sweeps are jitted programs on device,
gains are checkpointed as one npz artifact keyed by the config hash
(utils/cache.py), and the forward sweep can roll out a whole scenario
batch at once (the reference is strictly one trajectory per run).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from .utils.cache import load_or_comp, write_meta
from .utils.config import OptConConfig
from .utils.metrics import MetricsLogger


@dataclass
class OptConResult:
    """Outputs of one optcon_nse run (host-side numpy)."""

    cfg: OptConConfig
    times: np.ndarray  # (nts+1,)
    ys: np.ndarray  # (S, nts+1, p) closed-loop outputs
    us: np.ndarray  # (S, nts, m) control inputs
    ystar: np.ndarray  # (nts+1, p) target
    cost: float  # mean tracking cost over scenarios
    gains: Any  # (nts+1, m, n) device array
    extras: dict


def get_ystarvec(
    cost_cfg, times: np.ndarray, p: int, y_ref: np.ndarray | None = None
) -> np.ndarray:
    """Target output signal y*(t): (nts+1, p).

    Parity with cont_obs_utils.get_ystarvec (SURVEY.md SS2 row 4):
    'zero' regulates to the output origin, 'const' holds an absolute
    step, 'steady_offset' holds y_ref + amp (a reachable perturbation
    of the steady output), 'sin' rides a sinusoid on y_ref.
    """
    nts1 = len(times)
    if y_ref is None:
        y_ref = np.zeros(p)
    if cost_cfg.ystar == "zero":
        return np.zeros((nts1, p))
    if cost_cfg.ystar == "const":
        return np.full((nts1, p), cost_cfg.ystar_amp)
    if cost_cfg.ystar == "steady_offset":
        return np.tile(y_ref[None, :], (nts1, 1)) + cost_cfg.ystar_amp
    if cost_cfg.ystar == "sin":
        sig = cost_cfg.ystar_amp * np.sin(
            2.0 * np.pi * cost_cfg.ystar_freq * times
        )
        return np.tile(y_ref[None, :], (nts1, 1)) + sig[:, None]
    raise ValueError(f"unknown ystar family: {cost_cfg.ystar}")


def _setup_problem(cfg: OptConConfig):
    """Dispatch to the problem family; returns (np_ops, sys64, cond).

    cond is None for unconstrained problems (heat1d, config 1): no
    divergence constraint, no convection — the driver then takes the
    linear LTI sweep path instead of the NSE one.
    """
    p = cfg.problem
    if p.name == "cylinderwake":
        from .models.cylinder import cylinder_setup

        return cylinder_setup(re=p.re, refinement=p.refinement)
    if p.name == "drivencavity":
        from .models.cavity import cavity_stokes_setup
        from .solvers.steady import solve_steady_nse_host

        np_ops, sys, cond = cavity_stokes_setup(nx=p.nx)
        # Linearization point = steady NSE cavity flow (the nonlinear
        # forward sweep is a fixed point there; gains use the Stokes
        # operator, correct at the cavity's low Re).
        np_ops["vbar_full"], _ = solve_steady_nse_host(
            np_ops["full"], cond
        )
        return np_ops, sys, cond
    if p.name == "heat1d":
        from .fem.heat1d import heat1d_operators

        np_ops, sys = heat1d_operators(n=p.n_dof)
        return np_ops, sys, None
    raise ValueError(f"unknown problem: {p.name}")


def optcon_nse(
    cfg: OptConConfig,
    v0_batch: np.ndarray | None = None,
    cache_dir: str | None = None,
    metrics: MetricsLogger | None = None,
    vtk_dir: str | None = None,
    controlled: bool = True,
) -> OptConResult:
    """Run the full backward-forward optimal-control pipeline.

    v0_batch: (S, n) initial inner states; default = one scenario at
    the steady state (+nothing). Gains/feedforward are computed once
    and shared across the batch (same linearization), then the forward
    sweep is vmapped over scenarios.
    controlled=False skips the backward sweeps and rolls out the plain
    plant (u = 0) — the comparison baseline for every controlled run.
    """
    import jax
    import jax.numpy as jnp

    from . import utils
    from .control import (
        build_costate_cache,
        build_costate_cache_dae,
        feedforward_sweep,
    )
    from .riccati import dre_backward_sweep

    utils.setup(cfg.solver.matmul_precision)
    met = metrics or MetricsLogger()
    key = cfg.hash()
    write_meta(key, {"config": cfg.to_json()}, cache_dir)
    dtype = jnp.dtype(cfg.solver.dtype)
    dt = cfg.time.dt
    nts = cfg.time.nts
    times = cfg.time.t0 + dt * np.arange(nts + 1)

    with met.timed("setup", problem=cfg.problem.name):
        np_ops, sys64, cond = _setup_problem(cfg)
    constrained = cond is not None
    sys = sys64.astype(dtype)
    n, m = sys.b.shape
    p_out = sys.p_out
    met.log(
        "operators", n=n, n_p=sys.n_p if constrained else 0, m=m, p=p_out
    )

    # --- Backward DRE sweep: per-timestep gains (checkpointed). ---
    # DRE cache tier: 'auto' pairs the matfree step solver with the
    # matfree DRE cache (config-3+ sizes, no O((n+np)^2) object) and
    # everything else with the dense 'inverse' GEMM cache.
    dre_solver = cfg.solver.dre_solver
    if dre_solver == "auto":
        dre_solver = (
            "matfree" if cfg.solver.step_solver == "matfree"
            else "inverse"
        )

    def compute_gains():
        if constrained:
            from .riccati import (
                build_dre_cache_dae,
                build_dre_cache_dae_matfree,
                dre_shift_schedule_dae,
            )

            sig, sigma_seq, idx_seq = dre_shift_schedule_dae(
                np_ops["A"], np_ops["M"], np_ops["J"], dt,
                num_shifts=cfg.solver.num_shifts, n_adi=cfg.solver.n_adi,
            )
            if dre_solver == "matfree":
                cache = build_dre_cache_dae_matfree(
                    sys, dt, sig, dtype=dtype,
                    tol=cfg.solver.fgmres_tol,
                    max_cycles=cfg.solver.fgmres_cycles,
                )
            elif dre_solver == "inverse_ns":
                # Dense one-GEMM-per-solve tier with the inverse stack
                # built ON DEVICE by Newton-Schulz ladders (no host
                # splu, no bulk transfer).
                from .riccati import build_dre_cache_dae_ns

                cache, _ns_info = build_dre_cache_dae_ns(
                    sys, dt, sig, dtype=dtype,
                )
            else:
                # 'inverse' stacks are disk-cached under the config
                # hash (riccati.load_or_build_inverse_stack): a warm
                # driver restart skips the splu explicit-inverse
                # builds entirely (the reference's load_or_comp
                # restart contract, SURVEY.md SS3.5).
                cache = build_dre_cache_dae(
                    sys, dt, sig, dtype=dtype, solver=dre_solver,
                    cache_key=(
                        f"optcont_{cfg.hash()}"
                        if dre_solver == "inverse" else None
                    ),
                )
        else:
            from .riccati import build_dre_cache, dre_shift_schedule

            sig, sigma_seq, idx_seq = dre_shift_schedule(
                np_ops["A"], np_ops["M"], dt,
                num_shifts=cfg.solver.num_shifts, n_adi=cfg.solver.n_adi,
            )
            cache = build_dre_cache(
                sys, dt, sig, dtype=dtype,
                solver=dre_solver if dre_solver in ("lu", "inverse")
                else "lu",
            )
        zs, ks = dre_backward_sweep(
            sys, cache, cfg.cost.alpha, dt, nts,
            jnp.asarray(sigma_seq, dtype), jnp.asarray(idx_seq),
            n_newton=cfg.solver.n_newton, r_max=cfg.solver.r_max,
        )
        return {"ks": np.asarray(ks), "z0": np.asarray(zs[0])}

    if constrained:
        vbar_i = cond.restrict(np_ops["vbar_full"])
    else:
        vbar_i = np.zeros(n)
    y_bar = np.asarray(np_ops["C"] @ vbar_i)
    ystar = get_ystarvec(cfg.cost, times, p_out, y_ref=y_bar)

    if controlled:
        with met.timed("dre_backward_sweep", nts=nts):
            gains = load_or_comp(key, "gains", compute_gains, cache_dir)
        ks = jnp.asarray(gains["ks"], dtype)

        # --- Feedforward sweep (perturbation coordinates). ---
        ystar_delta = jnp.asarray(ystar - y_bar[None, :], dtype)
        with met.timed("feedforward_sweep"):
            costate_cache = (
                build_costate_cache_dae(sys, dt) if constrained
                else build_costate_cache(sys, dt)
            )
            ws = feedforward_sweep(sys, costate_cache, ks, ystar_delta, dt)
    else:
        ks = jnp.zeros((nts + 1, m, n), dtype)
        ws = jnp.zeros((nts + 1, n), dtype)

    # --- Forward closed-loop sweep (nonlinear NSE or linear LTI). ---
    if constrained:
        from .fem.device_conv import ConvKernel
        from .mpc import (
            batched_nse_closed_loop,
            build_nse_fused,
            build_nse_stepper,
            build_nse_stepper_matfree,
        )

        step_solver = cfg.solver.step_solver
        conv = ConvKernel.build(np_ops["full"], cond, dtype=dtype)
        if step_solver == "fused":
            stepper = build_nse_fused(
                np_ops, cond, dt, dtype=dtype,
                scheme=cfg.solver.imex_scheme,
            )
        elif step_solver == "matfree":
            stepper = build_nse_stepper_matfree(
                np_ops, cond, dt, dtype=dtype,
                scheme=cfg.solver.imex_scheme,
                tol=cfg.solver.fgmres_tol,
                max_cycles=cfg.solver.fgmres_cycles,
            )
        else:
            stepper = build_nse_stepper(
                np_ops, cond, dt, dtype=dtype,
                scheme=cfg.solver.imex_scheme, solver=step_solver,
            )
        if v0_batch is None:
            v0_batch = np.asarray(vbar_i)[None, :]
        v0_dev = jnp.asarray(v0_batch, dtype)
        roll_prec = (
            cfg.solver.rollout_matmul_precision
            or cfg.solver.matmul_precision
        )
        with met.timed("closed_loop_rollout", scenarios=len(v0_batch)):
            with jax.default_matmul_precision(roll_prec):
                vs, us, ys = batched_nse_closed_loop(
                    sys, conv, stepper, ks, ws, v0_dev,
                    cfg.cost.alpha, dt,
                    feedback=cfg.solver.feedback,
                )
            vs, us, ys = jax.block_until_ready((vs, us, ys))
    else:
        from .fem.heat1d import initial_state
        from .mpc import batched_closed_loop, build_step_cache

        stepper = build_step_cache(sys, dt)
        if v0_batch is None:
            v0_batch = initial_state(n)[None, :]
        v0_dev = jnp.asarray(v0_batch, dtype)
        with met.timed("closed_loop_rollout", scenarios=len(v0_batch)):
            vs, us, ys = batched_closed_loop(
                sys, stepper, ks, ws, v0_dev, cfg.cost.alpha, dt,
                feedback=cfg.solver.feedback,
            )
            vs, us, ys = jax.block_until_ready((vs, us, ys))

    ys_np = np.asarray(ys)
    us_np = np.asarray(us)
    track_err = ys_np - ystar[None, :, :]
    cost = float(
        np.mean(
            np.sum(track_err**2, axis=(1, 2)) * dt
            + cfg.cost.alpha * np.sum(us_np**2, axis=(1, 2)) * dt
        )
    )
    met.log("result", cost=cost, max_abs_y=float(np.abs(ys_np).max()))

    if vtk_dir is not None and constrained:
        from .utils.vtk import write_vtk_series

        vs0_full = np.stack(
            [cond.expand(np.asarray(v)) for v in np.asarray(vs[0])]
        )
        write_vtk_series(
            vtk_dir, np_ops["space"], vs0_full, times,
            stride=max(1, nts // 20),
        )

    return OptConResult(
        cfg=cfg,
        times=times,
        ys=ys_np,
        us=us_np,
        ystar=ystar,
        cost=cost,
        gains=ks,
        extras={
            "metrics": met.records,
            "steady_info": np_ops.get("steady_info"),
            "cache_key": key,
        },
    )
