"""Receding-horizon MPC — config 4 (BASELINE.md).

The reference's implied loop (SURVEY.md SS1 item 4): at each macro step,
re-linearize the NSE about the current nominal state, update the
Riccati gains over the prediction horizon (warm-started from the
previous macro step), roll the scenario batch forward under the new
feedback, shift the horizon. The inner machinery (DRE Newton-ADI,
batched rollouts) stays jitted and compiles ONCE across macro steps;
the macro loop is a short Python loop because each iteration rebuilds
solver caches about the new linearization point — the honest cost
structure of nonlinear MPC, and it DOES cross to the host each macro
step (re-linearization + preconditioner/factor setup are host work by
design; see solver options below).

Two rebuild paths, chosen by RHConfig.solver:
  * 'lu' — device re-linearization (ConvKernel.linearized_dense) +
    dense saddle LUs per shift. O((n+np)^2) memory x n_shifts; fine at
    toy scale, dominated by host getrf beyond ~5k dofs.
  * 'matfree' — host sparse re-linearization (fem.taylor_hood
    convection_matrices) + SaddleMatfreeCache rebuilds (block-Jacobi
    inverses + SpMM packs, solvers/matfree.py). No O((n+np)^2) object
    anywhere; setup is seconds at config-4 scale. This is the path the
    config-4 macro-step benchmark times (scripts/bench_receding.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.device_conv import ConvKernel
from ..solvers.saddle import SaddleLU, SaddleShiftedLUCache
from ..riccati.dre import dre_backward_sweep
from .nse_rollout import NSEStepCache, batched_nse_closed_loop


@dataclass(frozen=True)
class RHConfig:
    """Receding-horizon shape: predict `horizon` steps, apply `apply`."""

    horizon: int = 16  # DRE prediction steps per macro step
    apply: int = 8  # plant steps applied before re-linearizing
    dt: float = 0.01
    alpha: float = 1e-4
    n_newton: int = 1
    r_max: int = 32
    relinearize: bool = True
    # 'lu' (dense caches), 'matfree' (FGMRES everywhere), or
    # 'dense_ns' (r5): matfree rollout stepper + the dense
    # one-GEMM-per-solve DRE cache whose inverse stack lives on device
    # and NS-REFRESHES across re-linearizations (2 Newton-Schulz
    # passes per shift per macro from the previous inverses) — the
    # macro-rate path (solvers/ns_inverse.NSShiftStack).
    solver: str = "lu"
    fgmres_tol: float = 1e-6
    fgmres_cycles: int = 8
    # ADI iterations for macro steps AFTER the first: the warm start
    # from k_prev leaves the Newton step nearly converged (measured
    # 2.9e-9 one-Newton warm-start residual, tests/test_receding_mpc),
    # so later macros can run a truncated shift schedule. None = full.
    warm_n_adi: int | None = None
    # Refresh (not rebuild) the matfree caches on macro steps after
    # the first: operator values update, preconditioners persist.
    refresh_caches: bool = True
    # Preconditioner-staleness guards (ADVICE r4 medium #2): FGMRES
    # enforces tolerance against the EXACT refreshed operator, but a
    # stale block-Jacobi preconditioner can push solves to the cycle
    # cap where fgmres returns silently at whatever residual it
    # reached. The macro loop therefore PROBES the achieved relres on
    # the hardest shift each macro; when it exceeds
    # relres_refresh_factor * fgmres_tol, the next refresh re-inverts
    # the preconditioner blocks about the new operator (f32).
    # precond_refresh_every additionally forces that re-inversion
    # every K macros (0 = adaptive-only).
    precond_refresh_every: int = 0
    relres_refresh_factor: float = 10.0


def _rebuild_caches(
    m_d, a_stokes_d, j_d, conv: ConvKernel, cond_free, vnom_free,
    dir_values, cfg: RHConfig, sig, dtype,
):
    """Device-side re-linearization + factorization for one macro step.

    Returns (stepper_lu, l1_inner, dre_cache) built about vnom:
      stepper: [[M/dt - A_stokes + L1(vnom), J^T], [J, 0]]
      gains:   Atil = (A_stokes - L1 - L2)(vnom) - M/(2 dt)
    """
    vnom_full = dir_values.at[cond_free].set(vnom_free)
    l1l2 = conv.linearized_dense(vnom_full, include_l2=True)
    l1 = conv.linearized_dense(vnom_full, include_l2=False)
    l1_i = l1[cond_free][:, cond_free]
    l1l2_i = l1l2[cond_free][:, cond_free]

    stepper_lu = SaddleLU.build(
        m_d / cfg.dt - a_stokes_d + l1_i, j_d
    )
    a_lin = a_stokes_d - l1l2_i
    at_til = a_lin.T - m_d / (2.0 * cfg.dt)
    dre_cache = SaddleShiftedLUCache.build(
        at_til, m_d, j_d, jnp.asarray(sig, dtype)
    )
    return stepper_lu, l1_i, dre_cache


def _rebuild_caches_matfree(
    np_ops: dict, cond, vnom_free, cfg: RHConfig, sig, dtype,
    prev: tuple | None = None,
    refresh_precond: bool = False,
    executor=None,
):
    """Host-side sparse re-linearization + matrix-free cache rebuild
    for one macro step (no O((n+np)^2) object is ever formed).

    prev: optional (stepper, dre_cache) from the PREVIOUS macro step.
    When given, only the operator values are refreshed in the cached
    orderings (SaddleMatfreeCache.refresh_operator) and the
    block-Jacobi/pressure-Schur preconditioners are KEPT — the full
    rebuild was 90% preconditioner inversion (cProfile r4: 15.5 s
    np.linalg.inv + 4.9 s np.stack of 20.4 s/macro), while the actual
    re-linearization (convection_matrices) costs 0.15 s. FGMRES
    tolerance is enforced against the refreshed EXACT operator, so
    this changes iteration counts only, never accuracy.

    Returns (NSEMatfreeStepCache, dre SaddleMatfreeCache)."""
    import scipy.sparse as sp

    from ..fem.taylor_hood import convection_matrices
    from ..solvers.matfree import SaddleMatfreeCache
    from .nse_rollout import build_nse_stepper_matfree

    full = np_ops["full"]
    ns2 = full["M"].shape[0]
    vnom_full = np.zeros(ns2)
    vnom_full[cond.dirichlet] = cond.g
    vnom_full[cond.free] = np.asarray(vnom_free, dtype=np.float64)

    l1, l2 = convection_matrices(full, vnom_full)
    m_sp = sp.csr_matrix(np_ops["M"])
    a_lin = sp.csr_matrix(cond.mat_inner(full["A"] - l1 - l2))
    c = 1.0 / (2.0 * cfg.dt)
    at_dre = (a_lin.T - c * m_sp).tocsr()

    if prev is not None:
        import dataclasses

        from ..ops.sparse import ell_from_scipy

        stepper_prev, dre_prev = prev
        a_stokes_i = sp.csr_matrix(cond.mat_inner(full["A"]))
        l1_i = sp.csr_matrix(cond.mat_inner(l1))
        lin = (a_stokes_i - l1_i).tocsr()
        # refresh_precond: ALSO re-invert the block-Jacobi blocks about
        # the refreshed operators (f32; ~1.5 s vs ~20 s full rebuild) —
        # the staleness escape hatch the macro loop triggers from the
        # probed FGMRES relres (ADVICE r4 medium #2).
        m_pre = m_sp if refresh_precond else None

        def build_stepper():
            return dataclasses.replace(
                stepper_prev,
                saddle=stepper_prev.saddle.refresh_operator(
                    (-lin).tocsr(), m_sp=m_pre
                ),
                l1_pack=ell_from_scipy(
                    l1_i, pad_to=8, dtype=np.dtype(dtype)
                ),
                vbar=jnp.asarray(cond.restrict(vnom_full), dtype),
            )

        from ..solvers.ns_inverse import NSShiftStack

        if isinstance(dre_prev, NSShiftStack):
            dre_new = dre_prev.refresh(at_dre)
        else:
            dre_new = dre_prev.refresh_operator(at_dre, m_sp=m_pre)
        if executor is not None:
            # Pipelined refresh: the STEPPER refresh (host repack +
            # transfer) rides a worker thread CONCURRENT with the DRE
            # sweep the caller runs next — the stepper is only consumed
            # by the rollout after the sweep; kept until an H100
            # measurement decides, ROADMAP design item 1.
            return executor.submit(build_stepper), dre_new
        return build_stepper(), dre_new

    np_macro = dict(np_ops, vbar_full=vnom_full)
    stepper = build_nse_stepper_matfree(
        np_macro, cond, cfg.dt, dtype=dtype,
        tol=cfg.fgmres_tol, max_cycles=cfg.fgmres_cycles,
    )
    j_sp = sp.csr_matrix(np_ops["J"])
    if cfg.solver == "dense_ns":
        from ..solvers.ns_inverse import NSShiftStack

        dre_cache = NSShiftStack(
            at_dre, m_sp, j_sp, np.asarray(sig), dtype=dtype,
        )
    else:
        dre_cache = SaddleMatfreeCache.build(
            at_dre, m_sp, j_sp, np.asarray(sig),
            schur_offset=-c, dtype=dtype,
            tol=cfg.fgmres_tol, max_cycles=cfg.fgmres_cycles,
        )
    return stepper, dre_cache


def receding_horizon_mpc(
    sys,
    conv: ConvKernel,
    np_ops: dict,
    cond,
    cfg: RHConfig,
    sig: np.ndarray,
    sigma_seq: np.ndarray,
    idx_seq: np.ndarray,
    v0_batch: jax.Array,
    n_macro: int,
    metrics=None,
    profile: bool = False,
    checkpoint: str | None = None,
):
    """Run n_macro receding-horizon macro steps; returns dict of
    trajectories (vs (S, n_macro*apply+1, n)), inputs, gains history.

    sys: DAESystem at the INITIAL linearization (mass/b/c reused; the
    stiff part is re-linearized each macro step per cfg.solver).
    profile: insert device barriers and record per-macro-step wall
    times {rebuild, dre, rollout} under result['timings'] — the
    config-4 cost breakdown (scripts/bench_receding.py).
    checkpoint: optional npz path — after every completed macro step
    the loop state (macro index, scenario batch, warm-start gain) is
    written atomically, and a later call with the same path resumes
    from the last completed step (SURVEY.md SS5.3: per-macro-step
    resume points; the reference's load_or_comp restart granularity).
    Resumed runs return only the trajectories from the resume point
    (result['resumed_from'] > 0 flags the truncation).
    """
    import os as _os
    import time as _time
    dtype = sys.b.dtype
    n, m = sys.b.shape
    m_d, _, j_d = sys.dense()
    a_stokes_d = jnp.asarray(
        cond.mat_inner(np_ops["full"]["A"]).toarray(), dtype
    )
    fv = jnp.asarray(cond.mat_bc_rhs(np_ops["full"]["A"]), dtype)
    fp = jnp.asarray(cond.jmat_bc_rhs(np_ops["full"]["J"]), dtype)
    cond_free = jnp.asarray(cond.free, jnp.int32)
    vbar0 = jnp.asarray(cond.restrict(np_ops["vbar_full"]), dtype)

    v_batch = jnp.asarray(v0_batch, dtype)
    k_prev = jnp.zeros((m, n), dtype)
    # Config fingerprint written into every checkpoint: resuming with
    # a stale/foreign file (different problem size, horizon, dt, shift
    # schedule, or dtype) must fail loudly, not silently continue with
    # inconsistent state (ADVICE r2).
    import hashlib as _hashlib

    fingerprint = _hashlib.sha256(
        repr((
            n, m, int(v_batch.shape[0]), cfg.dt, cfg.horizon,
            cfg.apply, cfg.alpha, cfg.solver, str(dtype),
            np.asarray(sig, np.float64).tobytes(),
        )).encode()
    ).hexdigest()[:16]
    start_macro = 0
    if checkpoint is not None and _os.path.exists(checkpoint):
        ck = np.load(checkpoint)
        ck_fp = str(ck["fingerprint"]) if "fingerprint" in ck else ""
        if ck_fp != fingerprint:
            raise ValueError(
                f"checkpoint {checkpoint} fingerprint {ck_fp!r} does "
                f"not match this run's config ({fingerprint!r}); "
                "remove the file or fix the config"
            )
        done = int(ck["macro"])
        if 0 < done <= n_macro:
            start_macro = done
            v_batch = jnp.asarray(ck["v_batch"], dtype)
            k_prev = jnp.asarray(ck["k_prev"], dtype)
    vs_hist = [v_batch]
    us_hist = []
    ks_hist = []
    timings = []
    vnom = vbar0
    prev_caches = None
    need_precond_refresh = False
    probe_relres = None
    from concurrent.futures import Future, ThreadPoolExecutor

    pipe_ex = (
        ThreadPoolExecutor(1)
        if cfg.solver in ("matfree", "dense_ns") else None
    )

    for macro in range(start_macro, n_macro):
        t_macro0 = _time.time()
        # vnom is ONLY the linearization point for the operators; the
        # feedback setpoint stays the target vbar0 — regulating to the
        # moving batch mean would pin the batch wherever it happens to
        # be (cheap-control gains enforce the setpoint aggressively).
        if cfg.relinearize:
            vnom = jnp.mean(v_batch, axis=0)
        if cfg.solver in ("matfree", "dense_ns"):
            import dataclasses

            force_every = (
                cfg.precond_refresh_every > 0
                and macro > start_macro
                and (macro - start_macro) % cfg.precond_refresh_every == 0
            )
            stepper, dre_cache = _rebuild_caches_matfree(
                np_ops, cond, np.asarray(vnom), cfg, sig, dtype,
                prev=(
                    prev_caches
                    if cfg.refresh_caches and macro > start_macro
                    else None
                ),
                refresh_precond=need_precond_refresh or force_every,
                executor=pipe_ex,
            )
            # On refresh macros `stepper` is a Future resolving on a
            # worker thread concurrent with the DRE sweep below; it is
            # joined (and `cache` formed) only when the rollout needs
            # it (VERDICT r4 item 4 pipelining).
            cache = None
        else:
            stepper_lu, l1_i, dre_cache = _rebuild_caches(
                m_d, a_stokes_d, j_d, conv, cond_free, vnom,
                conv.dir_values, cfg, sig, dtype,
            )
            cache = NSEStepCache(
                lu=stepper_lu, l1_imp=l1_i, fv=fv, fp=fp, vbar=vbar0
            )
        if profile:
            if cache is not None:
                jax.block_until_ready(jax.tree.leaves(cache))
            t_rebuild = _time.time() - t_macro0
            t_dre0 = _time.time()
        # Warm macros run a truncated ADI schedule: k_prev seeds the
        # Newton so close to the solution that the full shift cycle is
        # redundant (cfg.warm_n_adi; one extra compile for the shorter
        # loop shape, shared by all later macros).
        n_adi_k = len(sigma_seq)
        if cfg.warm_n_adi is not None and macro > start_macro:
            n_adi_k = min(cfg.warm_n_adi, n_adi_k)
        from ..solvers.ns_inverse import NSShiftStack

        dre_for_sweep = (
            dre_cache.cache()
            if isinstance(dre_cache, NSShiftStack) else dre_cache
        )
        zs, ks = dre_backward_sweep(
            sys, dre_for_sweep, cfg.alpha, cfg.dt, cfg.horizon,
            jnp.asarray(sigma_seq[:n_adi_k], dtype),
            jnp.asarray(idx_seq[:n_adi_k]),
            n_newton=cfg.n_newton, r_max=cfg.r_max, k_init=k_prev,
        )
        k_now = ks[0]
        k_prev = k_now
        ks_hist.append(k_now)
        if profile:
            jax.block_until_ready(k_now)
            t_dre = _time.time() - t_dre0
        t_probe = 0.0
        if cfg.solver == "dense_ns":
            probe_relres = None  # no FGMRES in the dense DRE tier
        elif cfg.solver == "matfree":
            # Staleness probe (ADVICE r4 medium #2): one solve on the
            # hardest (smallest-|shift|) pencil, relres surfaced. If
            # the kept preconditioner degraded enough that FGMRES hit
            # the cycle cap above tol, re-invert it next macro.
            t_probe0 = _time.time()
            hard_i = int(np.argmin(np.abs(np.asarray(sig))))
            _, rel = dre_cache.solve_relres(
                hard_i, sys.mass.matvec(vnom)
            )
            probe_relres = float(rel)
            t_probe = _time.time() - t_probe0
            need_precond_refresh = (
                probe_relres > cfg.relres_refresh_factor * cfg.fgmres_tol
            )
        if cfg.solver in ("matfree", "dense_ns"):
            import dataclasses

            t_join0 = _time.time()
            if isinstance(stepper, Future):
                stepper = stepper.result()  # pipelined refresh join
            t_join = _time.time() - t_join0
            prev_caches = (stepper, dre_cache)
            # Linearize about vnom, but regulate to the target vbar0.
            cache = dataclasses.replace(stepper, vbar=vbar0)
        else:
            t_join = 0.0
        if profile:
            t_roll0 = _time.time()
        ks_roll = jnp.broadcast_to(k_now, (cfg.apply + 1, m, n))
        ws = jnp.zeros((cfg.apply + 1, n), dtype)
        vs, us, _ = batched_nse_closed_loop(
            sys, conv, cache, ks_roll, ws, v_batch, cfg.alpha, cfg.dt,
            feedback="implicit",
        )
        v_batch = vs[:, -1]
        vs_hist.append(vs[:, 1:])
        us_hist.append(us)
        if profile:
            jax.block_until_ready(v_batch)
            entry = {
                "rebuild_s": t_rebuild,
                "dre_s": t_dre,
                "probe_s": t_probe,
                "stepper_join_s": t_join,
                "rollout_s": _time.time() - t_roll0,
                "total_s": _time.time() - t_macro0,
            }
            if probe_relres is not None:
                entry["fgmres_probe_relres"] = probe_relres
            timings.append(entry)
        if checkpoint is not None:
            tmp = checkpoint + ".tmp"
            np.savez(
                tmp,
                macro=macro + 1,
                v_batch=np.asarray(v_batch),
                k_prev=np.asarray(k_prev),
                fingerprint=fingerprint,
            )
            # np.savez appends .npz to a bare prefix.
            _os.replace(
                tmp if tmp.endswith(".npz") else tmp + ".npz",
                checkpoint,
            )
        if metrics is not None:
            extra_m = (
                {"fgmres_probe_relres": probe_relres}
                if probe_relres is not None else {}
            )
            metrics.log(
                "mpc_macro_step",
                step=macro,
                max_gain=float(jnp.abs(k_now).max()),
                mean_state_norm=float(
                    jnp.linalg.norm(v_batch - vnom[None], axis=1).mean()
                ),
                **extra_m,
            )

    if pipe_ex is not None:
        pipe_ex.shutdown(wait=True)
    vs_all = jnp.concatenate(
        [vs_hist[0][:, None, :]] + vs_hist[1:], axis=1
    )
    s_batch = v_batch.shape[0]
    us_all = (
        jnp.concatenate(us_hist, axis=1) if us_hist
        else jnp.zeros((s_batch, 0, m), dtype)
    )
    out = {
        "vs": vs_all,
        "us": us_all,
        "ks": (
            jnp.stack(ks_hist) if ks_hist
            else jnp.zeros((0, m, n), dtype)
        ),
        "v_final": v_batch,
        "resumed_from": start_macro,
    }
    if profile:
        out["timings"] = timings
    return out
