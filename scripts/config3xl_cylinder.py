#!/usr/bin/env python
"""Config-3 XL (VERDICT r2 item 9): refinement-3 cylinder (~60k
velocity dofs) through the matrix-free stack — a size class the
reference's architecture (single-process SuperLU, dense factors) could
not touch interactively. Runs a short matfree DRE sweep + a few
closed-loop rollout steps, records wall times, FGMRES relres per
shift, factor feasibility, finiteness. Prints its result as one JSON line. Run:

    PYTHONPATH=. python scripts/config3xl_cylinder.py
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


RE = 60.0
REFINEMENT = 3
DT = 0.01
NTS_GAIN = 4
NTS_ROLL = 20
ALPHA = 1e-4
# r5 schedule: the r4-era (6 shifts, 12 ADI, r_max 32) schedule FAILED
# the residual certification this script now runs (mid-sweep projected
# DRE residual 1.68e-2 vs the 1e-2 bound at n=31,282) — outer ADI
# truncation, not FGMRES (probe relres ~1e-7). Wider schedule restores
# the budget.
R_MAX = 40
N_SHIFTS = 8
N_ADI = 16
S_BATCH = 8
# Inner tolerance DERIVED from the outer budget (config3 doctrine),
# with a twist this size class exposed (r5, two measured runs): the
# inner tol binds TWO outer quantities — the projected DRE residual
# floor (~3.3e-3 here; tol 1e-6 overshoots it 3000x) AND the factor
# feasibility |J Z|/|Z| (which tracks the inner tol ~1:1 — a 4e-4
# run measured feas 3.9e-4, FAILING the 1e-4 bound the r4 constant
# easily met). The binding constraint is feasibility: tol =
# feas_bound / 2.
FEASIBILITY_BOUND = 1e-4
FGMRES_TOL = FEASIBILITY_BOUND / 2.0  # 5e-5: feasibility-bound


def main():
    import jax
    import jax.numpy as jnp

    from optconpy_tpu import utils
    from optconpy_tpu.fem.device_conv import ConvKernel
    from optconpy_tpu.models.cylinder import cylinder_setup
    from optconpy_tpu.mpc import (
        batched_nse_closed_loop,
        build_nse_stepper_matfree,
    )
    from optconpy_tpu.riccati import (
        build_dre_cache_dae_matfree,
        dre_backward_sweep,
        dre_shift_schedule_dae,
    )

    utils.setup()
    dtype = jnp.float32
    log(f"device: {jax.devices()[0].device_kind}")

    t0 = time.time()
    np_ops, sys64, cond = cylinder_setup(re=RE, refinement=REFINEMENT)
    sysd = sys64.astype(dtype)
    n, m = sysd.b.shape
    t_setup = time.time() - t0
    log(f"setup {t_setup:.1f}s: n={n} np={sysd.n_p}")

    t0 = time.time()
    sig, sigma_seq, idx_seq = dre_shift_schedule_dae(
        np_ops["A"], np_ops["M"], np_ops["J"], DT,
        num_shifts=N_SHIFTS, n_adi=N_ADI,
    )
    log(f"shifts {time.time() - t0:.1f}s: [{sig[0]:.1f}, {sig[-1]:.1f}]")

    t0 = time.time()
    cache = build_dre_cache_dae_matfree(
        sysd, DT, sig, dtype=dtype, tol=FGMRES_TOL, max_cycles=8
    )
    jax.block_until_ready(cache.bj_inv)
    t_cache = time.time() - t0
    log(
        f"matfree cache {t_cache:.1f}s (block {cache.block}, "
        f"pack {type(cache.at_pack).__name__}, np={cache.n_p})"
    )

    # Per-shift FGMRES residual probe: one solve per shift on a random
    # rhs — records actual Krylov convergence at this size.
    rng = np.random.default_rng(1)
    probe = jnp.asarray(rng.standard_normal((n, 4)), dtype)
    relres = []
    t0 = time.time()
    # jit with the CACHE AS AN ARGUMENT: a bound-method closure bakes
    # the ~0.7 GB of preconditioner blocks into the HLO as constants
    # at refinement 3; as a pytree argument they stay device buffers.
    probe_solve = jax.jit(lambda c, i, rv, rp: c._solve_perm(i, rv, rp))
    for i in range(len(sig)):
        rv = probe[cache.perm]
        rp = jnp.zeros((cache.n_p, 4), dtype)
        _, _, rel = probe_solve(cache, jnp.int32(i), rv, rp)
        relres.append(float(np.asarray(rel)))
        log(f"  shift {i} ({sig[i]:.1f}): relres {relres[-1]:.2e}")
    log(f"probe solves {time.time() - t0:.1f}s")

    t0 = time.time()
    zs, ks = dre_backward_sweep(
        sysd, cache, ALPHA, DT, NTS_GAIN,
        jnp.asarray(sigma_seq, dtype), jnp.asarray(idx_seq),
        n_newton=1, r_max=R_MAX,
    )
    np.asarray(ks)
    t_dre = time.time() - t0
    adi_iters = NTS_GAIN * N_ADI
    log(f"DRE sweep {t_dre:.1f}s ({adi_iters / t_dre:.2f} ADI iters/s incl compile)")
    # WARM rate (VERDICT r4 item 5: the r4 artifact only recorded the
    # compile-inclusive number).
    t0 = time.time()
    _, ks_w = dre_backward_sweep(
        sysd, cache, ALPHA * 1.0001, DT, NTS_GAIN,
        jnp.asarray(sigma_seq, dtype), jnp.asarray(idx_seq),
        n_newton=1, r_max=R_MAX,
    )
    jax.block_until_ready(ks_w)
    t_dre_warm = time.time() - t0
    adi_warm_per_s = adi_iters / t_dre_warm
    log(f"warm DRE sweep {t_dre_warm:.1f}s ({adi_warm_per_s:.2f} ADI iters/s)")

    # CPU splu ADI baseline at THIS n (VERDICT r4 item 5: the r4 note
    # ASSERTED "multi-GB, minutes per factorization" — measure it).
    # One shifted saddle factorization + a few triangular solves,
    # amortized over the sweep like the config-3 baseline.
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    m_cpu = np_ops["M"].tocsr()
    a_cpu = np_ops["A"].tocsr()
    j_cpu = np_ops["J"].tocsr()
    at_til_cpu = (a_cpu.T - m_cpu / (2.0 * DT)).tocsr()
    n_p = j_cpu.shape[0]
    q_cols = sysd.p_out + R_MAX + m
    t0 = time.time()
    lu_one = spla.splu(sp.bmat(
        [[at_til_cpu + sig[0] * m_cpu, j_cpu.T], [j_cpu, None]],
        format="csc",
    ))
    t_factor_one = time.time() - t0
    lu_nnz = int(lu_one.L.nnz + lu_one.U.nnz)
    log(
        f"cpu splu ONE shifted saddle at n+np={n + n_p}: "
        f"{t_factor_one:.1f}s, L+U nnz {lu_nnz / 1e6:.1f}M "
        f"(~{lu_nnz * 16 / 2**30:.2f} GiB)"
    )
    rng_c = np.random.default_rng(2)
    w_np = rng_c.standard_normal((n, q_cols))
    zeros_p = np.zeros((n_p, q_cols))
    t0 = time.time()
    n_cpu_solves = 3
    v_it = w_np
    for _ in range(n_cpu_solves):
        v_it = lu_one.solve(np.concatenate([v_it, zeros_p]))[:n]
        v_it /= max(np.abs(v_it).max(), 1e-30)
    t_solve_one = (time.time() - t0) / n_cpu_solves
    # Amortized reference rate: N_SHIFTS factorizations + one solve
    # per ADI iteration over the sweep (each iteration also carries a
    # sparse M matmat, negligible next to the solve).
    cpu_adi_per_s = adi_iters / (
        N_SHIFTS * t_factor_one + adi_iters * t_solve_one
    )
    log(
        f"cpu ADI baseline at ref3: {t_solve_one * 1e3:.0f} ms/solve, "
        f"{cpu_adi_per_s:.3f} iters/s (amortizing {N_SHIFTS} x "
        f"{t_factor_one:.1f}s factors)"
    )
    del lu_one, v_it, w_np, zeros_p

    z0 = zs[0]
    jz = np.asarray(sysd.jmat.matmat(z0))
    feas = float(
        np.abs(jz).max() / max(np.abs(np.asarray(z0)).max(), 1e-30)
    )
    k0 = ks[0]
    log(f"|J Z|/|Z| = {feas:.2e}, |K| = {float(jnp.abs(k0).max()):.3e}")
    assert feas < 1e-4, feas
    assert np.isfinite(np.asarray(k0)).all()

    # Residual certification at 31k (VERDICT r4 item 5 / weak 5: the
    # r4 feasibility number 1.98e-5 was recorded with no bound or
    # cause): projected DRE step residual of the swept factors, f64
    # host (riccati/validate.py), asserted against the same bound the
    # config-3 artifact uses.
    from optconpy_tpu.riccati.validate import dre_step_residual

    res_bound = 1e-2
    t0 = time.time()
    residuals = []
    for step in (0, NTS_GAIN // 2):
        r = dre_step_residual(
            np_ops, np.asarray(zs[step]), np.asarray(ks[step]),
            np.asarray(zs[step + 1]), ALPHA, DT,
        )
        residuals.append(float(r))
        log(f"projected DRE residual @ step {step}: {r:.3e}")
    worst_res = float(max(residuals))
    log(f"residual validation {time.time() - t0:.1f}s")
    assert worst_res < res_bound, (worst_res, res_bound)

    conv = ConvKernel.build(np_ops["full"], cond, dtype=dtype)
    t0 = time.time()
    stepper = build_nse_stepper_matfree(
        np_ops, cond, DT, dtype=dtype, tol=FGMRES_TOL, max_cycles=10
    )
    log(f"matfree stepper {time.time() - t0:.1f}s")
    ks_roll = jnp.broadcast_to(k0, (NTS_ROLL + 1, m, n))
    ws = jnp.zeros((NTS_ROLL + 1, n), dtype)
    v0 = jnp.asarray(
        np.asarray(stepper.vbar)[None]
        + 1e-3 * rng.standard_normal((S_BATCH, n)),
        dtype,
    )
    t0 = time.time()
    vs, us, _ = batched_nse_closed_loop(
        sysd, conv, stepper, ks_roll, ws, v0, ALPHA, DT,
        feedback="implicit",
    )
    vs = np.asarray(vs)
    t_roll = time.time() - t0
    finite = bool(np.isfinite(vs).all())
    log(
        f"rollout {t_roll:.1f}s ({S_BATCH} scenarios x {NTS_ROLL} steps), "
        f"finite={finite}"
    )
    assert finite

    out = {
        "config": "3XL",
        "problem": f"cylinder_re{int(RE)}_ref{REFINEMENT}",
        "n_state": int(n),
        "n_pressure": int(sysd.n_p),
        "solver": "matfree_fgmres_blockjacobi_schur",
        "setup_s": round(t_setup, 1),
        "cache_build_s": round(t_cache, 1),
        "fgmres_relres_per_shift": [round(r, 9) for r in relres],
        "dre_sweep_s": round(t_dre, 1),
        "adi_iters_per_s_incl_compile": round(adi_iters / t_dre, 3),
        "dre_sweep_warm_s": round(t_dre_warm, 1),
        "adi_iters_per_s_warm": round(adi_warm_per_s, 3),
        "cpu_splu_factor_s_per_shift": round(t_factor_one, 1),
        "cpu_splu_lu_nnz": lu_nnz,
        "cpu_splu_solve_s": round(t_solve_one, 3),
        "cpu_adi_iters_per_s": round(cpu_adi_per_s, 4),
        "adi_warm_vs_cpu": round(adi_warm_per_s / cpu_adi_per_s, 2),
        "feasibility_JZ": feas,
        "worst_dre_residual": worst_res,
        "residual_bound": res_bound,
        "rollout_s": round(t_roll, 1),
        "rollout_steps": S_BATCH * NTS_ROLL,
        "finite": finite,
        "note": (
            "no O((n+np)^2) object anywhere; the CPU splu columns "
            "above MEASURE the reference-architecture cost at this "
            "size instead of asserting it (VERDICT r4 item 5)"
        ),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
