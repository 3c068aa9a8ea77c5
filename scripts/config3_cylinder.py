#!/usr/bin/env python
"""Config 3 (BASELINE.md): linearized cylinder-wake Re=60, ~15k dofs,
low-rank ADI/DRE Riccati feedback, one GPU — on the MATRIX-FREE
path (solvers/matfree.py): block-Jacobi + pressure-Schur FGMRES over
Pallas SpMM; no O((n+np)^2) factor is ever formed (the round-1 dense
reference-LU cache needed 2.4 GB getrf's that ran past the round
budget on the 2-vCPU host — see VERDICT r1 item 3).

Validation at this size is residual/behavioral (no dense golden is
feasible at 15k): constraint feasibility of the Riccati factors, finite
gains, and the controlled rollout suppressing the wake perturbation
energy relative to the uncontrolled one. Prints its result as one JSON line. Run:

    PYTHONPATH=. python scripts/config3_cylinder.py
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


RE = 60.0
REFINEMENT = 2
DT = 0.01
NTS_GAIN = 16  # DRE steps (gain converges to quasi-steady in O(10))
NTS_ROLL = 100
ALPHA = 1e-4
R_MAX = 40
N_SHIFTS = 12
N_ADI = 16
S_BATCH = 16
# Inner Krylov tolerance DERIVED from the outer accuracy budget
# (SURVEY SS7 hard part 1; VERDICT r4 item 1a): the production ADI
# schedule's own truncation floor at (N_SHIFTS, N_ADI, R_MAX) is the
# measured projected DRE step residual ~4.2e-4 (residuals were
# IDENTICAL to 3 digits at inner tol 1e-6 and 1e-4, i.e. the inner
# solves stop mattering ~25x below the outer floor). Solving 100x tighter than the truncation floor buys
# nothing but FGMRES iterations; one-quarter of the floor keeps a 4x
# safety margin while roughly halving Krylov work on the hard shifts.
ADI_TRUNCATION_FLOOR = 4.2e-4  # measured, r4 artifact
FGMRES_TOL = ADI_TRUNCATION_FLOOR / 4.0  # ~1e-4, derived not magic


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
        spectral_interval,
        spectral_interval_dae,
    )
    from optconpy_tpu.utils.cache import load_or_comp

    utils.setup()
    dtype = jnp.float32
    log(f"device: {jax.devices()[0].device_kind}")

    t0 = time.time()
    np_ops, sys64, cond = cylinder_setup(re=RE, refinement=REFINEMENT)
    sysd = sys64.astype(dtype)
    n, m = sysd.b.shape
    log(f"setup {time.time() - t0:.1f}s: n={n} np={sysd.n_p}")

    # Shift interval: mesh-converged bottom from the coarse projected
    # pencil + top from sparse ARPACK on the fine unprojected pencil.
    def interval_art():
        np1, _, _ = cylinder_setup(re=RE, refinement=1)
        lo_c, _ = spectral_interval_dae(np1["A"], np1["M"], np1["J"])
        _, hi_f = spectral_interval(np_ops["A"], np_ops["M"])
        return {"lo": np.asarray(lo_c), "hi": np.asarray(hi_f)}

    t0 = time.time()
    iv = load_or_comp(f"cyl_re{int(RE)}_ref{REFINEMENT}", "interval",
                      interval_art, cache_dir="data")
    a_min, a_max = float(iv["lo"]), float(iv["hi"])
    log(f"interval [{a_min:.2f}, {a_max:.1f}] ({time.time() - t0:.1f}s)")

    sig, sigma_seq, idx_seq = dre_shift_schedule_dae(
        None, None, None, DT, num_shifts=N_SHIFTS, n_adi=N_ADI,
        interval=(a_min, a_max),
    )

    t0 = time.time()
    cache = build_dre_cache_dae_matfree(
        sysd, DT, sig, dtype=dtype, tol=FGMRES_TOL, max_cycles=8
    )
    jax.block_until_ready(cache.bj_inv)
    log(
        f"matfree cache (block-Jacobi {cache.block}, "
        f"pack {type(cache.at_pack).__name__}) {time.time() - t0:.1f}s"
    )

    def run_sweep(cache_a, alpha, sigma_seq_a, idx_seq_a):
        zs, ks = dre_backward_sweep(
            sysd, cache_a, alpha, DT, NTS_GAIN,
            jnp.asarray(sigma_seq_a, dtype), jnp.asarray(idx_seq_a),
            n_newton=1, r_max=R_MAX,
        )
        np.asarray(ks)  # host materialization = hard barrier
        return zs, ks

    t0 = time.time()
    zs_mf, ks_mf = run_sweep(cache, ALPHA, sigma_seq, idx_seq)
    t_dre = time.time() - t0
    adi_iters = NTS_GAIN * N_ADI
    adi_per_s = adi_iters / t_dre
    log(f"matfree DRE sweep {t_dre:.1f}s ({adi_per_s:.2f} ADI iters/s incl compile)")
    # Warm sweep (VERDICT r2 item 4): the per-iteration rate once the
    # Newton-ADI body is compiled — what an MPC macro loop actually pays.
    warm_samples = []
    for rep in range(3):
        t0 = time.time()
        run_sweep(cache, ALPHA * (1 + 1e-4 * (rep + 1)), sigma_seq,
                  idx_seq)
        warm_samples.append(time.time() - t0)
    t_dre_warm = float(np.median(warm_samples))
    adi_per_s_warm = adi_iters / t_dre_warm
    log(f"warm matfree DRE sweep {t_dre_warm:.1f}s "
        f"({adi_per_s_warm:.2f} ADI iters/s, median of 3)")
    del cache  # free the matfree preconditioners before the dense tier

    # --- DENSE Newton-Schulz tier (VERDICT r4 item 1: WIN config 3).
    # The one-GEMM-per-solve ADI cache, with the inverse stack built
    # ON DEVICE by Newton-Schulz ladders (riccati.build_dre_cache_dae_ns)
    # — no host factorization, no bulk transfer. 8 shifts x (n, n) f32
    # = ~7.5 GB of device memory at this n. ---
    from optconpy_tpu.riccati import build_dre_cache_dae_ns

    NS_SHIFTS = 8
    sig8, sigma_seq8, idx_seq8 = dre_shift_schedule_dae(
        None, None, None, DT, num_shifts=NS_SHIFTS, n_adi=N_ADI,
        interval=(a_min, a_max),
    )
    t0 = time.time()
    cache_ns, ns_info = build_dre_cache_dae_ns(
        sysd, DT, sig8, dtype=dtype, verbose=log,
    )
    t_ns_build = time.time() - t0
    log(f"NS dense stack build {t_ns_build:.1f}s "
        f"(rungs {ns_info['ladder_rungs']}, worst residual "
        f"{max(ns_info['residuals']):.2e})")
    t0 = time.time()
    zs, ks = run_sweep(cache_ns, ALPHA, sigma_seq8, idx_seq8)
    t_dre_ns = time.time() - t0
    log(f"dense-NS DRE sweep {t_dre_ns:.1f}s incl compile")
    warm_ns_samples = []
    for rep in range(3):
        t0 = time.time()
        run_sweep(cache_ns, ALPHA * (1 + 1e-4 * (rep + 1)),
                  sigma_seq8, idx_seq8)
        warm_ns_samples.append(time.time() - t0)
    t_dre_ns_warm = float(np.median(warm_ns_samples))
    adi_ns_warm_per_s = adi_iters / t_dre_ns_warm
    log(f"warm dense-NS DRE sweep {t_dre_ns_warm:.2f}s "
        f"({adi_ns_warm_per_s:.1f} ADI iters/s, median of 3)")
    # Gain cross-tier parity: dense-NS vs matfree gains.
    k_dev = float(
        np.abs(np.asarray(ks[0]) - np.asarray(ks_mf[0])).max()
        / max(np.abs(np.asarray(ks_mf[0])).max(), 1e-30)
    )
    log(f"gain parity dense-NS vs matfree: {k_dev:.2e}")
    del cache_ns  # free the 7.5 GB stack before the rollout phase

    # Reference-architecture CPU baseline at THIS n (VERDICT r2 item 4):
    # scipy-splu factorizations of the same shifted saddle pencils +
    # the ADI recurrence in numpy f64, factors amortized over the sweep
    # (the reference's solve_proj_lyap_stein structure, SURVEY.md SS3.3).
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    m_sp = np_ops["M"].tocsr()
    a_sp = np_ops["A"].tocsr()
    j_sp = np_ops["J"].tocsr()
    at_til_sp = (a_sp.T - m_sp / (2.0 * DT)).tocsr()
    n_p = j_sp.shape[0]
    q_cols = sysd.p_out + R_MAX + m
    t0 = time.time()
    lus_adi = [
        spla.splu(sp.bmat(
            [[at_til_sp + s * m_sp, j_sp.T], [j_sp, None]], format="csc",
        ))
        for s in sig
    ]
    t_factor_cpu = time.time() - t0
    log(f"cpu ADI factors ({len(sig)} shifted saddles at n={n}) "
        f"{t_factor_cpu:.1f}s")
    rng_adi = np.random.default_rng(1)
    w_np = rng_adi.standard_normal((n, q_cols))
    zeros_p = np.zeros((n_p, q_cols))

    def cpu_shift_solve(idx, rhs):
        return lus_adi[idx].solve(np.concatenate([rhs, zeros_p]))[:n]

    import os as _os

    loadavg_1min = round(_os.getloadavg()[0], 2)
    n_cpu_iters = min(N_ADI, 8)
    iter_samples = []
    for _rep in range(3):  # median-of-3 (VERDICT r4 weak 2)
        t0 = time.time()
        v_it = cpu_shift_solve(0, w_np)
        for it in range(1, n_cpu_iters):
            idx = it % len(sig)
            v_it = v_it - (sig[idx] + sig[idx - 1]) * cpu_shift_solve(
                idx, m_sp @ v_it
            )
        iter_samples.append((time.time() - t0) / n_cpu_iters)
    t_iter_cpu = float(np.median(iter_samples))
    cpu_adi_per_s = adi_iters / (t_factor_cpu + adi_iters * t_iter_cpu)
    log(f"cpu ADI baseline {t_iter_cpu * 1e3:.1f} ms/iter (median of "
        f"{[round(1e3 * t, 1) for t in iter_samples]} ms, loadavg "
        f"{loadavg_1min}) -> {cpu_adi_per_s:.2f} iters/s "
        f"(amortized factors)")

    # Factor feasibility: Riccati iterates must lie in ker J.
    z0 = zs[0]
    jz = np.asarray(sysd.jmat.matmat(z0))
    feas = float(np.abs(jz).max() / max(np.abs(np.asarray(z0)).max(), 1e-30))
    k0 = ks[0]
    log(f"|J Z|/|Z| = {feas:.2e}, |K| = {float(jnp.abs(k0).max()):.3e}")
    assert feas < 1e-5, feas

    # Gain quality at 15k (VERDICT r2 item 4 / weak 4): projected DRE
    # step residual of the swept factors, f64 host measurement
    # (riccati/validate.py), asserted — a starved sweep fails here.
    from optconpy_tpu.riccati.validate import dre_step_residual

    res_bound = 1e-2
    residuals = []
    t0 = time.time()
    for step in (0, NTS_GAIN // 2):
        r = dre_step_residual(
            np_ops, np.asarray(zs[step]), np.asarray(ks[step]),
            np.asarray(zs[step + 1]), ALPHA, DT,
        )
        residuals.append(r)
        log(f"projected DRE residual @ step {step}: {r:.3e}")
    log(f"residual validation {time.time() - t0:.1f}s")
    worst_res = float(max(residuals))
    assert worst_res < res_bound, (worst_res, res_bound)

    # Closed loop vs uncontrolled: perturbation energy at T.
    conv = ConvKernel.build(np_ops["full"], cond, dtype=dtype)
    stepper = build_nse_stepper_matfree(
        np_ops, cond, DT, dtype=dtype, tol=FGMRES_TOL, max_cycles=10
    )
    ks_roll = jnp.broadcast_to(k0, (NTS_ROLL + 1, m, n))
    ws = jnp.zeros((NTS_ROLL + 1, n), dtype)
    rng = np.random.default_rng(0)
    v0 = jnp.asarray(
        np.asarray(stepper.vbar)[None] + 1e-3 * rng.standard_normal((S_BATCH, n)),
        dtype,
    )

    def energy(vs):
        d = vs - stepper.vbar[None, None, :]
        return np.asarray(jnp.sum(d * jax.vmap(jax.vmap(sysd.mass.matvec))(d), axis=2))

    t0 = time.time()
    vs_c, us_c, _ = batched_nse_closed_loop(
        sysd, conv, stepper, ks_roll, ws, v0, ALPHA, DT, feedback="implicit"
    )
    vs_c = np.asarray(vs_c)
    t_roll = time.time() - t0
    vs_u, _, _ = batched_nse_closed_loop(
        sysd, conv, stepper, jnp.zeros_like(ks_roll), ws, v0, ALPHA, DT,
        feedback="implicit",
    )
    vs_u = np.asarray(vs_u)
    e_c, e_u = energy(vs_c), energy(vs_u)
    ratio = float(e_c[:, -1].mean() / e_u[:, -1].mean())
    log(
        f"rollout {t_roll:.1f}s: perturbation energy T-ratio "
        f"controlled/uncontrolled = {ratio:.3e} "
        f"(u: {float(e_u[:, -1].mean()):.3e}, c: {float(e_c[:, -1].mean()):.3e})"
    )
    # Acceptance: feedback must suppress at least half the wake
    # perturbation energy over the window (r02 measured 0.234).
    assert ratio < 0.5, ratio
    assert np.isfinite(vs_c).all()

    out = {
        "config": 3,
        "problem": f"cylinder_re{int(RE)}_ref{REFINEMENT}",
        "n_state": int(n),
        "solver": "dense_ns_inverse (headline) + matfree_fgmres",
        "feasibility_JZ": feas,
        "energy_ratio_T": ratio,
        "energy_ratio_bound": 0.5,
        "worst_dre_residual": worst_res,
        "residual_bound": res_bound,
        # headline tier: device-built dense inverse stack (NS ladder)
        "ns_build_s": round(t_ns_build, 1),
        "ns_shifts": NS_SHIFTS,
        "ns_stack_residuals": [
            float(r) for r in ns_info["residuals"]
        ],
        "adi_iters_per_s_warm_dense_ns": round(adi_ns_warm_per_s, 2),
        "dre_sweep_warm_dense_ns_s": round(t_dre_ns_warm, 2),
        "dense_ns_warm_samples_s": [
            round(t, 3) for t in warm_ns_samples
        ],
        "gain_parity_dense_vs_matfree": k_dev,
        # matfree FGMRES tier (the large-n path, kept for comparison)
        "adi_iters_per_s_incl_compile": round(adi_per_s, 3),
        "adi_iters_per_s_warm_matfree": round(adi_per_s_warm, 3),
        "cpu_adi_iters_per_s": round(cpu_adi_per_s, 3),
        "cpu_sampling": "median_of_3",
        "host_loadavg_1min": loadavg_1min,
        "fgmres_tol": FGMRES_TOL,
        "fgmres_tol_derivation": "ADI_TRUNCATION_FLOOR/4 (see header)",
        "adi_warm_vs_cpu_dense_ns": round(
            adi_ns_warm_per_s / cpu_adi_per_s, 2
        ),
        "adi_warm_vs_cpu_matfree": round(
            adi_per_s_warm / cpu_adi_per_s, 2
        ),
        "dre_sweep_s": round(t_dre, 1),
        "dre_sweep_warm_s": round(t_dre_warm, 1),
        "rollout_s": round(t_roll, 2),
        "finite": bool(np.isfinite(np.asarray(vs_c)).all()),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
