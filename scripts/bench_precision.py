#!/usr/bin/env python
"""Measure matmul-precision tiers on the headline fused rollout: the
runtime default is 'highest' (full f32 products, utils/runtime.py),
chosen for the DRE sweep's 1e-4 gain fidelity. The ROLLOUT GEMMs may
not need it: this times the bench-shape closed loop re-traced under
'highest' / 'high' / 'default' and measures output deviation against the
'highest' trajectory AND against a float64 CPU reference rollout of
the same fused recurrence, so the tier choice is evidence-based
(the f64 gap is the floor any tier must stay close to).

Prints its result as one JSON line (tier table + horizon curve). Run:
    PYTHONPATH=. python scripts/bench_precision.py
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np


def log(m):
    print(m, file=sys.stderr, flush=True)


RE = 100.0
REFINEMENT = 1
S_BATCH = 1024
NTS = 64
DT = 0.005
ALPHA = 1e-2
NTS_GAIN = 4
R_MAX = 32


def main():
    import jax
    import jax.numpy as jnp

    from optconpy_tpu import utils
    from optconpy_tpu.fem.device_conv import ConvKernel
    from optconpy_tpu.models.cylinder import cylinder_setup
    from optconpy_tpu.mpc.nse_rollout import (
        batched_nse_closed_loop,
        build_nse_fused,
    )
    from optconpy_tpu.riccati import (
        build_dre_cache_dae,
        dre_backward_sweep,
        dre_shift_schedule_dae,
    )

    utils.setup()  # global 'highest'
    dtype = jnp.float32
    log(f"device: {jax.devices()[0].device_kind}")

    t0 = time.time()
    np_ops, sys64, cond = cylinder_setup(re=RE, refinement=REFINEMENT)
    sys = sys64.astype(dtype)
    conv = ConvKernel.build(np_ops["full"], cond, dtype=dtype)
    n, m = sys.b.shape
    log(f"setup {time.time() - t0:.1f}s: n={n}")

    sig, sigma_seq, idx_seq = dre_shift_schedule_dae(
        np_ops["A"], np_ops["M"], np_ops["J"], DT, num_shifts=6, n_adi=16
    )
    dre_cache = build_dre_cache_dae(sys, DT, sig, dtype=dtype)
    _, ks_gain = dre_backward_sweep(
        sys, dre_cache, ALPHA, DT, NTS_GAIN,
        jnp.asarray(sigma_seq, dtype), jnp.asarray(idx_seq),
        n_newton=1, r_max=R_MAX,
    )
    k0 = ks_gain[0]
    ks = jnp.broadcast_to(k0, (NTS + 1, m, n))
    ws = jnp.zeros((NTS + 1, n), dtype)
    step_cache = build_nse_fused(np_ops, cond, DT, dtype=dtype)
    vbar = step_cache.vbar
    rng = np.random.default_rng(0)
    v0 = jnp.asarray(
        np.asarray(vbar)[None] + 1e-3 * rng.standard_normal((S_BATCH, n)),
        dtype,
    )

    # f64 CPU reference of the same fused recurrence (explicit feedback
    # path, matching batched_nse_closed_loop's default) on a scenario
    # subset — the fidelity floor.
    s_ref = 4
    pmat = np.asarray(step_cache.pmat, np.float64)
    gmat = np.asarray(step_cache.gmat, np.float64)
    inv_vv = np.asarray(step_cache.inv_vv, np.float64)
    c0 = np.asarray(step_cache.c0, np.float64)
    k0_np = np.asarray(k0, np.float64)
    vbar_np = np.asarray(vbar, np.float64)
    cnp = np.asarray(sys64.c)

    space = np_ops["space"]
    from optconpy_tpu.fem.taylor_hood import convection_tensor

    t0t = convection_tensor(np_ops["full"])
    tri = space.tri_dofs
    ns = space.n_scalar
    free = cond.free
    dirv = np.zeros(2 * ns)
    dirv[cond.dirichlet] = cond.g

    def conv_np(v_inner):
        vf = dirv.copy()
        vf[free] = v_inner
        v2 = vf.reshape(2, ns)
        v_loc = v2[:, tri].transpose(1, 2, 0)
        out_loc = np.einsum("eijkb,ejb,eka->eia", t0t, v_loc, v_loc)
        out = np.zeros((2, ns))
        np.add.at(out[0], tri.reshape(-1), out_loc[:, :, 0].reshape(-1))
        np.add.at(out[1], tri.reshape(-1), out_loc[:, :, 1].reshape(-1))
        return out.reshape(-1)[free]

    v_ref = np.asarray(v0[:s_ref], np.float64)
    ys_ref = [v_ref @ cnp.T]
    t0 = time.time()
    for _ in range(NTS):
        u = -(v_ref - vbar_np) @ k0_np.T
        v_ref = (
            v_ref @ pmat.T
            + u @ gmat.T
            - np.stack([conv_np(v) for v in v_ref]) @ inv_vv.T
            + c0[None]
        )
        ys_ref.append(v_ref @ cnp.T)
    ys_ref = np.stack(ys_ref, axis=1)
    log(f"f64 reference rollout ({s_ref} scenarios) {time.time() - t0:.1f}s")
    y_scale = np.abs(ys_ref).max()

    results = {}
    ys_highest = None
    for prec in ("highest", "high", "default"):
        with jax.default_matmul_precision(prec):
            def run():
                vs, us, ys = batched_nse_closed_loop(
                    sys, conv, step_cache, ks, ws, v0, ALPHA, DT
                )
                return np.asarray(ys)

            t0 = time.time()
            ys = run()  # compile + run
            t_compile = time.time() - t0
            times = []
            for _ in range(3):
                t0 = time.time()
                run()
                times.append(time.time() - t0)
        t_roll = min(times)
        solves_per_s = S_BATCH * NTS / t_roll
        if ys_highest is None:
            ys_highest = ys
        dev_hi = float(
            np.abs(ys - ys_highest).max() / y_scale
        )
        dev_f64 = float(
            np.abs(ys[:s_ref] - ys_ref).max() / y_scale
        )
        finite = bool(np.isfinite(ys).all())
        results[prec] = {
            "solves_per_s": round(solves_per_s, 1),
            "rollout_s": round(t_roll, 4),
            "rel_dev_vs_highest": dev_hi,
            "rel_dev_vs_f64": dev_f64,
            "finite": finite,
        }
        log(
            f"{prec:8s}: {solves_per_s:9.0f} solves/s "
            f"(compile+1st {t_compile:.1f}s)  dev_vs_highest {dev_hi:.2e}  "
            f"dev_vs_f64 {dev_f64:.2e}"
        )

    # --- Horizon sensitivity of the production 'high' tier (VERDICT
    # r4 item 6): config 5 runs 200 steps and the round-4 evidence
    # stopped at 64. Measure dev-vs-f64 of the SAME recurrence at
    # horizons {64, 200, 500} on a scenario subsample. ---
    s_h = 2
    v0_h = v0[:s_h]
    horizon_curve = {}
    for nts_h in (64, 200, 500):
        ks_h = jnp.broadcast_to(k0, (nts_h + 1, m, n))
        ws_h = jnp.zeros((nts_h + 1, n), dtype)
        # f64 reference once per horizon, compared against BOTH tiers:
        # 'high' is the bench-horizon (64-step) production tier;
        # 'highest' is what long-horizon runs (config 5's 200 steps)
        # must use if 'high' drifts past the 1e-4 bound.
        v_r = np.asarray(v0_h, np.float64)
        ys_r = [v_r @ cnp.T]
        t0 = time.time()
        for _ in range(nts_h):
            u_r = -(v_r - vbar_np) @ k0_np.T
            v_r = (
                v_r @ pmat.T
                + u_r @ gmat.T
                - np.stack([conv_np(v) for v in v_r]) @ inv_vv.T
                + c0[None]
            )
            ys_r.append(v_r @ cnp.T)
        ys_r = np.stack(ys_r, axis=1)
        t_ref = time.time() - t0
        entry = {}
        for prec in ("high", "highest"):
            with jax.default_matmul_precision(prec):
                _, _, ys_h = batched_nse_closed_loop(
                    sys, conv, step_cache, ks_h, ws_h, v0_h, ALPHA, DT
                )
            ys_h = np.asarray(ys_h)
            dev = float(np.abs(ys_h - ys_r).max() / np.abs(ys_r).max())
            entry[prec] = {
                "rel_dev_vs_f64": dev,
                "finite": bool(np.isfinite(ys_h).all()),
            }
            log(
                f"horizon {nts_h:4d} ({prec:7s}): dev_vs_f64 {dev:.2e}"
                f" (f64 ref {t_ref:.1f}s)"
            )
        horizon_curve[str(nts_h)] = entry

    out = {
        "experiment": "rollout_matmul_precision",
        "problem": f"cylinder_re{int(RE)}_ref{REFINEMENT}",
        "n_state": int(n),
        "scenarios": S_BATCH,
        "horizon_steps": NTS,
        "f64_ref_scenarios": s_ref,
        "tiers": results,
        "high_tier_horizon_curve": horizon_curve,
        "device": str(jax.devices()[0].device_kind),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
