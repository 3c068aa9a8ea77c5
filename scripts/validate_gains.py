#!/usr/bin/env python
"""Certify the EXACT gains bench.py ships: run the bench's DRE
configuration (cylinder Re=100 ref-1, f32, n_adi=32 over 6 shifts,
n_newton=1 warm-started, r_max=32) on the GPU, then measure the projected generalized-Riccati residual of the
resulting factors in f64 on the host (riccati/validate.py). Also runs
an f64 CPU sweep at the same parameters and reports the f32-vs-f64
gain deviation. Prints its result as one JSON line. Run:

    PYTHONPATH=. python scripts/validate_gains.py
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


# EXACT bench.py parameters.
RE, REFINEMENT, DT, ALPHA = 100.0, 1, 0.005, 1e-2
NTS_GAIN, R_MAX, N_SHIFTS, N_ADI, N_NEWTON = 6, 32, 6, 32, 1
RESIDUAL_BOUND = 1e-3  # certified bound for the shipped f32 gains


def main():
    import jax
    import jax.numpy as jnp

    from optconpy_tpu import utils
    from optconpy_tpu.models.cylinder import cylinder_setup
    from optconpy_tpu.riccati import (
        build_dre_cache_dae,
        dre_backward_sweep,
        dre_shift_schedule_dae,
        dre_step_residual,
    )

    utils.setup()
    log(f"device: {jax.devices()[0].device_kind}")

    np_ops, sys64, cond = cylinder_setup(re=RE, refinement=REFINEMENT)
    sig, sseq, iseq = dre_shift_schedule_dae(
        np_ops["A"], np_ops["M"], np_ops["J"], DT,
        num_shifts=N_SHIFTS, n_adi=N_ADI,
    )

    def sweep(dtype):
        sysd = sys64.astype(dtype)
        cache = build_dre_cache_dae(
            sysd, DT, sig, dtype=dtype,
            solver="inverse" if dtype == jnp.float32 else "lu",
        )
        zs, ks = dre_backward_sweep(
            sysd, cache, ALPHA, DT, NTS_GAIN,
            jnp.asarray(sseq, dtype), jnp.asarray(iseq),
            n_newton=N_NEWTON, r_max=R_MAX,
        )
        return np.asarray(zs), np.asarray(ks)

    t0 = time.time()
    zs32, ks32 = sweep(jnp.float32)
    log(f"f32 sweep (bench config) {time.time() - t0:.1f}s")

    # Per-step projected Riccati residuals of the f32 factors (f64 math).
    residuals = []
    for k in range(NTS_GAIN):
        r = dre_step_residual(
            np_ops, zs32[k], ks32[k], zs32[k + 1], ALPHA, DT
        )
        residuals.append(float(r))
        log(f"step {k}: projected residual {r:.3e}")

    # f64 reference sweep at identical parameters -> gain deviation.
    # x64 is enabled only now: flipping it before the f32 device
    # sweep changes weak-type promotion inside the jitted pipeline.
    # The reference runs on the host CPU.
    t0 = time.time()
    jax.config.update("jax_enable_x64", True)
    with jax.default_device(jax.devices("cpu")[0]):
        _, ks64 = sweep(jnp.float64)
    log(f"f64 sweep (host CPU) {time.time() - t0:.1f}s")
    k0_dev = float(
        np.abs(ks32[0] - ks64[0]).max() / np.abs(ks64[0]).max()
    )
    log(f"f32 vs f64 gain deviation |dK|/|K| = {k0_dev:.3e}")

    worst = max(residuals)
    out = {
        "problem": f"cylinder_re{int(RE)}_ref{REFINEMENT}",
        "bench_params": {
            "dt": DT, "alpha": ALPHA, "nts_gain": NTS_GAIN,
            "r_max": R_MAX, "n_shifts": N_SHIFTS, "n_adi": N_ADI,
            "n_newton": N_NEWTON, "dtype": "float32",
        },
        "projected_residuals": [round(r, 8) for r in residuals],
        "worst_residual": worst,
        "residual_bound": RESIDUAL_BOUND,
        "f32_vs_f64_gain_dev": k0_dev,
        "pass": bool(worst < RESIDUAL_BOUND),
    }
    print(json.dumps(out))
    assert worst < RESIDUAL_BOUND, (
        f"bench-config gains fail the residual bound: {worst:.3e}"
    )


if __name__ == "__main__":
    main()
