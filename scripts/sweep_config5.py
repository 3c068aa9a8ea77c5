#!/usr/bin/env python
"""Config 5 (BASELINE.md) at SPEC SCALE on one chip: 8192-scenario
Re in [60, 150] parameter-sweep MPC — R=8 Reynolds buckets x 1024
scenarios, per-bucket linearization + DRE gain + steady-output target
y*, memory-lean rollout (nse_closed_loop_outputs: no state trajectory
in HBM). Honors the drawn Re distribution with ragged masked
buckets and disk-caches the per-bucket inverse stacks. Writes
one JSON line.

The multi-device psum path of the same kernel is checked on four GPUs
by `python chip_smoke.py --devices 4`. Run:

    PYTHONPATH=. python scripts/sweep_config5.py
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


RE_LO, RE_HI, R_BUCKETS = 60.0, 150.0, 8
S_TOTAL = 8192
REFINEMENT = 1
DT = 0.005
NTS = 200
ALPHA = 1e-2


def main():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from optconpy_tpu import utils
    from optconpy_tpu.fem.device_conv import ConvKernel
    from optconpy_tpu.models.cylinder import cylinder_setup
    from optconpy_tpu.parallel.param_sweep import (
        assign_re_buckets,
        build_sweep_gains_and_caches,
        sharded_sweep_rollout,
    )

    utils.setup()
    dtype = jnp.float32
    dev = jax.devices()[0]
    log(f"device: {dev.device_kind}")
    re_buckets = np.linspace(RE_LO, RE_HI, R_BUCKETS)
    log(f"Re buckets: {re_buckets}")

    # Continuous Re draw -> nearest-bucket assignment (the config-5
    # grouping contract). The drawn distribution is BINDING (VERDICT
    # r3 item 6): buckets get their REAL unequal counts, padded to a
    # static S_max with mask-0 rows, and every statistic is weighted
    # by the true counts.
    rng = np.random.default_rng(0)
    re_draw = rng.uniform(RE_LO, RE_HI, S_TOTAL)
    bucket_of = assign_re_buckets(re_draw, re_buckets)
    counts = np.bincount(bucket_of, minlength=R_BUCKETS)
    log(f"scenario draw per bucket (continuous Re): {counts}")
    # Pad to a multiple of 256 (lane-friendly, mesh-divisible).
    s_max = int(-(-counts.max() // 256) * 256)
    log(f"S_max (padded) = {s_max}; real total = {counts.sum()}")

    # Per-bucket setups: shared geometry, per-Re viscosity/steady state.
    t0 = time.time()
    setups = []
    for re in re_buckets:
        s0 = time.time()
        setups.append(cylinder_setup(re=float(re), refinement=REFINEMENT))
        info = setups[-1][0]["steady_info"]
        log(
            f"  Re={re:.1f}: steady residual {info['residual']:.2e} "
            f"({time.time() - s0:.1f}s)"
        )
    t_setup = time.time() - t0
    sys0, cond0 = setups[0][1], setups[0][2]
    n, m = sys0.b.shape
    log(f"setups {t_setup:.1f}s: n={n} x {R_BUCKETS} buckets")

    # Shared conv kernel (same mesh/BCs across buckets) — built BEFORE
    # the gains: the 'inverse_ns' stepper tier re-linearizes each
    # bucket ON DEVICE through it.
    conv = ConvKernel.build(
        setups[0][0]["full"], cond0, dtype=dtype
    )
    sysd = setups[0][1].astype(dtype)

    t0 = time.time()
    # DRE tier 'matfree' (~80 MB/bucket vs 618 MB/bucket dense);
    # stepper tier 'inverse_ns'
    # (VERDICT r4 item 7): ONE bf16 seed inverse shipped + on-device
    # Newton-Schulz chain across buckets, replacing ~0.1 GB/bucket of
    # host-built dense inverse+L1 transfer that made gains_s 220 s.
    sweep_info = {}
    cache_stack, ks = build_sweep_gains_and_caches(
        setups, DT, ALPHA, dtype=dtype,
        num_shifts=8, n_adi=16, nts_gain=8, r_max=24,
        solver="inverse_ns", dre_solver="matfree",
        conv=conv, info=sweep_info,
    )
    jax.block_until_ready(ks)
    t_gains = time.time() - t0
    ns_res = sweep_info.get("ns_residuals", [])
    log(
        f"per-bucket gains + step caches {t_gains:.1f}s "
        f"(NS-chain inverse residuals: "
        f"{['%.1e' % r for r in ns_res]})"
    )

    # Per-bucket target: each bucket tracks ITS OWN steady output.
    ystar = jnp.stack([
        jnp.asarray(
            np.asarray(s[0]["C"] @ s[2].restrict(s[0]["vbar_full"])),
            dtype,
        )
        for s in setups
    ])

    # Initial states: per-bucket steady state + perturbation for the
    # REAL scenarios of the draw; padded rows repeat the steady state
    # and carry mask 0 (they compute but never enter a statistic).
    v0 = np.empty((R_BUCKETS, s_max, n))
    mask = np.zeros((R_BUCKETS, s_max))
    for r, s in enumerate(setups):
        vbar_r = np.asarray(s[2].restrict(s[0]["vbar_full"]))
        v0[r] = vbar_r[None]
        c = int(counts[r])
        v0[r, :c] += 1e-3 * rng.standard_normal((c, n))
        mask[r, :c] = 1.0
    v0 = jnp.asarray(v0, dtype)
    mask_d = jnp.asarray(mask, dtype)

    mesh = Mesh(np.asarray(jax.devices()[:1]), ("scenario",))

    # PRECISION POLICY: this 200-step rollout runs at the session
    # default 'highest' (utils.setup); a cheaper tier would need its
    # own f64 check at this horizon.
    def run():
        ys, stats = sharded_sweep_rollout(
            mesh, sysd, conv, cache_stack, ks, v0, ALPHA, DT, NTS,
            ystar=ystar, mask=mask_d,
        )
        jax.block_until_ready(ys)
        return ys, stats

    t0 = time.time()
    ys, stats = run()  # compile + first run
    t_first = time.time() - t0
    log(f"sweep compile+run {t_first:.1f}s")
    t0 = time.time()
    ys, stats = run()
    t_sweep = time.time() - t0
    solves = int(counts.sum()) * NTS  # REAL solves only
    computed = R_BUCKETS * s_max * NTS  # incl. padding
    log(
        f"sweep warm {t_sweep:.1f}s -> {solves / t_sweep:.0f} real "
        f"solves/s ({counts.sum()} scenarios x {NTS} steps; padded "
        f"device throughput {computed / t_sweep:.0f}/s)"
    )

    ys_np = np.asarray(ys)
    assert np.isfinite(ys_np).all(), "non-finite sweep outputs"
    mean_cost = np.asarray(stats["mean_cost"], dtype=np.float64)
    err_t = np.asarray(stats["tracking_err_T"], dtype=np.float64)
    stat_counts = np.asarray(stats["scenarios"], dtype=np.float64)
    np.testing.assert_array_equal(stat_counts, counts.astype(float))
    for r, re in enumerate(re_buckets):
        log(
            f"  Re={re:.1f}: {int(stat_counts[r])} scenarios, "
            f"tracking cost {mean_cost[r]:.3e}, "
            f"terminal err {err_t[r]:.3e}"
        )

    # Device-resident array footprint after the sweep: live device
    # arrays — a lower bound on device memory in use (excludes
    # runtime/compiler scratch).
    live_bytes = sum(
        a.nbytes for a in jax.live_arrays() if dev in a.devices()
    )
    log(f"live device arrays {live_bytes/2**30:.2f} GiB")

    out = {
        "config": 5,
        "problem": f"cylinder_sweep_ref{REFINEMENT}",
        "n_state": int(n),
        "re_range": [RE_LO, RE_HI],
        "re_buckets": [round(float(r), 1) for r in re_buckets],
        "scenarios_total": int(counts.sum()),
        "scenarios_per_bucket": [int(c) for c in counts],
        "s_max_padded": s_max,
        "horizon_steps": NTS,
        "solves_per_s": round(solves / t_sweep, 1),
        "padded_solves_per_s": round(computed / t_sweep, 1),
        "sweep_s": round(t_sweep, 2),
        "setup_s": round(t_setup, 1),
        "gains_s": round(t_gains, 1),
        "tracking_cost_per_bucket": [float(c) for c in mean_cost],
        "terminal_err_per_bucket": [float(e) for e in err_t],
        "live_device_array_gib": round(live_bytes / 2**30, 2),
        "stepper_tier": "inverse_ns",
        "ns_chain_residuals": [float(r) for r in ns_res],
        "setup_note": (
            "stepper tier is the on-device Newton-Schulz inverse "
            "chain (one bf16 seed + 2 dense GEMMs/pass per bucket): "
            "~0.8 GB of per-bucket dense inverse+L1 transfer is "
            "replaced by ~50 MB total; per-bucket L1 is re-linearized "
            "on device through the shared convection tensor"
        ),
        "finite": True,
        "device": str(dev.device_kind),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
