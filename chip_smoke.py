#!/usr/bin/env python
"""Smoke run of the Riccati-feedback MPC pipeline on the GPU.

Drives `optcon_nse` at the bench model's full width (cylinder wake,
Re=100, refinement 1, n=4,396 velocity dofs, 1,024 scenarios, f32,
fused IMEX step, DRE inverse stack built on the device by Newton-Schulz
ladders) and checks every stage against an independent f64 reference.

Phases (one card, no arguments):

  device    JAX's default device is a GPU; prints the card's name and
            power limit as nvidia-smi reports them.
  pipeline  optcon_nse, cold then warm, with an emptied cache_dir: finite
            outputs of the expected shapes, wall time per stage.
  rollout   closed-loop outputs of the bench's fused rollout against the
            f64 NumPy recurrence, at 'highest', at 'high' (TF32) and at
            'BF16_BF16_F32_X3'; the bench's tier must stay within 1e-4.
  conv      ConvKernel.conv_full_batch (the Triton kernel on the GPU) and
            its plain XLA form at B=1,024 against the f64 NumPy element
            loop; times alone and as a share of a fused step.
  gains     device f32 gains against an f64 sweep of the same DRE on the
            host CPU ('lu' tier), plus projected Riccati residuals.

`--devices 4` runs only the scenario-sharded config-5 sweep
(`sharded_sweep_rollout` over a 4-card mesh) and its comparison with
`sweep_rollout` on one card.

    python chip_smoke.py
    python chip_smoke.py --devices 4

Any failed check raises, so the process exits non-zero. The last line of
standard output is `{"ok": true, "device": {...}}` and is printed only
after every phase passed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

GAIN_TOL = 1e-4  # |dK|/|K| of the f32 device gains against f64
RESIDUAL_TOL = 1e-2  # projected DRE step residual
ROLLOUT_TOL = 1e-4  # closed-loop output deviation against f64
CONV_TOL = 1e-5  # convection at 'highest' against the f64 element loop
SWEEP_TOL = 1e-5  # sharded against single-card sweep outputs and stats


class SmokeFailure(RuntimeError):
    """A phase's check failed."""


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


@dataclasses.dataclass(frozen=True)
class Smoke:
    """Sizes of one smoke run (defaults: the bench model at full width)."""

    problem: str = "cylinderwake"
    re: float = 100.0
    refinement: int = 1
    nx: int = 8  # cavity resolution, when problem='drivencavity'
    scenarios: int = 1024
    nts: int = 16  # pipeline horizon (DRE and closed loop)
    nts_rollout: int = 64  # bench rollout horizon
    dt: float = 0.005
    alpha: float = 1e-2
    num_shifts: int = 6
    n_adi: int = 32
    r_max: int = 32
    n_newton: int = 1
    residual_steps: int = 4  # DRE steps whose residual is measured
    timing_reps: int = 20
    re_buckets: tuple = (60.0, 100.0)
    sweep_scenarios: int = 2048  # per bucket: 4,096 rollouts in all
    sweep_steps: int = 64

    def config(self):
        from optconpy_tpu.utils import (
            CostConfig,
            OptConConfig,
            ProblemConfig,
            SolverConfig,
            TimeConfig,
        )

        return OptConConfig(
            problem=ProblemConfig(
                name=self.problem, re=self.re,
                refinement=self.refinement, nx=self.nx,
            ),
            time=TimeConfig(t0=0.0, t_end=self.nts * self.dt, nts=self.nts),
            cost=CostConfig(alpha=self.alpha),
            solver=SolverConfig(
                num_shifts=self.num_shifts, n_adi=self.n_adi,
                n_newton=self.n_newton, r_max=self.r_max,
                dtype="float32", step_solver="fused",
                dre_solver="inverse_ns",
            ),
        )


def phase_device(n_devices: int):
    import jax

    devs = jax.devices()
    check(
        devs[0].platform == "gpu",
        f"default JAX device is {devs[0].platform!r}, not a GPU",
    )
    check(
        len(devs) >= n_devices,
        f"{n_devices} GPUs asked for, JAX sees {len(devs)}",
    )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    say(f"[device] nvidia-smi: {smi.stdout.strip()}")
    say(f"[device] jax: {devs[0].platform} / {devs[0].device_kind} "
        f"x {len(devs)}, jax {jax.__version__}")
    return devs


def phase_pipeline(sm: Smoke, v0_batch: np.ndarray):
    """optcon_nse cold, then warm; returns the cold run's result."""
    from optconpy_tpu.optcont import optcon_nse
    from optconpy_tpu.utils import MetricsLogger

    cfg = sm.config()
    results = []
    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_gains_")
    try:
        for label in ("cold", "warm"):
            # An emptied cache_dir forces the DRE to run on the device.
            shutil.rmtree(cache_dir)
            t0 = time.perf_counter()
            res = optcon_nse(
                cfg, v0_batch=v0_batch, cache_dir=cache_dir,
                metrics=MetricsLogger(),
            )
            wall = time.perf_counter() - t0
            stages = ", ".join(
                f"{r['event']} {r['seconds']:.3f}s"
                for r in res.extras["metrics"] if "seconds" in r
            )
            say(f"[pipeline] {label}: {wall:.3f}s total; {stages}")
            results.append(res)
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    res = results[0]
    s, n = v0_batch.shape
    m, p = res.us.shape[-1], res.ys.shape[-1]
    check(res.ys.shape == (s, sm.nts + 1, p), f"ys shape {res.ys.shape}")
    check(res.us.shape == (s, sm.nts, m), f"us shape {res.us.shape}")
    check(
        res.gains.shape == (sm.nts + 1, m, n),
        f"gains shape {res.gains.shape}",
    )
    for r in results:
        check(
            bool(np.isfinite(r.ys).all() and np.isfinite(r.us).all()
                 and np.isfinite(np.asarray(r.gains)).all()
                 and np.isfinite(r.cost)),
            "non-finite pipeline output",
        )
    drift = float(np.abs(results[1].ys - res.ys).max())
    say(f"[pipeline] ok: ys {res.ys.shape}, us {res.us.shape}, "
        f"gains {res.gains.shape}, cost {res.cost:.6e}, "
        f"|ys warm - ys cold| {drift:.3e}")
    return res


def conv_reference(h: dict, v_inner: np.ndarray) -> np.ndarray:
    """f64 NumPy element loop for N(v)v on free dofs: (B, n) -> (B, n).

    h: ConvKernel._host_arrays (per-element tensor, dof maps, BC values).
    """
    import scipy.sparse as sp

    t0, tri, free, ns = h["t0"], h["tri_dofs"], h["free"], h["ns"]
    b = v_inner.shape[0]
    v_full = np.tile(h["dir_values"], (b, 1))
    v_full[:, free] = v_inner
    v_loc = v_full.reshape(b, 2, ns)[:, :, tri]  # (B, 2, nt, 6)
    w = np.einsum("eijkc,Bcej->Beik", t0, v_loc)
    out_loc = np.einsum("Beik,Baek->Baei", w, v_loc)  # (B, 2, nt, 6)
    nt6 = tri.size
    scatter = sp.csr_matrix(
        (np.ones(nt6), (tri.reshape(-1), np.arange(nt6))), shape=(ns, nt6)
    )
    out = (scatter @ out_loc.reshape(b * 2, nt6).T).T
    return out.reshape(b, 2 * ns)[:, free]


def median_time(fn, *args, reps: int) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def phase_rollout(sm, sys, conv, step_cache, k0, v0_batch, h_conv, tiers):
    """Bench-shaped fused rollout at each matmul precision tier against
    the f64 NumPy recurrence; returns {tier: seconds per step}."""
    import jax
    import jax.numpy as jnp

    from optconpy_tpu.mpc.nse_rollout import batched_nse_closed_loop

    n, m = sys.b.shape
    nts = sm.nts_rollout
    ks = jnp.broadcast_to(k0, (nts + 1, m, n))
    ws = jnp.zeros((nts + 1, n), jnp.float32)

    def run(tier):
        with jax.default_matmul_precision(tier):
            return batched_nse_closed_loop(
                sys, conv, step_cache, ks, ws, v0_batch, sm.alpha, sm.dt,
            )[2]

    s_ref = 2
    pmat = np.asarray(step_cache.pmat, np.float64)
    gmat = np.asarray(step_cache.gmat, np.float64)
    inv_vv = np.asarray(step_cache.inv_vv, np.float64)
    c0 = np.asarray(step_cache.c0, np.float64)
    vbar = np.asarray(step_cache.vbar, np.float64)
    c_out = np.asarray(sys.c, np.float64)
    k64 = np.asarray(k0, np.float64)
    v = np.asarray(v0_batch[:s_ref], np.float64)
    ys_ref = [v @ c_out.T]
    for _ in range(nts):
        u = -(v - vbar) @ k64.T
        v = (
            v @ pmat.T + u @ gmat.T
            - conv_reference(h_conv, v) @ inv_vv.T + c0
        )
        ys_ref.append(v @ c_out.T)
    ys_ref = np.stack(ys_ref, axis=1)

    step_s, devs = {}, {}
    for tier in tiers:
        ys = np.asarray(run(tier))
        check(bool(np.isfinite(ys).all()), f"non-finite rollout ({tier})")
        devs[tier] = float(
            np.abs(ys[:s_ref] - ys_ref).max() / np.abs(ys_ref).max()
        )
        step_s[tier] = median_time(run, tier, reps=3) / nts
        say(f"[rollout] '{tier}': output deviation vs f64 "
            f"{devs[tier]:.3e} over {nts} steps ({s_ref} scenarios), "
            f"{step_s[tier] * 1e3:.4f} ms/step at B={len(v0_batch)}")
    return step_s, devs


def phase_conv(sm, conv, v0_batch, h_conv, step_s):
    """Convection at B=1,024: the dispatching path (the Triton kernel
    when compiled for the GPU) and the plain XLA path, each against the
    f64 element loop, timed alone and as a share of a fused step."""
    import jax
    import jax.numpy as jnp

    v_full_t = (
        conv.dir_values[:, None]
        + jnp.zeros((2 * conv.ns, len(v0_batch)), jnp.float32)
        .at[conv.free].set(v0_batch.T)
    )
    ref = conv_reference(h_conv, np.asarray(v0_batch, np.float64))
    free = np.asarray(h_conv["free"])
    nt = h_conv["tri_dofs"].shape[0]
    paths = {
        "conv_full_batch": jax.jit(conv.conv_full_batch),
        "conv_full_batch_xla": jax.jit(conv.conv_full_batch_xla),
    }
    outs = {}
    for name, fn in paths.items():
        with jax.default_matmul_precision("highest"):
            outs[name] = np.asarray(fn(v_full_t), np.float64)
        rel = float(np.abs(outs[name][free].T - ref).max() / np.abs(ref).max())
        say(f"[conv] {name} vs f64 element loop at B={len(v0_batch)}, "
            f"nt={nt} ('highest'): {rel:.3e}")
        check(rel <= CONV_TOL, f"{name} parity {rel:.3e} > {CONV_TOL:.0e}")
        for tier, t_step in step_s.items():
            with jax.default_matmul_precision(tier):
                t_conv = median_time(fn, v_full_t, reps=sm.timing_reps)
            say(f"[conv] {name} '{tier}': {t_conv * 1e3:.4f} ms alone, "
                f"fused step {t_step * 1e3:.4f} ms -> share "
                f"{t_conv / t_step:.3f}")
    a, b = outs.values()
    say(f"[conv] dispatching vs XLA path: "
        f"{np.abs(a - b).max() / np.abs(b).max():.3e}")


def phase_gains(sm, np_ops, gains_dev):
    """Device f32 sweep factors and gains against an f64 host sweep."""
    import jax
    import jax.numpy as jnp

    from optconpy_tpu.fem.dae import dae_from_scipy
    from optconpy_tpu.riccati import (
        build_dre_cache_dae,
        build_dre_cache_dae_ns,
        dre_backward_sweep,
        dre_shift_schedule_dae,
        dre_step_residual,
    )

    sig, sseq, iseq = dre_shift_schedule_dae(
        np_ops["A"], np_ops["M"], np_ops["J"], sm.dt,
        num_shifts=sm.num_shifts, n_adi=sm.n_adi,
    )

    def sweep(sys, cache, dtype):
        return dre_backward_sweep(
            sys, cache, sm.alpha, sm.dt, sm.nts,
            jnp.asarray(sseq, dtype), jnp.asarray(iseq),
            n_newton=sm.n_newton, r_max=sm.r_max,
        )

    def dae(dtype):
        return dae_from_scipy(
            np_ops["M"], np_ops["A"], np_ops["J"], np_ops["B"], np_ops["C"]
        ).astype(dtype)

    # The pipeline keeps only the gains; the factors for the residuals
    # come from the same sweep run again on the device.
    sys32 = dae(jnp.float32)
    cache, ns_info = build_dre_cache_dae_ns(sys32, sm.dt, sig, jnp.float32)
    zs32, ks32 = (np.asarray(a) for a in sweep(sys32, cache, jnp.float32))
    del cache
    ks_pipe = np.asarray(gains_dev, np.float64)
    say(f"[gains] NS stack worst residual {max(ns_info['residuals']):.2e}; "
        f"rerun vs pipeline gains "
        f"{np.abs(ks32 - ks_pipe).max() / np.abs(ks_pipe).max():.3e}")

    t0 = time.perf_counter()
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        sys64 = dae(jnp.float64)
        cache64 = build_dre_cache_dae(sys64, sm.dt, sig, solver="lu")
        ks64 = np.asarray(sweep(sys64, cache64, jnp.float64)[1])
    dk = float(np.abs(ks_pipe - ks64).max() / np.abs(ks64).max())
    dk0 = float(np.abs(ks_pipe[0] - ks64[0]).max() / np.abs(ks64[0]).max())
    say(f"[gains] f64 host sweep ({sm.nts} steps, 'lu' tier) "
        f"{time.perf_counter() - t0:.1f}s; f32 device gains |dK|/|K| "
        f"{dk:.3e} over all steps, {dk0:.3e} at t=0")
    check(dk <= GAIN_TOL, f"gain deviation {dk:.3e} > {GAIN_TOL:.0e}")

    stride = max(1, sm.nts // sm.residual_steps)
    res = {
        k: dre_step_residual(
            np_ops, zs32[k], ks32[k], zs32[k + 1], sm.alpha, sm.dt
        )
        for k in range(0, sm.nts, stride)
    }
    say("[gains] projected residuals: " + ", ".join(
        f"step {k} {r:.3e}" for k, r in res.items()))
    worst = max(res.values())
    check(worst <= RESIDUAL_TOL,
          f"DRE residual {worst:.3e} > {RESIDUAL_TOL:.0e}")


def run_single(
    sm: Smoke, tiers=("highest", "high", "BF16_BF16_F32_X3")
) -> None:
    """Every one-card phase after `device`."""
    import jax.numpy as jnp

    from bench import ROLLOUT_PREC
    from optconpy_tpu.fem.device_conv import ConvKernel
    from optconpy_tpu.mpc.nse_rollout import build_nse_fused
    from optconpy_tpu.optcont import _setup_problem

    check(ROLLOUT_PREC in tiers, f"bench tier {ROLLOUT_PREC!r} not tested")
    cfg = sm.config()
    np_ops, sys64, cond = _setup_problem(cfg)
    vbar = cond.restrict(np_ops["vbar_full"])
    rng = np.random.default_rng(0)
    v0 = (vbar[None] + 1e-3 * rng.standard_normal((sm.scenarios, len(vbar))))
    v0 = v0.astype(np.float32)

    res = phase_pipeline(sm, v0)

    sys = sys64.astype(jnp.float32)
    conv = ConvKernel.build(np_ops["full"], cond, dtype=jnp.float32)
    h_conv = ConvKernel._host_arrays(np_ops["full"], cond)
    step_cache = build_nse_fused(np_ops, cond, sm.dt, dtype=jnp.float32)
    v0_dev = jnp.asarray(v0)
    step_s, devs = phase_rollout(
        sm, sys, conv, step_cache, res.gains[0], v0_dev, h_conv, tiers
    )
    ok_tiers = [t for t in tiers if devs[t] <= ROLLOUT_TOL]
    say(f"[rollout] tiers within {ROLLOUT_TOL:.0e}: {ok_tiers}; "
        f"bench tier '{ROLLOUT_PREC}'")
    check(devs[ROLLOUT_PREC] <= ROLLOUT_TOL,
          f"bench tier '{ROLLOUT_PREC}' deviates {devs[ROLLOUT_PREC]:.3e}")

    phase_conv(sm, conv, v0_dev, h_conv, step_s)
    phase_gains(sm, np_ops, res.gains)


def run_sweep(sm: Smoke, devs) -> None:
    """Config-5 sweep: sharded over `devs` against one card."""
    import jax
    import jax.numpy as jnp

    from optconpy_tpu.fem.device_conv import ConvKernel
    from optconpy_tpu.optcont import _setup_problem
    from optconpy_tpu.parallel import (
        build_sweep_gains_and_caches,
        scenario_mesh,
        shard_scenarios,
        sharded_sweep_rollout,
        sweep_rollout,
    )

    f32 = jnp.float32
    t0 = time.perf_counter()
    setups = [
        _setup_problem(dataclasses.replace(sm, re=re).config())
        for re in sm.re_buckets
    ]
    np_ops0, sys64, cond0 = setups[0]
    sys = sys64.astype(f32)
    conv = ConvKernel.build(np_ops0["full"], cond0, dtype=f32)
    cache_stack, ks = build_sweep_gains_and_caches(
        setups, sm.dt, sm.alpha, dtype=f32
    )
    r, s = len(setups), sm.sweep_scenarios
    vbars = np.stack([c.restrict(o["vbar_full"]) for o, _, c in setups])
    rng = np.random.default_rng(0)
    v0 = (vbars[:, None] + 1e-3 * rng.standard_normal((r, s, vbars.shape[1])))
    v0 = jnp.asarray(v0, f32)
    say(f"[sweep] setup {time.perf_counter() - t0:.1f}s: {r} buckets "
        f"Re={list(sm.re_buckets)}, {s} scenarios each, "
        f"{sm.sweep_steps} steps, n={vbars.shape[1]}")

    t0 = time.perf_counter()
    ys1, u_sq1, _ = jax.block_until_ready(
        sweep_rollout(sys, conv, cache_stack, ks, v0, sm.alpha, sm.dt,
                      sm.sweep_steps)
    )
    say(f"[sweep] one card ({ys1.sharding.device_set}): "
        f"{time.perf_counter() - t0:.1f}s incl. compile")
    ys1, u_sq1 = np.asarray(ys1, np.float64), np.asarray(u_sq1, np.float64)
    cost1 = (np.sum(ys1**2, axis=(2, 3)) + sm.alpha * u_sq1.sum(2)) * sm.dt
    ref_stats = {
        "mean_cost": cost1.mean(1),
        "max_abs_y": np.abs(ys1).max(axis=(1, 2, 3)),
        "tracking_err_T": np.linalg.norm(ys1[:, :, -1], axis=-1).mean(1),
        "scenarios": np.full(r, float(s)),
    }

    mesh = scenario_mesh(devs)
    v0_sh = shard_scenarios(mesh, jnp.swapaxes(v0, 0, 1))
    v0_sh = jnp.swapaxes(v0_sh, 0, 1)
    t0 = time.perf_counter()
    ys4, stats4 = jax.block_until_ready(
        sharded_sweep_rollout(mesh, sys, conv, cache_stack, ks, v0_sh,
                              sm.alpha, sm.dt, sm.sweep_steps)
    )
    say(f"[sweep] {len(devs)} cards: {time.perf_counter() - t0:.1f}s "
        f"incl. compile")
    for name, arr in (("v0", v0_sh), ("ys", ys4)):
        shard_devs = {sh.device for sh in arr.addressable_shards}
        shapes = {sh.data.shape for sh in arr.addressable_shards}
        say(f"[sweep] {name} sharding {arr.sharding.spec} over "
            f"{len(shard_devs)} devices, shard shapes {shapes}")
        check(shard_devs == set(devs), f"{name} not spread over the mesh")
        check(shapes == {(r, s // len(devs)) + arr.shape[2:]},
              f"{name} shards {shapes}")
    dev_ys = float(np.abs(np.asarray(ys4) - ys1).max() / np.abs(ys1).max())
    say(f"[sweep] ys sharded vs one card: {dev_ys:.3e}")
    check(dev_ys <= SWEEP_TOL, f"sharded ys deviate {dev_ys:.3e}")
    for key, ref in ref_stats.items():
        got = np.asarray(stats4[key], np.float64)
        dev = float(np.abs(got - ref).max() / np.abs(ref).max())
        say(f"[sweep] {key}: sharded {got} vs one card {ref} -> {dev:.3e}")
        check(dev <= SWEEP_TOL, f"sweep statistic {key} deviates {dev:.3e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--devices", type=int, default=1, choices=(1, 4),
        help="4: run only the scenario-sharded sweep over four cards",
    )
    args = ap.parse_args(argv)

    import jax

    devs = phase_device(args.devices)
    from optconpy_tpu import utils

    utils.setup()
    t0 = time.perf_counter()
    sm = Smoke()
    if args.devices == 1:
        run_single(sm)
    else:
        run_sweep(sm, devs[: args.devices])
    say(f"[done] {time.perf_counter() - t0:.1f}s after the device phase")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
