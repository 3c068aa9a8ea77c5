"""Parameter-sweep MPC — config 5 (BASELINE.md): thousands of scenario
rollouts across a family of linearizations (e.g. Re in [60, 150]),
sharded over the device mesh.

Structure: R parameter buckets (one linearization + gain each) x S
scenarios per bucket. Bucket operands are stacked pytrees vmapped on
the leading axis; the scenario axis inside each bucket is sharded over
the mesh with shard_map, and aggregate statistics ride psum
(SURVEY.md SS5.8). The rollout kernel is the memory-lean
nse_sweep_outputs (one batched time scan, no state trajectories in HBM).

Geometry is shared across buckets (same mesh, different viscosity /
steady state), so ONE ConvKernel serves the whole sweep and only the
stepper caches + gains are per-bucket.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..mpc.nse_rollout import (
    NSEStepCache,
    build_nse_stepper,
    nse_sweep_outputs,
)


def build_sweep_gains_and_caches(
    setups: list,
    dt: float,
    alpha: float,
    dtype=jnp.float32,
    num_shifts: int = 8,
    n_adi: int = 16,
    nts_gain: int = 8,
    r_max: int = 24,
    solver: str = "inverse",
    interval=None,
    cache_keys: list | None = None,
    dre_solver: str = "inverse",
    conv=None,
    info: dict | None = None,
):
    """Per-bucket gains + stepper caches, host loop (setup time).

    setups: list of (np_ops, sys, cond) from models/* at each parameter
    value. Returns (stacked NSEStepCache, ks (R, m, n)).
    cache_keys: optional per-bucket stable strings — with
    dre_solver='inverse' each bucket's shifted-inverse stack is
    disk-cached under its key (riccati.load_or_build_inverse_stack),
    so a warm sweep restart skips all R splu builds (VERDICT r3 item 5).
    dre_solver: 'inverse' (dense GEMM stack; 618 MB/bucket of device
    transfer at cylinder ref1 x 8 shifts) or 'matfree' (block-Jacobi +
    Schur FGMRES, ~80 MB/bucket; gain parity with the dense path is
    checked by tests/test_matfree.py).
    solver: stepper tier — 'lu' / 'inverse' (per-bucket host builds,
    ~0.1 GB dense transfer per bucket) or 'inverse_ns' (one bf16 seed
    inverse + on-device Newton-Schulz chain across buckets, ~50 MB
    total transfer — VERDICT r4 item 7; requires `conv`, the shared
    geometry's ConvKernel, for device re-linearization).
    info: optional dict populated with setup diagnostics
    ('ns_residuals': certified per-bucket inverse residuals).
    """
    from ..riccati import (
        build_dre_cache_dae,
        build_dre_cache_dae_matfree,
        dre_backward_sweep,
        dre_shift_schedule_dae,
    )

    from concurrent.futures import ThreadPoolExecutor

    gains = []
    # Overlap the per-bucket STEPPER builds (host f64 inverse + device
    # transfer) with the DRE gain sweeps: scipy/LAPACK release the GIL
    # and jnp.asarray transfers are async, so two worker threads keep
    # the host busy while the device runs the gain programs; kept until
    # an H100 measurement decides, ROADMAP design item 1.
    # Only the memory-lean matfree DRE tier overlaps ALL stepper builds
    # up-front; with dre_solver='inverse' a multi-hundred-MB shifted-
    # inverse stack would coexist with in-flight stepper inverse
    # builds/transfers and raise peak host+device memory (ADVICE r4
    # low #4), so that tier submits each bucket's stepper only after
    # its DRE cache is freed.
    import sys as _sys
    import time as _time

    def _log(m):
        print(m, file=_sys.stderr, flush=True)

    overlap_all = dre_solver == "matfree"
    t_all0 = _time.time()
    with ThreadPoolExecutor(2) as ex:
        if solver == "inverse_ns":
            # One worker runs the whole Newton-Schulz chain (device
            # GEMMs + one bf16 seed transfer) concurrent with the DRE
            # gain sweeps on the main thread.
            from ..mpc.nse_rollout import build_sweep_steppers_ns_chain

            ns_fut = ex.submit(
                build_sweep_steppers_ns_chain, setups, dt,
                dtype=dtype, conv=conv,
            )
            stepper_futs = [None] * len(setups)
        else:
            ns_fut = None
            stepper_futs = [
                ex.submit(
                    build_nse_stepper, np_ops, cond, dt,
                    dtype=dtype, solver=solver,
                )
                for np_ops, _sys64, cond in setups
            ] if overlap_all else [None] * len(setups)
        for i, (np_ops, sys64, cond) in enumerate(setups):
            t_b0 = _time.time()
            sys = sys64.astype(dtype)
            sig, sigma_seq, idx_seq = dre_shift_schedule_dae(
                np_ops["A"], np_ops["M"], np_ops["J"], dt,
                num_shifts=num_shifts, n_adi=n_adi, interval=interval,
            )
            t_shift = _time.time() - t_b0
            if dre_solver == "matfree":
                dre_cache = build_dre_cache_dae_matfree(
                    sys, dt, sig, dtype=dtype
                )
            else:
                dre_cache = build_dre_cache_dae(
                    sys, dt, sig, dtype=dtype, solver="inverse",
                    cache_key=(
                        None if cache_keys is None else cache_keys[i]
                    ),
                )
            t_cache = _time.time() - t_b0 - t_shift
            _, ks = dre_backward_sweep(
                sys, dre_cache, alpha, dt, nts_gain,
                jnp.asarray(sigma_seq, dtype), jnp.asarray(idx_seq),
                n_newton=1, r_max=r_max,
            )
            gains.append(ks[0])
            del dre_cache  # free per-shift factors before the next bucket
            _log(
                f"  [sweep] bucket {i}: shifts {t_shift:.1f}s, "
                f"dre-cache {t_cache:.1f}s, sweep "
                f"{_time.time() - t_b0 - t_shift - t_cache:.1f}s"
            )
            if not overlap_all and solver != "inverse_ns":
                stepper_futs[i] = ex.submit(
                    build_nse_stepper, np_ops, cond, dt,
                    dtype=dtype, solver=solver,
                )
        t_gains_done = _time.time() - t_all0
        if ns_fut is not None:
            caches, ns_residuals = ns_fut.result()
            if info is not None:
                info["ns_residuals"] = ns_residuals
        else:
            caches = [f.result() for f in stepper_futs]
        _log(
            f"  [sweep] gains loop {t_gains_done:.1f}s, stepper join "
            f"+{_time.time() - t_all0 - t_gains_done:.1f}s"
        )
    cache_stack = jax.tree.map(lambda *xs: jnp.stack(xs), *caches)
    return cache_stack, jnp.stack(gains)


def sweep_rollout(
    sys,
    conv,
    cache_stack: NSEStepCache,
    ks: jax.Array,
    v0: jax.Array,
    alpha: float,
    dt: float,
    nts: int,
):
    """Unsharded sweep rollout: v0 (R, S, n) -> (ys (R, S, nts+1, p),
    u_sq (R, S, nts), v_final (R, S, n)). sys supplies the shared
    mass/b/c; per-bucket operands come from the stacked cache.

    One batched time scan over all R x S rollouts (nse_sweep_outputs):
    the shared convection runs on the flattened batch through the
    production kernel; the earlier per-scenario double-vmap OOM'd HBM
    on (nt, 6, 6, R, S) XLA convection intermediates at spec scale."""
    return nse_sweep_outputs(
        sys, conv, cache_stack, ks, v0, alpha, dt, nts
    )


def sharded_sweep_rollout(
    mesh: Mesh,
    sys,
    conv,
    cache_stack: NSEStepCache,
    ks: jax.Array,
    v0: jax.Array,
    alpha: float,
    dt: float,
    nts: int,
    axis: str = "scenario",
    ystar: jax.Array | None = None,
    mask: jax.Array | None = None,
):
    """Config-5 entry: scenario axis sharded over the mesh, bucket
    operands replicated, block-reduced sweep statistics via psum.

    v0: (R, S, n) with S % mesh.shape[axis] == 0. Returns
    (ys (R, S, nts+1, p), stats) with stats globally reduced per
    bucket: mean_cost (R,), max_abs_y (R,), tracking_err_T (R,),
    scenarios (R,) — the REAL per-bucket scenario counts.

    ystar: optional (R, p) per-bucket constant target so the sweep
    measures the DRIVER'S quadratic tracking objective
    int ||y - y*||^2 + alpha ||u||^2 dt (BASELINE config 5 parity with
    optcont.py); None keeps the regulation objective (y* = 0).

    mask: optional (R, S) 0/1 validity mask for RAGGED buckets — the
    honest config-5 contract (BASELINE: 8192 drawn Re values assigned
    to nearest buckets give UNEQUAL counts; buckets are padded to a
    static S_max and padded rows carry mask 0). Padded scenarios still
    compute (static shapes) but contribute nothing to any
    statistic, and every mean is weighted by the true counts.
    """
    p_out = sys.p_out
    n_buckets = v0.shape[0]
    if ystar is None:
        ystar = jnp.zeros((n_buckets, p_out), v0.dtype)
    if mask is None:
        mask = jnp.ones(v0.shape[:2], v0.dtype)

    def local_block(cache_l, ks_l, v0_l, ystar_l, mask_l):
        ys, u_sq, v_fin = sweep_rollout(
            sys, conv, cache_l, ks_l, v0_l, alpha, dt, nts
        )
        w = mask_l.astype(ys.dtype)  # (R, S_local)
        valid = mask_l > 0  # boolean SELECT, not multiply: padded rows
        # still compute the full nonlinear rollout and may diverge to
        # inf/NaN at unstable Re; 0*inf = NaN would poison every psum/
        # pmax for the whole bucket (ADVICE r4 medium #1).
        dy = ys - ystar_l[:, None, None, :]
        cost_per_s = (
            jnp.sum(dy**2, axis=(2, 3)) * dt
            + alpha * jnp.sum(u_sq, axis=2) * dt
        )  # (R, S_local)
        cost_per_s = jnp.where(valid, cost_per_s, 0.0)
        total_cost = jax.lax.psum(jnp.sum(cost_per_s, axis=1), axis)
        counts = jax.lax.psum(jnp.sum(w, axis=1), axis)  # (R,)
        safe = jnp.maximum(counts, 1.0)
        max_y = jax.lax.pmax(
            jnp.max(
                jnp.where(valid[:, :, None, None], jnp.abs(ys), 0.0),
                axis=(1, 2, 3),
            ),
            axis,
        )
        # Terminal tracking error, mean over REAL scenarios per bucket.
        err_t = jax.lax.psum(
            jnp.sum(
                jnp.where(
                    valid, jnp.linalg.norm(dy[:, :, -1, :], axis=-1), 0.0
                ),
                axis=1,
            ),
            axis,
        )
        return ys, {
            "mean_cost": total_cost / safe,
            "max_abs_y": max_y,
            "tracking_err_T": err_t / safe,
            "scenarios": counts,
        }

    fn = jax.shard_map(
        local_block,
        mesh=mesh,
        in_specs=(
            jax.tree.map(lambda _: P(), cache_stack),
            P(),
            P(None, axis, None),
            P(),
            P(None, axis),
        ),
        out_specs=(
            P(None, axis),
            {
                "mean_cost": P(),
                "max_abs_y": P(),
                "tracking_err_T": P(),
                "scenarios": P(),
            },
        ),
        check_vma=False,
    )
    return jax.jit(fn)(cache_stack, ks, v0, ystar, mask)


def assign_re_buckets(re_values: np.ndarray, re_buckets: np.ndarray):
    """Nearest-bucket assignment for a continuous parameter sweep:
    scenario i with parameter re_values[i] uses the gain/linearization
    of the closest bucket (the config-5 grouping step)."""
    return np.argmin(
        np.abs(re_values[:, None] - re_buckets[None, :]), axis=1
    ).astype(np.int32)
