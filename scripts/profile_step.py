#!/usr/bin/env python
"""Per-op timing breakdown of the closed-loop IMEX step at bench shapes.

Times each component of the batched NSE step (cylinder Re=100 ref=1,
1024 scenarios) on the GPU. Each op is iterated ITERS times inside ONE
jitted lax.scan so per-dispatch latency cancels; reported numbers are
(t_scan - t_noop) / ITERS.
"""
from __future__ import annotations

import sys as _sys
import time

import numpy as np

ITERS = 50


def main():
    import jax
    import jax.numpy as jnp

    from optconpy_tpu import utils
    from optconpy_tpu.fem.device_conv import ConvKernel
    from optconpy_tpu.models.cylinder import cylinder_setup
    from optconpy_tpu.mpc.nse_rollout import build_nse_fused, build_nse_stepper

    utils.setup()
    dtype = jnp.float32
    dev = jax.devices()[0]
    print(f"device: {dev.platform} / {dev.device_kind}", file=_sys.stderr)

    np_ops, sys64, cond = cylinder_setup(re=100.0, refinement=1)
    fsys = sys64.astype(dtype)
    conv = ConvKernel.build(np_ops["full"], cond, dtype=dtype)
    n, m = fsys.b.shape
    nt = conv.t0.shape[0]
    print(f"n={n} np={fsys.n_p} m={m} nt={nt}", file=_sys.stderr)

    B = 1024
    dt = 0.005
    cache = build_nse_stepper(np_ops, cond, dt, dtype=dtype, solver="inverse")
    rng = np.random.default_rng(0)
    vb = jnp.asarray(
        np.asarray(cache.vbar)[None] + 1e-3 * rng.standard_normal((B, n)), dtype
    )
    k0 = jnp.asarray(rng.standard_normal((m, n)) * 1e-3, dtype)
    l1 = cache.l1_imp
    mass = fsys.mass

    def scanner(op):
        @jax.jit
        def run(v):
            def body(c, _):
                out = op(c)
                # Shape-free data dependence so the op isn't DCE'd,
                # without adding a per-iter renormalize op.
                return c + out.ravel()[0] * 0, None

            c, _ = jax.lax.scan(body, v, None, length=ITERS)
            return c

        return run

    def timeit(fn, v):
        out = fn(v)
        jax.block_until_ready(out)
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(v))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    import os
    sel = os.environ.get("PROFILE_OPS", "").split(",")
    ops = {
        "noop": lambda v: v,
        "conv_batched": lambda v: jax.vmap(conv.conv_inner)(v),
        "l1_gemm": lambda v: v @ l1.T,
        "mass_ell": lambda v: jax.vmap(mass.matvec)(v),
        "saddle_inv_gemm": lambda v: cache.lu.apply(v.T, None).T,
        "feedback": lambda v: ((-(v - cache.vbar) @ k0.T) @ fsys.b.T),
    }

    def full_step(v):
        u = -(v - cache.vbar) @ k0.T
        expl = jax.vmap(conv.conv_inner)(v) - v @ l1.T
        rhs_v = jax.vmap(mass.matvec)(v) / dt - expl + u @ fsys.b.T - cache.fv
        return cache.lu.apply(rhs_v.T, None).T

    ops["full_step"] = full_step

    fused = build_nse_fused(np_ops, cond, dt, dtype=dtype)
    ops["conv_batch_last"] = lambda v: conv.conv_inner_batch(v)

    def fused_step(v):
        u = -(v - fused.vbar) @ k0.T
        return (
            v @ fused.pmat.T
            + u @ fused.gmat.T
            - conv.conv_inner_batch(v) @ fused.inv_vv.T
            + fused.c0
        )

    ops["fused_step"] = fused_step

    if sel and sel[0]:
        ops = {k: v for k, v in ops.items() if k == "noop" or k in sel}
    res = {}
    for name, op in ops.items():
        res[name] = timeit(scanner(op), vb)
        print(f"  done {name}", file=_sys.stderr)
    t0 = res["noop"]
    parts = 0.0
    for name, t in res.items():
        per = (t - t0) / ITERS * 1e3
        if name not in ("noop", "full_step", "fused_step",
                        "conv_batch_last"):
            parts += per
        print(f"{name:20s} {per:8.3f} ms/iter", file=_sys.stderr)
    print(f"{'sum(parts)':20s} {parts:8.3f} ms/iter", file=_sys.stderr)


if __name__ == "__main__":
    main()
