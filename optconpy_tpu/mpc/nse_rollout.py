"""Nonlinear NSE transient rollout — IMEX stepping with feedback.

The reference's solve_nse loop (SURVEY.md SS3.4): one cached saddle
factorization of the implicit block, explicit convection via
get_convvec, feedback gains applied as tall-skinny matvecs inside the
loop; its `lin_vel_point` option linearizes convection about a fixed
velocity. Device design: lax.scan over steps, device-side convection
(fem/device_conv.py), batched scenarios via vmap (the 'closed-loop MPC
solves/s/chip' kernel, BASELINE.md).

Two IMEX schemes, chosen at cache-build time:
  * explicit:  implicit block [[M/dt - A_stokes, J^T], [J, 0]], full
    convection N(v)v explicit — CFL-limited (dt <~ h/u).
  * oseen (default): the steady-state-linearized convection L1(vbar)
    joins the implicit block; only the quadratic remainder
    N(v)v - L1(vbar) v stays explicit. Unconditionally stable near
    vbar, allowing 10-20x larger steps (measured on cylinder Re=100).

State convention: v is the FREE-dof velocity (Dirichlet values live in
the ConvKernel); the feedback regulates the perturbation from the
linearization point vbar:  u_k = -K_k (v_k - vbar) + (1/alpha) B^T w_k.

Step (fv, fp are the BC condensation rhs from BCCondenser.mat_bc_rhs /
jmat_bc_rhs, so the dynamic forcing enters as -fv; L1i is the inner
linearized-convection matrix, zero for the explicit scheme):
  [[M/dt - A_stokes + L1i, J^T], [J, 0]] [v+; p]
      = [M v_k/dt - (N(v_k)v_k - L1i v_k) + B u_k - fv; fp]
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from ..fem.device_conv import ConvKernel
from ..solvers.saddle import SaddleLU


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("lu", "l1_imp", "fv", "fp", "vbar", "rhs_half"),
    meta_fields=(),
)
@dataclass(frozen=True)
class NSEStepCache:
    """Cached IMEX step operators for one (problem, dt) pair.

    lu: SaddleLU of the implicit block;
    l1_imp: (n, n) implicitly-treated convection (zeros => explicit
        scheme — XLA folds the zero matmul away at trace time when the
        caller passes the `explicit` build);
    fv, fp: BC condensation rhs; vbar: linearization point;
    rhs_half: None for backward-Euler schemes; for the trapezoid
        (CNAB2) scheme the explicit half of the linear operator,
        (A_stokes - L1)/2, applied on the rhs each step (the implicit
        block then carries M/dt - (A_stokes - L1)/2). Presence of
        rhs_half selects the scheme in the rollout kernels.
    """

    lu: SaddleLU  # or SaddleInverse — any saddle solver with .apply
    l1_imp: jax.Array
    fv: jax.Array
    fp: jax.Array
    vbar: jax.Array
    rhs_half: jax.Array | None = None


def build_nse_stepper(
    np_ops: dict,
    cond,
    dt: float,
    dtype=jnp.float32,
    scheme: str = "oseen",
    solver: str = "lu",
) -> NSEStepCache:
    """Host-side builder: assembles the IMEX step cache from the
    cylinder/cavity setup dict (models/*.py) and the BC condenser.

    scheme: 'oseen' (L1(vbar) implicit Euler, default), 'explicit'
    (full convection explicit, Euler), or 'oseen-cn' (trapezoid on the
    Oseen-linearized part + Adams-Bashforth-2 on the quadratic
    convection remainder — the CNAB2 scheme; second order, matching
    the reference's 'IMEX Euler or trapezoid' option, SURVEY.md SS2
    row 7).
    solver: 'lu' (device triangular solves) or 'inverse' (host-built
    explicit inverse applied as one GEMM, same apply contract; see
    solvers/saddle.py SaddleInverse).
    """
    import numpy as np

    from ..fem.taylor_hood import convection_matrices
    from ..solvers.saddle import SaddleInverse

    full = np_ops["full"]
    m_i = np_ops["M"]
    a_stokes_i = cond.mat_inner(full["A"])
    j_i = np_ops["J"]
    n = m_i.shape[0]

    if scheme in ("oseen", "oseen-cn"):
        l1, _ = convection_matrices(full, np_ops["vbar_full"])
        l1_i = cond.mat_inner(l1).toarray()
    elif scheme == "explicit":
        l1_i = np.zeros((n, n))
    else:
        raise ValueError(f"unknown IMEX scheme: {scheme}")

    theta = 0.5 if scheme == "oseen-cn" else 1.0
    lin = a_stokes_i.toarray() - l1_i  # implicitly-treated linear part
    imp = m_i.toarray() / dt - theta * lin
    solver_cls = {"lu": SaddleLU, "inverse": SaddleInverse}[solver]
    lu = solver_cls.build(
        jnp.asarray(imp, dtype), jnp.asarray(j_i.toarray(), dtype)
    )
    return NSEStepCache(
        lu=lu,
        l1_imp=jnp.asarray(l1_i, dtype),
        fv=jnp.asarray(cond.mat_bc_rhs(full["A"]), dtype),
        fp=jnp.asarray(cond.jmat_bc_rhs(full["J"]), dtype),
        vbar=jnp.asarray(cond.restrict(np_ops["vbar_full"]), dtype),
        rhs_half=(
            jnp.asarray(0.5 * lin, dtype) if scheme == "oseen-cn"
            else None
        ),
    )


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("pmat", "inv_vv", "gmat", "c0", "vbar"),
    meta_fields=("dt",),
)
@dataclass(frozen=True)
class NSEFusedCache:
    """Fused IMEX step: the whole linear part of one Oseen-IMEX
    step is pre-contracted on the host (f64) into TWO device GEMMs.

    With S = [[M/dt - A + L1, J^T], [J, 0]]^-1 and blocks
    inv_vv = S[:n,:n], inv_vp = S[:n,n:], the step
        v+ = S_vv rhs_v + S_vp fp,  rhs_v = (M/dt + L1) v - N(v)v + B u - fv
    becomes
        v+ = pmat @ v + inv_vv @ (B u - N(v)v) + c0
    with pmat = inv_vv (M/dt + L1),  c0 = inv_vp fp - inv_vv fv,
    gmat = inv_vv B. This folds the mass SpMV, the L1 GEMM, and the
    saddle-inverse apply of the v-linear rhs into ONE (n, n) GEMM —
    measured ~2.4x fewer step FLOPs than the unfused inverse path at
    bench shapes (SURVEY.md SS3.4 step contract, re-associated into
    GEMMs)."""

    pmat: jax.Array  # (n, n)
    inv_vv: jax.Array  # (n, n)
    gmat: jax.Array  # (n, m)
    c0: jax.Array  # (n,)
    vbar: jax.Array  # (n,)
    dt: float  # baked into pmat/c0 at build time (meta, checked at apply)


def build_nse_fused(
    np_ops: dict,
    cond,
    dt: float,
    dtype=jnp.float32,
    scheme: str = "oseen",
) -> NSEFusedCache:
    """Host-side (f64) builder of the fused Oseen-IMEX step cache.

    All contractions stay in NUMPY float64 on the host — x64 need not be
    enabled in JAX — and each cached array crosses to the device dtype
    exactly once at the end.
    """
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from ..fem.taylor_hood import convection_matrices

    full = np_ops["full"]
    m_sp = sp.csr_matrix(np_ops["M"])
    m_i = np.asarray(m_sp.toarray(), dtype=np.float64)
    a_stokes_sp = sp.csr_matrix(cond.mat_inner(full["A"]))
    j_sp = sp.csr_matrix(np_ops["J"])
    n = m_i.shape[0]
    n_p = j_sp.shape[0]

    if scheme == "oseen":
        l1, _ = convection_matrices(full, np_ops["vbar_full"])
        l1_sp = sp.csr_matrix(cond.mat_inner(l1))
    elif scheme == "explicit":
        l1_sp = sp.csr_matrix((n, n))
    else:
        raise ValueError(f"unknown IMEX scheme: {scheme}")
    l1_i = np.asarray(l1_sp.toarray(), dtype=np.float64)

    # Sparse LU (not dense getrf: ~6x cheaper at n+np ~ 5k on the
    # deploy VMs), explicit inverse by solving against I. f64 host.
    big = sp.bmat(
        [[m_sp / dt - a_stokes_sp + l1_sp, j_sp.T], [j_sp, None]],
        format="csc",
    )
    inv = spla.splu(big).solve(np.eye(n + n_p))  # stays np.float64
    inv_vv = inv[:n, :n]
    inv_vp = inv[:n, n:]
    fv = np.asarray(cond.mat_bc_rhs(full["A"]), dtype=np.float64)
    fp = np.asarray(cond.jmat_bc_rhs(full["J"]), dtype=np.float64)
    b_np = np.asarray(np_ops["B"].toarray() if hasattr(
        np_ops["B"], "toarray") else np_ops["B"], dtype=np.float64)
    return NSEFusedCache(
        pmat=jnp.asarray(inv_vv @ (m_i / dt + l1_i), dtype),
        inv_vv=jnp.asarray(inv_vv, dtype),
        gmat=jnp.asarray(inv_vv @ b_np, dtype),
        c0=jnp.asarray(inv_vp @ fp - inv_vv @ fv, dtype),
        vbar=jnp.asarray(cond.restrict(np_ops["vbar_full"]), dtype),
        dt=float(dt),
    )


@partial(jax.jit, static_argnames=("feedback",))
def batched_nse_closed_loop_fused(
    sys,
    conv: ConvKernel,
    cache: NSEFusedCache,
    ks: jax.Array,
    ws: jax.Array,
    v0_batch: jax.Array,
    alpha: float,
    feedback: str = "explicit",
):
    """Fused batched closed loop: lax.scan over time, whole scenario
    batch inside each step (explicit (B, n) GEMMs), with
    the batch-last convection kernel (ConvKernel.conv_inner_batch).
    Same (vs, us, ys) contract as batched_nse_closed_loop."""
    bt = sys.b.T
    vbar = cache.vbar
    m_in = sys.m_in

    if feedback == "implicit":
        eye_m = jnp.eye(m_in, dtype=cache.gmat.dtype)

        def step(v, inp):
            k_gain, w_k = inp
            uff = (bt @ w_k) / alpha + k_gain @ vbar
            x0 = (
                v @ cache.pmat.T
                + uff @ cache.gmat.T
                - conv.conv_inner_batch(v) @ cache.inv_vv.T
                + cache.c0
            )
            s_mat = eye_m + k_gain @ cache.gmat
            corr = jnp.linalg.solve(s_mat, (x0 @ k_gain.T).T).T
            v_next = x0 - corr @ cache.gmat.T
            u = -(v_next - vbar) @ k_gain.T + (bt @ w_k) / alpha
            return v_next, (v_next, u)

    else:

        def step(v, inp):
            k_gain, w_k = inp
            u = -(v - vbar) @ k_gain.T + (bt @ w_k) / alpha
            v_next = (
                v @ cache.pmat.T
                + u @ cache.gmat.T
                - conv.conv_inner_batch(v) @ cache.inv_vv.T
                + cache.c0
            )
            return v_next, (v_next, u)

    _, (vs_tail, us) = jax.lax.scan(step, v0_batch, (ks[:-1], ws[:-1]))
    vs = jnp.concatenate([v0_batch[None], vs_tail], axis=0)
    ys = vs @ sys.c.T
    # time-major -> scenario-major, matching batched_nse_closed_loop
    return (
        jnp.swapaxes(vs, 0, 1),
        jnp.swapaxes(us, 0, 1),
        jnp.swapaxes(ys, 0, 1),
    )


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("saddle", "l1_pack", "fv", "fp", "vbar", "rhs_half"),
    meta_fields=("dt",),
)
@dataclass(frozen=True)
class NSEMatfreeStepCache:
    """Matrix-free IMEX step cache — the config-3+ rollout path where
    the (n+np)^2 saddle factor of NSEStepCache no longer fits
    (SURVEY.md SS3.4 step contract at large n).

    saddle: single-coefficient SaddleMatfreeCache of
        [[M/dt - theta (A_stokes - L1), J^T], [J, 0]] (block-Jacobi +
        pressure-Schur FGMRES over SpMM, solvers/matfree.py; theta = 1
        Euler, 1/2 trapezoid);
    l1_pack: implicitly-treated convection as a sparse pack (ELL /
        windowed — NEVER densified: (n, n) dense L1 is ~1 GB at 15k);
    rhs_half: None (Euler) or the (A_stokes - L1)/2 sparse pack applied
        on the rhs each CNAB2 step.
    """

    saddle: object  # SaddleMatfreeCache
    l1_pack: object  # ELL, (n, n)
    fv: jax.Array
    fp: jax.Array
    vbar: jax.Array
    rhs_half: object  # ELL pack or None
    dt: float


def build_nse_stepper_matfree(
    np_ops: dict,
    cond,
    dt: float,
    dtype=jnp.float32,
    scheme: str = "oseen",
    block: int = 512,
    m_krylov: int = 30,
    max_cycles: int = 8,
    tol: float = 1e-6,
) -> NSEMatfreeStepCache:
    """Host-side builder of the matrix-free IMEX step cache (scipy
    sparse only — no densification at any point)."""
    import numpy as np
    import scipy.sparse as sp

    from ..fem.taylor_hood import convection_matrices
    from ..ops.sparse import ell_from_scipy
    from ..solvers.matfree import SaddleMatfreeCache

    full = np_ops["full"]
    m_i = sp.csr_matrix(np_ops["M"])
    a_stokes_i = sp.csr_matrix(cond.mat_inner(full["A"]))
    j_i = sp.csr_matrix(np_ops["J"])

    if scheme in ("oseen", "oseen-cn"):
        l1, _ = convection_matrices(full, np_ops["vbar_full"])
        l1_i = sp.csr_matrix(cond.mat_inner(l1))
    elif scheme == "explicit":
        l1_i = sp.csr_matrix(m_i.shape)
    else:
        raise ValueError(f"unknown IMEX scheme: {scheme}")

    # F = M/dt - theta (A_stokes - L1): mass coefficient +1/dt (this
    # flips the Schur sign relative to the ADI pencils — handled by
    # the signed schur_coeffs in SaddleMatfreeCache).
    theta = 0.5 if scheme == "oseen-cn" else 1.0
    lin = (a_stokes_i - l1_i).tocsr()
    saddle = SaddleMatfreeCache.build(
        (-theta * lin).tocsr(), m_i, j_i, [1.0 / dt],
        dtype=dtype, block=block, m_krylov=m_krylov,
        max_cycles=max_cycles, tol=tol,
    )
    return NSEMatfreeStepCache(
        saddle=saddle,
        l1_pack=ell_from_scipy(l1_i, pad_to=8, dtype=np.dtype(dtype)),
        fv=jnp.asarray(cond.mat_bc_rhs(full["A"]), dtype),
        fp=jnp.asarray(cond.jmat_bc_rhs(full["J"]), dtype),
        vbar=jnp.asarray(cond.restrict(np_ops["vbar_full"]), dtype),
        rhs_half=(
            ell_from_scipy(
                (0.5 * lin).tocsr(), pad_to=8, dtype=np.dtype(dtype)
            )
            if scheme == "oseen-cn" else None
        ),
        dt=float(dt),
    )


@partial(jax.jit, static_argnames=("passes",))
def _ns_refine_dense(x, big_d, passes: int):
    """Newton-Schulz inverse refinement: X <- X (2I - A X), `passes`
    times, all dense GEMMs. Quadratic: r_k = ||I - A X_k||_2
    satisfies r_k = r_{k-1}^2, so convergence needs r_0 < 1."""

    def body(x, _):
        ax = big_d @ x  # spelled 2X - X(AX): exactly two (N, N) GEMMs
        return 2.0 * x - x @ ax, None

    x, _ = jax.lax.scan(body, x, None, length=passes)
    return x


@jax.jit
def _inv_residual_probe(x, big_d, key):
    """max_j ||v_j - A (X v_j)|| / ||v_j|| over 4 random probes — an
    O(N^2) spectral-radius estimate of ||I - A X||."""
    n = x.shape[0]
    v = jax.random.normal(key, (n, 4), x.dtype)
    r = v - big_d @ (x @ v)
    return jnp.max(
        jnp.linalg.norm(r, axis=0) / jnp.linalg.norm(v, axis=0)
    )


def build_sweep_steppers_ns_chain(
    setups: list,
    dt: float,
    dtype=jnp.float32,
    conv=None,
    scheme: str = "oseen",
    ns_passes: int = 4,
    seed_passes: int = 2,
    certify_tol: float = 1e-4,
):
    """Config-5 stepper tier (VERDICT r4 item 7): per-bucket explicit
    saddle inverses WITHOUT per-bucket dense transfers — one bf16 seed
    inverse shipped once + an on-device Newton-Schulz chain across the
    Re buckets.

    A per-bucket host build ships ~0.1 GB of f64 inverse + dense L1
    per bucket to the device. Measured feasibility on the cylinder-ref1
    bucket family (Re 60..150, 8 buckets, this repo's operators):
    rho(I - A_r X_{r-1}) is 0.093..0.14 between ADJACENT buckets and
    1.3e-2 for a bf16-cast same-bucket inverse, so Newton-Schulz
    (quadratic: rho -> rho^2 per pass) reaches ~7e-7 in 3-4 passes /
    ~3e-8 in 2 seed passes. Per-bucket device work is 2 dense GEMMs a
    pass (~0.5 TFLOP at n+np ~ 5k); the only bulk transfer is the
    single bf16 seed (~50 MB).

    L1(vbar_r) is computed ON DEVICE from the shared convection tensor
    (ConvKernel.linearized_dense — same mesh across buckets) instead of
    shipping a dense (n, n) matrix per bucket.

    setups: list of (np_ops, sys64, cond) (models/cylinder at each Re,
    shared geometry). conv: a ConvKernel built on the shared geometry;
    required (supplies the device re-linearization).
    Returns (steppers, residuals): list[NSEStepCache] with
    SaddleInverse solvers and the certified per-bucket inverse
    residuals (asserted < certify_tol).
    """
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from ..ops.sparse import ell_from_scipy
    from ..solvers.saddle import SaddleInverse

    if scheme != "oseen":
        raise ValueError("ns_chain tier supports the oseen scheme only")
    if conv is None:
        raise ValueError("ns_chain tier needs the shared ConvKernel")

    np_ops0, _, cond0 = setups[0]
    n = np_ops0["M"].shape[0]
    n_p = np_ops0["J"].shape[0]
    big_n = n + n_p
    free = np.asarray(cond0.free)
    free_d = jnp.asarray(free, jnp.int32)

    def assemble_big(np_ops, cond, l1_sp):
        m_sp = sp.csr_matrix(np_ops["M"])
        a_sp = sp.csr_matrix(cond.mat_inner(np_ops["full"]["A"]))
        j_sp = sp.csr_matrix(np_ops["J"])
        return sp.bmat(
            [[m_sp / dt - a_sp + l1_sp, j_sp.T], [j_sp, None]],
            format="csr",
        )

    def l1_device(np_ops):
        """(n, n) implicit convection block, assembled on device."""
        vbar_full = jnp.asarray(np_ops["vbar_full"], dtype)
        l1_full = conv.linearized_dense(vbar_full, include_l2=False)
        return l1_full[free_d][:, free_d]

    from ..fem.taylor_hood import convection_matrices

    import sys as _sys
    import time as _time

    def _log(m):
        print(m, file=_sys.stderr, flush=True)

    steppers = []
    residuals = []
    key = jax.random.PRNGKey(0)
    x_prev = None
    for r, (np_ops, _sys64, cond) in enumerate(setups):
        t_b0 = _time.time()
        l1_sp, _ = convection_matrices(
            np_ops["full"], np_ops["vbar_full"]
        )
        l1_sp = sp.csr_matrix(cond.mat_inner(l1_sp))
        big_sp = assemble_big(np_ops, cond, l1_sp)
        big_ell = ell_from_scipy(big_sp, pad_to=8, dtype=np.float32)
        big_d = big_ell.todense().astype(dtype)  # densified ON device
        t_asm = _time.time() - t_b0

        if r == 0:
            # Seed: host f64 sparse-LU inverse, shipped ONCE as bf16
            # (half the bytes of f32; the cast error rho ~1e-2 is
            # repaired by `seed_passes` NS passes on device).
            inv0 = spla.splu(big_sp.tocsc()).solve(np.eye(big_n))
            x = jnp.asarray(inv0.astype(np.float32), jnp.bfloat16)
            x = _ns_refine_dense(x.astype(dtype), big_d, seed_passes)
        else:
            x = _ns_refine_dense(x_prev, big_d, ns_passes)
        t_ns = _time.time() - t_b0 - t_asm
        key, sub = jax.random.split(key)
        res = float(_inv_residual_probe(x, big_d, sub))
        assert res < certify_tol, (
            f"NS chain failed to certify bucket {r}: "
            f"residual {res:.3e} >= {certify_tol:.1e}"
        )
        residuals.append(res)
        x_prev = x
        del big_d

        t_l1 = _time.time()
        steppers.append(NSEStepCache(
            lu=SaddleInverse(x, n),
            l1_imp=l1_device(np_ops).astype(dtype),
            fv=jnp.asarray(cond.mat_bc_rhs(np_ops["full"]["A"]), dtype),
            fp=jnp.asarray(cond.jmat_bc_rhs(np_ops["full"]["J"]), dtype),
            vbar=jnp.asarray(
                cond.restrict(np_ops["vbar_full"]), dtype
            ),
            rhs_half=None,
        ))
        jax.block_until_ready(steppers[-1].l1_imp)
        _log(
            f"  [ns-chain] bucket {r}: assemble {t_asm:.1f}s, "
            f"ns+probe {t_ns + (t_l1 - t_b0 - t_asm - t_ns):.1f}s, "
            f"l1_device {_time.time() - t_l1:.1f}s, res {res:.1e}"
        )
    return steppers, residuals


@partial(jax.jit, static_argnames=("feedback",))
def batched_nse_closed_loop_matfree(
    sys,
    conv: ConvKernel,
    cache: NSEMatfreeStepCache,
    ks: jax.Array,
    ws: jax.Array,
    v0_batch: jax.Array,
    alpha: float,
    feedback: str = "explicit",
):
    """Matrix-free batched closed loop: lax.scan over time, the WHOLE
    scenario batch solved as the FGMRES column block of one saddle
    solve per step (the Krylov recurrences are column-batched, so S
    scenarios cost the same matvec count as one), warm-started from the
    previous step's (v, p). Same (vs, us, ys) contract as
    batched_nse_closed_loop."""
    bt = sys.b.T
    vbar = cache.vbar
    dt = cache.dt
    n, n_p = cache.saddle.n, cache.saddle.n_p
    s_batch = v0_batch.shape[0]
    dtype = v0_batch.dtype
    fp_cols = jnp.broadcast_to(cache.fp[:, None], (n_p, s_batch))
    cn = cache.rhs_half is not None

    def q_of(v):
        # explicit quadratic remainder, batch-first (S, n)
        return conv.conv_inner_batch(v) - cache.l1_pack.matmat(v.T).T

    def rhs_cols(v, u, q, q_prev):
        # v (S, n), u (S, m) -> (n, S) momentum rhs columns
        r = sys.mass.matmat(v.T) / dt + sys.b @ u.T - cache.fv[:, None]
        if cn:
            r = (
                r + cache.rhs_half.matmat(v.T)
                - (1.5 * q - 0.5 * q_prev).T
            )
        else:
            r = r - q.T
        return r

    if feedback == "implicit":
        gmat = cache.saddle.apply(
            sys.b, jnp.zeros((n_p, sys.m_in), dtype)
        )  # (n, m), constant across steps
        eye_m = jnp.eye(sys.m_in, dtype=dtype)

        def step(carry, inp):
            v, q_prev, v_prev_sol, p_prev_sol = carry
            k_gain, w_k = inp
            uff = (bt @ w_k) / alpha + k_gain @ vbar  # (m,)
            u_cols = jnp.broadcast_to(
                uff[:, None], (sys.m_in, s_batch)
            ).T
            q = q_of(v)
            x0_sol, p_sol = cache.saddle.apply_full(
                rhs_cols(v, u_cols, q, q_prev), fp_cols,
                x0=(v_prev_sol, p_prev_sol),
            )
            s_small = eye_m + k_gain @ gmat
            corr = jnp.linalg.solve(s_small, k_gain @ x0_sol)
            v_next_cols = x0_sol - gmat @ corr
            v_next = v_next_cols.T
            u = -(v_next - vbar) @ k_gain.T + (bt @ w_k) / alpha
            return (v_next, q, v_next_cols, p_sol), (v_next, u)

    else:

        def step(carry, inp):
            v, q_prev, v_prev_sol, p_prev_sol = carry
            k_gain, w_k = inp
            u = -(v - vbar) @ k_gain.T + (bt @ w_k) / alpha
            q = q_of(v)
            v_next_cols, p_sol = cache.saddle.apply_full(
                rhs_cols(v, u, q, q_prev), fp_cols,
                x0=(v_prev_sol, p_prev_sol),
            )
            v_next = v_next_cols.T
            return (v_next, q, v_next_cols, p_sol), (v_next, u)

    init = (
        v0_batch,
        q_of(v0_batch),
        v0_batch.T,
        jnp.zeros((n_p, s_batch), dtype),
    )
    _, (vs_tail, us) = jax.lax.scan(step, init, (ks[:-1], ws[:-1]))
    vs = jnp.concatenate([v0_batch[None], vs_tail], axis=0)
    ys = vs @ sys.c.T
    return (
        jnp.swapaxes(vs, 0, 1),
        jnp.swapaxes(us, 0, 1),
        jnp.swapaxes(ys, 0, 1),
    )


def build_nse_step_cache(
    m_dense: jax.Array,
    a_stokes_dense: jax.Array,
    j_dense: jax.Array,
    dt: float,
) -> SaddleLU:
    """Explicit-scheme saddle LU (legacy entry; prefer build_nse_stepper)."""
    return SaddleLU.build(m_dense / dt - a_stokes_dense, j_dense)


@partial(jax.jit, static_argnames=("feedback",))
def nse_closed_loop_rollout(
    sys,
    conv: ConvKernel,
    cache: NSEStepCache,
    ks: jax.Array,
    ws: jax.Array,
    v0: jax.Array,
    alpha: float,
    dt: float,
    feedback: str = "explicit",
):
    """Nonlinear closed loop; returns (vs, us, ys).

    sys: DAESystem whose stiff is the LINEARIZED operator (for gains);
    mass/b/c are shared with the nonlinear plant.
    ks: (nts+1, m, n); ws: (nts+1, n) feedforward states; v0: (n,).

    feedback='explicit': u_k from the current state v_k.
    feedback='implicit': u_k = -K_k (v_{k+1} - vbar) + ff, with B K_k
    folded into the implicit solve via SMW on the cached saddle LU —
    required when the closed-loop poles exceed 1/dt (cheap control);
    G = lu^-1 B is constant so the extra cost is one (m, m) solve/step.

    A cache built with scheme='oseen-cn' (rhs_half present) runs the
    CNAB2 trapezoid: rhs gains + (A_stokes - L1)/2 v and the quadratic
    remainder q(v) = N(v)v - L1 v extrapolates Adams-Bashforth-2
    (1.5 q_k - 0.5 q_{k-1}; first step CNAB1), second order overall.
    """
    bt = sys.b.T
    vbar = cache.vbar
    cn = cache.rhs_half is not None

    def q_of(v):
        return conv.conv_inner(v) - cache.l1_imp @ v

    def rhs_base(v, q, q_prev):
        r = sys.mass.matvec(v) / dt - cache.fv
        if cn:
            r = r + cache.rhs_half @ v - (1.5 * q - 0.5 * q_prev)
        else:
            r = r - q
        return r

    if feedback == "implicit":
        n_p = cache.fp.shape[0]
        gmat = cache.lu.apply(
            sys.b, jnp.zeros((n_p, sys.m_in), sys.b.dtype)
        )  # (n, m), constant across steps
        eye_m = jnp.eye(sys.m_in, dtype=sys.b.dtype)

        def step(carry, inp):
            v, q_prev = carry
            k_gain, w_k = inp
            uff = (bt @ w_k) / alpha + k_gain @ vbar
            q = q_of(v)
            rhs_v = rhs_base(v, q, q_prev) + sys.b @ uff
            x0 = cache.lu.apply(rhs_v, cache.fp)
            s_small = eye_m + k_gain @ gmat
            corr = jnp.linalg.solve(s_small, k_gain @ x0)
            v_next = x0 - gmat @ corr
            u = -(k_gain @ (v_next - vbar)) + (bt @ w_k) / alpha
            return (v_next, q), (v_next, u)

    else:

        def step(carry, inp):
            v, q_prev = carry
            k_gain, w_k = inp
            u = -(k_gain @ (v - vbar)) + (bt @ w_k) / alpha
            q = q_of(v)
            rhs_v = rhs_base(v, q, q_prev) + sys.b @ u
            v_next = cache.lu.apply(rhs_v, cache.fp)
            return (v_next, q), (v_next, u)

    q0 = q_of(v0)  # AB2 seed: q_{-1} := q_0 (first step = CNAB1)
    _, (vs_tail, us) = jax.lax.scan(step, (v0, q0), (ks[:-1], ws[:-1]))
    vs = jnp.concatenate([v0[None], vs_tail], axis=0)
    ys = vs @ sys.c.T
    return vs, us, ys


def batched_nse_closed_loop(
    sys,
    conv: ConvKernel,
    cache: NSEStepCache,
    ks: jax.Array,
    ws: jax.Array,
    v0_batch: jax.Array,
    alpha: float,
    dt: float,
    feedback: str = "explicit",
):
    """vmap over scenario initial states v0_batch (S, n).

    An NSEFusedCache dispatches to the fused time-major scan
    (batched_nse_closed_loop_fused) — same return contract. The fused
    cache bakes dt into pmat/c0 at build time, so the passed dt must
    match the build dt (checked here: silent mismatch = wrong dynamics).
    """
    if isinstance(cache, (NSEFusedCache, NSEMatfreeStepCache)):
        if abs(cache.dt - dt) > 1e-12 * max(abs(dt), 1e-30):
            raise ValueError(
                f"dt={dt} disagrees with {type(cache).__name__} build "
                f"dt={cache.dt}; rebuild the cache for this dt"
            )
        dispatch = (
            batched_nse_closed_loop_fused
            if isinstance(cache, NSEFusedCache)
            else batched_nse_closed_loop_matfree
        )
        return dispatch(
            sys, conv, cache, ks, ws, v0_batch, alpha, feedback
        )
    return jax.vmap(
        lambda v0: nse_closed_loop_rollout(
            sys, conv, cache, ks, ws, v0, alpha, dt, feedback
        )
    )(v0_batch)


@partial(jax.jit, static_argnames=("nts", "feedback"))
def nse_closed_loop_outputs(
    sys,
    conv: ConvKernel,
    cache: NSEStepCache,
    k_gain: jax.Array,
    v0: jax.Array,
    alpha: float,
    dt: float,
    nts: int,
    feedback: str = "implicit",
):
    """Memory-lean rollout: constant gain, returns (ys (nts+1, p),
    u_norms (nts,), v_final) WITHOUT storing the state trajectory —
    the sweep-scale kernel (8192 scenarios x long horizons would not
    fit (S, nts, n) in HBM). Honors the cache's scheme (CNAB2 when
    rhs_half is present, backward Euler otherwise).
    """
    vbar = cache.vbar
    cn = cache.rhs_half is not None

    def q_of(v):
        return conv.conv_inner(v) - cache.l1_imp @ v

    def rhs_base(v, q, q_prev):
        r = sys.mass.matvec(v) / dt - cache.fv
        if cn:
            r = r + cache.rhs_half @ v - (1.5 * q - 0.5 * q_prev)
        else:
            r = r - q
        return r

    if feedback == "implicit":
        n_p = cache.fp.shape[0]
        gmat = cache.lu.apply(
            sys.b, jnp.zeros((n_p, sys.m_in), sys.b.dtype)
        )
        eye_m = jnp.eye(sys.m_in, dtype=sys.b.dtype)

        def step(carry, _):
            v, q_prev = carry
            uff = k_gain @ vbar
            q = q_of(v)
            rhs_v = rhs_base(v, q, q_prev) + sys.b @ uff
            x0 = cache.lu.apply(rhs_v, cache.fp)
            corr = jnp.linalg.solve(eye_m + k_gain @ gmat, k_gain @ x0)
            v_next = x0 - gmat @ corr
            u = -(k_gain @ (v_next - vbar))
            return (v_next, q), (sys.c @ v_next, jnp.sum(u * u))

    else:

        def step(carry, _):
            v, q_prev = carry
            u = -(k_gain @ (v - vbar))
            q = q_of(v)
            rhs_v = rhs_base(v, q, q_prev) + sys.b @ u
            v_next = cache.lu.apply(rhs_v, cache.fp)
            return (v_next, q), (sys.c @ v_next, jnp.sum(u * u))

    (v_final, _), (ys_tail, u_sq) = jax.lax.scan(
        step, (v0, q_of(v0)), None, length=nts
    )
    ys = jnp.concatenate([(sys.c @ v0)[None], ys_tail], axis=0)
    return ys, u_sq, v_final


def nse_sweep_outputs(
    sys,
    conv: ConvKernel,
    cache_stack: NSEStepCache,
    ks: jax.Array,
    v0: jax.Array,
    alpha: float,
    dt: float,
    nts: int,
    feedback: str = "implicit",
):
    """Batched config-5 sweep rollout: R buckets x S scenarios in ONE
    time scan. The shared convection runs on the FLATTENED (R*S, n)
    batch through the production batch kernel;
    per-bucket operators are (R,)-batched GEMMs. The earlier
    per-scenario double-vmap of nse_closed_loop_outputs materialized
    (nt, 6, 6, R, S) XLA convection intermediates — 38.7 GB at the
    8-bucket x 1024-scenario spec scale, an HBM OOM at compile.

    cache_stack: NSEStepCache with every leaf stacked on a leading R
    axis (build_sweep_gains_and_caches). ks (R, m, n), v0 (R, S, n).
    Memory-lean like nse_closed_loop_outputs: no state trajectory is
    kept. Returns (ys (R, S, nts+1, p), u_sq (R, S, nts),
    v_final (R, S, n)).
    """
    r_b, s_b, n = v0.shape
    m_in = sys.m_in
    n_p = cache_stack.fp.shape[-1]
    vbar = cache_stack.vbar  # (R, n)
    cn = cache_stack.rhs_half is not None

    def conv_flat(v):
        return conv.conv_inner_batch(
            v.reshape(r_b * s_b, n)
        ).reshape(r_b, s_b, n)

    def mass_flat(v):
        return sys.mass.matmat(
            v.reshape(r_b * s_b, n).T
        ).T.reshape(r_b, s_b, n)

    def q_of(v):
        return conv_flat(v) - jnp.einsum(
            "rij,rsj->rsi", cache_stack.l1_imp, v
        )

    def rhs_base(v, q, q_prev):
        r = mass_flat(v) / dt - cache_stack.fv[:, None, :]
        if cn:
            r = r + jnp.einsum(
                "rij,rsj->rsi", cache_stack.rhs_half, v
            ) - (1.5 * q - 0.5 * q_prev)
        else:
            r = r - q
        return r

    apply_r = jax.vmap(lambda lu, rv, fp: lu.apply(rv, fp))
    fp_cols = jnp.broadcast_to(
        cache_stack.fp[:, :, None], (r_b, n_p, s_b)
    )

    def solve(rhs):  # (R, S, n) -> (R, S, n)
        out = apply_r(
            cache_stack.lu, jnp.swapaxes(rhs, 1, 2), fp_cols
        )
        return jnp.swapaxes(out, 1, 2)

    def outputs(v):
        return jnp.einsum("pn,rsn->rsp", sys.c, v)

    if feedback == "implicit":
        gmat = apply_r(
            cache_stack.lu,
            jnp.broadcast_to(sys.b[None], (r_b, n, m_in)),
            jnp.zeros((r_b, n_p, m_in), sys.b.dtype),
        )  # (R, n, m)
        s_mat = jnp.eye(m_in, dtype=sys.b.dtype)[None] + jnp.einsum(
            "rmn,rnk->rmk", ks, gmat
        )  # (R, m, m)
        uff = jnp.einsum("rmn,rn->rm", ks, vbar)  # (R, m)
        buff = jnp.einsum("nm,rm->rn", sys.b, uff)  # (R, n)

        def step(carry, _):
            v, q_prev = carry
            q = q_of(v)
            rhs_v = rhs_base(v, q, q_prev) + buff[:, None, :]
            x0 = solve(rhs_v)
            kx0 = jnp.einsum("rmn,rsn->rsm", ks, x0)
            corr = jnp.linalg.solve(
                s_mat[:, None], kx0[..., None]
            )[..., 0]  # (R, S, m)
            v_next = x0 - jnp.einsum("rnm,rsm->rsn", gmat, corr)
            u = -jnp.einsum(
                "rmn,rsn->rsm", ks, v_next - vbar[:, None, :]
            )
            return (v_next, q), (outputs(v_next), jnp.sum(u * u, -1))

    else:

        def step(carry, _):
            v, q_prev = carry
            u = -jnp.einsum(
                "rmn,rsn->rsm", ks, v - vbar[:, None, :]
            )
            q = q_of(v)
            rhs_v = rhs_base(v, q, q_prev) + jnp.einsum(
                "nm,rsm->rsn", sys.b, u
            )
            v_next = solve(rhs_v)
            return (v_next, q), (outputs(v_next), jnp.sum(u * u, -1))

    (v_final, _), (ys_tail, u_sq) = jax.lax.scan(
        step, (v0, q_of(v0)), None, length=nts
    )
    ys = jnp.concatenate(
        [outputs(v0)[:, :, None, :], jnp.moveaxis(ys_tail, 0, 2)],
        axis=2,
    )
    return ys, jnp.moveaxis(u_sq, 0, 2), v_final
