"""Device-built dense saddle inverse stacks via Newton-Schulz ladders.

The one-GEMM-per-solve ADI tier applies a dense (n, n) velocity-block
inverse per shifted saddle pencil as ONE GEMM (solvers/saddle.py
SaddleShiftedInverseCache). The host can build those inverses (splu +
solve-against-identity) and copy them to the device; this module
instead builds the whole stack ON DEVICE from the sparse operator
packs, so no host factorization and no bulk transfer is needed. It
rests on three facts, checked on this repo's cylinder operators:

  1. Newton-Schulz (X <- X (2I - A X)) converges quadratically
     whenever rho = ||I - A X_0||_2 < 1, and one pass is just two
     GEMMs.
  2. Adjacent shifted saddles differ only by (s_i - s_j) M, so an
     inverse at one shift seeds the next: measured rho 0.14-0.19
     between adjacent Wachspress shifts at the bench schedule
     (3 passes to ~5e-6), and a geometric synthetic-rung ladder keeps
     rho bounded for arbitrary shift gaps.
  3. At a large enough synthetic shift s_huge the pencil is
     mass-dominated, and [[sM, J^T], [J, 0]]^{-1} has a closed block
     form in M^{-1} and the pressure Schur complement — both cheap on
     device (M is SPD and diag-scaled-well-conditioned, so M^{-1} is
     itself a short NS iteration; the (np, np) Schur inverse is a
     small dense solve).

The result: zero host factorization, zero bulk transfer, and the dense
ADI tier extended to config-3 scale (n = 15,316: the 12-shift stack is
~11 GB of f32 velocity blocks).

Reference parity: replaces SaddleShiftedInverseCache.build_sparse_host
(the reference's splu-per-shift setup, SURVEY.md SS3.3) with identical
output contract; the per-shift inverse quality is certified in-run by
residual probes.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np



@partial(
    jax.tree_util.register_dataclass,
    data_fields=("at_pack", "m_pack", "j_pack", "jt_pack", "m_diag"),
    meta_fields=("n", "n_p"),
)
@dataclass(frozen=True)
class SaddleOpsPack:
    """Sparse device packs of one saddle pencil family
    [[At + s M, J^T], [J, 0]] (RCM-permuted ordering)."""

    at_pack: object
    m_pack: object
    j_pack: object
    jt_pack: object
    m_diag: jax.Array  # (n,)
    n: int
    n_p: int

    @staticmethod
    def build(at_sp, m_sp, j_sp, dtype=jnp.float32):
        """Host-side packing (scipy) in a bandwidth-reducing RCM
        ordering; returns (pack, perm, iperm, p_perm, p_iperm)."""
        import scipy.sparse as sp

        from ..ops.sparse import (
            ell_from_scipy,
            rcm_permutation,
            sort_rows_by_window,
        )

        def pack_op(a):
            return ell_from_scipy(a, pad_to=8, dtype=np.dtype(dtype))

        at = sp.csr_matrix(at_sp)
        m = sp.csr_matrix(m_sp)
        j = sp.csr_matrix(j_sp)
        perm = rcm_permutation(m, at)
        iperm = np.argsort(perm)
        at_r = at[perm][:, perm].tocsr()
        m_r = m[perm][:, perm].tocsr()
        j_c = j[:, perm].tocsr()
        p_perm = sort_rows_by_window(j_c)
        p_iperm = np.argsort(p_perm)
        j_r = j_c[p_perm].tocsr()
        pack = SaddleOpsPack(
            at_pack=pack_op(at_r),
            m_pack=pack_op(m_r),
            j_pack=pack_op(j_r),
            jt_pack=pack_op(j_r.T.tocsr()),
            m_diag=jnp.asarray(m_r.diagonal(), dtype),
            n=at.shape[0],
            n_p=j.shape[0],
        )
        return pack, perm, iperm, p_perm, p_iperm


@jax.jit
def _apply_big(pack: SaddleOpsPack, s, x):
    """[[At + s M, J^T], [J, 0]] @ X for X (n+np, q)."""
    n = pack.n
    xv, xp = x[:n], x[n:]
    top = (
        pack.at_pack @ xv
        + s * (pack.m_pack @ xv)
        + pack.jt_pack @ xp
    )
    return jnp.concatenate([top, pack.j_pack @ xv], axis=0)


@jax.jit
def _ns_pass_saddle(pack: SaddleOpsPack, s, x):
    """One Newton-Schulz pass against the EXACT sparse pencil:
    X <- 2X - X (A(s) X). Two big ops: one sparse apply over n+np
    columns, one dense (N, N) GEMM."""
    ax = _apply_big(pack, s, x)
    return 2.0 * x - x @ ax


@jax.jit
def _residual_probe(pack: SaddleOpsPack, s, x, key):
    """max over 8 random probes of ||v - A(s) (X v)|| / ||v||."""
    nn = x.shape[0]
    v = jax.random.normal(key, (nn, 8), x.dtype)
    r = v - _apply_big(pack, s, x @ v)
    return jnp.max(
        jnp.linalg.norm(r, axis=0) / jnp.linalg.norm(v, axis=0)
    )


@partial(jax.jit, static_argnames=("iters",))
def _lambda_max_dinv_m(pack: SaddleOpsPack, key, iters: int = 24):
    """lambda_max of diag(M)^-1 M by power iteration (device)."""
    v = jax.random.normal(key, (pack.n, 1), pack.m_diag.dtype)

    def body(i, carry):
        v, lam = carry
        w = (pack.m_pack @ v) / pack.m_diag[:, None]
        lam = jnp.linalg.norm(w)
        return w / jnp.maximum(lam, 1e-30), lam

    v, lam = jax.lax.fori_loop(0, iters, body, (v, jnp.asarray(1.0)))
    return lam


@partial(jax.jit, static_argnames=("iters",))
def _lambda_max_minv_pencil(pack: SaddleOpsPack, minv, s_ref, key,
                            iters: int = 24):
    """lambda_max of M^-1 (At + s_ref M) by power iteration — sizes
    the mass-dominated synthetic seed shift s_huge."""
    v = jax.random.normal(key, (pack.n, 1), minv.dtype)

    def body(i, carry):
        v, lam = carry
        w = minv @ (
            pack.at_pack @ v + s_ref * (pack.m_pack @ v)
        )
        lam = jnp.linalg.norm(w)
        return w / jnp.maximum(lam, 1e-30), lam

    v, lam = jax.lax.fori_loop(0, iters, body, (v, jnp.asarray(1.0)))
    return lam


@jax.jit
def _minv_ns_pass(pack: SaddleOpsPack, x):
    """X <- 2X - X (M X): Newton-Schulz for the SPD mass inverse."""
    mx = pack.m_pack @ x
    return 2.0 * x - x @ mx


@jax.jit
def _minv_residual(pack: SaddleOpsPack, x, key):
    v = jax.random.normal(key, (pack.n, 8), x.dtype)
    r = v - pack.m_pack @ (x @ v)
    return jnp.max(
        jnp.linalg.norm(r, axis=0) / jnp.linalg.norm(v, axis=0)
    )


@partial(jax.jit, donate_argnums=(0,))
def _store_full_block(stack, x, i):
    """stack[i] <- x (full permuted saddle inverse), in place."""
    return jax.lax.dynamic_update_index_in_dim(stack, x, i, 0)


@partial(jax.jit, donate_argnums=(0,))
def _store_vv_block(stack, x, iperm, i):
    """stack[i] <- velocity block of x, back-permuted to the original
    dof order. The stack buffer is DONATED so XLA updates it in place:
    at config-3 scale the stack is ~7.5 GB, and a jnp.stack at the end
    would hold a second copy."""
    n = stack.shape[1]
    blk = x[:n, :n][iperm][:, iperm]
    return jax.lax.dynamic_update_index_in_dim(stack, blk, i, 0)


@jax.jit
def _seed_block_inverse(pack: SaddleOpsPack, minv, sp_inv, s_huge):
    """Closed-form [[s M, J^T],[J, 0]]^-1 from M^-1 and the pressure
    Schur inverse S_p^-1 = (J M^-1 J^T)^-1:

      X_vv = (1/s)(M^-1 - M^-1 J^T S_p^-1 J M^-1)
      X_vp = M^-1 J^T S_p^-1,  X_pv = S_p^-1 J M^-1,  X_pp = -s S_p^-1
    """
    n, n_p = pack.n, pack.n_p
    nn = n + n_p
    jm = pack.j_pack @ minv  # (np, n) = J M^-1
    mjt = jm.T  # M^-1 J^T (M^-1 symmetric to NS accuracy)
    x = jnp.zeros((nn, nn), minv.dtype)
    x = x.at[:n, :n].set((minv - mjt @ (sp_inv @ jm)) / s_huge)
    x = x.at[:n, n:].set(mjt @ sp_inv)
    x = x.at[n:, :n].set(sp_inv @ jm)
    x = x.at[n:, n:].set(-s_huge * sp_inv)
    return x


def build_inverse_stack_ns(
    at_sp,
    m_sp,
    j_sp,
    sig,
    dtype=jnp.float32,
    rung_ratio: float = 1.6,
    passes_per_rung: int = 3,
    extra_passes_at_shift: int = 1,
    minv_tol: float = 1e-2,
    certify_tol: float = 5e-4,
    verbose=None,
    keep_full: bool = False,
):
    """Build the (J, n, n) shifted-saddle velocity-block inverse stack
    ON DEVICE. Same output contract as
    SaddleShiftedInverseCache.build_sparse_host (original dof order).

    Returns (inv_stack (J, n, n) device array, info dict with the
    certified per-shift residuals and ladder metadata).
    """
    import time

    log = verbose or (lambda *_: None)
    t_all = time.time()
    pack, perm, iperm, p_perm, p_iperm = SaddleOpsPack.build(
        at_sp, m_sp, j_sp, dtype=dtype
    )
    n, n_p = pack.n, pack.n_p
    nn = n + n_p
    key = jax.random.PRNGKey(17)

    # --- 1. M^-1 by Newton-Schulz from a scaled-diagonal seed ---
    key, k1, k2 = jax.random.split(key, 3)
    lam_dm = float(_lambda_max_dinv_m(pack, k1))
    omega = 1.0 / lam_dm
    minv = jnp.diag(omega / pack.m_diag)
    minv_passes = 0
    res_m = float(_minv_residual(pack, minv, k2))
    while res_m > minv_tol and minv_passes < 30:
        minv = _minv_ns_pass(pack, minv)
        minv_passes += 1
        if minv_passes % 4 == 0 or minv_passes > 20:
            key, kp = jax.random.split(key)
            res_m = float(_minv_residual(pack, minv, kp))
    log(f"  minv: lam_max(D^-1 M)={lam_dm:.2f}, {minv_passes} passes, "
        f"residual {res_m:.1e}")

    # --- 2. pressure Schur inverse (np x np dense). The (np, np)
    # inverse goes through the HOST in f64 (np <= ~2k: a ~17 MB round
    # trip); kept until an H100 measurement decides, ROADMAP design
    # item 1. ---
    jm = pack.j_pack @ minv
    jt_cols = pack.jt_pack @ jnp.eye(n_p, dtype=dtype)  # (n, np)
    schur = jm @ jt_cols
    sp_inv = jnp.asarray(
        np.linalg.inv(np.asarray(schur, np.float64)), dtype
    )

    # --- 3. mass-dominated synthetic seed ---
    sig_np = np.asarray(sig, np.float64)
    order = np.argsort(-np.abs(sig_np))
    s_sorted = sig_np[order]
    key, k3 = jax.random.split(key)
    lam_p = float(
        _lambda_max_minv_pencil(pack, minv, jnp.asarray(0.0, dtype), k3)
    )
    sign = float(np.sign(s_sorted[0]) or 1.0)
    s_huge = sign * max(10.0 * lam_p, 10.0 * abs(s_sorted[0]))
    x = _seed_block_inverse(
        pack, minv, sp_inv, jnp.asarray(s_huge, dtype)
    )
    del minv, jm, jt_cols, schur, sp_inv
    key, kp = jax.random.split(key)
    r_seed = float(
        _residual_probe(pack, jnp.asarray(s_huge, dtype), x, kp)
    )
    # Seed refinement at s_huge itself (fixes the approximate M^-1).
    seed_passes = 0
    while r_seed > 0.3 and seed_passes < 12:
        x = _ns_pass_saddle(pack, jnp.asarray(s_huge, dtype), x)
        seed_passes += 1
        key, kp = jax.random.split(key)
        r_seed = float(
            _residual_probe(pack, jnp.asarray(s_huge, dtype), x, kp)
        )
    log(f"  seed: s_huge={s_huge:.3e} (|M^-1 At| ~ {lam_p:.2e}), "
        f"{seed_passes} refine passes, residual {r_seed:.2e}")

    # --- 4. geometric ladder s_huge -> shifts, NS at every rung ---
    def rungs_between(s_from, s_to):
        """Geometric intermediate rungs keeping per-rung ratio
        <= rung_ratio (same sign; |s| decreasing)."""
        out = []
        cur = s_from
        while abs(cur) / abs(s_to) > rung_ratio:
            cur = cur / rung_ratio
            out.append(cur)
        out.append(s_to)
        return out

    inv_stack = jnp.zeros((len(sig_np), n, n), dtype)
    full_stack = (
        jnp.zeros((len(sig_np), nn, nn), dtype) if keep_full else None
    )
    residuals = [None] * len(sig_np)
    iperm_d = jnp.asarray(iperm.astype(np.int32))
    s_cur = s_huge
    n_rungs = 0
    for pos, s_target in zip(order, s_sorted):
        for s_r in rungs_between(s_cur, s_target):
            s_d = jnp.asarray(s_r, dtype)
            for _ in range(passes_per_rung):
                x = _ns_pass_saddle(pack, s_d, x)
            n_rungs += 1
            s_cur = s_r
        s_d = jnp.asarray(s_target, dtype)
        for _ in range(extra_passes_at_shift):
            x = _ns_pass_saddle(pack, s_d, x)
        key, kp = jax.random.split(key)
        res = float(_residual_probe(pack, s_d, x, kp))
        extra = 0
        while res > certify_tol and extra < 6:
            x = _ns_pass_saddle(pack, s_d, x)
            extra += 1
            key, kp = jax.random.split(key)
            res = float(_residual_probe(pack, s_d, x, kp))
        if res > 10 * certify_tol:
            raise RuntimeError(
                f"NS ladder failed to certify shift {s_target:.4e}: "
                f"residual {res:.3e} (certify_tol {certify_tol:.1e})"
            )
        residuals[pos] = res
        # velocity block, back to ORIGINAL ordering, written in place
        inv_stack = _store_vv_block(
            inv_stack, x, iperm_d, jnp.int32(pos)
        )
        if keep_full:
            full_stack = _store_full_block(
                full_stack, x, jnp.int32(pos)
            )
        log(f"  shift {s_target:12.2f}: residual {res:.2e} "
            f"(+{extra} extra passes)")
    jax.block_until_ready(inv_stack)
    info = {
        "residuals": residuals,
        "certify_tol": certify_tol,
        "s_huge": s_huge,
        "seed_residual": r_seed,
        "minv_passes": minv_passes,
        "ladder_rungs": n_rungs,
        "build_s": time.time() - t_all,
    }
    if keep_full:
        info["full_stack"] = full_stack
        info["pack"] = pack
        info["perm"] = perm
        info["iperm"] = iperm
        info["p_perm"] = p_perm
    return inv_stack, info


@partial(jax.jit, static_argnames=("passes",))
def _refresh_shift(pack: SaddleOpsPack, s, x_full, iperm, passes: int):
    """NS-refresh one shift's FULL inverse about refreshed operator
    values: `passes` Newton-Schulz passes from the previous inverse
    (re-linearization drift is a small operator perturbation —
    measured rho ~ O(1e-2..1e-1) per MPC macro step, so 2 passes
    reach the f32 floor). Returns (x_full_new, vv_block_original)."""
    for _ in range(passes):
        x_full = _ns_pass_saddle(pack, s, x_full)
    n = iperm.shape[0]
    vv = x_full[:n, :n][iperm][:, iperm]
    return x_full, vv


class NSShiftStack:
    """Receding-horizon helper: a device-resident stack of FULL
    shifted-saddle inverses that REFRESHES in place across MPC
    re-linearizations (2 NS passes per shift per macro) and exposes
    the dense-ADI cache view (SaddleShiftedInverseCache contract).

    Memory: keeps (J, n+np, n+np) full inverses (the NS iterates) plus
    the (J, n, n) velocity-block view — sized for config-4 scale
    (n ~ 4.4k: ~0.8 + 0.6 GB), NOT for config-3 (use
    build_inverse_stack_ns without keep_full there).
    """

    def __init__(self, at_sp, m_sp, j_sp, sig, dtype=jnp.float32,
                 certify_tol: float = 5e-4, verbose=None):
        inv_stack, info = build_inverse_stack_ns(
            at_sp, m_sp, j_sp, sig, dtype=dtype,
            certify_tol=certify_tol, verbose=verbose, keep_full=True,
        )
        self.sig = np.asarray(sig, np.float64)
        self.dtype = dtype
        self.vv = inv_stack
        self.full = info["full_stack"]
        self.pack = info["pack"]
        self.perm = info["perm"]
        self.iperm_d = jnp.asarray(info["iperm"].astype(np.int32))
        self.p_perm = info["p_perm"]
        self.residuals = info["residuals"]
        self.n = self.vv.shape[1]

    def cache(self):
        from .saddle import SaddleShiftedInverseCache

        return SaddleShiftedInverseCache(self.vv, self.n)

    def refresh(self, at_sp_new, passes: int = 2,
                certify: bool = False):
        """Value-refresh for a re-linearized operator (same pattern /
        orderings): repack at, then `passes` NS passes per shift from
        the previous inverses. Returns self (mutated)."""
        import dataclasses

        import scipy.sparse as sp

        from ..ops.sparse import ell_from_scipy

        at_r = sp.csr_matrix(at_sp_new)[self.perm][:, self.perm].tocsr()
        self.pack = dataclasses.replace(
            self.pack,
            at_pack=ell_from_scipy(
                at_r, pad_to=8, dtype=np.dtype(self.dtype)
            ),
        )
        key = jax.random.PRNGKey(3)
        for i, s in enumerate(self.sig):
            s_d = jnp.asarray(s, self.dtype)
            x_new, vv = _refresh_shift(
                self.pack, s_d,
                jax.lax.dynamic_index_in_dim(
                    self.full, i, keepdims=False
                ),
                self.iperm_d, passes,
            )
            self.full = _store_full_block(self.full, x_new, jnp.int32(i))
            self.vv = _store_full_block(self.vv, vv, jnp.int32(i))
            if certify:
                key, kp = jax.random.split(key)
                res = float(_residual_probe(
                    self.pack, s_d,
                    jax.lax.dynamic_index_in_dim(
                        self.full, i, keepdims=False
                    ),
                    kp,
                ))
                self.residuals[i] = res
        return self
