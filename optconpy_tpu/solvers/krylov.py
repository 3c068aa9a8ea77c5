"""Matrix-free Krylov solvers — the large-n path behind the LU contract.

The reference leans on exact sparse LU for every shifted/saddle solve
(SURVEY.md SS2 row 10); dense LU replaces that on the device for
moderate n, but caching one factorization PER ADI SHIFT stops fitting
in device memory at large n. Answer (SURVEY.md SS7 hard part 1):

  cache ONE dense factorization at a reference shift sigma_0 and solve
  every other shift (A^T + sigma_i M) x = b by GMRES preconditioned
  with it. The preconditioned operator is
      I + (sigma_i - sigma_0) (A^T + sigma_0 M)^{-1} M,
  a clustered low-departure-from-identity map, so a handful of
  iterations reach 1e-6 — each iteration is batched triangular solves
  + an SpMV, i.e. dense device work.

All loops are fixed-length lax.scan / fori_loop (static shapes); RHS
blocks (n, q) are solved column-batched — the Krylov recurrences here
are blockwise with per-column scalars, so a (n, q) solve costs the
same matvec count as one column.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp


def _dotcols(a: jax.Array, b: jax.Array) -> jax.Array:
    """Per-column inner products of (n, q) blocks: returns (q,)."""
    return jnp.einsum("nq,nq->q", a, b)


def cg(
    matvec,
    b: jax.Array,
    x0: jax.Array | None = None,
    n_iter: int = 50,
    precond=None,
):
    """Conjugate gradients for SPD systems; column-batched RHS.

    b: (n,) or (n, q). Fixed iteration count (jit-static); stagnated
    columns stop updating through the rho-guard (no NaNs).
    Returns (x, final residual norms (q,)).
    """
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    x = jnp.zeros_like(b) if x0 is None else (x0[:, None] if squeeze else x0)
    pc = precond or (lambda v: v)

    r = b - matvec(x)
    z = pc(r)
    p = z
    rz = _dotcols(r, z)
    eps = jnp.asarray(1e-30, b.dtype)

    def body(carry, _):
        x, r, p, rz = carry
        ap = matvec(p)
        denom = _dotcols(p, ap)
        alpha = jnp.where(jnp.abs(denom) > eps, rz / denom, 0.0)
        x = x + alpha[None, :] * p
        r = r - alpha[None, :] * ap
        z = pc(r)
        rz_new = _dotcols(r, z)
        beta = jnp.where(jnp.abs(rz) > eps, rz_new / rz, 0.0)
        p = z + beta[None, :] * p
        return (x, r, p, rz_new), None

    (x, r, _, _), _ = jax.lax.scan(body, (x, r, p, rz), None, length=n_iter)
    res = jnp.sqrt(_dotcols(r, r))
    return (x[:, 0], res[0]) if squeeze else (x, res)


def gmres(
    matvec,
    b: jax.Array,
    x0: jax.Array | None = None,
    n_iter: int = 20,
    precond=None,
):
    """Right-preconditioned GMRES(n_iter), single cycle, column-batched.

    Solves A x = b with A nonsymmetric; precond approximates A^{-1}.
    b: (n,) or (n, q) — each column runs its own Arnoldi recurrence
    (shared matvecs, per-column scalars). Fixed-size Krylov basis
    (n_iter+1, n, q) — keep n_iter modest; intended for strongly
    clustered (preconditioned) operators where 5-20 steps converge.
    Returns (x, final residual norms (q,)).
    """
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    n, q = b.shape
    dtype = b.dtype
    pc = precond or (lambda v: v)
    x0a = jnp.zeros_like(b) if x0 is None else (x0[:, None] if squeeze else x0)

    r0 = b - matvec(x0a)
    beta = jnp.sqrt(_dotcols(r0, r0))  # (q,)
    eps = jnp.asarray(1e-30, dtype)
    safe_beta = jnp.maximum(beta, eps)

    m = n_iter
    vs = jnp.zeros((m + 1, n, q), dtype)
    vs = vs.at[0].set(r0 / safe_beta[None, :])
    h = jnp.zeros((m + 1, m, q), dtype)
    zs = jnp.zeros((m, n, q), dtype)  # preconditioned basis vectors

    def arnoldi(j, carry):
        vs, h, zs = carry
        z = pc(vs[j])
        w = matvec(z)
        zs = zs.at[j].set(z)

        # Modified Gram-Schmidt against v_0..v_j (masked full loop).
        def mgs(i, wh):
            w, h = wh
            hij = jnp.where(i <= j, _dotcols(vs[i], w), 0.0)
            w = w - hij[None, :] * vs[i]
            h = h.at[i, j].set(hij)
            return (w, h)

        w, h = jax.lax.fori_loop(0, m + 1, mgs, (w, h))
        hnorm = jnp.sqrt(_dotcols(w, w))
        # Happy breakdown (column converged): a near-zero w must become
        # a ZERO basis vector (and a zero H entry), not w/eps noise
        # that pollutes the basis. The threshold must sit ABOVE the
        # dtype's MGS roundoff floor (~eps * |w pre-orthogonalization|):
        # with the old absolute 1e-12 it never fired in f32, so a
        # converged column produced hnorm -> 0, w/1e-30 -> inf, and the
        # NaNs took down the DRE sweep at ADI iterations past
        # convergence.
        eps_bd = jnp.asarray(64.0, dtype) * jnp.finfo(dtype).eps
        breakdown = hnorm < eps_bd * safe_beta
        h = h.at[j + 1, j].set(jnp.where(breakdown, 0.0, hnorm))
        v_next = jnp.where(
            breakdown[None, :], 0.0, w / jnp.maximum(hnorm, eps)[None, :]
        )
        vs = vs.at[j + 1].set(v_next)
        return (vs, h, zs)

    vs, h, zs = jax.lax.fori_loop(0, m, arnoldi, (vs, h, zs))

    # Solve the small least squares min ||beta e1 - H y|| per column via
    # batched thin QR of the (m+1, m) Hessenberg (normal equations would
    # square its condition number and cap accuracy near sqrt(eps)).
    hq = jnp.transpose(h, (2, 0, 1))  # (q, m+1, m)
    e1 = jnp.zeros((q, m + 1), dtype).at[:, 0].set(beta)
    qmat, rmat = jnp.linalg.qr(hq, mode="reduced")  # (q,m+1,m), (q,m,m)
    qtb = jnp.einsum("qki,qk->qi", qmat, e1)
    # Guard singular R (breakdown columns) by TRUNCATION, not nudging:
    # replacing a ~0 diagonal with 1e-30 turned the solve into a 1e30
    # amplifier of roundoff (y exploded, then inf/NaN in the next
    # matvec). Instead, rows with a negligible diagonal get y_i = 0 —
    # the Moore-Penrose behavior for the converged/degenerate Krylov
    # directions.
    # NOTE (ADVICE r3): the 64*eps*dmax cut also zeroes legitimate but
    # ill-conditioned Krylov directions whose R diagonal sits > ~1e5
    # below the largest (f32). For the intended near-identity
    # PRECONDITIONED operators that regime never occurs; an
    # unpreconditioned ill-conditioned caller sees slower single-cycle
    # convergence, recovered by FGMRES restarts.
    diag = jnp.abs(jnp.diagonal(rmat, axis1=-2, axis2=-1))  # (q, m)
    dmax = jnp.max(diag, axis=-1, keepdims=True)
    sing = diag <= jnp.asarray(64.0, dtype) * jnp.finfo(dtype).eps * (
        jnp.maximum(dmax, eps)
    )
    eye_m = jnp.eye(m, dtype=dtype)[None]
    rmat = jnp.where(sing[..., None], eye_m, rmat)
    qtb = jnp.where(sing, 0.0, qtb)
    y = jax.scipy.linalg.solve_triangular(rmat, qtb[..., None])[..., 0]
    x = x0a + jnp.einsum("jnq,qj->nq", zs, y)
    res = jnp.sqrt(_dotcols(b - matvec(x), b - matvec(x)))
    return (x[:, 0], res[0]) if squeeze else (x, res)


def fgmres(
    matvec,
    b: jax.Array,
    precond=None,
    m: int = 30,
    tol: float = 1e-6,
    max_cycles: int = 8,
    x0: jax.Array | None = None,
):
    """Restarted flexible GMRES: gmres(m) cycles under lax.while_loop.

    The single-cycle `gmres` above stores every preconditioned basis
    vector explicitly (that is what makes it FLEXIBLE — inner iterative
    preconditioners are admissible), so restarting it is the standard
    FGMRES(m). The while_loop gives a tolerance-driven dynamic cycle
    count under jit: easy (mass-dominated) shifted systems stop after
    one cycle, hard ones run up to max_cycles (solvers/matfree.py is
    the main consumer — its block-preconditioned saddle solves need
    15-120 total iterations depending on the shift).

    b: (n,) or (n, q). Stops when EVERY column's relative residual
    drops below tol (zero columns count as converged). Returns
    (x, relres) with relres the final max column-relative residual.

    Columns are NORMALIZED before the solve (the system is linear in
    b, so solve(b) = ||b||_col * solve(b / ||b||_col)): badly scaled
    batches are routine here — an ADI chain's late iterations hand
    this solver columns spanning 1e-13..1e-8 (riccati/lyap_adi.py),
    where a compiled f32 Arnoldi has produced NaNs on an accelerator
    backend that the same arithmetic un-jitted did not. With unit
    columns the solver only ever sees O(1) data, and per-column
    relative tolerances become absolute ones.
    """
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    dtype = b.dtype
    bnorm = jnp.sqrt(_dotcols(b, b))
    tiny = jnp.asarray(1e-30, dtype)
    safe = jnp.maximum(bnorm, tiny)
    bs = b / safe[None, :]
    if x0 is None:
        x_init = jnp.zeros_like(b)
    else:
        # A zero/tiny-norm rhs column with a nonzero warm-start column
        # would amplify x0 by up to 1/tiny (ADVICE r3): such columns
        # fall back to the zero initial guess instead.
        x0c = x0[:, None] if squeeze else x0
        x_init = jnp.where(
            (bnorm > tiny)[None, :], x0c / safe[None, :], 0.0
        )

    def cond_fn(carry):
        _, rel, c = carry
        return jnp.logical_and(c < max_cycles, rel > tol)

    def body_fn(carry):
        x, _, c = carry
        x_new, res = gmres(matvec, bs, x0=x, n_iter=m, precond=precond)
        # bs columns are unit (or exactly zero): res IS the relative
        # residual; zero columns report res = 0.
        rel = jnp.max(res)
        return (x_new, rel, c + 1)

    x, rel, _ = jax.lax.while_loop(
        cond_fn, body_fn,
        (x_init, jnp.asarray(jnp.inf, dtype), jnp.int32(0)),
    )
    x = x * safe[None, :]
    return (x[:, 0], rel) if squeeze else (x, rel)


def _pick_references(shifts_np, n_ref: int):
    """Log-spaced reference shifts + nearest-reference index per shift.

    Host-side (concrete shifts). Returns (refs (n_ref,), idx (n_shifts,)).
    """
    import numpy as np

    logs = np.log(-np.asarray(shifts_np))
    lo, hi = logs.min(), logs.max()
    centers = lo + (hi - lo) * (np.arange(n_ref) + 0.5) / n_ref
    refs = -np.exp(centers)
    idx = np.argmin(np.abs(logs[:, None] - centers[None, :]), axis=1)
    return refs, idx.astype(np.int32)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=(
        "lu", "piv", "mass_data", "mass_cols", "shifts", "ref_sigma",
        "ref_idx",
    ),
    meta_fields=("n", "n_iter"),
)
@dataclass(frozen=True)
class ShiftedKrylovCache:
    """Few reference LUs + GMRES: the memory-lean ShiftedLUCache.

    Same solve/solve_smw contract as solvers.shifted.ShiftedLUCache
    (consumed by riccati/lyap_adi.py), but holds n_ref (default 2)
    log-spaced reference factorizations instead of one per shift —
    O(n_ref n^2) HBM instead of O(n_shifts n^2). Convergence guide:
    ~15 GMRES iterations per decade of log-distance between a shift and
    its nearest reference (measured on heat1d / cavity pencils).
    """

    lu: jax.Array  # (n_ref, n, n)
    piv: jax.Array  # (n_ref, n)
    mass_data: jax.Array
    mass_cols: jax.Array
    shifts: jax.Array  # (n_shifts,)
    ref_sigma: jax.Array  # (n_ref,)
    ref_idx: jax.Array  # (n_shifts,) nearest reference per shift
    n: int
    n_iter: int

    @staticmethod
    def build(
        at_dense: jax.Array,
        mass,
        shifts,
        n_iter: int = 30,
        n_ref: int = 2,
    ) -> "ShiftedKrylovCache":
        """at_dense: (n, n) dense A^T; mass: ops.sparse.ELL M;
        shifts: concrete (host) negative reals."""
        import numpy as np

        refs_np, idx_np = _pick_references(np.asarray(shifts), n_ref)
        dtype = at_dense.dtype
        m_dense = mass.todense()

        from ..ops.dense import host_lu_factor

        at_np = np.asarray(at_dense, dtype=np.float64)
        m_np = np.asarray(m_dense, dtype=np.float64)
        lus, pivs = [], []
        for sigma in refs_np:
            lu_r, piv_r = host_lu_factor(at_np + sigma * m_np, dtype)
            lus.append(lu_r)
            pivs.append(piv_r)
        lu, piv = jnp.stack(lus), jnp.stack(pivs)
        return ShiftedKrylovCache(
            lu=lu,
            piv=piv,
            mass_data=mass.data,
            mass_cols=mass.cols,
            shifts=jnp.asarray(shifts, dtype),
            ref_sigma=jnp.asarray(refs_np, dtype),
            ref_idx=jnp.asarray(idx_np),
            n=at_dense.shape[0],
            n_iter=n_iter,
        )

    def _mass_mat(self, x: jax.Array) -> jax.Array:
        return jnp.einsum("mk,mkb->mb", self.mass_data, x[self.mass_cols])

    def _ref_solve(self, r: jax.Array, rhs: jax.Array) -> jax.Array:
        lu_r = jax.lax.dynamic_index_in_dim(self.lu, r, keepdims=False)
        piv_r = jax.lax.dynamic_index_in_dim(self.piv, r, keepdims=False)
        return jax.scipy.linalg.lu_solve((lu_r, piv_r), rhs)

    def solve(self, i: jax.Array, rhs: jax.Array) -> jax.Array:
        """Solve (A^T + sigma_i M) x = rhs via preconditioned GMRES."""
        squeeze = rhs.ndim == 1
        if squeeze:
            rhs = rhs[:, None]
        r = self.ref_idx[i]
        dsig = self.shifts[i] - self.ref_sigma[r]

        # Left-preconditioned fixed point: with P = A^T + sigma_r M,
        #   (A^T + sigma_i M) x = rhs  <=>  (I + dsig P^{-1} M) x = P^{-1} rhs,
        # and the left operator needs only P^{-1} (cached LU) and M.
        def op(x):
            return x + dsig * self._ref_solve(r, self._mass_mat(x))

        b_prec = self._ref_solve(r, rhs)
        x, _ = gmres(op, b_prec, n_iter=self.n_iter)
        return x[:, 0] if squeeze else x

    def solve_smw(
        self, i: jax.Array, u: jax.Array, v: jax.Array, rhs: jax.Array
    ) -> jax.Array:
        """Feedback-shifted solve (A^T + sigma_i M - u v^T)^{-1} rhs."""
        from ..ops.lowrank import smw_solve

        return smw_solve(lambda r: self.solve(i, r), u, v, rhs)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=(
        "lu", "piv", "mass_data", "mass_cols", "shifts", "ref_sigma",
        "ref_idx",
    ),
    meta_fields=("n", "n_iter"),
)
@dataclass(frozen=True)
class SaddleShiftedKrylovCache:
    """Few reference saddle LUs + GMRES — the memory-lean
    SaddleShiftedLUCache (same solve/solve_smw contract, consumed by
    the projected ADI on index-2 DAEs, SURVEY.md SS3.3).

    Shifted saddle identity: S(sigma_i) = S(sigma_r) + dsig Mhat with
    Mhat = blockdiag(M, 0); GMRES runs on the left-preconditioned
    system (I + dsig Sr^{-1} Mhat) x = Sr^{-1} [rhs_v; 0] over the full
    (v, p) space, keeping every iterate consistent with the constraint
    rows (the Leray projection stays implicit).
    """

    lu: jax.Array  # (n_ref, n+np, n+np)
    piv: jax.Array
    mass_data: jax.Array
    mass_cols: jax.Array
    shifts: jax.Array
    ref_sigma: jax.Array
    ref_idx: jax.Array
    n: int  # velocity block size
    n_iter: int

    @staticmethod
    def build(
        at_dense: jax.Array,
        mass,
        j_dense: jax.Array,
        shifts,
        n_iter: int = 30,
        n_ref: int = 2,
    ) -> "SaddleShiftedKrylovCache":
        import numpy as np

        refs_np, idx_np = _pick_references(np.asarray(shifts), n_ref)
        n = at_dense.shape[0]
        n_p = j_dense.shape[0]
        dtype = at_dense.dtype

        # Host assembly + host LAPACK factorization (ops/dense.py);
        # kept until an H100 measurement decides, ROADMAP design
        # item 2.
        from ..ops.dense import host_lu_factor

        at_np = np.asarray(at_dense, dtype=np.float64)
        m_np = np.asarray(mass.todense(), dtype=np.float64)
        j_np = np.asarray(j_dense, dtype=np.float64)
        lus, pivs = [], []
        for sigma in refs_np:
            big = np.zeros((n + n_p, n + n_p), dtype=np.float64)
            big[:n, :n] = at_np + sigma * m_np
            big[:n, n:] = j_np.T
            big[n:, :n] = j_np
            lu_r, piv_r = host_lu_factor(big, dtype)
            lus.append(lu_r)
            pivs.append(piv_r)
        lu, piv = jnp.stack(lus), jnp.stack(pivs)
        return SaddleShiftedKrylovCache(
            lu=lu,
            piv=piv,
            mass_data=mass.data,
            mass_cols=mass.cols,
            shifts=jnp.asarray(shifts, dtype),
            ref_sigma=jnp.asarray(refs_np, dtype),
            ref_idx=jnp.asarray(idx_np),
            n=n,
            n_iter=n_iter,
        )

    def _mass_mat(self, x: jax.Array) -> jax.Array:
        return jnp.einsum("mk,mkb->mb", self.mass_data, x[self.mass_cols])

    def _ref_solve(self, r: jax.Array, rhs_big: jax.Array) -> jax.Array:
        lu_r = jax.lax.dynamic_index_in_dim(self.lu, r, keepdims=False)
        piv_r = jax.lax.dynamic_index_in_dim(self.piv, r, keepdims=False)
        return jax.scipy.linalg.lu_solve((lu_r, piv_r), rhs_big)

    def solve(self, i: jax.Array, rhs: jax.Array) -> jax.Array:
        squeeze = rhs.ndim == 1
        if squeeze:
            rhs = rhs[:, None]
        n_tot = self.lu.shape[1]
        q = rhs.shape[1]
        r = self.ref_idx[i]
        dsig = self.shifts[i] - self.ref_sigma[r]

        def op(x_big):
            mx = self._mass_mat(x_big[: self.n])
            upd = jnp.zeros((n_tot, q), x_big.dtype).at[: self.n].set(mx)
            return x_big + dsig * self._ref_solve(r, upd)

        rhs_big = jnp.zeros((n_tot, q), rhs.dtype).at[: self.n].set(rhs)
        b_prec = self._ref_solve(r, rhs_big)
        x_big, _ = gmres(op, b_prec, n_iter=self.n_iter)
        v = x_big[: self.n]
        return v[:, 0] if squeeze else v

    def solve_smw(
        self, i: jax.Array, u: jax.Array, v: jax.Array, rhs: jax.Array
    ) -> jax.Array:
        from ..ops.lowrank import smw_solve

        return smw_solve(lambda r: self.solve(i, r), u, v, rhs)
