"""Saddle-point solvers: [[F, J^T], [J, 0]] systems.

The reference funnels every constrained solve through
solve_sadpnt_smw on a cached SuperLU factorization (SURVEY.md SS2 row
5, SS3.2-3.4). Device equivalents here:

  * SaddleLU / SaddleShiftedLUCache — ONE batched dense LU of the
    (n+np) saddle matrix (per shift), reused for every
    solve; feedback updates via SMW on padded low-rank factors. The
    velocity-block solve applies the discrete Leray projection
    implicitly (iterates stay in ker J) — the app_prj_via_sadpnt
    contract, with the projector never formed.
  * Host-side scipy golden (solve_sadpnt_scipy) for oracles.

For problem sizes where dense factors don't fit, solvers/krylov.py
provides the matrix-free path behind the same solve contract.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from ..ops.lowrank import smw_solve


def solve_sadpnt_scipy(a_sp, j_sp, rhs_v, rhs_p=None):
    """Host golden: sparse-LU saddle solve; returns (v, p)."""
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    n = a_sp.shape[0]
    n_p = j_sp.shape[0]
    if rhs_p is None:
        rhs_p = np.zeros(n_p)
    big = sp.bmat(
        [[a_sp, j_sp.T], [j_sp, None]], format="csc"
    )
    sol = spla.spsolve(big, np.concatenate([rhs_v, rhs_p]))
    return sol[:n], sol[n:]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("lu", "piv"),
    meta_fields=("n",),
)
@dataclass(frozen=True)
class SaddleLU:
    """Cached dense LU of one saddle matrix; solves return velocity+pressure."""

    lu: jax.Array
    piv: jax.Array
    n: int  # velocity block size

    @staticmethod
    def build(f_dense: jax.Array, j_dense: jax.Array) -> "SaddleLU":
        """Host-LAPACK factorization of the assembled saddle matrix
        (setup-time; ops/dense.py)."""
        import numpy as np

        from ..ops.dense import host_lu_factor

        n = f_dense.shape[0]
        n_p = j_dense.shape[0]
        dtype = jnp.asarray(f_dense).dtype
        f_np = np.asarray(f_dense, dtype=np.float64)
        j_np = np.asarray(j_dense, dtype=np.float64)
        big = np.zeros((n + n_p, n + n_p))
        big[:n, :n] = f_np
        big[:n, n:] = j_np.T
        big[n:, :n] = j_np
        lu, piv = host_lu_factor(big, out_dtype=dtype)
        return SaddleLU(lu, piv, n)

    def apply(self, rhs_v: jax.Array, rhs_p: jax.Array | None = None):
        """Solve; rhs_v (n,) or (n, k). Returns velocity block only."""
        squeeze = rhs_v.ndim == 1
        if squeeze:
            rhs_v = rhs_v[:, None]
        n_p = self.lu.shape[0] - self.n
        if rhs_p is None:
            rhs_p = jnp.zeros((n_p, rhs_v.shape[1]), rhs_v.dtype)
        elif rhs_p.ndim == 1:
            rhs_p = rhs_p[:, None]
        big_rhs = jnp.concatenate([rhs_v, rhs_p], axis=0)
        sol = jax.scipy.linalg.lu_solve((self.lu, self.piv), big_rhs)
        v = sol[: self.n]
        return v[:, 0] if squeeze else v

    def apply_full(self, rhs_v: jax.Array, rhs_p: jax.Array):
        """Solve returning (velocity, pressure)."""
        squeeze = rhs_v.ndim == 1
        rv = rhs_v[:, None] if squeeze else rhs_v
        rp = rhs_p[:, None] if squeeze else rhs_p
        sol = jax.scipy.linalg.lu_solve(
            (self.lu, self.piv), jnp.concatenate([rv, rp], axis=0)
        )
        v, p = sol[: self.n], sol[self.n :]
        return (v[:, 0], p[:, 0]) if squeeze else (v, p)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("lu", "piv"),
    meta_fields=("n",),
)
@dataclass(frozen=True)
class SaddleShiftedLUCache:
    """Batched dense LU of [[A^T + sigma_i M, J^T], [J, 0]] over shifts.

    Same solve/solve_smw contract as solvers.shifted.ShiftedLUCache but
    on the constrained (index-2 DAE) velocity space: every solve keeps
    its result in ker J (implicit Leray projection), which is exactly
    what keeps ADI iterates feasible (SURVEY.md SS3.3).
    """

    lu: jax.Array
    piv: jax.Array
    n: int

    @staticmethod
    def build(
        at_dense: jax.Array,
        m_dense: jax.Array,
        j_dense: jax.Array,
        shifts: jax.Array,
    ) -> "SaddleShiftedLUCache":
        """Per-shift host-LAPACK factorizations (setup-time)."""
        import numpy as np

        from ..ops.dense import host_lu_factor

        n = at_dense.shape[0]
        n_p = j_dense.shape[0]
        dtype = jnp.asarray(at_dense).dtype
        at_np = np.asarray(at_dense, dtype=np.float64)
        m_np = np.asarray(m_dense, dtype=np.float64)
        j_np = np.asarray(j_dense, dtype=np.float64)
        lus, pivs = [], []
        for sigma in np.asarray(shifts, dtype=np.float64):
            big = np.zeros((n + n_p, n + n_p))
            big[:n, :n] = at_np + sigma * m_np
            big[:n, n:] = j_np.T
            big[n:, :n] = j_np
            lu, piv = host_lu_factor(big, out_dtype=dtype)
            lus.append(lu)
            pivs.append(piv)
        return SaddleShiftedLUCache(jnp.stack(lus), jnp.stack(pivs), n)

    def _solve_padded(self, i: jax.Array, rhs_v: jax.Array) -> jax.Array:
        lu_i = jax.lax.dynamic_index_in_dim(self.lu, i, keepdims=False)
        piv_i = jax.lax.dynamic_index_in_dim(self.piv, i, keepdims=False)
        squeeze = rhs_v.ndim == 1
        if squeeze:
            rhs_v = rhs_v[:, None]
        n_p = self.lu.shape[1] - self.n
        big_rhs = jnp.concatenate(
            [rhs_v, jnp.zeros((n_p, rhs_v.shape[1]), rhs_v.dtype)], axis=0
        )
        sol = jax.scipy.linalg.lu_solve((lu_i, piv_i), big_rhs)
        v = sol[: self.n]
        return v[:, 0] if squeeze else v

    def solve(self, i: jax.Array, rhs: jax.Array) -> jax.Array:
        return self._solve_padded(i, rhs)

    def solve_smw(
        self, i: jax.Array, u: jax.Array, v: jax.Array, rhs: jax.Array
    ) -> jax.Array:
        """Feedback-shifted saddle solve via SMW on the velocity block.

        Solves the saddle system whose velocity block is
        (A^T + sigma M - U V^T); U, V live on the velocity space only
        (the constraint rows are untouched by feedback).
        """
        return smw_solve(
            lambda r: self._solve_padded(i, r), u, v, rhs
        )


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("inv",),
    meta_fields=("n",),
)
@dataclass(frozen=True)
class SaddleInverse:
    """Explicit saddle inverse applied as ONE GEMM per solve.

    A GEMM runs far faster than blocked triangular solves, so for
    matrices applied thousands of times (the IMEX rollout step, ADI
    sweeps) the explicit inverse wins despite the O(n^2) extra setup;
    it is computed on the host in f64 and cast, so accuracy matches an
    LU solve at device precision. Same apply contract as SaddleLU.
    """

    inv: jax.Array  # (n+np, n+np)
    n: int

    @staticmethod
    def build(f_dense: jax.Array, j_dense: jax.Array) -> "SaddleInverse":
        import numpy as np

        from ..ops.dense import host_inverse

        n = f_dense.shape[0]
        n_p = j_dense.shape[0]
        dtype = jnp.asarray(f_dense).dtype
        big = np.zeros((n + n_p, n + n_p))
        big[:n, :n] = np.asarray(f_dense, dtype=np.float64)
        big[:n, n:] = np.asarray(j_dense, dtype=np.float64).T
        big[n:, :n] = np.asarray(j_dense, dtype=np.float64)
        return SaddleInverse(host_inverse(big, out_dtype=dtype), n)

    def _solve(self, rhs_v: jax.Array, rhs_p: jax.Array | None):
        squeeze = rhs_v.ndim == 1
        rv = rhs_v[:, None] if squeeze else rhs_v
        n_p = self.inv.shape[0] - self.n
        if rhs_p is None:
            rp = jnp.zeros((n_p, rv.shape[1]), rv.dtype)
        else:
            rp = rhs_p[:, None] if squeeze else rhs_p
        sol = self.inv @ jnp.concatenate([rv, rp], axis=0)
        return sol, squeeze

    def apply(self, rhs_v: jax.Array, rhs_p: jax.Array | None = None):
        sol, squeeze = self._solve(rhs_v, rhs_p)
        v = sol[: self.n]
        return v[:, 0] if squeeze else v

    def apply_full(self, rhs_v: jax.Array, rhs_p: jax.Array):
        sol, squeeze = self._solve(rhs_v, rhs_p)
        v, p = sol[: self.n], sol[self.n :]
        return (v[:, 0], p[:, 0]) if squeeze else (v, p)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("inv",),
    meta_fields=("n",),
)
@dataclass(frozen=True)
class SaddleShiftedInverseCache:
    """Host-built explicit inverses of the shifted saddle systems,
    applied as one GEMM per solve (velocity block returned) — the
    GEMM-bound ADI solve path; same contract as SaddleShiftedLUCache."""

    inv: jax.Array  # (J, n+np, n+np) or vv-block-only (J, n, n)
    n: int

    @staticmethod
    def build(at_dense, m_dense, j_dense, shifts):
        import numpy as np

        from ..ops.dense import host_inverse

        n = at_dense.shape[0]
        n_p = j_dense.shape[0]
        dtype = jnp.asarray(at_dense).dtype
        at_np = np.asarray(at_dense, dtype=np.float64)
        m_np = np.asarray(m_dense, dtype=np.float64)
        j_np = np.asarray(j_dense, dtype=np.float64)
        invs = []
        for sigma in np.asarray(shifts, dtype=np.float64):
            big = np.zeros((n + n_p, n + n_p))
            big[:n, :n] = at_np + sigma * m_np
            big[:n, n:] = j_np.T
            big[n:, :n] = j_np
            invs.append(host_inverse(big, out_dtype=dtype))
        return SaddleShiftedInverseCache(jnp.stack(invs), n)

    @staticmethod
    def build_sparse_host(
        at_sp, m_sp, j_sp, shifts, dtype=jnp.float32, panel_cols=512,
    ):
        """Host half of build_sparse: returns the stacked (J, n, n)
        numpy vv-block inverses WITHOUT transferring to device — the
        cacheable artifact for warm MPC restarts (riccati/dre.py keys
        it by config and np.save's it uncompressed).

        The identity RHS is solved in panel_cols-column panels rather
        than one dense (n+np, n) block: the monolithic solve carries a
        ~180 MB working set per thread and regressed 6 s -> 266 s per
        shift under co-tenant contention on the 2-core deploy box
        (BENCH_r03 post-mortem, DIAG_INV_r04.json); 512-column panels
        keep the working set ~10 MB and measured 3.7 s/shift on the
        same box — contention-resistant AND faster when idle.
        """
        import os
        from concurrent.futures import ThreadPoolExecutor

        import numpy as np
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        at_sp = sp.csr_matrix(at_sp)
        m_sp = sp.csr_matrix(m_sp)
        j_sp = sp.csr_matrix(j_sp)
        n = at_sp.shape[0]
        n_p = j_sp.shape[0]

        def one(sigma):
            big = sp.bmat(
                [[at_sp + sigma * m_sp, j_sp.T], [j_sp, None]],
                format="csc",
            )
            lu = spla.splu(big)
            inv = np.empty((n, n), dtype=np.dtype(dtype))
            rhs = np.zeros((n + n_p, panel_cols))
            for lo in range(0, n, panel_cols):
                w = min(panel_cols, n - lo)
                rhs[:, :w] = 0.0
                rhs[lo : lo + w, :w] = np.eye(w)
                inv[:, lo : lo + w] = lu.solve(rhs[:, :w])[:n]
            return inv

        # SuperLU's C factor/solve release the GIL — thread the shifts
        # (measured 1.55x on the 2-vCPU deploy host, r3 cold-start).
        workers = min(len(np.asarray(shifts)), os.cpu_count() or 1)
        with ThreadPoolExecutor(workers) as ex:
            invs = list(ex.map(one, np.asarray(shifts, np.float64)))
        return np.stack(invs)

    @staticmethod
    def build_sparse(at_sp, m_sp, j_sp, shifts, dtype=jnp.float32):
        """Sparse-LU setup: splu of each shifted saddle pencil, then
        the explicit inverse's velocity-velocity block by solving
        against [I_n; 0] — only block solve() ever reads. ~6x cheaper
        than dense getrf+getri at n+np ~ 5k on the deploy VMs (the
        round-1 bench spent ~150 s of its 'compile+factor' there) and
        (J, n, n) instead of (J, (n+np)^2) HBM.
        """
        invs = SaddleShiftedInverseCache.build_sparse_host(
            at_sp, m_sp, j_sp, shifts, dtype=dtype
        )
        return SaddleShiftedInverseCache(
            jnp.asarray(invs), at_sp.shape[0]
        )

    def solve(self, i: jax.Array, rhs: jax.Array) -> jax.Array:
        inv_i = jax.lax.dynamic_index_in_dim(self.inv, i, keepdims=False)
        squeeze = rhs.ndim == 1
        if squeeze:
            rhs = rhs[:, None]
        # Only the velocity-block columns of the inverse act on a
        # velocity-only rhs; slice instead of padding with zeros.
        x = inv_i[: self.n, : self.n] @ rhs
        return x[:, 0] if squeeze else x

    def solve_smw(
        self, i: jax.Array, u: jax.Array, v: jax.Array, rhs: jax.Array
    ) -> jax.Array:
        return smw_solve(lambda r: self.solve(i, r), u, v, rhs)
