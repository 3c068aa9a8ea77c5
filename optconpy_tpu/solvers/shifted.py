"""Batched shifted-system solvers: (A^T + sigma_i M) x = b for all i.

The reference caches one SuperLU factorization per ADI shift and reuses
it across the whole Newton/ADI sweep (SURVEY.md SS3.3 "dominates
runtime"). The device equivalent for moderate n: ONE batched dense
LU over the shift axis, then O(n^2) batched
triangular solves per ADI step. Feedback updates F = A - B K never
refactor: they go through Sherman-Morrison-Woodbury on the cached
factors, exactly mirroring the reference's solve_sadpnt_smw design
(SURVEY.md SS2 row 5). For large n the Krylov path (solvers/krylov.py)
plugs in behind the same `solve(i, rhs)` contract.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from ..ops.lowrank import smw_solve


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("lu", "piv"),
    meta_fields=(),
)
@dataclass(frozen=True)
class ShiftedLUCache:
    """Dense LU factors of (A^T + sigma_i M) stacked over shifts.

    lu: (J, n, n); piv: (J, n).
    """

    lu: jax.Array
    piv: jax.Array

    @staticmethod
    def build(at_dense: jax.Array, m_dense: jax.Array, shifts: jax.Array):
        """Factor A^T + sigma_i M for every shift — host LAPACK
        (setup-time; ops/dense.py)."""
        import numpy as np

        from ..ops.dense import host_lu_factor

        dtype = jnp.asarray(at_dense).dtype
        at_np = np.asarray(at_dense, dtype=np.float64)
        m_np = np.asarray(m_dense, dtype=np.float64)
        lus, pivs = [], []
        for sigma in np.asarray(shifts, dtype=np.float64):
            lu, piv = host_lu_factor(at_np + sigma * m_np, out_dtype=dtype)
            lus.append(lu)
            pivs.append(piv)
        return ShiftedLUCache(jnp.stack(lus), jnp.stack(pivs))

    def solve(self, i: jax.Array, rhs: jax.Array) -> jax.Array:
        """x = (A^T + sigma_i M)^{-1} rhs, rhs (n,) or (n, k)."""
        lu_i = jax.lax.dynamic_index_in_dim(self.lu, i, keepdims=False)
        piv_i = jax.lax.dynamic_index_in_dim(self.piv, i, keepdims=False)
        squeeze = rhs.ndim == 1
        if squeeze:
            rhs = rhs[:, None]
        x = jax.scipy.linalg.lu_solve((lu_i, piv_i), rhs)
        return x[:, 0] if squeeze else x

    def solve_smw(
        self, i: jax.Array, u: jax.Array, v: jax.Array, rhs: jax.Array
    ) -> jax.Array:
        """x = (A^T + sigma_i M - U V^T)^{-1} rhs via SMW on cached LU.

        For closed-loop shifts F^T + sigma M with F = A - B K:
        U = K^T (n, m), V = B (n, m).
        """
        return smw_solve(lambda r: self.solve(i, r), u, v, rhs)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("inv",),
    meta_fields=(),
)
@dataclass(frozen=True)
class ShiftedInverseCache:
    """Host-built explicit inverses of (A^T + sigma_i M), applied as one
    GEMM per solve (ops/dense.py rationale). Same solve/solve_smw
    contract."""

    inv: jax.Array  # (J, n, n)

    @staticmethod
    def build(at_dense, m_dense, shifts):
        import numpy as np

        from ..ops.dense import host_inverse

        dtype = jnp.asarray(at_dense).dtype
        at_np = np.asarray(at_dense, dtype=np.float64)
        m_np = np.asarray(m_dense, dtype=np.float64)
        invs = [
            host_inverse(at_np + sigma * m_np, out_dtype=dtype)
            for sigma in np.asarray(shifts, dtype=np.float64)
        ]
        return ShiftedInverseCache(jnp.stack(invs))

    def solve(self, i: jax.Array, rhs: jax.Array) -> jax.Array:
        inv_i = jax.lax.dynamic_index_in_dim(self.inv, i, keepdims=False)
        squeeze = rhs.ndim == 1
        if squeeze:
            rhs = rhs[:, None]
        x = inv_i @ rhs
        return x[:, 0] if squeeze else x

    def solve_smw(
        self, i: jax.Array, u: jax.Array, v: jax.Array, rhs: jax.Array
    ) -> jax.Array:
        return smw_solve(lambda r: self.solve(i, r), u, v, rhs)
