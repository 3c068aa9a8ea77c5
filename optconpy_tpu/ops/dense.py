"""Dense factorization caches — the device stand-in for cached SuperLU.

The reference's single hottest pattern is "factor a sparse matrix once
with splu, reuse the triangular solves thousands of times" (SURVEY.md
SS2 row 10, SS3.3-3.4). The replacement here:

  * FACTORIZE ON THE HOST (LAPACK f64 via scipy); factors are cast to
    the device dtype and shipped once. Whether a device LU (cuSOLVER
    through jnp.linalg) should replace this is not measured yet,
    ROADMAP design item 2.
  * SOLVE ON THE DEVICE: batched triangular solves (LUSolver), or one
    GEMM against a host-computed explicit inverse (DenseInverse) —
    a GEMM runs far closer to the card's peak than blocked triangular
    solves, so the inverse path wins whenever the matrix is applied
    many times (rollout steps, ADI sweeps).

For larger n, solvers/krylov.py provides the matrix-free path behind
the same `apply` contract.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def host_lu_factor(a, out_dtype=None):
    """LAPACK f64 factorization on the host; returns device (lu, piv).

    a: concrete numpy/jax array (setup-time only — never traced).
    """
    import scipy.linalg as sla

    a_np = np.asarray(a, dtype=np.float64)
    lu, piv = sla.lu_factor(a_np)
    dtype = out_dtype or jnp.asarray(a).dtype
    return jnp.asarray(lu, dtype), jnp.asarray(piv.astype(np.int32))


def host_inverse(a, out_dtype=None):
    """Host f64 explicit inverse, cast to the device dtype."""
    import scipy.linalg as sla

    a_np = np.asarray(a, dtype=np.float64)
    lu, piv = sla.lu_factor(a_np)
    inv = sla.lu_solve((lu, piv), np.eye(a_np.shape[0]))
    dtype = out_dtype or jnp.asarray(a).dtype
    return jnp.asarray(inv, dtype)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("lu", "piv"),
    meta_fields=(),
)
@dataclass(frozen=True)
class LUSolver:
    """Cached dense LU of a (possibly batched) square matrix.

    lu:  (..., n, n) packed LU factors.
    piv: (..., n) pivot indices.
    `apply` solves A x = b for b (..., n) or (..., n, k); leading batch
    dims of the factorization broadcast against the RHS via vmap at the
    call site (keep factors unbatched here; batch with jax.vmap(LUSolver.apply)).
    """

    lu: jax.Array
    piv: jax.Array

    @staticmethod
    def factor(a: jax.Array) -> "LUSolver":
        """Host-LAPACK factorization (a must be concrete, not traced)."""
        lu, piv = host_lu_factor(a)
        return LUSolver(lu, piv)

    @staticmethod
    def factor_device(a: jax.Array) -> "LUSolver":
        """On-device factorization, for traced/inside-jit use."""
        lu, piv = jax.scipy.linalg.lu_factor(a)
        return LUSolver(lu, piv)

    def apply(self, b: jax.Array) -> jax.Array:
        squeeze = b.ndim == 1
        if squeeze:
            b = b[:, None]
        x = jax.scipy.linalg.lu_solve((self.lu, self.piv), b)
        return x[:, 0] if squeeze else x


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("chol",),
    meta_fields=(),
)
@dataclass(frozen=True)
class CholeskySolver:
    """Cached dense Cholesky (SPD systems: mass matrices, Gram blocks)."""

    chol: jax.Array  # lower triangular

    @staticmethod
    def factor(a: jax.Array) -> "CholeskySolver":
        return CholeskySolver(jnp.linalg.cholesky(a))

    def apply(self, b: jax.Array) -> jax.Array:
        squeeze = b.ndim == 1
        if squeeze:
            b = b[:, None]
        y = jax.scipy.linalg.solve_triangular(self.chol, b, lower=True)
        x = jax.scipy.linalg.solve_triangular(
            self.chol.T, y, lower=False
        )
        return x[:, 0] if squeeze else x


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("inv",),
    meta_fields=(),
)
@dataclass(frozen=True)
class DenseInverse:
    """Explicit inverse applied as one GEMM — the GEMM-bound reuse
    path (see module docstring). Built on the host in f64, so the
    apply error is cond(A) * eps(device dtype) like an LU solve."""

    inv: jax.Array

    @staticmethod
    def factor(a) -> "DenseInverse":
        return DenseInverse(host_inverse(a))

    def apply(self, b: jax.Array) -> jax.Array:
        squeeze = b.ndim == 1
        if squeeze:
            b = b[:, None]
        x = self.inv @ b
        return x[:, 0] if squeeze else x
