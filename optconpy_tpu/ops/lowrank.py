"""Low-rank factor utilities: tall-skinny QR, truncation, SMW.

The reference accumulates ADI factors Z = [Z, Z_new] and compresses by
thin QR + truncated SVD (SURVEY.md SS3.3). Ranks are dynamic there; on
the device every factor lives in a STATIC (n, r_max) buffer whose trailing
columns are exactly zero when unused (SURVEY.md SS7 hard part 5). All
routines here preserve that invariant and are jit/scan/vmap-safe.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def tsqr_cholqr2(z: jax.Array) -> tuple[jax.Array, jax.Array]:
    """CholeskyQR2 for tall-skinny Z (n, r): two Gram+Cholesky passes.

    GEMM-bound (two r*r Grams + triangular solves) and accurate to
    ~machine eps for cond(Z) < 1/sqrt(eps). Zero columns are handled by
    regularizing the Gram diagonal; the corresponding R rows stay ~0.
    """
    n, r = z.shape
    eps = jnp.finfo(z.dtype).eps

    def _pass(zz):
        g = zz.T @ zz
        # Regularize so all-zero (masked) columns don't break Cholesky.
        shift = eps * jnp.trace(g) + jnp.finfo(z.dtype).tiny
        c = jnp.linalg.cholesky(g + shift * jnp.eye(r, dtype=z.dtype))
        q = jax.scipy.linalg.solve_triangular(
            c, zz.T, lower=True
        ).T
        return q, c.T  # R upper triangular

    q1, r1 = _pass(z)
    q2, r2 = _pass(q1)
    return q2, r2 @ r1


def tsqr(z: jax.Array, method: str = "qr") -> tuple[jax.Array, jax.Array]:
    if method == "cholqr2":
        return tsqr_cholqr2(z)
    return jnp.linalg.qr(z, mode="reduced")


def compress(
    z: jax.Array,
    out_rank: int | None = None,
    rtol: float = 1e-8,
    method: str = "qr",
) -> jax.Array:
    """Column-compress a low-rank factor, keeping a static shape.

    Z (n, r) -> Z' (n, out_rank or r) with Z'Z'^T ~= ZZ^T: thin QR, SVD of
    the small R factor, drop singular values < rtol * s_max by zeroing
    (static shapes — dropped columns become exact zeros, the masked-rank
    invariant). Columns come out ordered by decreasing singular value, so
    truncating to out_rank keeps the dominant subspace.
    """
    n, r = z.shape
    q, rr = tsqr(z, method=method if n >= r else "qr")
    u, s, _ = jnp.linalg.svd(rr, full_matrices=False)
    keep = s > rtol * s[0]
    s_masked = jnp.where(keep, s, 0.0)
    zc = q @ (u * s_masked[None, :])
    k = zc.shape[1]  # = min(n, r)
    if out_rank is None or out_rank == k:
        return zc
    if out_rank < k:
        return zc[:, :out_rank]
    return jnp.pad(zc, ((0, 0), (0, out_rank - k)))


def append_columns(z: jax.Array, v: jax.Array, ncols: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Append v's columns into the first free slots of static buffer z.

    z: (n, r_max) with columns [0, ncols) used; v: (n, rv). Returns the
    updated buffer and new column count. jit-safe (dynamic_update_slice).
    """
    rv = v.shape[1]
    updated = jax.lax.dynamic_update_slice(
        z, v.astype(z.dtype), (jnp.int32(0), ncols.astype(jnp.int32))
    )
    return updated, ncols + rv


def lowrank_matvec(z: jax.Array, x: jax.Array) -> jax.Array:
    """(Z Z^T) @ x via two tall-skinny products (never forms ZZ^T)."""
    return z @ (z.T @ x)


def smw_solve(
    ainv_apply,
    u: jax.Array,
    v: jax.Array,
    b: jax.Array,
) -> jax.Array:
    """Sherman-Morrison-Woodbury: solve (A - U V^T) x = b.

    `ainv_apply(rhs)` applies A^{-1} (any factorization/Krylov closure).
    Mirrors the reference's solve_sadpnt_smw low-rank update path
    (SURVEY.md SS2 row 5): one factorization of A serves all
    feedback-shifted solves A - B K^T.
    """
    aib = ainv_apply(b)
    aiu = ainv_apply(u)
    r = u.shape[1]
    cap = jnp.eye(r, dtype=b.dtype) - v.T @ aiu
    correction = aiu @ jnp.linalg.solve(cap, v.T @ aib)
    return aib + correction
