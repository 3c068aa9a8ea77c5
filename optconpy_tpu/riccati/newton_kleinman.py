"""Newton-Kleinman iteration for the generalized algebraic Riccati eq.

Solves  A^T X M + M^T X A - M^T X B R^-1 B^T X M + C^T C = 0  (R = alpha I)
for X ~= Z Z^T: each Newton step is one low-rank ADI Lyapunov solve with
the feedback-shifted F_j = A - B K_j, where the shifted factorizations
are cached ONCE and feedback enters via SMW — the structure of the
reference's proj_alg_ric_newtonadi (SURVEY.md SS2 row 6, SS3.3 Newton
wrapper), with fixed iteration counts for XLA.

Gain convention: K = R^-1 B^T X M  (m, n), closed loop F = A - B K.
Newton Lyapunov RHS factor: W_j = [C^T, sqrt(alpha) K_j^T].
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.operators import LTISystem
from ..ops.lowrank import compress
from ..solvers.shifted import ShiftedLUCache
from .lyap_adi import lowrank_adi, lowrank_adi_hostloop


def gain_from_factor(
    z: jax.Array, sys: LTISystem, alpha: float
) -> jax.Array:
    """K = (1/alpha) B^T Z Z^T M via tall-skinny products."""
    return ((sys.b.T @ z) @ (sys.mass.matmat(z)).T) / alpha


@partial(
    jax.jit,
    static_argnames=("n_newton", "out_rank", "extra_w_cols"),
)
def newton_adi_are(
    sys: LTISystem,
    cache: ShiftedLUCache,
    alpha: float,
    sigma_seq: jax.Array,
    idx_seq: jax.Array,
    n_newton: int = 8,
    out_rank: int = 40,
    k0: jax.Array | None = None,
    w_extra: jax.Array | None = None,
    extra_w_cols: int = 0,
    compress_rtol: float = 1e-9,
):
    """Low-rank generalized ARE solve; returns (Z, K).

    cache must hold LU factors of (A^T + sigma_j M) for the distinct
    shifts referenced by idx_seq (A = sys.stiff or a time-shifted copy
    for DRE steps — the caller chooses, this routine only sees factors).

    w_extra: optional (n, extra_w_cols) additional constant-term factor,
    used by the DRE to inject M^T Z_next / sqrt(dt) (riccati/dre.py).
    """
    n, m = sys.b.shape
    p = sys.p_out
    dtype = sys.b.dtype
    ct = sys.c.T
    if k0 is None:
        k0 = jnp.zeros((m, n), dtype)
    sqrt_alpha = jnp.sqrt(jnp.asarray(alpha, dtype))

    def newton_step(carry, _):
        k_gain, _z_prev = carry
        parts = [ct]
        if w_extra is not None:
            parts.append(w_extra)
        parts.append(sqrt_alpha * k_gain.T)
        w = jnp.concatenate(parts, axis=1)
        z_full = lowrank_adi(
            cache,
            smw_u=k_gain.T,
            smw_v=sys.b,
            mass=sys.mass,
            w=w,
            sigma_seq=sigma_seq,
            idx_seq=idx_seq,
        )
        z = compress(z_full, out_rank=out_rank, rtol=compress_rtol)
        k_new = gain_from_factor(z, sys, alpha)
        return (k_new, z), None

    z0 = jnp.zeros((n, out_rank), dtype)
    (k, z), _ = jax.lax.scan(
        newton_step, (k0, z0), None, length=n_newton
    )
    return z, k


@partial(jax.jit, static_argnames=("out_rank",))
def _compress_gain(sys, z_full, alpha, out_rank, rtol):
    z = compress(z_full, out_rank=out_rank, rtol=rtol)
    return z, gain_from_factor(z, sys, alpha)


def newton_adi_are_host(
    sys: LTISystem,
    cache,
    alpha: float,
    sigma_seq,
    idx_seq,
    n_newton: int = 8,  # matches newton_adi_are's default (ADVICE r3)
    out_rank: int = 40,
    k0: jax.Array | None = None,
    w_extra: jax.Array | None = None,
    extra_w_cols: int = 0,
    compress_rtol: float = 1e-9,
):
    """newton_adi_are with Newton AND ADI loops on the HOST.

    Same math, one jitted program per ADI iteration (plus one for
    compress+gain) instead of scan(newton){scan(adi){...}}. Used for
    the matrix-free cache, whose long FGMRES chains stay out of one
    device scan; kept until an H100 measurement decides, ROADMAP
    design item 1 (see lowrank_adi_hostloop). extra_w_cols is accepted
    for signature parity and unused (w_extra's width is visible on
    the host).
    """
    del extra_w_cols
    n, m = sys.b.shape
    dtype = sys.b.dtype
    ct = sys.c.T
    k = (
        jnp.zeros((m, n), dtype) if k0 is None
        else jnp.asarray(k0, dtype)
    )
    sqrt_alpha = float(np.sqrt(alpha))
    z = jnp.zeros((n, out_rank), dtype)
    for _ in range(n_newton):
        parts = [ct]
        if w_extra is not None:
            parts.append(w_extra)
        parts.append(sqrt_alpha * k.T)
        w = jnp.concatenate(parts, axis=1)
        z_full = lowrank_adi_hostloop(
            cache, k.T, sys.b, sys.mass, w, sigma_seq, idx_seq
        )
        z, k = _compress_gain(
            sys, z_full, jnp.asarray(alpha, dtype), out_rank,
            jnp.asarray(compress_rtol, dtype),
        )
    return z, k
