"""Low-rank ADI for (generalized) Lyapunov equations — the inner engine.

Solves  F^T X M + M^T X F = -W W^T  for X ~= Z Z^T in low-rank factored
form, with F = A - B K (feedback-shifted) handled through SMW on cached
shifted factorizations — the contract of the reference's
solve_proj_lyap_stein (SURVEY.md SS3.3), redesigned for XLA: fixed
shift schedule precomputed on host, lax.scan over iterations, static
factor buffer (n, n_iter * q), no dynamic shapes.

Iteration (real shifts sigma_i < 0):
    V_1 = (F^T + sigma_1 M)^{-1} W
    V_i = V_{i-1} - (sigma_i + sigma_{i-1}) (F^T + sigma_i M)^{-1} (M V_{i-1})
    Z   = [sqrt(-2 sigma_1) V_1, ..., sqrt(-2 sigma_J) V_J]
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.sparse import ELL
from ..solvers.shifted import ShiftedLUCache


def lowrank_adi(
    cache: ShiftedLUCache,
    smw_u: jax.Array,
    smw_v: jax.Array,
    mass: ELL,
    w: jax.Array,
    sigma_seq: jax.Array,
    idx_seq: jax.Array,
) -> jax.Array:
    """Run the full ADI schedule; returns Z with X ~= Z Z^T.

    cache: LU factors of (A^T + sigma_j M) for the DISTINCT shifts.
    smw_u, smw_v: (n, m) low-rank feedback update, so the actual solves
        are (A^T + sigma M - smw_u smw_v^T)^{-1} = (F^T + sigma M)^{-1}
        with F = A - smw_v smw_u^T|_{transposed}; pass zeros for pure A.
    w: (n, q) right-hand-side factor.
    sigma_seq: (n_iter,) shift value per iteration (host-cycled).
    idx_seq: (n_iter,) int32 index of each iteration's shift in `cache`.
    """
    n, q = w.shape
    n_iter = sigma_seq.shape[0]
    dtype = w.dtype

    def solve(i, rhs):
        return cache.solve_smw(i, smw_u, smw_v, rhs)

    v1 = solve(idx_seq[0], w)
    z = jnp.zeros((n, n_iter * q), dtype)
    z = jax.lax.dynamic_update_slice(
        z, jnp.sqrt(-2.0 * sigma_seq[0]) * v1, (0, 0)
    )

    def step(carry, inp):
        v_prev, sig_prev, z_acc = carry
        sig, idx, i = inp
        mv = mass.matmat(v_prev)
        v = v_prev - (sig + sig_prev) * solve(idx, mv)
        z_acc = jax.lax.dynamic_update_slice(
            z_acc,
            jnp.sqrt(-2.0 * sig) * v,
            (jnp.int32(0), i * jnp.int32(q)),
        )
        return (v, sig, z_acc), None

    if n_iter > 1:
        xs = (
            sigma_seq[1:],
            idx_seq[1:],
            jnp.arange(1, n_iter, dtype=jnp.int32),
        )
        (_, _, z), _ = jax.lax.scan(step, (v1, sigma_seq[0], z), xs)
    return z


@jax.jit
def _adi_first_iter(cache, smw_u, smw_v, w, sig0, idx0):
    v1 = cache.solve_smw(idx0, smw_u, smw_v, w)
    return v1, jnp.sqrt(-2.0 * sig0) * v1


@jax.jit
def _adi_next_iter(cache, smw_u, smw_v, mass, v_prev, sig, sig_prev, idx):
    mv = mass.matmat(v_prev)
    v = v_prev - (sig + sig_prev) * cache.solve_smw(idx, smw_u, smw_v, mv)
    return v, jnp.sqrt(-2.0 * sig) * v


@partial(jax.jit, static_argnames=("nsteps",))
def _adi_chunk(cache, smw_u, smw_v, mass, v, sig_prev, sigs, idxs,
               nsteps: int):
    """`nsteps` consecutive ADI iterations as ONE device program
    (lax.scan); the caller chunks the schedule."""

    def body(carry, inp):
        v_c, sp = carry
        sig, idx = inp
        mv = mass.matmat(v_c)
        v_n = v_c - (sig + sp) * cache.solve_smw(idx, smw_u, smw_v, mv)
        return (v_n, sig), jnp.sqrt(-2.0 * sig) * v_n

    (v, sig_prev), zs = jax.lax.scan(
        body, (v, sig_prev), (sigs, idxs), length=nsteps
    )
    return v, sig_prev, zs  # zs: (nsteps, n, q)


def lowrank_adi_hostloop(
    cache,
    smw_u: jax.Array,
    smw_v: jax.Array,
    mass: ELL,
    w: jax.Array,
    sigma_seq,
    idx_seq,
    chunk: int = 4,
) -> jax.Array:
    """lowrank_adi with the iteration loop CHUNKED on the host: the
    schedule runs as ceil(n_iter / chunk) device programs of `chunk`
    scanned iterations each instead of one length-n_iter device scan.

    Chunks of at most 8 iterations are kept until an H100 measurement
    decides, ROADMAP design item 1. Against one program per iteration,
    chunking at 4 cuts the host dispatch count 4x; chunk=1 reproduces
    the per-iteration behavior exactly.

    Same math as lowrank_adi; the cache/mass ride as pytree ARGUMENTS
    so one trace serves every rebuild (receding-horizon macro steps
    swap cache values, not shapes).
    """
    sig_np = np.asarray(sigma_seq, dtype=np.float64)
    idx_np = np.asarray(idx_seq, dtype=np.int32)
    n_iter = sig_np.shape[0]
    dtype = w.dtype
    chunk = max(1, min(int(chunk), 8))
    v, z0 = _adi_first_iter(
        cache, smw_u, smw_v, w,
        jnp.asarray(sig_np[0], dtype), jnp.int32(idx_np[0]),
    )
    cols = [z0]
    i = 1
    while i < n_iter:
        c = min(chunk, n_iter - i)
        v, _, zs = _adi_chunk(
            cache, smw_u, smw_v, mass, v,
            jnp.asarray(sig_np[i - 1], dtype),
            jnp.asarray(sig_np[i : i + c], dtype),
            jnp.asarray(idx_np[i : i + c]),
            nsteps=c,
        )
        # (c, n, q) -> q-column blocks in iteration order
        cols.extend(zs[j] for j in range(c))
        i += c
    return jnp.concatenate(cols, axis=1)


def lyap_residual_norm(
    ft_z: jax.Array, mt_z: jax.Array, w: jax.Array
) -> jax.Array:
    """||F^T Z Z^T M + M^T Z Z^T F + W W^T||_2 without forming n x n.

    Stack U = [F^T Z, M^T Z, W]; the residual is U D U^T with
    D = [[0, I, 0], [I, 0, 0], [0, 0, I]]. QR-reduce U and take the
    spectral norm of the small T D T^T (SURVEY.md SS4 residual oracles).
    """
    r = ft_z.shape[1]
    q = w.shape[1]
    u = jnp.concatenate([ft_z, mt_z, w], axis=1)
    _, t = jnp.linalg.qr(u, mode="reduced")
    k = t.shape[0]
    d = jnp.zeros((2 * r + q, 2 * r + q), u.dtype)
    eye_r = jnp.eye(r, dtype=u.dtype)
    d = d.at[:r, r : 2 * r].set(eye_r)
    d = d.at[r : 2 * r, :r].set(eye_r)
    d = d.at[2 * r :, 2 * r :].set(jnp.eye(q, dtype=u.dtype))
    mid = t @ d @ t.T
    mid = 0.5 * (mid + mid.T)
    del k
    return jnp.max(jnp.abs(jnp.linalg.eigvalsh(mid)))
