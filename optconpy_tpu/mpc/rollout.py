"""Closed-loop transient rollouts under lax.scan.

The reference's solve_nse loop (SURVEY.md SS3.4): factor the implicit
system once, then per step apply feedback (tall-skinny matvecs) and one
cached triangular solve. Here the linear (LTI / Oseen-linearized)
rollout is a lax.scan whose body is two dense triangular solves on the
device; scenarios batch via vmap over the initial state / targets, which
is what "closed-loop MPC solves/s/chip" measures (BASELINE.md).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..fem.operators import LTISystem
from ..ops.dense import LUSolver


def build_step_cache(
    sys: LTISystem, dt: float, scheme: str = "euler"
) -> LUSolver:
    """LU of the implicit time-step system, factored once.

    scheme='euler': M/dt - A (first order);
    scheme='cn':    M/dt - A/2 (trapezoid / Crank-Nicolson, second
    order — SURVEY.md SS2 row 7: the reference's transient loop offers
    'IMEX Euler or trapezoid').
    """
    m_d, a_d = sys.dense()
    theta = _scheme_theta(scheme)
    return LUSolver.factor(m_d / dt - theta * a_d)


def _scheme_theta(scheme: str) -> float:
    if scheme == "euler":
        return 1.0
    if scheme == "cn":
        return 0.5
    raise ValueError(f"unknown time scheme: {scheme}")


def build_step_cache_dae(sys, dt: float, scheme: str = "euler"):
    """Saddle LU of [[M/dt - theta A, J^T], [J, 0]] for constrained
    rollouts (theta = 1 Euler, 1/2 trapezoid).

    SaddleLU.apply returns the velocity block, so closed_loop_rollout
    works unchanged for DAE systems (iterates stay in ker J).
    """
    from ..solvers.saddle import SaddleLU

    m_d, a_d, j_d = sys.dense()
    return SaddleLU.build(m_d / dt - _scheme_theta(scheme) * a_d, j_d)


@partial(jax.jit, static_argnames=("feedback", "scheme"))
def closed_loop_rollout(
    sys: LTISystem,
    cache: LUSolver,
    ks: jax.Array,
    ws: jax.Array,
    v0: jax.Array,
    alpha: float,
    dt: float,
    feedback: str = "explicit",
    scheme: str = "euler",
):
    """Forward closed loop; returns (vs, us, ys).

    ks: (nts + 1, m, n) gains; ws: (nts + 1, n) feedforward states;
    v0: (n,) initial state. The cache must be built with the SAME
    scheme (build_step_cache(..., scheme=...)).

    scheme='euler' (first order):
      feedback='explicit' (matches golden_closed_loop step-for-step):
        u_k = -K_k v_k + (1/alpha) B^T w_k
        (M/dt - A) v_{k+1} = M v_k / dt + B u_k
      feedback='implicit' (robust for cheap-control gains whose
      closed-loop poles exceed 1/dt — the explicit loop then diverges):
        (M/dt - A + B K_k) v_{k+1} = M v_k/dt + (1/alpha) B B^T w_k
        u_k = -K_k v_{k+1} + (1/alpha) B^T w_k
      implemented via SMW on the SAME cached LU (the reference's
      solve_sadpnt_smw pattern, SURVEY.md SS2 row 5): G = (M/dt-A)^-1 B
      is constant, so each step adds only an (m, m) solve.

    scheme='cn' (trapezoid, second order in the closed-loop dynamics;
    golden_closed_loop_cn is the oracle). With the midpoint gain
    K_mid = (K_k + K_{k+1})/2 and feedforward w_mid likewise:
      feedback='explicit': u from the left state,
        u_k = -K_mid v_k + (1/alpha) B^T w_mid
        (M/dt - A/2) v_{k+1} = (M/dt + A/2) v_k + B u_k
        (control coupling is first order; plant operator second order)
      feedback='implicit': the feedback is averaged across the step —
        true trapezoid on the closed-loop operator F = A - B K_mid:
        (M/dt - A/2 + B K_mid/2) v+ =
            (M/dt + A/2 - B K_mid/2) v + B uff_mid
        u_k = -K_mid (v_k + v_{k+1})/2 + uff_mid
      (SMW with the constant G = (M/dt - A/2)^-1 B.)
    """
    bt = sys.b.T

    if scheme == "cn":
        ks_l, ks_r = ks[:-1], ks[1:]
        ws_l, ws_r = ws[:-1], ws[1:]
        k_seq = 0.5 * (ks_l + ks_r)
        w_seq = 0.5 * (ws_l + ws_r)
    else:
        k_seq, w_seq = ks[:-1], ws[:-1]

    def rhs_lin(v):
        r = sys.mass.matvec(v) / dt
        if scheme == "cn":
            r = r + 0.5 * sys.stiff.matvec(v)
        return r

    if feedback == "implicit":
        gmat = cache.apply(sys.b)  # (n, m), hoisted out of the scan
        eye_m = jnp.eye(sys.m_in, dtype=gmat.dtype)

        if scheme == "cn":

            def step(v, inp):
                k_gain, w_k = inp
                uff = (bt @ w_k) / alpha
                kv = k_gain @ v
                rhs = rhs_lin(v) - 0.5 * (sys.b @ kv) + sys.b @ uff
                x0 = cache.apply(rhs)
                s_small = eye_m + 0.5 * (k_gain @ gmat)
                corr = jnp.linalg.solve(s_small, k_gain @ x0)
                v_next = x0 - 0.5 * (gmat @ corr)
                u = -0.5 * (k_gain @ (v + v_next)) + uff
                return v_next, (v_next, u)

        else:

            def step(v, inp):
                k_gain, w_k = inp
                uff = (bt @ w_k) / alpha
                rhs = rhs_lin(v) + sys.b @ uff
                x0 = cache.apply(rhs)
                s_small = eye_m + k_gain @ gmat
                corr = jnp.linalg.solve(s_small, k_gain @ x0)
                v_next = x0 - gmat @ corr
                u = -(k_gain @ v_next) + uff
                return v_next, (v_next, u)

    else:

        def step(v, inp):
            k_gain, w_k = inp
            u = -(k_gain @ v) + (bt @ w_k) / alpha
            rhs = rhs_lin(v) + sys.b @ u
            v_next = cache.apply(rhs)
            return v_next, (v_next, u)

    _, (vs_tail, us) = jax.lax.scan(step, v0, (k_seq, w_seq))
    vs = jnp.concatenate([v0[None], vs_tail], axis=0)
    ys = vs @ sys.c.T
    return vs, us, ys


def batched_closed_loop(
    sys: LTISystem,
    cache: LUSolver,
    ks: jax.Array,
    ws: jax.Array,
    v0_batch: jax.Array,
    alpha: float,
    dt: float,
    feedback: str = "explicit",
    scheme: str = "euler",
):
    """vmap over a scenario batch of initial states: v0_batch (S, n).

    Gains/feedforward are shared (same linearization) — the batched MPC
    inner kernel; sharding of the S axis lives in parallel/.
    """
    return jax.vmap(
        lambda v0: closed_loop_rollout(
            sys, cache, ks, ws, v0, alpha, dt, feedback, scheme
        )
    )(v0_batch)
