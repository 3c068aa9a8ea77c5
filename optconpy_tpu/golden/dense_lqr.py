"""Serial f64 dense scipy golden path — the executable oracle.

The reference publishes no numbers and its tree was unavailable at
survey time (SURVEY.md SS0, SS6); per BASELINE.md the acceptance
contract is MATHEMATICAL: the device engine must reproduce this dense
f64 implementation of the identical discretization to <= 1e-4 relative
error. Everything here is deliberately naive, dense, and serial.

Scheme (matches riccati/dre.py exactly):

  DRE  -M^T X' M = A^T X M + M^T X A - M^T X B R^-1 B^T X M + C^T C,
  X(tE) = 0, discretized backward-in-time by implicit Euler. Each step
  solves the generalized ARE

    Atil^T Xk M + M^T Xk Atil - M^T Xk B R^-1 B^T Xk M + Qk = 0,
    Atil = A - M / (2 dt),   Qk = C^T C + M^T X_{k+1} M / dt,

  via scipy.linalg.solve_continuous_are(a=Atil, b=B, q=Qk, r=R, e=M).

  Feedforward (tracking y*):  M^T w' = -(A - B R^-1 B^T X M)^T w - C^T y*,
  w(tE) = 0, implicit Euler backward:
    (M^T/dt - Fk^T) wk = M^T w_{k+1} / dt + C^T ystar_k.

  Closed loop, implicit Euler forward:
    (M/dt - A) v_{k+1} = M vk / dt + B uk,
    uk = -R^-1 B^T (Xk M vk - wk).
"""
from __future__ import annotations

import numpy as np
import scipy.linalg as sla


def _dense(x):
    return x.toarray() if hasattr(x, "toarray") else np.asarray(x)


def golden_are(m, a, b, c, alpha: float) -> np.ndarray:
    """Generalized CARE solution X (infinite-horizon LQR)."""
    m, a, b, c = map(_dense, (m, a, b, c))
    r = alpha * np.eye(b.shape[1])
    q = c.T @ c
    return sla.solve_continuous_are(a, b, q, r, e=m, s=None)


def golden_dre_sweep(
    m, a, b, c, alpha: float, dt: float, nts: int, xT=None
) -> list:
    """Backward implicit-Euler DRE sweep; returns [X_0, ..., X_nts]."""
    m, a, b, c = map(_dense, (m, a, b, c))
    n = m.shape[0]
    r = alpha * np.eye(b.shape[1])
    x = np.zeros((n, n)) if xT is None else np.asarray(xT)
    atil = a - m / (2.0 * dt)
    xs = [None] * (nts + 1)
    xs[nts] = x
    for k in range(nts - 1, -1, -1):
        q = c.T @ c + m.T @ xs[k + 1] @ m / dt
        q = 0.5 * (q + q.T)
        xs[k] = sla.solve_continuous_are(atil, b, q, r, e=m, s=None)
    return xs


def golden_feedforward(
    m, a, b, c, alpha: float, dt: float, xs: list, ystar
) -> list:
    """Backward implicit-Euler tracking feedforward; [w_0, ..., w_nts].

    ystar: (nts+1, p) target outputs at the time grid.
    """
    m, a, b, c = map(_dense, (m, a, b, c))
    n = m.shape[0]
    nts = len(xs) - 1
    ws = [None] * (nts + 1)
    ws[nts] = np.zeros(n)
    for k in range(nts - 1, -1, -1):
        fk = a - b @ (b.T @ xs[k] @ m) / alpha
        lhs = m.T / dt - fk.T
        rhs = m.T @ ws[k + 1] / dt + c.T @ np.asarray(ystar[k])
        ws[k] = np.linalg.solve(lhs, rhs)
    return ws


def golden_closed_loop(
    m, a, b, c, alpha: float, dt: float, xs: list, ws, v0
):
    """Implicit-Euler forward closed loop; returns (vs, us, ys)."""
    m, a, b, c = map(_dense, (m, a, b, c))
    nts = len(xs) - 1
    n = m.shape[0]
    lhs = m / dt - a
    lu, piv = sla.lu_factor(lhs)
    vs = np.zeros((nts + 1, n))
    us = np.zeros((nts, b.shape[1]))
    ys = np.zeros((nts + 1, c.shape[0]))
    vs[0] = np.asarray(v0)
    ys[0] = c @ vs[0]
    for k in range(nts):
        wk = ws[k] if ws is not None else np.zeros(n)
        us[k] = -(b.T @ (xs[k] @ (m @ vs[k]) - wk)) / alpha
        rhs = m @ vs[k] / dt + b @ us[k]
        vs[k + 1] = sla.lu_solve((lu, piv), rhs)
        ys[k + 1] = c @ vs[k + 1]
    return vs, us, ys


def golden_closed_loop_cn(
    m, a, b, c, alpha: float, dt: float, xs: list, ws, v0
):
    """Trapezoid (Crank-Nicolson) forward closed loop, explicit control
    — oracle for closed_loop_rollout(scheme='cn', feedback='explicit')
    (SURVEY.md SS2 row 7: the reference's 'IMEX Euler or trapezoid'):
      K_mid = (K_k + K_{k+1})/2,  u_k = -K_mid v_k + (1/alpha) B^T w_mid
      (M/dt - A/2) v_{k+1} = (M/dt + A/2) v_k + B u_k
    """
    m, a, b, c = map(_dense, (m, a, b, c))
    nts = len(xs) - 1
    n = m.shape[0]
    lhs = m / dt - 0.5 * a
    lu, piv = sla.lu_factor(lhs)
    ks = [(b.T @ xs[k] @ m) / alpha for k in range(nts + 1)]
    vs = np.zeros((nts + 1, n))
    us = np.zeros((nts, b.shape[1]))
    ys = np.zeros((nts + 1, c.shape[0]))
    vs[0] = np.asarray(v0)
    ys[0] = c @ vs[0]
    for k in range(nts):
        k_mid = 0.5 * (ks[k] + ks[k + 1])
        w_mid = (
            0.5 * (ws[k] + ws[k + 1]) if ws is not None else np.zeros(n)
        )
        us[k] = -(k_mid @ vs[k]) + (b.T @ w_mid) / alpha
        rhs = m @ vs[k] / dt + 0.5 * (a @ vs[k]) + b @ us[k]
        vs[k + 1] = sla.lu_solve((lu, piv), rhs)
        ys[k + 1] = c @ vs[k + 1]
    return vs, us, ys


def golden_closed_loop_cn_implicit(
    m, a, b, c, alpha: float, dt: float, xs: list, ws, v0
):
    """Trapezoid forward loop with the feedback averaged across the
    step (true CN on the closed-loop operator F = A - B K_mid) —
    oracle for closed_loop_rollout(scheme='cn', feedback='implicit'):
      (M/dt - A/2 + B K_mid/2) v+ = (M/dt + A/2 - B K_mid/2) v + B uff
      u_k = -K_mid (v_k + v_{k+1})/2 + uff,  uff = (1/alpha) B^T w_mid
    """
    m, a, b, c = map(_dense, (m, a, b, c))
    nts = len(xs) - 1
    n = m.shape[0]
    ks = [(b.T @ xs[k] @ m) / alpha for k in range(nts + 1)]
    vs = np.zeros((nts + 1, n))
    us = np.zeros((nts, b.shape[1]))
    ys = np.zeros((nts + 1, c.shape[0]))
    vs[0] = np.asarray(v0)
    ys[0] = c @ vs[0]
    for k in range(nts):
        k_mid = 0.5 * (ks[k] + ks[k + 1])
        w_mid = (
            0.5 * (ws[k] + ws[k + 1]) if ws is not None else np.zeros(n)
        )
        uff = (b.T @ w_mid) / alpha
        bk = b @ k_mid
        lhs = m / dt - 0.5 * a + 0.5 * bk
        rhs = (m / dt + 0.5 * a - 0.5 * bk) @ vs[k] + b @ uff
        vs[k + 1] = np.linalg.solve(lhs, rhs)
        us[k] = -(k_mid @ (0.5 * (vs[k] + vs[k + 1]))) + uff
        ys[k + 1] = c @ vs[k + 1]
    return vs, us, ys


def golden_closed_loop_implicit(
    m, a, b, c, alpha: float, dt: float, xs: list, ws, v0
):
    """Implicit-Euler forward loop with IMPLICIT feedback; returns
    (vs, us, ys). Oracle for closed_loop_rollout(feedback='implicit'):
      (M/dt - A + B K_k) v_{k+1} = M v_k/dt + (1/alpha) B B^T w_k,
      u_k = -K_k v_{k+1} + (1/alpha) B^T w_k,  K_k = (1/alpha) B^T X_k M.
    """
    m, a, b, c = map(_dense, (m, a, b, c))
    nts = len(xs) - 1
    n = m.shape[0]
    vs = np.zeros((nts + 1, n))
    us = np.zeros((nts, b.shape[1]))
    ys = np.zeros((nts + 1, c.shape[0]))
    vs[0] = np.asarray(v0)
    ys[0] = c @ vs[0]
    for k in range(nts):
        wk = ws[k] if ws is not None else np.zeros(n)
        kk = (b.T @ xs[k] @ m) / alpha
        uff = (b.T @ wk) / alpha
        rhs = m @ vs[k] / dt + b @ uff
        vs[k + 1] = np.linalg.solve(m / dt - a + b @ kk, rhs)
        us[k] = -(kk @ vs[k + 1]) + uff
        ys[k + 1] = c @ vs[k + 1]
    return vs, us, ys
