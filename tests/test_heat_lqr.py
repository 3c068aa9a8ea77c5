"""Acceptance config 1 (BASELINE.md): 1D heat LQR, 64 dofs, horizon 50.

End-to-end oracle chain per SURVEY.md SS4/SS6: every device-engine stage is
checked against the dense f64 scipy golden of the IDENTICAL scheme to
<= 1e-4 relative error (the north-star fidelity bound).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from optconpy_tpu.control import build_costate_cache, feedforward_sweep
from optconpy_tpu.fem import heat1d_operators, initial_state
from optconpy_tpu.golden import (
    golden_are,
    golden_closed_loop,
    golden_dre_sweep,
    golden_feedforward,
)
from optconpy_tpu.mpc import build_step_cache, closed_loop_rollout
from optconpy_tpu.riccati import (
    build_dre_cache,
    cycled_shifts,
    dre_backward_sweep,
    dre_shift_schedule,
    gain_from_factor,
    lowrank_adi,
    lyap_residual_norm,
    newton_adi_are,
    spectral_interval,
    wachspress_shifts,
)
from optconpy_tpu.solvers import ShiftedLUCache

N = 64
# alpha = 1e-4: the static tracking optimum for these B/C is y ~= 0.232
# of the 0.25 target (computed directly from min ||Gu-y*||^2+alpha||u||^2,
# G = -C A^-1 B); larger alpha makes weak tracking optimal and the
# physics assertion below meaningless.
ALPHA = 1e-4
NTS = 50
T_END = 1.0
DT = T_END / NTS


@pytest.fixture(scope="module")
def heat():
    np_ops, sys = heat1d_operators(n=N)
    return np_ops, sys


@pytest.fixture(scope="module")
def shift_setup(heat):
    np_ops, _ = heat
    a_min, a_max = spectral_interval(np_ops["A"], np_ops["M"])
    sig = wachspress_shifts(a_min, a_max, 12)
    n_adi = 30
    sigma_seq = cycled_shifts(sig, n_adi)
    idx_seq = cycled_shifts(np.arange(12, dtype=np.int32), n_adi)
    return sig, jnp.asarray(sigma_seq), jnp.asarray(idx_seq)


def test_operators_match_scipy(heat):
    np_ops, sys = heat
    v = np.random.default_rng(1).standard_normal(N)
    np.testing.assert_allclose(
        np.asarray(sys.mass.matvec(jnp.asarray(v))),
        np_ops["M"] @ v,
        rtol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(sys.stiff.matvec(jnp.asarray(v))),
        np_ops["A"] @ v,
        rtol=1e-12,
    )


def test_adi_lyapunov_residual(heat, shift_setup):
    """Plain (K = 0) ADI: Lyapunov residual small relative to ||WW^T||."""
    np_ops, sys = heat
    sig, sigma_seq, idx_seq = shift_setup
    m_d, a_d = sys.dense()
    cache = ShiftedLUCache.build(a_d.T, m_d, jnp.asarray(sig))
    w = sys.c.T  # (n, 1)
    z = lowrank_adi(
        cache,
        smw_u=jnp.zeros((N, sys.m_in)),
        smw_v=sys.b,
        mass=sys.mass,
        w=w,
        sigma_seq=sigma_seq,
        idx_seq=idx_seq,
    )
    ft_z = a_d.T @ z
    mt_z = m_d.T @ z
    res = float(lyap_residual_norm(ft_z, mt_z, w))
    w_norm = float(jnp.linalg.norm(w.T @ w, ord=2))
    assert res / w_norm < 1e-8

    # Cross-check against scipy's dense Lyapunov solution.
    import scipy.linalg as sla

    ainv_m = np.linalg.solve(np_ops["M"].toarray(), np_ops["A"].toarray())
    # A^T X M + M X A = -W W^T  <=>  (M^-1 A)^T Y + Y (M^-1 A) = -W W^T
    # with Y = M X M.
    y = sla.solve_lyapunov(ainv_m.T, -np.asarray(w @ w.T))
    minv = np.linalg.inv(np_ops["M"].toarray())
    x_dense = minv @ y @ minv
    x_adi = np.asarray(z @ z.T)
    rel = np.linalg.norm(x_adi - x_dense) / np.linalg.norm(x_dense)
    assert rel < 1e-8


def test_newton_adi_matches_scipy_are(heat, shift_setup):
    np_ops, sys = heat
    sig, sigma_seq, idx_seq = shift_setup
    m_d, a_d = sys.dense()
    cache = ShiftedLUCache.build(a_d.T, m_d, jnp.asarray(sig))
    z, k = newton_adi_are(
        sys, cache, ALPHA, sigma_seq, idx_seq, n_newton=10, out_rank=50
    )
    x_gold = golden_are(
        np_ops["M"], np_ops["A"], np_ops["B"], np_ops["C"], ALPHA
    )
    x_lr = np.asarray(z @ z.T)
    rel = np.linalg.norm(x_lr - x_gold) / np.linalg.norm(x_gold)
    assert rel < 1e-6, rel
    k_gold = (
        np_ops["B"].T @ x_gold @ np_ops["M"].toarray()
    ) / ALPHA
    rel_k = np.linalg.norm(np.asarray(k) - k_gold) / np.linalg.norm(k_gold)
    assert rel_k < 1e-6, rel_k


@pytest.fixture(scope="module")
def dre_solution(heat):
    np_ops, sys = heat
    sig, sigma_seq, idx_seq = dre_shift_schedule(
        np_ops["A"], np_ops["M"], DT, num_shifts=12, n_adi=26
    )
    cache = build_dre_cache(sys, DT, sig)
    zs, ks = dre_backward_sweep(
        sys,
        cache,
        ALPHA,
        DT,
        NTS,
        jnp.asarray(sigma_seq),
        jnp.asarray(idx_seq),
        n_newton=3,
        r_max=60,
    )
    xs_gold = golden_dre_sweep(
        np_ops["M"], np_ops["A"], np_ops["B"], np_ops["C"], ALPHA, DT, NTS
    )
    return zs, ks, xs_gold


@pytest.mark.slow
def test_dre_matches_golden(heat, dre_solution):
    np_ops, sys = heat
    zs, ks, xs_gold = dre_solution
    m_d = np_ops["M"].toarray()
    b = np_ops["B"]
    for k_idx in [0, 10, 25, 49]:
        x_lr = np.asarray(zs[k_idx] @ zs[k_idx].T)
        rel = np.linalg.norm(x_lr - xs_gold[k_idx]) / np.linalg.norm(
            xs_gold[k_idx]
        )
        assert rel < 1e-5, (k_idx, rel)
        k_gold = b.T @ xs_gold[k_idx] @ m_d / ALPHA
        rel_k = np.linalg.norm(np.asarray(ks[k_idx]) - k_gold) / max(
            np.linalg.norm(k_gold), 1e-30
        )
        assert rel_k < 1e-5, (k_idx, rel_k)


@pytest.mark.slow
def test_closed_loop_matches_golden(heat, dre_solution):
    """The north-star check: closed-loop sequence to <= 1e-4 rel err."""
    np_ops, sys = heat
    zs, ks, xs_gold = dre_solution
    v0 = initial_state(N)
    ystar = np.tile(np.array([0.25]), (NTS + 1, 1))  # constant target

    ws_gold = golden_feedforward(
        np_ops["M"],
        np_ops["A"],
        np_ops["B"],
        np_ops["C"],
        ALPHA,
        DT,
        xs_gold,
        ystar,
    )
    vs_g, us_g, ys_g = golden_closed_loop(
        np_ops["M"],
        np_ops["A"],
        np_ops["B"],
        np_ops["C"],
        ALPHA,
        DT,
        xs_gold,
        ws_gold,
        v0,
    )

    cost_cache = build_costate_cache(sys, DT)
    ws = feedforward_sweep(
        sys, cost_cache, ks, jnp.asarray(ystar), DT
    )
    step_cache = build_step_cache(sys, DT)
    vs, us, ys = closed_loop_rollout(
        sys, step_cache, ks, ws, jnp.asarray(v0), ALPHA, DT
    )

    rel_v = np.linalg.norm(np.asarray(vs) - vs_g) / np.linalg.norm(vs_g)
    rel_u = np.linalg.norm(np.asarray(us) - us_g) / np.linalg.norm(us_g)
    rel_y = np.linalg.norm(np.asarray(ys) - ys_g) / np.linalg.norm(ys_g)
    assert rel_v < 1e-4, rel_v
    assert rel_u < 1e-4, rel_u
    assert rel_y < 1e-4, rel_y

    # Control must actually track mid-horizon (near t=T the optimal
    # control shuts off — X(T)=w(T)=0 with no terminal cost — and the
    # heat state decays, so the terminal output is NOT near the target).
    assert abs(float(ys[NTS // 2, 0]) - 0.232) < 0.05


@pytest.mark.slow
def test_implicit_feedback_matches_golden(heat, dre_solution):
    """SMW-implicit feedback rollout vs its dense f64 oracle, and
    agreement with the explicit loop to O(dt) (same continuous limit)."""
    from optconpy_tpu.golden import golden_closed_loop_implicit

    np_ops, sys = heat
    zs, ks, xs_gold = dre_solution
    v0 = initial_state(N)
    ystar = np.tile(np.array([0.25]), (NTS + 1, 1))
    ws_gold = golden_feedforward(
        np_ops["M"], np_ops["A"], np_ops["B"], np_ops["C"],
        ALPHA, DT, xs_gold, ystar,
    )
    vs_g, us_g, ys_g = golden_closed_loop_implicit(
        np_ops["M"], np_ops["A"], np_ops["B"], np_ops["C"],
        ALPHA, DT, xs_gold, ws_gold, v0,
    )
    cost_cache = build_costate_cache(sys, DT)
    ws = feedforward_sweep(sys, cost_cache, ks, jnp.asarray(ystar), DT)
    step_cache = build_step_cache(sys, DT)
    vs, us, ys = closed_loop_rollout(
        sys, step_cache, ks, ws, jnp.asarray(v0), ALPHA, DT,
        feedback="implicit",
    )
    rel_v = np.linalg.norm(np.asarray(vs) - vs_g) / np.linalg.norm(vs_g)
    assert rel_v < 1e-4, rel_v
    # Same continuous-time limit as the explicit loop:
    vs_e, _, _ = closed_loop_rollout(
        sys, step_cache, ks, ws, jnp.asarray(v0), ALPHA, DT,
        feedback="explicit",
    )
    # Both schemes are first-order; their gap is O(dt) of the transient
    # (~10% at dt = 0.02 here), not a bug.
    drift = np.linalg.norm(np.asarray(vs) - np.asarray(vs_e))
    assert drift / np.linalg.norm(vs_e) < 0.2
