"""Krylov layer: CG/GMRES correctness + the one-LU-many-shifts caches
(SURVEY.md SS7 hard part 1: iterative solves behind the LU contract).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from optconpy_tpu.fem import heat1d_operators
from optconpy_tpu.models import cavity_stokes_setup
from optconpy_tpu.riccati import (
    cycled_shifts,
    lowrank_adi,
    spectral_interval,
    spectral_interval_dae,
    wachspress_shifts,
)
from optconpy_tpu.solvers import (
    SaddleShiftedKrylovCache,
    SaddleShiftedLUCache,
    ShiftedKrylovCache,
    ShiftedLUCache,
    cg,
    gmres,
)


@pytest.fixture(scope="module")
def heat():
    return heat1d_operators(n=64)


@pytest.fixture(scope="module")
def cavity():
    return cavity_stokes_setup(nx=5)


def test_cg_spd_block(heat):
    np_ops, sys = heat
    m_d = np_ops["M"].toarray()
    rng = np.random.default_rng(0)
    b = rng.standard_normal((64, 3))
    x, res = cg(lambda v: jnp.asarray(m_d) @ v, jnp.asarray(b), n_iter=80)
    np.testing.assert_allclose(
        np.asarray(x), np.linalg.solve(m_d, b), rtol=0, atol=1e-10
    )
    assert float(res.max()) < 1e-10


def test_gmres_nonsymmetric(heat):
    np_ops, _ = heat
    rng = np.random.default_rng(1)
    n = 64
    a = np.eye(n) + 0.3 * rng.standard_normal((n, n)) / np.sqrt(n)
    b = rng.standard_normal((n, 2))
    x, res = gmres(lambda v: jnp.asarray(a) @ v, jnp.asarray(b), n_iter=40)
    np.testing.assert_allclose(
        np.asarray(x), np.linalg.solve(a, b), rtol=0, atol=1e-8
    )


def test_shifted_krylov_matches_lu(heat):
    """One-LU GMRES cache == per-shift LU cache, every shift."""
    np_ops, sys = heat
    a_min, a_max = spectral_interval(np_ops["A"], np_ops["M"])
    sig = jnp.asarray(wachspress_shifts(a_min, a_max, 8))
    at_d = jnp.asarray(np_ops["A"].T.toarray())
    lu_cache = ShiftedLUCache.build(at_d, sys.mass.todense(), sig)
    kr_cache = ShiftedKrylovCache.build(at_d, sys.mass, sig, n_iter=25)
    rng = np.random.default_rng(2)
    rhs = jnp.asarray(rng.standard_normal((sys.n, 4)))
    for i in range(8):
        x_lu = np.asarray(lu_cache.solve(jnp.int32(i), rhs))
        x_kr = np.asarray(kr_cache.solve(jnp.int32(i), rhs))
        rel = np.abs(x_kr - x_lu).max() / np.abs(x_lu).max()
        assert rel < 1e-8, (i, rel)


def test_saddle_shifted_krylov_matches_lu(cavity):
    np_ops, sys, _ = cavity
    a_min, a_max = spectral_interval_dae(
        np_ops["A"], np_ops["M"], np_ops["J"]
    )
    sig = jnp.asarray(wachspress_shifts(a_min, a_max, 8))
    m_d, a_d, j_d = sys.dense()
    lu_cache = SaddleShiftedLUCache.build(a_d.T, m_d, j_d, sig)
    kr_cache = SaddleShiftedKrylovCache.build(
        a_d.T, sys.mass, j_d, sig, n_iter=30
    )
    rng = np.random.default_rng(3)
    rhs = jnp.asarray(rng.standard_normal((sys.n, 3)))
    for i in (0, 3, 7):
        x_lu = np.asarray(lu_cache.solve(jnp.int32(i), rhs))
        x_kr = np.asarray(kr_cache.solve(jnp.int32(i), rhs))
        rel = np.abs(x_kr - x_lu).max() / np.abs(x_lu).max()
        assert rel < 1e-7, (i, rel)
    # Feasibility preserved: solutions stay in ker J against BC rhs.
    x_kr = np.asarray(kr_cache.solve(jnp.int32(2), rhs))
    jx = np_ops["J"] @ x_kr
    assert np.abs(jx).max() < 1e-8 * max(1.0, np.abs(x_kr).max())


def test_adi_with_krylov_cache_matches_lu(cavity):
    """The projected low-rank ADI gives the same factor through the
    Krylov cache as through the per-shift LU cache."""
    np_ops, sys, _ = cavity
    a_min, a_max = spectral_interval_dae(
        np_ops["A"], np_ops["M"], np_ops["J"]
    )
    n_sh, n_adi = 8, 16
    sig = jnp.asarray(wachspress_shifts(a_min, a_max, n_sh))
    sigma_seq = jnp.asarray(cycled_shifts(np.asarray(sig), n_adi))
    idx_seq = jnp.asarray(
        cycled_shifts(np.arange(n_sh, dtype=np.int32), n_adi)
    )
    m_d, a_d, j_d = sys.dense()
    lu_cache = SaddleShiftedLUCache.build(a_d.T, m_d, j_d, sig)
    kr_cache = SaddleShiftedKrylovCache.build(
        a_d.T, sys.mass, j_d, sig, n_iter=30
    )
    smw_u = jnp.zeros((sys.n, sys.m_in))
    args = dict(
        smw_u=smw_u, smw_v=sys.b, mass=sys.mass, w=sys.c.T,
        sigma_seq=sigma_seq, idx_seq=idx_seq,
    )
    z_lu = np.asarray(lowrank_adi(lu_cache, **args))
    z_kr = np.asarray(lowrank_adi(kr_cache, **args))
    rel = np.abs(z_kr - z_lu).max() / np.abs(z_lu).max()
    assert rel < 1e-6, rel


def test_inverse_caches_match_lu(heat, cavity):
    """GEMM-apply shifted caches == LU caches (both backends)."""
    np_ops, sys = heat
    a_min, a_max = spectral_interval(np_ops["A"], np_ops["M"])
    sig = jnp.asarray(wachspress_shifts(a_min, a_max, 6))
    at_d = jnp.asarray(np_ops["A"].T.toarray())
    m_d = sys.mass.todense()
    from optconpy_tpu.solvers import (
        SaddleShiftedInverseCache,
        ShiftedInverseCache,
    )

    lu_c = ShiftedLUCache.build(at_d, m_d, sig)
    inv_c = ShiftedInverseCache.build(at_d, m_d, sig)
    rng = np.random.default_rng(4)
    rhs = jnp.asarray(rng.standard_normal((sys.n, 3)))
    for i in (0, 5):
        x1 = np.asarray(lu_c.solve(jnp.int32(i), rhs))
        x2 = np.asarray(inv_c.solve(jnp.int32(i), rhs))
        np.testing.assert_allclose(x2, x1, rtol=0,
                                   atol=1e-9 * np.abs(x1).max())

    np_ops_c, sys_c, _ = cavity
    a_min, a_max = spectral_interval_dae(
        np_ops_c["A"], np_ops_c["M"], np_ops_c["J"]
    )
    sigc = jnp.asarray(wachspress_shifts(a_min, a_max, 6))
    m_dc, a_dc, j_dc = sys_c.dense()
    lu_s = SaddleShiftedLUCache.build(a_dc.T, m_dc, j_dc, sigc)
    inv_s = SaddleShiftedInverseCache.build(a_dc.T, m_dc, j_dc, sigc)
    # Sparse-LU builder (the cheap setup path build_dre_cache_dae
    # uses): must agree with the dense builder.
    inv_sp = SaddleShiftedInverseCache.build_sparse(
        np_ops_c["A"].T.tocsr(), np_ops_c["M"], np_ops_c["J"],
        np.asarray(sigc), dtype=jnp.float64,
    )
    rhs = jnp.asarray(rng.standard_normal((sys_c.n, 2)))
    for i in (1, 4):
        x1 = np.asarray(lu_s.solve(jnp.int32(i), rhs))
        x2 = np.asarray(inv_s.solve(jnp.int32(i), rhs))
        x3 = np.asarray(inv_sp.solve(jnp.int32(i), rhs))
        np.testing.assert_allclose(x2, x1, rtol=0,
                                   atol=1e-8 * np.abs(x1).max())
        np.testing.assert_allclose(x3, x1, rtol=0,
                                   atol=1e-8 * np.abs(x1).max())


def test_gmres_f32_breakdown_stays_finite():
    """Happy breakdown in f32: columns that converge (or are zero)
    before the basis fills must yield FINITE, accurate solutions.

    Regression for a config-4 crash: the old breakdown threshold
    (absolute 1e-12) never fired in f32, so a converged column's
    Arnoldi norm hit 0, w/1e-30 -> inf, and the NaNs propagated
    through the DRE sweep (riccati/lyap_adi.py) and stopped the
    device worker. The scenario: rhs columns spanning 6
    orders of magnitude, including an exactly-zero column, solved with
    a far-too-large basis (n_iter >> iterations-to-convergence).
    """
    from optconpy_tpu.solvers.krylov import fgmres

    rng = np.random.default_rng(3)
    n = 48
    a = np.eye(n) + 0.05 * rng.standard_normal((n, n))
    a32 = jnp.asarray(a, jnp.float32)

    def matvec(x):
        return a32 @ x

    b = rng.standard_normal((n, 4))
    b[:, 1] *= 1e-6  # tiny column: converges immediately vs col 0
    b[:, 2] = 0.0  # exactly zero column
    b[:, 3] *= 1e3
    b32 = jnp.asarray(b, jnp.float32)

    # Basis far larger than needed: most Arnoldi steps past
    # convergence are breakdown steps.
    x, res = gmres(matvec, b32, n_iter=40)
    x = np.asarray(x)
    assert np.isfinite(x).all()
    err = np.abs(a @ x.astype(np.float64) - b)
    assert err[:, 0].max() < 1e-4 * np.abs(b[:, 0]).max()
    assert err[:, 3].max() < 1e-4 * np.abs(b[:, 3]).max()
    assert np.abs(x[:, 2]).max() < 1e-6  # zero rhs -> zero solution

    # Restarted FGMRES: cycles past convergence must not corrupt x.
    xf, rel = fgmres(matvec, b32, m=20, tol=1e-6, max_cycles=8)
    xf = np.asarray(xf)
    assert np.isfinite(xf).all()
    err = np.abs(a @ xf.astype(np.float64) - b)
    assert err[:, 0].max() < 1e-4 * np.abs(b[:, 0]).max()

    # The ADI pattern that triggered the crash: re-solving with the
    # (small) previous solution as rhs, many times over.
    v = b32
    for _ in range(8):
        v, _ = gmres(matvec, 1e-2 * v, n_iter=30)
    assert np.isfinite(np.asarray(v)).all()


def test_gmres_f64_breakdown_stays_finite():
    """f64 case of the breakdown guard (ADVICE r3): the threshold is
    dtype-relative (64 eps ~ 1.4e-14 in f64), so breakdown fires much
    later than in f32 — near-converged columns then lean on the
    R-diagonal truncation. Lock in that the f64 path stays finite and
    accurate through the same over-long-basis + tiny/zero-column
    scenario."""
    from optconpy_tpu.solvers.krylov import fgmres

    rng = np.random.default_rng(3)
    n = 48
    a = np.eye(n) + 0.05 * rng.standard_normal((n, n))
    a64 = jnp.asarray(a, jnp.float64)

    def matvec(x):
        return a64 @ x

    b = rng.standard_normal((n, 4))
    b[:, 1] *= 1e-6
    b[:, 2] = 0.0
    b[:, 3] *= 1e3
    b64 = jnp.asarray(b, jnp.float64)

    x, res = gmres(matvec, b64, n_iter=40)
    x = np.asarray(x)
    assert np.isfinite(x).all()
    err = np.abs(a @ x - b)
    assert err[:, 0].max() < 1e-10 * np.abs(b[:, 0]).max()
    assert err[:, 3].max() < 1e-10 * np.abs(b[:, 3]).max()
    assert np.abs(x[:, 2]).max() < 1e-12

    xf, rel = fgmres(matvec, b64, m=20, tol=1e-10, max_cycles=8)
    xf = np.asarray(xf)
    assert np.isfinite(xf).all()
    assert np.abs(a @ xf - b)[:, 0].max() < 1e-8 * np.abs(b[:, 0]).max()


def test_fgmres_zero_rhs_with_warm_start():
    """A zero/tiny-norm rhs column with a NONZERO warm-start column
    must fall back to the zero initial guess, not amplify x0 by 1/1e-30
    (ADVICE r3: matfree.solve_smw exposes the warm-start path)."""
    from optconpy_tpu.solvers.krylov import fgmres

    rng = np.random.default_rng(5)
    n = 32
    a = np.eye(n) + 0.05 * rng.standard_normal((n, n))
    a32 = jnp.asarray(a, jnp.float32)

    def matvec(x):
        return a32 @ x

    b = rng.standard_normal((n, 3)).astype(np.float32)
    b[:, 1] = 0.0  # zero rhs column
    x0 = rng.standard_normal((n, 3)).astype(np.float32)  # nonzero x0
    x, rel = fgmres(
        matvec, jnp.asarray(b), x0=jnp.asarray(x0), m=20, tol=1e-6,
    )
    x = np.asarray(x)
    assert np.isfinite(x).all()
    assert np.abs(x[:, 1]).max() < 1e-6  # zero rhs -> zero solution
    err = np.abs(a @ x.astype(np.float64) - b)
    assert err[:, 0].max() < 1e-4 * np.abs(b[:, 0]).max()
