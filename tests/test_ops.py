"""ops/ substrate tests: ELL vs scipy, low-rank utils, dense caches."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from optconpy_tpu.ops import (
    ELL,
    CholeskySolver,
    LUSolver,
    append_columns,
    compress,
    ell_from_scipy,
    ell_to_scipy,
    lowrank_matvec,
    smw_solve,
    tsqr,
    tsqr_cholqr2,
)

RNG = np.random.default_rng(0)


def _random_csr(m, n, density=0.1):
    a = sp.random(m, n, density=density, random_state=42, format="csr")
    a.data[:] = RNG.standard_normal(a.nnz)
    return a


class TestELL:
    def test_roundtrip(self):
        a = _random_csr(37, 23)
        ell = ell_from_scipy(a, pad_to=4)
        back = ell_to_scipy(ell)
        np.testing.assert_allclose(back.toarray(), a.toarray(), atol=1e-14)

    def test_matvec_matches_scipy(self):
        a = _random_csr(50, 40)
        ell = ell_from_scipy(a)
        x = RNG.standard_normal(40)
        np.testing.assert_allclose(
            np.asarray(ell.matvec(jnp.asarray(x))), a @ x, rtol=1e-12
        )

    def test_matmat_matches_scipy(self):
        a = _random_csr(50, 40)
        ell = ell_from_scipy(a, pad_to=8)
        x = RNG.standard_normal((40, 7))
        np.testing.assert_allclose(
            np.asarray(ell.matmat(jnp.asarray(x))), a @ x, rtol=1e-12
        )

    def test_todense(self):
        a = _random_csr(20, 20)
        ell = ell_from_scipy(a)
        np.testing.assert_allclose(
            np.asarray(ell.todense()), a.toarray(), atol=1e-14
        )


@pytest.fixture(scope="module")
def saddle_ops_rcm():
    """Cavity saddle operators in the matrix-free solvers' orderings."""
    from optconpy_tpu.models import cavity_stokes_setup
    from optconpy_tpu.ops.sparse import rcm_permutation, sort_rows_by_window

    np_ops, _, _ = cavity_stokes_setup(nx=6)
    m = sp.csr_matrix(np_ops["M"])
    at = sp.csr_matrix(np_ops["A"]).T.tocsr()
    j = sp.csr_matrix(np_ops["J"])
    perm = rcm_permutation(m, at)
    j_c = j[:, perm].tocsr()
    j_r = j_c[sort_rows_by_window(j_c)].tocsr()
    return {
        "M": m[perm][:, perm].tocsr(),
        "At": at[perm][:, perm].tocsr(),
        "J": j_r,
        "Jt": j_r.T.tocsr(),
        "perm": perm,
        "orig_M": m,
    }


@pytest.mark.parametrize("name", ["M", "At", "J", "Jt"])
def test_ell_pack_spmm_matches_scipy(saddle_ops_rcm, name):
    """The device SpMM path (pad-8 ELL pack, `pack @ x`) against scipy
    on each FEM operator the matrix-free and NS tiers pack."""
    a = saddle_ops_rcm[name]
    pack = ell_from_scipy(a, pad_to=8, dtype=np.float64)
    assert pack.row_nnz % 8 == 0
    x = RNG.standard_normal((a.shape[1], 5))
    np.testing.assert_allclose(
        np.asarray(pack @ jnp.asarray(x)), a @ x, rtol=1e-12, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(pack @ jnp.asarray(x[:, 0])), a @ x[:, 0],
        rtol=1e-12, atol=1e-12,
    )


def test_rcm_permutation_narrows_band(saddle_ops_rcm):
    perm = saddle_ops_rcm["perm"]
    m = saddle_ops_rcm["orig_M"]
    assert np.array_equal(np.sort(perm), np.arange(m.shape[0]))

    def bandwidth(a):
        c = a.tocoo()
        return int(np.abs(c.row - c.col).max())

    assert bandwidth(saddle_ops_rcm["M"]) <= bandwidth(m)
    j = saddle_ops_rcm["J"]
    first = [j.indices[j.indptr[i]:j.indptr[i + 1]].min()
             for i in range(j.shape[0]) if j.indptr[i + 1] > j.indptr[i]]
    assert np.all(np.diff(first) >= 0)


class TestLowRank:
    def test_tsqr_qr(self):
        z = jnp.asarray(RNG.standard_normal((100, 8)))
        q, r = tsqr(z)
        np.testing.assert_allclose(np.asarray(q @ r), np.asarray(z), atol=1e-10)
        np.testing.assert_allclose(
            np.asarray(q.T @ q), np.eye(8), atol=1e-10
        )

    def test_tsqr_cholqr2(self):
        z = jnp.asarray(RNG.standard_normal((200, 10)))
        q, r = tsqr_cholqr2(z)
        np.testing.assert_allclose(np.asarray(q @ r), np.asarray(z), atol=1e-8)
        np.testing.assert_allclose(
            np.asarray(q.T @ q), np.eye(10), atol=1e-8
        )

    def test_compress_preserves_gram(self):
        base = RNG.standard_normal((80, 5))
        z = jnp.asarray(np.hstack([base, base @ RNG.standard_normal((5, 11))]))
        zc = compress(z, out_rank=8)
        assert zc.shape == (80, 8)
        np.testing.assert_allclose(
            np.asarray(zc @ zc.T), np.asarray(z @ z.T), rtol=1e-8, atol=1e-8
        )

    def test_compress_wide(self):
        # More columns than rows (post-ADI buffers): still exact.
        base = RNG.standard_normal((16, 40))
        z = jnp.asarray(base)
        zc = compress(z, out_rank=16)
        np.testing.assert_allclose(
            np.asarray(zc @ zc.T), base @ base.T, rtol=1e-8, atol=1e-8
        )

    def test_append_columns(self):
        z = jnp.zeros((10, 6))
        v = jnp.asarray(RNG.standard_normal((10, 2)))
        z2, cnt = append_columns(z, v, jnp.int32(2))
        assert int(cnt) == 4
        np.testing.assert_allclose(np.asarray(z2[:, 2:4]), np.asarray(v))

    def test_lowrank_matvec(self):
        z = jnp.asarray(RNG.standard_normal((30, 4)))
        x = jnp.asarray(RNG.standard_normal(30))
        np.testing.assert_allclose(
            np.asarray(lowrank_matvec(z, x)),
            np.asarray(z) @ (np.asarray(z).T @ np.asarray(x)),
            rtol=1e-12,
        )


class TestDense:
    def test_lu_solver(self):
        a = RNG.standard_normal((20, 20)) + 20 * np.eye(20)
        b = RNG.standard_normal((20, 3))
        solver = LUSolver.factor(jnp.asarray(a))
        np.testing.assert_allclose(
            np.asarray(solver.apply(jnp.asarray(b))),
            np.linalg.solve(a, b),
            rtol=1e-10,
        )

    def test_cholesky_solver(self):
        g = RNG.standard_normal((15, 15))
        a = g @ g.T + 15 * np.eye(15)
        b = RNG.standard_normal(15)
        solver = CholeskySolver.factor(jnp.asarray(a))
        np.testing.assert_allclose(
            np.asarray(solver.apply(jnp.asarray(b))),
            np.linalg.solve(a, b),
            rtol=1e-10,
        )

    def test_smw_matches_dense(self):
        n, r = 25, 3
        a = RNG.standard_normal((n, n)) + 25 * np.eye(n)
        u = RNG.standard_normal((n, r))
        v = RNG.standard_normal((n, r))
        b = RNG.standard_normal(n)
        solver = LUSolver.factor(jnp.asarray(a))
        x = smw_solve(
            solver.apply, jnp.asarray(u), jnp.asarray(v), jnp.asarray(b)
        )
        np.testing.assert_allclose(
            np.asarray(x), np.linalg.solve(a - u @ v.T, b), rtol=1e-8
        )

    def test_smw_zero_update_is_plain_solve(self):
        n = 10
        a = RNG.standard_normal((n, n)) + 10 * np.eye(n)
        b = RNG.standard_normal(n)
        solver = LUSolver.factor(jnp.asarray(a))
        x = smw_solve(
            solver.apply,
            jnp.zeros((n, 2)),
            jnp.zeros((n, 2)),
            jnp.asarray(b),
        )
        np.testing.assert_allclose(
            np.asarray(x), np.linalg.solve(a, b), rtol=1e-10
        )


def test_dense_inverse_matches_lu():
    from optconpy_tpu.ops.dense import DenseInverse, LUSolver

    rng = np.random.default_rng(7)
    n = 80
    a = rng.standard_normal((n, n)) + 3 * np.sqrt(n) * np.eye(n)
    b = rng.standard_normal((n, 5))
    x_lu = np.asarray(LUSolver.factor(jnp.asarray(a)).apply(jnp.asarray(b)))
    x_inv = np.asarray(
        DenseInverse.factor(jnp.asarray(a)).apply(jnp.asarray(b))
    )
    np.testing.assert_allclose(x_inv, x_lu, rtol=0, atol=1e-10)


def test_saddle_inverse_matches_saddle_lu():
    from optconpy_tpu.solvers import SaddleInverse, SaddleLU

    rng = np.random.default_rng(8)
    n, n_p = 60, 12
    f = rng.standard_normal((n, n)) + 3 * np.sqrt(n) * np.eye(n)
    j = rng.standard_normal((n_p, n))
    rv = rng.standard_normal((n, 3))
    rp = rng.standard_normal((n_p, 3))
    lu = SaddleLU.build(jnp.asarray(f), jnp.asarray(j))
    inv = SaddleInverse.build(jnp.asarray(f), jnp.asarray(j))
    np.testing.assert_allclose(
        np.asarray(inv.apply(jnp.asarray(rv), jnp.asarray(rp))),
        np.asarray(lu.apply(jnp.asarray(rv), jnp.asarray(rp))),
        rtol=0, atol=1e-9,
    )
    v1, p1 = inv.apply_full(jnp.asarray(rv), jnp.asarray(rp))
    v2, p2 = lu.apply_full(jnp.asarray(rv), jnp.asarray(rp))
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p2), atol=1e-9)
