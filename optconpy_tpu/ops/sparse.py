"""Static-sparsity sparse operators on the device.

The reference keeps all FEM operators as scipy.sparse CSR and solves
through SuperLU (SURVEY.md SS2 rows 5, 10; SS3.1 hot kernels). Here the
sparsity is frozen offline (FEM layer, SURVEY.md SS3.5 caching
boundary) into a padded-ELL layout: every row stores exactly `k` (value,
col) pairs, zero-padded. On-device SpMV/SpMM is then a static gather +
dense contraction — no dynamic shapes, vmap/scan-safe. The host-side
orderings below (RCM, window-sorted rows) narrow each operator's band
for the matrix-free solvers' block-Jacobi preconditioner.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def rcm_permutation(*mats) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of the union pattern of `mats`.

    Host-side setup step: returns perm such that mat[perm][:, perm] is
    banded. Apply to the velocity dof set once, at the FEM -> device
    boundary (SURVEY.md SS3.5).
    """
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg

    patt = None
    for m in mats:
        m = sp.csr_matrix(m)
        m = abs(m) + abs(m).T
        patt = m if patt is None else patt + m
    return np.asarray(
        csg.reverse_cuthill_mckee(patt.tocsr(), symmetric_mode=True)
    )


def sort_rows_by_window(csr) -> np.ndarray:
    """Row order sorting rows by their first nonzero column.

    For rectangular operators (J: pressure rows x velocity cols) whose
    column space was RCM-ordered: sorting rows geometrically narrows the
    band the same way RCM does for square operators.
    """
    import scipy.sparse as sp

    m = sp.csr_matrix(csr)
    first = np.full(m.shape[0], m.shape[1], dtype=np.int64)
    for i in range(m.shape[0]):
        lo, hi = m.indptr[i], m.indptr[i + 1]
        if hi > lo:
            first[i] = m.indices[lo:hi].min()
    return np.argsort(first, kind="stable")


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("data", "cols"),
    meta_fields=("shape",),
)
@dataclass(frozen=True)
class ELL:
    """Padded-ELL sparse matrix: row-major, fixed nnz per row.

    data: (m, k) float values, zero-padded.
    cols: (m, k) int32 column indices; padded entries point at column 0
          with data 0.0 so gathers stay in-bounds and contribute nothing.
    shape: static (m, n).
    """

    data: jax.Array
    cols: jax.Array
    shape: tuple

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def row_nnz(self) -> int:
        return self.data.shape[1]

    def matvec(self, x: jax.Array) -> jax.Array:
        """y = A @ x for x of shape (n,)."""
        return jnp.einsum("mk,mk->m", self.data, x[self.cols])

    def matmat(self, x: jax.Array) -> jax.Array:
        """Y = A @ X for X of shape (n, b) — batched SpMM.

        Wide X (dense right-hand blocks, e.g. the Newton-Schulz
        inverse builds applying the operator to (n, n) columns) is
        column-chunked under lax.map: the einsum lowering materializes
        the (m, k, b) gather, which at b ~ n is multi-GB of device
        memory — chunking caps it at ~128 MB with identical math.
        """
        m, k = self.data.shape
        b = x.shape[1]
        budget = 128 * 1024 * 1024
        cb = max(128, budget // max(m * k * 4, 1) // 128 * 128)
        if b <= cb:
            return jnp.einsum("mk,mkb->mb", self.data, x[self.cols])
        nb = -(-b // cb)
        xp = jnp.zeros((x.shape[0], nb * cb), x.dtype)
        xp = jax.lax.dynamic_update_slice(xp, x, (0, 0))
        xg = jnp.moveaxis(xp.reshape(x.shape[0], nb, cb), 1, 0)
        y = jax.lax.map(
            lambda xc: jnp.einsum(
                "mk,mkb->mb", self.data, xc[self.cols]
            ),
            xg,
        )  # (nb, m, cb)
        return jnp.moveaxis(y, 0, 1).reshape(m, nb * cb)[:, :b]

    def __matmul__(self, x: jax.Array) -> jax.Array:
        if x.ndim == 1:
            return self.matvec(x)
        return self.matmat(x)

    def todense(self) -> jax.Array:
        m, n = self.shape
        out = jnp.zeros((m, n), self.data.dtype)
        rows = jnp.broadcast_to(
            jnp.arange(m)[:, None], self.cols.shape
        )
        return out.at[rows, self.cols].add(self.data)

    def astype(self, dtype) -> "ELL":
        return ELL(self.data.astype(dtype), self.cols, self.shape)


def ell_from_scipy(a, pad_to: int | None = None, dtype=None) -> ELL:
    """Convert a scipy.sparse matrix to padded ELL (host-side, setup time).

    pad_to: round the per-row nnz up to a multiple (e.g. 8); default
    keeps the max row nnz.
    """
    import scipy.sparse as sp

    a = sp.csr_matrix(a)
    a.sum_duplicates()
    m, n = a.shape
    row_nnz = np.diff(a.indptr)
    k = int(row_nnz.max()) if m else 0
    if pad_to:
        k = _round_up(max(k, 1), pad_to)
    k = max(k, 1)
    data = np.zeros((m, k), dtype=dtype or a.dtype)
    cols = np.zeros((m, k), dtype=np.int32)
    # Vectorized scatter: nnz j of row i lands at (i, j - indptr[i]).
    rows_flat = np.repeat(np.arange(m), row_nnz)
    slot_flat = np.arange(a.nnz) - np.repeat(a.indptr[:-1], row_nnz)
    data[rows_flat, slot_flat] = a.data
    cols[rows_flat, slot_flat] = a.indices
    return ELL(jnp.asarray(data), jnp.asarray(cols), (m, n))


def ell_to_scipy(a: ELL):
    """Inverse of ell_from_scipy (host-side, for golden cross-checks)."""
    import scipy.sparse as sp

    m, n = a.shape
    data = np.asarray(a.data)
    cols = np.asarray(a.cols)
    rows = np.repeat(np.arange(m), a.row_nnz)
    mat = sp.coo_matrix(
        (data.ravel(), (rows, cols.ravel())), shape=(m, n)
    )
    mat.sum_duplicates()
    mat = mat.tocsr()
    # Drop the ELL padding slots (explicit zeros at column 0): leaving
    # them makes every row "touch" column 0, which widens the RCM band
    # and the window-sorted row order downstream.
    mat.eliminate_zeros()
    return mat
