"""On-device convection N(v)v — gather / einsum / scatter, no assembly.

The reference re-assembles the convection vector through DOLFIN every
transient step (SURVEY.md SS3.4 get_convvec, an L0 FFI crossing). Here
the geometry is baked into the per-element tensor T0 at setup
(fem/taylor_hood.py convection_tensor) and each evaluation is a static
gather + batched tensor contraction + segment-sum scatter — fully
jit/vmap-safe, zero host involvement.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("t0", "tri_dofs", "free", "dir_values", "scatter_slots",
                 "t0p", "dofs_p", "slots_nm"),
    meta_fields=("ns", "n_free"),
)
@dataclass(frozen=True)
class ConvKernel:
    """Device-resident convection evaluator with BC bookkeeping.

    t0: (nt, 6, 6, 6, 2) per-element tensor;
    tri_dofs: (nt, 6) scalar P2 dofs;
    free: (n_free,) indices of free dofs in the FULL velocity vector;
    dir_values: (2*ns,) full-length vector holding Dirichlet values at
        constrained dofs and 0 at free dofs (scatter base);
    scatter_slots: (ns, k_s) int32 — for each scalar dof, the flat
        (element*6 + localnode) slots that accumulate into it, padded
        with nt*6 (a zero row appended at apply time), so the
        segment-sum scatter becomes a static-gather + sum over k_s.
        This is the batch-last fast path: it gathers whole rows (the
        scenario batch is the contiguous axis) instead of doing a
        per-scenario scatter.
    t0p, dofs_p, slots_nm: the same tensor, dof map and scatter slots
        in the GPU kernel's layout (ops/conv_triton.pack_element_tensor).
    """

    t0: jax.Array
    tri_dofs: jax.Array
    free: jax.Array
    dir_values: jax.Array
    scatter_slots: jax.Array
    t0p: jax.Array
    dofs_p: jax.Array
    slots_nm: jax.Array
    ns: int
    n_free: int

    @staticmethod
    def _host_arrays(ops: dict, cond) -> dict:
        """Host-side (numpy, f64) build of every ConvKernel array; also
        the input of host-side references."""
        from .taylor_hood import convection_tensor

        space = ops["space"]
        t0 = convection_tensor(ops)
        ns = space.n_scalar
        dir_values = np.zeros(2 * ns)
        dir_values[cond.dirichlet] = cond.g
        # Invert the scatter map: scalar dof -> flat (e, localnode)
        # slots, padded with the sentinel nt*6 (zero row at apply).
        flat = np.asarray(space.tri_dofs, np.int64).reshape(-1)
        nt6 = flat.shape[0]
        counts = np.bincount(flat, minlength=ns)
        k_s = max(int(counts.max()), 1)
        slots = np.full((ns, k_s), nt6, dtype=np.int32)
        order = np.argsort(flat, kind="stable")
        sorted_dofs = flat[order]
        group_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.arange(nt6) - group_start[sorted_dofs]
        slots[sorted_dofs, rank] = order
        return {
            "t0": t0,
            "tri_dofs": np.asarray(space.tri_dofs, np.int32),
            "free": np.asarray(cond.free, np.int32),
            "dir_values": dir_values,
            "slots": slots,
            "ns": ns,
        }

    @staticmethod
    def build(ops: dict, cond, dtype=jnp.float64) -> "ConvKernel":
        from ..ops.conv_triton import pack_element_tensor

        h = ConvKernel._host_arrays(ops, cond)
        t0p, dofs_p, slots_nm = pack_element_tensor(
            h["t0"], h["tri_dofs"], h["slots"]
        )
        return ConvKernel(
            t0=jnp.asarray(h["t0"], dtype),
            tri_dofs=jnp.asarray(h["tri_dofs"]),
            free=jnp.asarray(h["free"]),
            dir_values=jnp.asarray(h["dir_values"], dtype),
            scatter_slots=jnp.asarray(h["slots"]),
            t0p=jnp.asarray(t0p, dtype),
            dofs_p=jnp.asarray(dofs_p),
            slots_nm=jnp.asarray(slots_nm),
            ns=h["ns"],
            n_free=len(cond.free),
        )

    def expand(self, v_inner: jax.Array) -> jax.Array:
        """Lift inner (free-dof) velocity to the full dof vector."""
        return self.dir_values.at[self.free].set(v_inner)

    def conv_full(self, v_full: jax.Array) -> jax.Array:
        """N(v)v on the full dof set: (2ns,) -> (2ns,) weak-form vector."""
        ns = self.ns
        v2 = v_full.reshape(2, ns)
        v_loc = v2[:, self.tri_dofs].transpose(1, 2, 0)  # (nt, 6, 2)
        out_loc = jnp.einsum(
            "eijkb,ejb,eka->eia", self.t0, v_loc, v_loc
        )  # (nt, 6, 2)
        flat_idx = self.tri_dofs.reshape(-1)  # (nt*6,)
        # Scatter-add via indexed .at[].add (the supported segment-sum
        # spelling; XLA lowers both to the same scatter).
        out = jnp.zeros((2, ns), v_full.dtype)
        out = out.at[0, flat_idx].add(out_loc[:, :, 0].reshape(-1))
        out = out.at[1, flat_idx].add(out_loc[:, :, 1].reshape(-1))
        return out.reshape(-1)

    def conv_inner(self, v_inner: jax.Array) -> jax.Array:
        """N(v)v restricted to free dofs, BC values included in v."""
        v_full = self.expand(v_inner)
        return self.conv_full(v_full)[self.free]

    def conv_full_batch(self, v_full_t: jax.Array) -> jax.Array:
        """Batch-last N(v)v: (2ns, B) -> (2ns, B) weak-form vectors.

        Compiled for a CUDA GPU, batches wider than one kernel column
        tile run the element contraction in the fused Triton kernel
        (conv_full_batch_triton); narrower batches and every other
        platform run conv_full_batch_xla. On an H100, XLA was faster up
        to 64 columns and the kernel from 256 on (PERF.md). The platform
        is chosen when the program is lowered.
        """
        from ..ops.conv_triton import B_TILE

        if v_full_t.shape[1] <= B_TILE:
            return self.conv_full_batch_xla(v_full_t)
        return jax.lax.platform_dependent(
            v_full_t,
            cuda=self.conv_full_batch_triton,
            default=self.conv_full_batch_xla,
        )

    def conv_full_batch_triton(self, v_full_t: jax.Array) -> jax.Array:
        """conv_full_batch through ops/conv_triton.py (CUDA GPU only)."""
        from ..ops.conv_triton import conv_local_triton

        b = v_full_t.shape[1]
        out = conv_local_triton(v_full_t, self.t0p, self.dofs_p, ns=self.ns)
        gathered = out.reshape(2, -1, b)[:, self.slots_nm]  # (2, ns, k_s, B)
        return gathered.sum(axis=2).reshape(2 * self.ns, b)

    def conv_full_batch_xla(self, v_full_t: jax.Array) -> jax.Array:
        """Batch-last N(v)v in plain XLA — the kernel's reference.

        Fast path for scenario batches. All index ops are whole-row
        gathers from (rows, B) matrices — each gathered row is B
        contiguous elements — and the segment-sum scatter of conv_full
        is replaced by the precomputed scatter_slots gather (+ sum over
        k_s).
        """
        ns = self.ns
        nt = self.tri_dofs.shape[0]
        b = v_full_t.shape[1]
        v2 = v_full_t.reshape(2, ns, b)
        flat = self.tri_dofs.reshape(-1)
        v_loc = v2[:, flat].reshape(2, nt, 6, b)  # (2, nt, 6, B)
        # W[e,i,k,:] = sum_{j,b} T0[e,i,j,k,b] v_loc[b,e,j,:]
        w = jnp.einsum("eijkb,bejB->eikB", self.t0, v_loc)
        # out[a,e,i,:] = sum_k W[e,i,k,:] v_loc[a,e,k,:].
        # Unrolled over k (6 fused multiply-adds): the einsum form can
        # make XLA materialize the (2, nt, 6, 6, B) broadcast (~2 GB
        # at bench shapes).
        out_loc = w[None, :, :, 0, :] * v_loc[:, :, None, 0, :]
        for k in range(1, 6):
            out_loc = out_loc + (
                w[None, :, :, k, :] * v_loc[:, :, None, k, :]
            )
        out_flat = out_loc.reshape(2, nt * 6, b)
        out_flat = jnp.concatenate(
            [out_flat, jnp.zeros((2, 1, b), out_flat.dtype)], axis=1
        )
        gathered = out_flat[:, self.scatter_slots]  # (2, ns, k_s, B)
        return gathered.sum(axis=2).reshape(2 * ns, b)

    def conv_inner_batch(self, v_batch: jax.Array) -> jax.Array:
        """Batched N(v)v on free dofs: (B, n_free) -> (B, n_free)."""
        b = v_batch.shape[0]
        base = jnp.zeros((2 * self.ns, b), v_batch.dtype)
        v_full_t = (
            self.dir_values[:, None] + base.at[self.free].set(v_batch.T)
        )
        return self.conv_full_batch(v_full_t)[self.free].T

    def linearized_dense(
        self, v_full: jax.Array, include_l2: bool = True
    ) -> jax.Array:
        """Dense linearized convection L1(v) (+ L2(v)) on FULL dofs.

        Device-side mirror of fem.taylor_hood.convection_matrices for
        online re-linearization inside the MPC loop (no host crossing):
        L1 u = (v.grad)u (component-diagonal), L2 u = (u.grad)v
        (component-coupling). Returns (2ns, 2ns); restrict to free dofs
        with mat[free][:, free] at the call site.
        """
        ns = self.ns
        nt = self.tri_dofs.shape[0]
        v2 = v_full.reshape(2, ns)
        v_loc = v2[:, self.tri_dofs].transpose(1, 2, 0)  # (nt, 6, 2)
        rows = jnp.broadcast_to(
            self.tri_dofs[:, :, None], (nt, 6, 6)
        )
        cols = jnp.broadcast_to(
            self.tri_dofs[:, None, :], (nt, 6, 6)
        )
        out = jnp.zeros((2 * ns, 2 * ns), v_full.dtype)
        # L1[(i,a),(k,a)] = sum_{j,b} T0[e,i,j,k,b] v_loc[e,j,b]
        l1_loc = jnp.einsum("eijkb,ejb->eik", self.t0, v_loc)
        out = out.at[rows, cols].add(l1_loc)
        out = out.at[rows + ns, cols + ns].add(l1_loc)
        if include_l2:
            # L2[(i,a),(j,b)] = sum_k T0[e,i,j,k,b] v_loc[e,k,a]
            l2_loc = jnp.einsum("eijkb,eka->eijab", self.t0, v_loc)
            for a_c in range(2):
                for b_c in range(2):
                    out = out.at[rows + a_c * ns, cols + b_c * ns].add(
                        l2_loc[..., a_c, b_c]
                    )
        return out

    def astype(self, dtype) -> "ConvKernel":
        return ConvKernel(
            self.t0.astype(dtype),
            self.tri_dofs,
            self.free,
            self.dir_values.astype(dtype),
            self.scatter_slots,
            self.t0p.astype(dtype),
            self.dofs_p,
            self.slots_nm,
            self.ns,
            self.n_free,
        )


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("p_pack", "gx_pack", "gy_pack", "pwt_pack", "free",
                 "dir_values"),
    meta_fields=("ns", "n_free"),
)
@dataclass(frozen=True)
class QuadConvKernel:
    """Quadrature-interpolation convection: N(v)v as FOUR SpMMs.

    Restructures ConvKernel's quadrature-exact integral through
    interpolation matrices (host-built, static sparsity):

        P, Gx, Gy: (NQ, ns)  values / x- / y-derivatives of the P2
            basis at every quadrature point (6 nnz/row);
        PwT = P^T diag(2 A_e w_q): (ns, NQ) weighted scatter;
        out_a = PwT @ [ (P vx) (Gx v_a) + (P vy) (Gy v_a) ].

    Both components ride one SpMM each as column blocks; identical
    quadrature (degree-5 rule) to the assembly path, so it matches
    ConvKernel to roundoff (tests/test_quad_conv.py).

    This is an alternative backend, not the production batch kernel:
    the einsum-ELL SpMM materializes an (NQ, k, B) gather, so the
    per-element tensor ConvKernel stays the batch path. Where this one
    can win: tiny single-vector evaluations and memory-constrained
    settings (its packs are O(nnz) vs the tensor's O(432 nt)).

    Same conv_full/conv_inner/conv_*_batch contract as ConvKernel
    (linearized_dense excepted — host re-linearization covers that).
    """

    p_pack: object
    gx_pack: object
    gy_pack: object
    pwt_pack: object
    free: jax.Array
    dir_values: jax.Array
    ns: int
    n_free: int

    @staticmethod
    def build(ops: dict, cond, dtype=jnp.float64) -> "QuadConvKernel":
        import scipy.sparse as sp

        from ..ops.sparse import ell_from_scipy, sort_rows_by_window
        from .taylor_hood import _QL, _QW, _p2_dlam, _p2_values

        space = ops["space"]
        mesh = space.mesh
        ns = space.n_scalar
        nt = mesh.nt
        nq = _QL.shape[0]
        phi = _p2_values(_QL)  # (nq, 6)
        dphi = _p2_dlam(_QL)  # (nq, 6, 3)
        # gq[e, q, i, d] = dphi[q, i, l] glam[e, l, d]
        gq = np.einsum("qil,eld->eqid", dphi, space.grad_lam)

        rows = np.repeat(np.arange(nt * nq), 6)
        cols = np.broadcast_to(
            space.tri_dofs[:, None, :], (nt, nq, 6)
        ).reshape(-1)

        def interp(vals_flat):
            m = sp.coo_matrix(
                (vals_flat, (rows, cols)), shape=(nt * nq, ns)
            )
            m.sum_duplicates()
            return m.tocsr()

        p_sp = interp(np.broadcast_to(phi[None], (nt, nq, 6)).reshape(-1))
        gx_sp = interp(gq[..., 0].reshape(-1))
        gy_sp = interp(gq[..., 1].reshape(-1))
        wq = (2.0 * space.area[:, None] * (0.5 * _QW)[None]).reshape(-1)

        # Banded quad-point ordering (columns follow the mesh's dof
        # order; sorting rows by first column keeps each SpMM's gather
        # local).
        qperm = sort_rows_by_window(p_sp)
        p_sp = p_sp[qperm].tocsr()
        gx_sp = gx_sp[qperm].tocsr()
        gy_sp = gy_sp[qperm].tocsr()
        wq = wq[qperm]
        pwt_sp = (sp.diags(wq) @ p_sp).T.tocsr()

        dir_values = np.zeros(2 * ns)
        dir_values[cond.dirichlet] = cond.g

        def pack(a):
            return ell_from_scipy(a, pad_to=8, dtype=np.dtype(dtype))

        return QuadConvKernel(
            p_pack=pack(p_sp),
            gx_pack=pack(gx_sp),
            gy_pack=pack(gy_sp),
            pwt_pack=pack(pwt_sp),
            free=jnp.asarray(cond.free, jnp.int32),
            dir_values=jnp.asarray(dir_values, dtype),
            ns=ns,
            n_free=len(cond.free),
        )

    def expand(self, v_inner: jax.Array) -> jax.Array:
        return self.dir_values.at[self.free].set(v_inner)

    def conv_full_batch(self, v_full_t: jax.Array) -> jax.Array:
        """Batch-last N(v)v: (2ns, B) -> (2ns, B) weak-form vectors."""
        ns = self.ns
        b = v_full_t.shape[1]
        # Components as column blocks: (ns, 2B).
        u = jnp.concatenate([v_full_t[:ns], v_full_t[ns:]], axis=1)
        pq = self.p_pack @ u  # values at quad points
        gxq = self.gx_pack @ u
        gyq = self.gy_pack @ u
        vxq, vyq = pq[:, :b], pq[:, b:]
        rx = vxq * gxq[:, :b] + vyq * gyq[:, :b]
        ry = vxq * gxq[:, b:] + vyq * gyq[:, b:]
        out = self.pwt_pack @ jnp.concatenate([rx, ry], axis=1)
        return jnp.concatenate([out[:, :b], out[:, b:]], axis=0)

    def conv_full(self, v_full: jax.Array) -> jax.Array:
        return self.conv_full_batch(v_full[:, None])[:, 0]

    def conv_inner(self, v_inner: jax.Array) -> jax.Array:
        v_full = self.expand(v_inner)
        return self.conv_full(v_full)[self.free]

    def conv_inner_batch(self, v_batch: jax.Array) -> jax.Array:
        """Batched N(v)v on free dofs: (B, n_free) -> (B, n_free)."""
        b = v_batch.shape[0]
        base = jnp.zeros((2 * self.ns, b), v_batch.dtype)
        v_full_t = (
            self.dir_values[:, None] + base.at[self.free].set(v_batch.T)
        )
        return self.conv_full_batch(v_full_t)[self.free].T

    def astype(self, dtype) -> "QuadConvKernel":
        return QuadConvKernel(
            self.p_pack.astype(dtype),
            self.gx_pack.astype(dtype),
            self.gy_pack.astype(dtype),
            self.pwt_pack.astype(dtype),
            self.free,
            self.dir_values.astype(dtype),
            self.ns,
            self.n_free,
        )
