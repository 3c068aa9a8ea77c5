"""Fused convection element kernel for the GPU (Pallas, Triton route).

One program per (element tile x batch tile). It gathers the velocities
of the six local nodes of E_TILE elements for a B_TILE-column tile
straight from the full batch-last velocity (12 (E_TILE, B_TILE) tiles),
contracts them with the per-element tensor one local test node at a
time (6 W accumulators), and writes the element-local N(v)v
contributions. The scatter-sum over elements stays in XLA
(fem/device_conv.py ConvKernel). Against XLA's lowering of the same
math (ConvKernel.conv_full_batch_xla) the gathered (2, nt, 6, B)
velocities and the (nt, 6, 6, B) W intermediate never reach device
memory.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

E_TILE = 16  # elements per program
B_TILE = 64  # scenario columns per program


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pack_element_tensor(t0, tri_dofs, slots):
    """Host-side repack of ConvKernel's arrays for the kernel.

    t0: (nt, 6, 6, 6, 2) element tensor; tri_dofs: (nt, 6); slots:
    (ns, k_s) element-major scatter slots (e * 6 + i, sentinel nt * 6).
    Returns t0p (432, nt_pad), dofs (6, nt_pad) int32 and node-major
    slots (i * nt_pad + e) into the kernel's (2, 6, nt_pad, B) output.
    nt_pad leaves at least one all-zero padding element; its node 0
    is the sentinel slot, whose contribution is exactly zero.
    """
    t0 = np.asarray(t0)
    nt = t0.shape[0]
    nt_pad = _round_up(nt + 1, E_TILE)
    t0p = np.zeros((432, nt_pad), t0.dtype)
    t0p[:, :nt] = t0.reshape(nt, 432).T
    dofs = np.zeros((6, nt_pad), np.int32)
    dofs[:, :nt] = np.asarray(tri_dofs).T
    slots = np.asarray(slots)
    e, i = np.divmod(slots, 6)
    slots_nm = np.where(slots == nt * 6, nt, i * nt_pad + e)
    return t0p, dofs, slots_nm.astype(np.int32)


def _kernel(dofs_ref, t0_ref, v_ref, out_ref, *, ns: int):
    import jax.experimental.pallas as pl

    es = pl.ds(pl.program_id(0) * E_TILE, E_TILE)
    bs = pl.ds(pl.program_id(1) * B_TILE, B_TILE)
    # v[c][j]: component c of local node j, (E_TILE, B_TILE).
    v = [[None] * 6 for _ in range(2)]
    for j in range(6):
        dof = dofs_ref[j, es]
        for c in range(2):
            v[c][j] = v_ref[dof + c * ns, bs]

    # One local test node i per iteration: a loop, not an unrolled
    # Python loop, keeps the Triton program (and its compile) small.
    def node(i, carry):
        # W[i][k] = sum_{j,c} T0[e,i,j,k,c] v[c][j]
        w = []
        for k in range(6):
            acc = None
            for j in range(6):
                for c in range(2):
                    t = t0_ref[i * 72 + (j * 6 + k) * 2 + c, es]
                    term = t[:, None] * v[c][j]
                    acc = term if acc is None else acc + term
            w.append(acc)
        # out[a][i] = sum_k W[i][k] v[a][k]
        for a in range(2):
            o = w[0] * v[a][0]
            for k in range(1, 6):
                o = o + w[k] * v[a][k]
            out_ref[a, i, es, bs] = o
        return carry

    jax.lax.fori_loop(0, 6, node, 0)


@partial(jax.jit, static_argnames=("ns", "interpret"))
def conv_local_triton(v_full_t, t0p, dofs, *, ns: int, interpret=False):
    """Element-local N(v)v: (2 ns, B) -> (2, 6, nt_pad, B).

    interpret: run the Pallas interpreter (CPU tests); the card runs the
    Triton-compiled kernel.
    """
    import jax.experimental.pallas as pl
    from jax.experimental.pallas import triton as plgpu

    b = v_full_t.shape[1]
    bp = _round_up(b, B_TILE)
    v = jnp.pad(v_full_t, ((0, 0), (0, bp - b)))
    nt_pad = t0p.shape[1]
    out = pl.pallas_call(
        partial(_kernel, ns=ns),
        out_shape=jax.ShapeDtypeStruct((2, 6, nt_pad, bp), v.dtype),
        grid=(nt_pad // E_TILE, bp // B_TILE),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="conv_element_triton",
    )(dofs, t0p.astype(v.dtype), v)
    return out[..., :b]
