#!/usr/bin/env python
"""Diagnose the DRE inverse-cache cold start.

Building explicit shifted-saddle inverses via splu(big).solve(dense
eye) can cost far more than the factorizations themselves. This script
times every candidate build strategy for ONE representative shift and
reports
per-shift + extrapolated 6-shift totals plus accuracy vs f64:

  A. splu factor + dense-RHS solve (current path), 256-col panel
     extrapolated;
  B. host dense f64 LAPACK lu_factor + lu_solve(eye);
  C. on-device f32: scatter the sparse pencil to dense, batched
     jnp.linalg.inv, slice the vv block (transfer = a few MB of COO).

Prints its result as one JSON line.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

RE = 100.0
REFINEMENT = 1
DT = 0.005
N_SHIFTS = 6
N_ADI = 24
PANEL = 256


def log(m):
    print(m, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp
    import scipy.linalg as sla
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from optconpy_tpu import utils
    from optconpy_tpu.models.cylinder import cylinder_setup
    from optconpy_tpu.riccati import dre_shift_schedule_dae

    utils.setup()
    out = {}

    t0 = time.time()
    np_ops, sys64, cond = cylinder_setup(re=RE, refinement=REFINEMENT)
    log(f"setup {time.time() - t0:.1f}s")
    sig, _, _ = dre_shift_schedule_dae(
        np_ops["A"], np_ops["M"], np_ops["J"], DT,
        num_shifts=N_SHIFTS, n_adi=N_ADI,
    )
    sig = np.asarray(sig, np.float64)
    m_sp = np_ops["M"].tocsr()
    a_sp = np_ops["A"].tocsr()
    j_sp = np_ops["J"].tocsr()
    at_til = (a_sp.T - m_sp / (2.0 * DT)).tocsr()
    n = a_sp.shape[0]
    n_p = j_sp.shape[0]
    big_n = n + n_p
    out["n"] = n
    out["n_p"] = n_p
    log(f"n={n} n_p={n_p} shifts={sig}")

    s0 = sig[0]
    big_sp = sp.bmat(
        [[at_til + s0 * m_sp, j_sp.T], [j_sp, None]], format="csc"
    )
    out["nnz"] = int(big_sp.nnz)

    # --- A: current splu path, panel-extrapolated ---
    t0 = time.time()
    lu = spla.splu(big_sp)
    t_factor = time.time() - t0
    rhs_panel = np.zeros((big_n, PANEL))
    rhs_panel[:PANEL, :] = np.eye(PANEL)
    t0 = time.time()
    lu.solve(rhs_panel)
    t_panel = time.time() - t0
    per_shift_a = t_factor + t_panel * n / PANEL
    out["A_splu"] = {
        "factor_s": round(t_factor, 3),
        "panel256_s": round(t_panel, 3),
        "per_shift_s": round(per_shift_a, 1),
        "six_shift_s": round(6 * per_shift_a, 1),
    }
    log(f"A splu: factor {t_factor:.2f}s panel {t_panel:.2f}s "
        f"-> {per_shift_a:.1f}s/shift")

    # --- B: host dense f64 LAPACK ---
    big_d = np.zeros((big_n, big_n))
    big_d[:n, :n] = (at_til + s0 * m_sp).toarray()
    big_d[:n, n:] = j_sp.T.toarray()
    big_d[n:, :n] = j_sp.toarray()
    t0 = time.time()
    lu_d, piv_d = sla.lu_factor(big_d)
    t_dfac = time.time() - t0
    t0 = time.time()
    inv64 = sla.lu_solve((lu_d, piv_d), np.eye(big_n))
    t_dsol = time.time() - t0
    per_shift_b = t_dfac + t_dsol
    out["B_dense_f64"] = {
        "factor_s": round(t_dfac, 2),
        "solve_eye_s": round(t_dsol, 2),
        "per_shift_s": round(per_shift_b, 1),
        "six_shift_s": round(6 * per_shift_b, 1),
    }
    log(f"B dense f64: factor {t_dfac:.1f}s solve {t_dsol:.1f}s "
        f"-> {per_shift_b:.1f}s/shift")
    inv64_vv = inv64[:n, :n]

    # --- C: on-device f32 batched inverse from scattered sparse ---
    dev = jax.devices()[0]
    log(f"device: {dev.platform} / {dev.device_kind}")
    coo_at = at_til.tocoo()
    coo_m = m_sp.tocoo()
    coo_j = j_sp.tocoo()
    # ship COO once (f32 data + int32 indices, a few MB total)
    at_d = (jnp.asarray(coo_at.data, jnp.float32),
            jnp.asarray(coo_at.row), jnp.asarray(coo_at.col))
    m_d = (jnp.asarray(coo_m.data, jnp.float32),
           jnp.asarray(coo_m.row), jnp.asarray(coo_m.col))
    j_d = (jnp.asarray(coo_j.data, jnp.float32),
           jnp.asarray(coo_j.row), jnp.asarray(coo_j.col))
    sig_d = jnp.asarray(sig, jnp.float32)

    def scatter_dense(sigma):
        big = jnp.zeros((big_n, big_n), jnp.float32)
        big = big.at[at_d[1], at_d[2]].add(at_d[0])
        big = big.at[m_d[1], m_d[2]].add(sigma * m_d[0])
        big = big.at[j_d[1], n + j_d[2]].add(j_d[0])  # J^T block
        big = big.at[n + j_d[1], j_d[2]].add(j_d[0])  # J block
        return big

    @jax.jit
    def build_all(sigmas):
        bigs = jax.vmap(scatter_dense)(sigmas)
        invs = jnp.linalg.inv(bigs)
        return invs[:, :n, :n]

    t0 = time.time()
    invs_dev = jax.block_until_ready(build_all(sig_d))
    t_dev_cold = time.time() - t0
    t0 = time.time()
    invs_np = np.asarray(invs_dev)
    t_fetch = time.time() - t0
    t0 = time.time()
    jax.block_until_ready(build_all(sig_d * 1.0000001))
    t_dev_warm = time.time() - t0
    out["C_device_f32"] = {
        "six_shift_compile_run_s": round(t_dev_cold, 1),
        "six_shift_warm_s": round(t_dev_warm, 1),
        "fetch_to_host_s": round(t_fetch, 1),
    }
    log(f"C device f32: 6-shift cold {t_dev_cold:.1f}s "
        f"warm {t_dev_warm:.1f}s fetch {t_fetch:.1f}s")

    # accuracy of C vs B (f64 golden), shift 0
    c_vv = invs_np[0].astype(np.float64)
    rel = np.linalg.norm(c_vv - inv64_vv) / np.linalg.norm(inv64_vv)
    # operator residual on the vv block through random vectors:
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 8))
    # apply big f64 op to [c_vv @ x; inferred p rows] is not available
    # (vv block only); use the action error vs f64 instead:
    act_rel = np.linalg.norm(c_vv @ x - inv64_vv @ x) / np.linalg.norm(
        inv64_vv @ x
    )
    out["C_accuracy_vs_f64"] = {
        "vv_fro_rel": float(rel),
        "action_rel": float(act_rel),
    }
    log(f"C accuracy: vv fro rel {rel:.2e}, action rel {act_rel:.2e}")
    # f32 cast of the f64 inverse (the current production accuracy):
    cast_rel = np.linalg.norm(
        inv64_vv.astype(np.float32).astype(np.float64) - inv64_vv
    ) / np.linalg.norm(inv64_vv)
    out["f32_cast_floor_rel"] = float(cast_rel)
    log(f"f32 cast floor: {cast_rel:.2e}")



if __name__ == "__main__":
    main()
