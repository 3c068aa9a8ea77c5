"""Differential Riccati equation — backward implicit-Euler sweep.

  -M^T X' M = A^T X M + M^T X A - M^T X B R^-1 B^T X M + C^T C,
  X(tE) = X_T (default 0), R = alpha I.

Implicit Euler in X turns every backward step into a generalized ARE
with the CONSTANT time-shifted matrix  Atil = A - M/(2 dt)  and constant
term  C^T C + M^T X_{k+1} M / dt  (derivation in golden/dense_lqr.py,
which implements the identical scheme densely in f64 — the oracle).
Because Atil is time-independent, ONE batched shifted-LU cache serves
the whole sweep; each step runs a warm-started Newton-ADI with the
previous step's gain (the reference's per-step DRE structure,
SURVEY.md SS3.1 backward sweep, SS2 row 6). The sweep itself is a
lax.scan over timesteps with static (n, r_max) factor buffers.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.operators import LTISystem
from ..solvers.shifted import ShiftedLUCache
from . import shifts as shiftmod
from .newton_kleinman import newton_adi_are, newton_adi_are_host


def dre_shift_schedule(
    a_np, m_np, dt: float, num_shifts: int = 12, n_adi: int = 24
):
    """Host-side shift setup for the DRE's time-shifted pencil.

    Computes the spectral interval of (A, M) once, shifts it by 1/(2 dt)
    analytically (riccati/shifts.py), and returns the Wachspress shifts
    plus the cycled per-iteration schedule (values + cache indices).
    """
    a_min, a_max = shiftmod.spectral_interval(a_np, m_np)
    a_min_s, a_max_s = shiftmod.dre_shifted_interval(a_min, a_max, dt)
    sig = shiftmod.wachspress_shifts(a_min_s, a_max_s, num_shifts)
    idx = np.arange(num_shifts, dtype=np.int32)
    reps = int(np.ceil(n_adi / num_shifts))
    sigma_seq = np.tile(sig, reps)[:n_adi]
    idx_seq = np.tile(idx, reps)[:n_adi]
    return sig, sigma_seq, idx_seq


def build_dre_cache(
    sys: LTISystem, dt: float, sig: np.ndarray, dtype=None,
    solver: str = "lu",
) -> ShiftedLUCache:
    """Shifted cache for (Atil^T + sigma_j M), Atil = A - M/(2 dt).

    solver: 'lu' (triangular solves) or 'inverse' (one GEMM per solve —
    solvers/shifted.py)."""
    from ..solvers.shifted import ShiftedInverseCache

    m_d, a_d = sys.dense()
    at_til = a_d.T - m_d / (2.0 * dt)  # M symmetric
    if dtype is not None:
        at_til = at_til.astype(dtype)
        m_d = m_d.astype(dtype)
    cls = {"lu": ShiftedLUCache, "inverse": ShiftedInverseCache}[solver]
    return cls.build(at_til, m_d, jnp.asarray(sig, at_til.dtype))


def dre_shift_schedule_dae(
    a_np, m_np, j_np, dt: float, num_shifts: int = 12, n_adi: int = 24,
    interval: tuple | None = None,
):
    """Shift setup for constrained systems: projected spectral interval
    of (A, M)|ker J, time-shifted analytically (riccati/shifts.py).

    interval: optional precomputed (a_min, a_max) override. Without it,
    small n (<= 1200) uses the exact dense projected interval; larger n
    uses shifts.spectral_interval_dae_cheap — (0, sparse-ARPACK a_max)
    — because the DRE time shift c = 1/(2 dt) dominates the interval
    bottom anyway (see that function's docstring; kills the ~30 s
    dense projected eig from the bench cold start, VERDICT r2 item 6).
    """
    if interval is not None:
        a_min, a_max = interval
    elif a_np.shape[0] <= 1200:
        a_min, a_max = shiftmod.spectral_interval_dae(a_np, m_np, j_np)
    else:
        a_min, a_max = shiftmod.spectral_interval_dae_cheap(a_np, m_np)
    a_min_s, a_max_s = shiftmod.dre_shifted_interval(a_min, a_max, dt)
    sig = shiftmod.wachspress_shifts(a_min_s, a_max_s, num_shifts)
    idx = np.arange(num_shifts, dtype=np.int32)
    reps = int(np.ceil(n_adi / num_shifts))
    return sig, np.tile(sig, reps)[:n_adi], np.tile(idx, reps)[:n_adi]


def load_or_build_inverse_stack(
    at_til_sp, m_sp, j_sp, sig, dtype, cache_key=None, cache_dir=None,
):
    """The (J, n, n) shifted-saddle inverse stack as a host array, with
    the reference's load_or_comp disk contract (SURVEY.md SS3.5): keyed
    by cache_key + package version, stored UNCOMPRESSED (npz-compress
    of ~0.5 GB of float noise costs more than the splu rebuild).

    Returns (inv_np, source) with source in {'built', 'disk'} so cold
    starts can report which path they paid (BENCH dre_cold_start_s).
    """
    import hashlib
    import os

    from ..solvers.saddle import SaddleShiftedInverseCache
    from ..utils.cache import DEFAULT_CACHE_DIR, _code_salt

    path = None
    if cache_key is not None:
        # Cheap operator fingerprint folded into the digest so a caller
        # whose cache_key under-specifies the problem (dt is folded into
        # at_til before this call) can never load a mismatched stack
        # (ADVICE r4 low #3): shapes, nnz, and data checksums of every
        # operator the build consumes.
        import scipy.sparse as sp

        def _fp(mat):
            m = sp.csr_matrix(mat)
            return (
                m.shape, int(m.nnz),
                hashlib.sha256(
                    np.ascontiguousarray(m.data).tobytes()
                ).hexdigest()[:16],
            )

        digest = hashlib.sha256(
            repr((
                cache_key, np.asarray(sig, np.float64).tobytes(),
                str(np.dtype(dtype)),
                _fp(at_til_sp), _fp(m_sp), _fp(j_sp),
            )).encode()
        ).hexdigest()[:12]
        d = cache_dir or DEFAULT_CACHE_DIR
        path = os.path.join(d, f"dreinv_{digest}-{_code_salt()}.npy")
        if os.path.exists(path):
            return np.load(path), "disk"
    inv_np = SaddleShiftedInverseCache.build_sparse_host(
        at_til_sp, m_sp, j_sp, np.asarray(sig), dtype=dtype
    )
    if path is not None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp.npy"
        np.save(tmp, inv_np)
        os.replace(tmp, path)
    return inv_np, "built"


def build_dre_cache_dae(
    sys, dt: float, sig: np.ndarray, dtype=None, solver: str = "lu",
    cache_key: str | None = None, cache_dir: str | None = None,
):
    """Shifted saddle cache of [[Atil^T + sigma M, J^T], [J, 0]].

    solver: 'lu' or 'inverse' (GEMM apply — solvers/saddle.py; built
    through SPARSE LU factorizations, the cheap setup path).
    cache_key: optional stable string (problem/Re/dt/refinement) — with
    solver='inverse' the host inverse stack is disk-cached under it
    (load_or_build_inverse_stack) so warm restarts skip the splu build.
    """
    from ..solvers.saddle import (
        SaddleShiftedInverseCache,
        SaddleShiftedLUCache,
    )

    if solver == "inverse":
        from ..ops.sparse import ell_to_scipy

        m_sp = ell_to_scipy(sys.mass)
        a_sp = ell_to_scipy(sys.stiff)
        j_sp = ell_to_scipy(sys.jmat)
        at_til_sp = (a_sp.T - m_sp / (2.0 * dt)).tocsr()
        inv_np, _src = load_or_build_inverse_stack(
            at_til_sp, m_sp, j_sp, np.asarray(sig),
            dtype or sys.b.dtype, cache_key=cache_key,
            cache_dir=cache_dir,
        )
        return SaddleShiftedInverseCache(
            jnp.asarray(inv_np), a_sp.shape[0]
        )

    m_d, a_d, j_d = sys.dense()
    at_til = a_d.T - m_d / (2.0 * dt)
    if dtype is not None:
        at_til = at_til.astype(dtype)
        m_d = m_d.astype(dtype)
        j_d = j_d.astype(dtype)
    return SaddleShiftedLUCache.build(
        at_til, m_d, j_d, jnp.asarray(sig, at_til.dtype)
    )


def build_dre_cache_dae_ns(
    sys, dt: float, sig: np.ndarray, dtype=jnp.float32,
    certify_tol: float = 5e-4, verbose=None,
):
    """DEVICE-BUILT dense shifted-saddle inverse cache: the
    one-GEMM-per-solve ADI tier (SaddleShiftedInverseCache), with the
    inverse stack constructed on device by Newton-Schulz ladders
    (solvers/ns_inverse.py) instead of host splu + transfer.

    This extends the dense tier to config-3 scale (n = 15,316): the
    build is device GEMMs with ZERO bulk transfer, and each subsequent
    ADI solve is one (n, n) GEMM instead of a 30-115-iteration FGMRES
    solve. Device memory: len(sig) * n^2 * 4 bytes of velocity-block
    inverses (e.g. 8 shifts at n=15,316 -> 7.5 GB; callers size
    num_shifts to the card).

    Returns (cache, info) — info carries the certified per-shift
    residuals (build_inverse_stack_ns).
    """
    from ..ops.sparse import ell_to_scipy
    from ..solvers.ns_inverse import build_inverse_stack_ns
    from ..solvers.saddle import SaddleShiftedInverseCache

    m_sp = ell_to_scipy(sys.mass)
    a_sp = ell_to_scipy(sys.stiff)
    j_sp = ell_to_scipy(sys.jmat)
    at_til = (a_sp.T - m_sp / (2.0 * dt)).tocsr()
    inv_stack, info = build_inverse_stack_ns(
        at_til, m_sp, j_sp, np.asarray(sig), dtype=dtype,
        certify_tol=certify_tol, verbose=verbose,
    )
    return SaddleShiftedInverseCache(inv_stack, a_sp.shape[0]), info


def build_dre_cache_dae_krylov(
    sys, dt: float, sig: np.ndarray, dtype=None,
    n_iter: int = 30, n_ref: int = 2,
):
    """Memory-lean DRE cache: n_ref reference saddle LUs + GMRES
    (solvers/krylov.py) instead of one LU per shift — the config-3+
    path where len(sig) full factorizations exceed HBM."""
    from ..solvers.krylov import SaddleShiftedKrylovCache

    m_d, a_d, j_d = sys.dense()
    at_til = a_d.T - m_d / (2.0 * dt)
    if dtype is not None:
        at_til = at_til.astype(dtype)
        j_d = j_d.astype(dtype)
    mass = sys.mass if dtype is None else sys.mass.astype(dtype)
    return SaddleShiftedKrylovCache.build(
        at_til, mass, j_d, np.asarray(sig), n_iter=n_iter, n_ref=n_ref
    )


def build_dre_cache_dae_matfree(
    sys, dt: float, sig: np.ndarray, dtype=jnp.float32,
    block: int = 512, m_krylov: int = 30, max_cycles: int = 8,
    tol: float = 1e-6,
):
    """Matrix-free DRE cache: block-Jacobi + pressure-Schur FGMRES over
    ELL SpMM (solvers/matfree.py) — NO O((n+np)^2) factor anywhere.
    The config-3+ path: setup is seconds where the reference-LU caches
    took tens of minutes of host getrf at n+np ~ 17k.

    The implicit-Euler time shift -1/(2 dt) is folded into Atil for the
    solves and passed as schur_offset so the pressure preconditioner
    sees the TOTAL signed mass coefficient sigma - 1/(2 dt).
    """
    import scipy.sparse as sp

    from ..ops.sparse import ell_to_scipy
    from ..solvers.matfree import SaddleMatfreeCache

    m_sp = ell_to_scipy(sys.mass)
    a_sp = ell_to_scipy(sys.stiff)
    j_sp = ell_to_scipy(sys.jmat)
    c = 1.0 / (2.0 * dt)
    at_til = (a_sp.T - c * m_sp).tocsr()
    return SaddleMatfreeCache.build(
        at_til, m_sp, j_sp, np.asarray(sig), schur_offset=-c,
        dtype=dtype, block=block, m_krylov=m_krylov,
        max_cycles=max_cycles, tol=tol,
    )


def dre_backward_sweep(
    sys: LTISystem,
    cache: ShiftedLUCache,
    alpha: float,
    dt: float,
    nts: int,
    sigma_seq: jax.Array,
    idx_seq: jax.Array,
    n_newton: int = 2,
    r_max: int = 40,
    compress_rtol: float = 1e-9,
    k_init: jax.Array | None = None,
):
    """Backward DRE sweep; returns (zs, ks) with

    zs: (nts + 1, n, r_max) low-rank factors, X_k ~= Z_k Z_k^T
        (zs[nts] = terminal = 0),
    ks: (nts + 1, m, n) feedback gains K_k = (1/alpha) B^T X_k M.

    Warm start: each step's Newton begins from the previous (later-time)
    step's gain, so n_newton = 1-2 suffices (SURVEY.md SS3.1). k_init
    seeds the TERMINAL step's Newton (receding-horizon MPC passes the
    previous macro-step's gain; terminal factor stays 0).

    The time loop runs on the HOST around the single jitted
    newton_adi_are — deliberately NOT a lax.scan: one compile of the
    Newton-ADI body serves every timestep, macro step, and bench config,
    where a scan recompiles a 4-deep loop nest per (nts, cache)
    signature. For the MATRIX-FREE cache the ADI/Newton loops are
    host-looped too (newton_adi_are_host). Both host loops are kept
    until an H100 measurement decides, ROADMAP design item 1.
    """
    from ..solvers.matfree import SaddleMatfreeCache

    newton_fn = (
        newton_adi_are_host
        if isinstance(cache, SaddleMatfreeCache)
        else newton_adi_are
    )
    n, m = sys.b.shape
    dtype = sys.b.dtype
    inv_sqrt_dt = 1.0 / float(np.sqrt(dt))

    z = jnp.zeros((n, r_max), dtype)
    k = (
        jnp.zeros((m, n), dtype) if k_init is None
        else jnp.asarray(k_init, dtype)
    )
    zs = [z]  # backward order: [terminal, X_{nts-1}, ..., X_0]
    ks = [k]
    for _ in range(nts):
        w_extra = sys.mass.matmat(z) * inv_sqrt_dt
        z, k = newton_fn(
            sys,
            cache,
            alpha,
            sigma_seq,
            idx_seq,
            n_newton=n_newton,
            out_rank=r_max,
            k0=k,
            w_extra=w_extra,
            extra_w_cols=r_max,
            compress_rtol=compress_rtol,
        )
        zs.append(z)
        ks.append(k)
    return jnp.stack(zs[::-1]), jnp.stack(ks[::-1])
