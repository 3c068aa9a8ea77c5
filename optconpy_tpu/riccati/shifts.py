"""ADI shift selection — offline, on CPU (SURVEY.md SS7 hard part 3).

The reference precomputes Penzl/Wachspress-type shifts on the host
(SURVEY.md SS3.3); this repo keeps shift selection a setup-time numpy
step as well. For the symmetric
(heat/Stokes) pencils the spectral interval is computed exactly with
ARPACK/dense eigs and Wachspress-optimal real log-spaced shifts are
used; DRE time-shifted pencils A - M/(2 dt) reuse the same interval
shifted by 1/(2 dt) analytically (no re-eig per step).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def spectral_interval(a, m) -> tuple[float, float]:
    """[lo, hi] of |Re lambda| for the stable pencil (A, M), A ~ Hurwitz.

    Returns (a_min, a_max) with 0 < a_min <= a_max such that the
    eigenvalues of M^{-1} A lie in [-a_max, -a_min] (symmetric case).
    """
    n = a.shape[0]
    if n <= 600:
        lam = np.linalg.eigvals(
            np.linalg.solve(
                m.toarray() if sp.issparse(m) else np.asarray(m),
                a.toarray() if sp.issparse(a) else np.asarray(a),
            )
        )
        re = -np.real(lam)
    else:
        a_s = sp.csc_matrix(a)
        m_s = sp.csc_matrix(m)
        # Largest-magnitude and smallest-magnitude generalized eigenvalues.
        lam_big = spla.eigs(
            a_s, k=1, M=m_s, which="LM", return_eigenvectors=False
        )
        lam_small = spla.eigs(
            a_s, k=1, M=m_s, sigma=0.0, which="LM", return_eigenvectors=False
        )
        re = -np.real(np.concatenate([lam_big, lam_small]))
    re = re[re > 0]
    return float(re.min()), float(re.max())


def spectral_interval_dae(a_sp, m_sp, j_sp) -> tuple[float, float]:
    """Spectral interval of the PROJECTED pencil (A, M) restricted to
    ker J — the spectrum that governs constrained ADI convergence.

    Host-side: reduce with an M-orthonormal kernel basis (dense; fine
    for setup-time moderate n, SURVEY.md SS7 hard part 3) and take the
    interval of the reduced standard pencil.
    """
    from ..golden.dae_reduce import nullspace_basis

    theta = nullspace_basis(j_sp, m_sp)
    a = a_sp.toarray() if sp.issparse(a_sp) else np.asarray(a_sp)
    at = theta.T @ a @ theta
    lam = np.linalg.eigvals(at)
    re = -np.real(lam)
    re = re[re > 0]
    return float(re.min()), float(re.max())


def spectral_interval_dae_cheap(a_sp, m_sp) -> tuple[float, float]:
    """Cheap large-n interval for DRE-SHIFTED constrained pencils:
    (0, a_max) with a_max from sparse ARPACK on the UNPROJECTED pencil.

    Justified for the DRE use only: the implicit-Euler time shift adds
    c = 1/(2 dt) to both interval ends (dre_shifted_interval), and c
    (~1e2) dwarfs the projected pencil's smallest real part (~1e0), so
    a_min's exact value is irrelevant after shifting; a_max of the
    unprojected pencil upper-bounds the projected one (modest
    over-coverage, log-insensitive for Wachspress). Replaces the dense
    projected eig (~30 s at n=4396, VERDICT r2 cold-start item) with
    one ARPACK LM solve (~1 s).
    """
    a_s = sp.csc_matrix(a_sp)
    m_s = sp.csc_matrix(m_sp)
    # Deterministic ARPACK start vector: the default random v0 makes
    # the computed interval (hence the Wachspress shifts, hence every
    # shift-keyed cache artifact) vary run to run.
    v0 = np.ones(a_s.shape[0])
    lam_big = spla.eigs(
        a_s, k=1, M=m_s, which="LM", return_eigenvectors=False, v0=v0
    )
    a_max = float(np.max(-np.real(lam_big)))
    return 0.0, a_max


def wachspress_shifts(a_min: float, a_max: float, num: int) -> np.ndarray:
    """Log-spaced real negative shifts covering [-a_max, -a_min].

    The classical near-optimal choice for symmetric spectra:
    sigma_j = -a_min (a_max/a_min)^((2j-1)/(2J)), j = 1..J.
    """
    j = np.arange(1, num + 1)
    ratio = max(a_max / a_min, 1.0 + 1e-12)
    return -a_min * ratio ** ((2 * j - 1) / (2 * num))


def cycled_shifts(shifts: np.ndarray, n_iter: int) -> np.ndarray:
    """Repeat the shift set cyclically to a full ADI iteration schedule."""
    reps = int(np.ceil(n_iter / len(shifts)))
    return np.tile(shifts, reps)[:n_iter]


def dre_shifted_interval(
    a_min: float, a_max: float, dt: float
) -> tuple[float, float]:
    """Spectral interval of (A - M/(2 dt), M) from that of (A, M).

    For the symmetric pencil, eig(A - c M, M) = eig(A, M) - c exactly.
    """
    c = 1.0 / (2.0 * dt)
    return a_min + c, a_max + c
