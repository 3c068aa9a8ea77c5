"""Infinite-horizon ARE on (possibly unstable) constrained systems.

The reference's flagship capability (SURVEY.md SS1 item 3, SS3.3):
Riccati feedback for the cylinder wake ABOVE the critical Reynolds
number, where the linearized operator has unstable eigenvalues and
Newton-Kleinman from K0 = 0 diverges. The classical cure (and the one
this module wires end-to-end): an algebraic-Bernoulli stabilizing
initial gain (riccati/bernoulli.py, Amodei-Buchot minimal-rank), then
Newton-ADI on the DAE pencil with the feedback folded in through SMW —
the shifted open-loop factorizations are still the only factored
objects (SURVEY.md SS2 rows 5-6).

Shift selection for the unstable case cannot use the open-loop
spectrum (it straddles the imaginary axis); the correct interval is
that of the BERNOULLI-CLOSED-LOOP operator A - B K0, computed on the
reduced ker-J system at setup time (host, offline — SURVEY.md SS7
hard part 3). Pass `interval` explicitly at scales where the dense
reduced eigendecomposition is infeasible.
"""
from __future__ import annotations

import numpy as np

from ..golden.dae_reduce import reduce_dae
from . import shifts as shiftmod
from .bernoulli import stabilizing_gain_reduced
from .newton_kleinman import newton_adi_are, newton_adi_are_host


def solve_are_stabilized(
    np_ops: dict,
    sys,
    alpha: float,
    n_shifts: int = 8,
    n_adi: int = 24,
    n_newton: int = 8,
    r_max: int = 40,
    interval: tuple | None = None,
    cache: str = "lu",
    dtype=None,
    matfree_kwargs: dict | None = None,
):
    """Bernoulli-stabilized Newton-ADI ARE; returns (Z, K, info).

    np_ops: scipy operator dict (models/*.py) with M, A, J, B, C;
    sys: the matching DAESystem (device pytree);
    cache: 'lu' (dense per-shift saddle LUs — moderate n) or 'matfree'
        (block-Jacobi + pressure-Schur FGMRES, solvers/matfree.py —
        no O((n+np)^2) factor, the config-3+ path).
    interval: optional (a_min, a_max) of the closed-loop spectrum
        |Re lambda(A - B K0, M)|ker J| — REQUIRED at large n.

    info carries n_unstable, the K0 used, and the shift schedule.
    """
    import jax.numpy as jnp

    dtype = dtype or sys.b.dtype

    red = reduce_dae(np_ops)
    k0t, n_unstable = stabilizing_gain_reduced(
        red["At"], red["Bt"], alpha
    )
    k0 = (k0t @ red["theta"].T) @ red["M_full"]

    if interval is None:
        closed = red["At"] - red["Bt"] @ k0t
        lam = np.linalg.eigvals(closed)
        re = -np.real(lam)
        re = re[re > 0]
        a_min, a_max = float(re.min()), float(re.max())
    else:
        a_min, a_max = interval

    sig = shiftmod.wachspress_shifts(a_min, a_max, n_shifts)
    sigma_seq = shiftmod.cycled_shifts(sig, n_adi)
    idx_seq = shiftmod.cycled_shifts(
        np.arange(n_shifts, dtype=np.int32), n_adi
    )

    if cache == "lu":
        from ..solvers.saddle import SaddleShiftedLUCache

        m_d, a_d, j_d = sys.dense()
        cache_obj = SaddleShiftedLUCache.build(
            a_d.T, m_d, j_d, jnp.asarray(sig, dtype)
        )
    elif cache == "matfree":
        from ..solvers.matfree import SaddleMatfreeCache

        cache_obj = SaddleMatfreeCache.build(
            np_ops["A"].T.tocsr(), np_ops["M"], np_ops["J"], sig,
            dtype=dtype, **(matfree_kwargs or {}),
        )
    else:
        raise ValueError(f"unknown cache kind: {cache}")

    # Matfree caches host-loop the ADI chain; kept until an H100
    # measurement decides, ROADMAP design item 1 (see
    # lyap_adi.lowrank_adi_hostloop).
    newton_fn = (
        newton_adi_are_host if cache == "matfree" else newton_adi_are
    )
    z, k = newton_fn(
        sys,
        cache_obj,
        alpha,
        jnp.asarray(sigma_seq, dtype),
        jnp.asarray(idx_seq),
        n_newton=n_newton,
        out_rank=r_max,
        k0=jnp.asarray(k0, dtype),
    )
    info = {
        "n_unstable": int(n_unstable),
        "k0": k0,
        "shifts": sig,
        "interval": (a_min, a_max),
    }
    return z, k, info
