"""Runtime configuration: matmul precision, NaN sanitizer, compile cache.

Precision: an f32 matrix product on the GPU may run on the tensor cores
in TF32, which keeps about three decimal digits, unless a precision is
asked for. The tiers JAX offers there are 'highest' (full f32
products), 'high' (TF32), the explicit dot-algorithm presets such as
'TF32_TF32_F32_X3' and 'BF16_BF16_F32_X3' (split operands whose partial
products recover most of the f32 mantissa), and f64 under x64 mode.
setup() keeps 'highest' as the global default: the 1e-4 bounds on the
gains and the closed-loop outputs are checked against f64 at that tier
(chip_smoke.py). Call setup() before any jit.
"""
from __future__ import annotations

import os
from pathlib import Path

import jax

# Fixed per checkout, not per working directory, so runs started from
# any directory share one cache.
CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def setup(
    matmul_precision: str = "highest",
    debug_nans: bool | None = None,
) -> None:
    """Configure JAX for the solver workload (idempotent).

    debug_nans: the CI sanitizer mode (SURVEY.md SS5.2) — every jitted
    computation re-checks for NaN outputs and raises FloatingPointError
    at the producing op (deoptimizes; never use for benchmarks). When
    None, the OPTCONPY_DEBUG_NANS env var ('1'/'true') decides, so CI
    can flip the whole suite to sanitized mode without code changes.

    Persistent compilation cache: where JAX_COMPILATION_CACHE_DIR is
    set, JAX reads it itself and no other directory is set here;
    otherwise compiles go to CACHE_DIR.
    """
    jax.config.update("jax_default_matmul_precision", matmul_precision)
    if debug_nans is None:
        debug_nans = os.environ.get(
            "OPTCONPY_DEBUG_NANS", ""
        ).lower() in ("1", "true", "yes")
    jax.config.update("jax_debug_nans", bool(debug_nans))
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
