"""Test harness config: CPU-only, 8 virtual devices, x64 enabled.

Per SURVEY.md SS4: tests are residual-based mathematical oracles against
dense scipy solutions, run on a virtual 8-device CPU mesh so sharding
logic is exercised without a GPU. JAX_PLATFORMS=cpu is set before JAX
is imported, so no test process (xdist workers included) opens a card;
chip_smoke.py and bench.py run on the GPU, tests never do.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
