"""Device mesh + sharding layout (SURVEY.md SS5.8, SS7 layer 6).

The reference is single-process CPU with no communication layer
(SURVEY.md SS2 parallelism census); the distribution model here is
GSPMD: a ('scenario',) — optionally ('scenario', 'model') — device
mesh, NamedSharding of the scenario batch over the cards, and XLA
collectives inside shard_map'ed solver steps. No custom transport.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def scenario_mesh(devices=None, axis: str = "scenario") -> Mesh:
    """1D mesh over all (or given) devices for scenario data-parallel."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def shard_scenarios(mesh: Mesh, batch, axis: str = "scenario"):
    """Shard leading (scenario) axis of a pytree of arrays over the mesh."""
    sharding = NamedSharding(mesh, P(axis))
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding), batch
    )


def replicate(mesh: Mesh, tree):
    """Replicate a pytree (gains, operators) on every device."""
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding), tree
    )


def init_multihost(coordinator: str | None = None):
    """Multi-host initialization: thin jax.distributed wrapper."""
    if jax.process_count() > 1:
        return  # already initialized by the launcher
    if coordinator is not None:
        jax.distributed.initialize(coordinator_address=coordinator)
