"""utils/ — runtime config, checkpointing, metrics, timing."""
from .cache import load_arrays, load_or_comp, save_arrays
from .config import (
    CostConfig,
    OptConConfig,
    ProblemConfig,
    ShardingConfig,
    SolverConfig,
    TimeConfig,
    config_from_json,
)
from .metrics import MetricsLogger, device_timeit
from .profiling import SectionTimer, trace
from .runtime import setup

__all__ = [
    "CostConfig",
    "MetricsLogger",
    "SectionTimer",
    "trace",
    "OptConConfig",
    "ProblemConfig",
    "ShardingConfig",
    "SolverConfig",
    "TimeConfig",
    "config_from_json",
    "device_timeit",
    "load_arrays",
    "load_or_comp",
    "save_arrays",
    "setup",
]
