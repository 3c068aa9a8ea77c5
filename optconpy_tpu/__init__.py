"""optconpy_tpu — accelerator MPC / trajectory-optimization engine.

A from-scratch JAX/XLA re-design of the workload of
`highlando/optconpy` (optimal control of FEM-discretized incompressible
Navier-Stokes with quadratic tracking costs and Riccati-based feedback).

See SURVEY.md for the structural analysis of the reference and the layer
plan this package implements; BASELINE.md for the acceptance configs.

Layer map (SURVEY.md SS7):
    ops/       static-sparsity sparse formats, low-rank + dense kernels
    fem/       offline CPU discretization -> frozen Operators pytrees
    solvers/   Krylov + saddle-point + steady-state Navier-Stokes
    riccati/   low-rank ADI, Newton-Kleinman, differential Riccati sweeps
    control/   LQR gains, feedback + feedforward application
    mpc/       closed-loop rollouts, batched scenarios, receding horizon
    parallel/  device mesh, GSPMD shardings, shard_map'ed solvers
    utils/     config, checkpointing, metrics, timing
    golden/    serial f64 scipy reference implementations (the oracle)
"""

__version__ = "0.2.0"
