"""ZEUS core on PyTorch: PSO + multistart dense BFGS on the batched sweep.

Port of src/repro/core for the single-host main path (see the module
docstrings for what each file covers and what is not ported yet).
"""
from repro_torch.core.bfgs import BFGSOptions, BatchedDenseBFGS, make_bfgs_solver
from repro_torch.core.clustering import (
    ConfidenceReport,
    cluster_solutions,
    run_until_confident,
)
from repro_torch.core.engine import (
    CONVERGED,
    DIVERGED,
    STOPPED,
    BatchedDirectionStrategy,
    BatchLanes,
    BFGSResult,
    EngineOptions,
    batch_lanes_init,
    batch_lanes_step,
    get_solver,
    register_solver,
    run_multistart,
)
from repro_torch.core.objectives import (
    OBJECTIVES,
    BatchedObjective,
    as_batched,
    get_objective,
    objective_name_of,
    register_batched_vg,
)
from repro_torch.core.pso import PSOOptions, SwarmState, TorchDraws, run_pso
from repro_torch.core.zeus import (
    ZeusOptions,
    ZeusResult,
    phase2_setup,
    solve_phase2,
    zeus,
)
