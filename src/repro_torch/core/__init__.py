"""ZEUS core on PyTorch: PSO or mean-field phase 1, multistart BFGS or
L-BFGS on the batched, megakernel or per-lane sweep, and the sequential
baseline.

Port of src/repro/core for a single host (see the module docstrings for
what each file covers and what is not ported yet).
"""
from repro_torch.core.bfgs import (
    BatchedDenseBFGS,
    BFGSOptions,
    DenseBFGS,
    batched_bfgs,
    make_bfgs_solver,
    serial_bfgs,
)
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
    DirectionStrategy,
    EngineOptions,
    Lane,
    VmappedStrategy,
    as_batched_strategy,
    batch_lanes_init,
    batch_lanes_step,
    get_solver,
    lane_init,
    lane_step,
    register_solver,
    run_multistart,
    solver_names,
)
from repro_torch.core.lbfgs import LBFGS, LBFGSOptions, batched_lbfgs
from repro_torch.core.meanfield import (
    MeanFieldPSOOptions,
    MeanFieldState,
    consensus_point,
    run_meanfield_pso,
)
from repro_torch.core.objectives import (
    OBJECTIVES,
    BatchedObjective,
    as_batched,
    get_objective,
    objective_name_of,
    register_batched_vg,
)
from repro_torch.core.pso import (
    PSOOptions,
    SwarmState,
    TorchDraws,
    run_pso,
    sequential_pso,
)
from repro_torch.core.zeus import (
    SequentialZeusResult,
    ZeusOptions,
    ZeusResult,
    phase2_setup,
    sequential_zeus,
    solve_phase2,
    zeus,
    zeus_jit,
)
