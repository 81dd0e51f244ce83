"""The FEA pull test on PyTorch: model build, the solve routes (whole-solve
kernels and the hybrid) and the ramp loops."""

from .model import FeaModel, apply_stiffness, build_model
from .ramp import (RampResult, SolveDivergedError, run_ramp, run_ramp_async,
                   run_ramp_scan, run_ramp_sharded, truncate_after_fracture)
from .solve import (SolveResult, compute_tree_factor, solve_displacement,
                    solve_route)

__all__ = ["FeaModel", "apply_stiffness", "build_model", "RampResult",
           "SolveDivergedError", "run_ramp", "run_ramp_async", "run_ramp_scan",
           "run_ramp_sharded", "truncate_after_fracture",
           "SolveResult", "compute_tree_factor", "solve_displacement",
           "solve_route"]
