"""The FEA pull test on PyTorch: model build, hybrid solve, ramp loop."""

from .model import FeaModel, apply_stiffness, build_model
from .ramp import RampResult, SolveDivergedError, run_ramp
from .solve import SolveResult, compute_tree_factor, solve_displacement

__all__ = ["FeaModel", "apply_stiffness", "build_model", "RampResult",
           "SolveDivergedError", "run_ramp", "SolveResult",
           "compute_tree_factor", "solve_displacement"]
