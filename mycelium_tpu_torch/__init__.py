"""mycelium_tpu_torch: the PyTorch/CUDA port of mycelium_tpu, beside the
JAX package it is held against.

Two slices run on the card: growth (``growth/``: translocation, growth
and branching, anastomosis, uptake, walls) and the FEA pull test (mesh ->
model -> 40 tree-PC CG solves with fracture -> CSV records; each solve one
launch of the whole-solve kernel below its size gate, the hybrid of
separate kernels above it), coupled through the exported mesh, with six
hand-written CUDA kernels for Hopper (``kernels/``). The package imports torch and nothing of jax
or the JAX package; the CUDA library is compiled on first use, not at
import.
"""

from .config import GROWTH_PRESETS, GrowthConfig, hybrid_fea_config
from .fea import (build_model, run_ramp, run_ramp_async, run_ramp_scan,
                  solve_displacement)
from .growth import run_growth, state_mesh

__version__ = "0.2.0"

__all__ = ["GROWTH_PRESETS", "GrowthConfig", "hybrid_fea_config",
           "build_model", "run_ramp", "run_ramp_async", "run_ramp_scan",
           "solve_displacement", "run_growth",
           "state_mesh", "__version__"]
