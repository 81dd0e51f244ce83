"""mycelium_tpu_torch: the PyTorch/CUDA port of mycelium_tpu, beside the
JAX package it is held against.

This slice runs the FEA pull test (mesh -> model -> 40 hybrid tree-PC CG
solves with fracture -> CSV records) with three hand-written CUDA kernels
for Hopper (``kernels/``). The package imports torch, never jax; the CUDA
library is compiled on first use, not at import.
"""

from .config import hybrid_fea_config
from .fea import build_model, run_ramp, solve_displacement

__version__ = "0.1.0"

__all__ = ["hybrid_fea_config", "build_model", "run_ramp",
           "solve_displacement", "__version__"]
