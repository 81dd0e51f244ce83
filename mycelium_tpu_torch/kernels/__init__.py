"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: K1 ``chain_matvec``, K2 ``pcr_factor`` and K3 ``pcr_apply`` (both
bound in ``PcrLaunch``), K4 ``anast_scan``, K5 ``chain_cg`` (``ChainCgLaunch``), K6
``tree_cg`` (``TreeCgLaunch``), K7 the grip reachability
(``AnchoredLaunch``), K8 a ramp step's post-solve and record rows
(``PostSolveLaunch``), and ``ordered_sum``, the fixed-order segment sum of
the PyTorch routes (none of the last three replaces a TPU kernel).

Nothing is compiled or loaded at import; ``build.library()`` compiles the
sources on first use."""

from .anast import anast_scan, anast_scan_plain
from .anchored import AnchoredLaunch
from .build import launch_counts, reset_launch_counts
from .chain_cg import ChainCgLaunch, chain_cg_plain, chain_cg_setup_plain
from .chain_matvec import ChainOperator, chain_matvec, chain_matvec_plain
from .ordered_sum import ordered_sum, ordered_sum_plain
from .post_solve import PostRows, PostSolveLaunch, post_solve_plain
from .pcr import (PcrLaunch, pcr_apply, pcr_apply_plain, pcr_factor,
                  pcr_factor_plain)
from .tree_cg import TreeCgLaunch, tree_cg_plain, tree_cg_setup_plain

__all__ = ["ChainOperator", "chain_matvec", "chain_matvec_plain", "pcr_factor",
           "pcr_factor_plain", "PcrLaunch", "pcr_apply",
           "pcr_apply_plain", "ordered_sum", "ordered_sum_plain",
           "anast_scan", "anast_scan_plain", "ChainCgLaunch",
           "chain_cg_plain", "chain_cg_setup_plain",
           "TreeCgLaunch", "tree_cg_plain", "tree_cg_setup_plain",
           "AnchoredLaunch", "PostRows", "PostSolveLaunch",
           "post_solve_plain",
           "launch_counts", "reset_launch_counts"]
