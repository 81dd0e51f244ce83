"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: K1 ``chain_matvec``, K2 ``pcr_factor``, K3 ``pcr_apply``.

Nothing is compiled or loaded at import; ``build.library()`` compiles the
sources on first use."""

from .build import launch_counts, reset_launch_counts
from .chain_matvec import chain_matvec, chain_matvec_plain
from .pcr import pcr_apply, pcr_apply_plain, pcr_factor, pcr_factor_plain

__all__ = ["chain_matvec", "chain_matvec_plain", "pcr_factor",
           "pcr_factor_plain", "pcr_apply", "pcr_apply_plain",
           "launch_counts", "reset_launch_counts"]
