"""The port's solver preset.

The reference's ``mycelium_tpu.config.tuned_fea_config`` imports jax, so
the port keeps its own preset over the same ``FeaConfig`` fields: the
benchmark configuration of ``bench.py`` without the TPU-only knobs, and
without the cluster coarse correction, which is not ported yet.
"""

from __future__ import annotations

from mycelium_tpu.config import FeaConfig


def hybrid_fea_config(**overrides) -> FeaConfig:
    """Chain operator + spanning-forest PC, float32, rtol 1e-6."""
    base = dict(dtype="float32", rtol=1e-6, operator="chain",
                precond="tree", use_pallas=True, tree_reg_rel=1e-7,
                tree_coarse_weight=0.0)
    base.update(overrides)
    return FeaConfig(**base)
