"""Prescribed-displacement boundary conditions (port of
``mycelium_tpu/fea/bc.py``: ``prescribed_values``, ``bc_operator``,
``bc_rhs``).

The solve uses the projected operator P·(K·(P·u) + reg·P·u) + (I−P)·u
with P = diag(free) and right-hand side −P·K·u_k + (I−P)·u_k, so the
solution carries the prescribed values exactly. These are the node-space
forms (operator 'ell' or 'scatter'); the chain path builds the same pair
on its own layout (``fea/hybrid.py``).
"""

from __future__ import annotations

import torch

from .model import apply_stiffness


def prescribed_values(model, dy_top: float, dy_bot: float) -> torch.Tensor:
    """(N, 3) field holding the BC values: grip nodes move (0, ±dy, 0),
    free nodes hold zero."""
    # masks times Python scalars: no host-to-device copy, so no host sync
    uy = model.top_nodes.to(model.dtype) * dy_top \
        + model.bot_nodes.to(model.dtype) * dy_bot
    z = torch.zeros_like(uy)
    return torch.stack([z, uy, z], dim=1)


def bc_operator(model, active, cfg, free_nodes=None):
    """The SPD boundary-conditioned operator on node-major (N, 3)."""
    free = (model.free_nodes if free_nodes is None else free_nodes)[:, None]

    def apply(u):
        uf = torch.where(free, u, 0.0)
        ku = apply_stiffness(model, uf, active, cfg.operator)
        return torch.where(free, ku + cfg.reg * uf, u)

    return apply


def bc_rhs(model, active, u_k, cfg, free_nodes=None):
    """b = −P·K·u_k + (I−P)·u_k (the pull test has no external loads)."""
    free = (model.free_nodes if free_nodes is None else free_nodes)[:, None]
    ku = apply_stiffness(model, u_k, active, cfg.operator)
    return torch.where(free, -ku, u_k)
