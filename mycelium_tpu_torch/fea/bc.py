"""Prescribed-displacement boundary values (port of
``mycelium_tpu/fea/bc.py::prescribed_values``).

The solve uses the projected operator P·(K·(P·u) + reg·P·u) + (I−P)·u
with P = diag(free) and right-hand side −P·K·u_k + (I−P)·u_k, so the
solution carries the prescribed values exactly (see ``fea/hybrid.py``).
"""

from __future__ import annotations

import torch


def prescribed_values(model, dy_top: float, dy_bot: float) -> torch.Tensor:
    """(N, 3) field holding the BC values: grip nodes move (0, ±dy, 0),
    free nodes hold zero."""
    zero = torch.zeros((), dtype=model.dtype, device=model.device)
    top = torch.tensor(dy_top, dtype=model.dtype, device=model.device)
    bot = torch.tensor(dy_bot, dtype=model.dtype, device=model.device)
    uy = torch.where(model.top_nodes, top, zero) \
        + torch.where(model.bot_nodes, bot, zero)
    z = torch.zeros_like(uy)
    return torch.stack([z, uy, z], dim=1)
