"""Per-element data and strain (port of ``mycelium_tpu/fea/elements.py``).

The element is an axial truss term (EA/L)·n⊗n plus an isotropic
transverse penalty (12EI/L³)·(I − n⊗n), three translational DOF per node.
Lengths are clamped at 1e-12 against coincident nodes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class ElementGeometry:
    """Static per-element data (the mesh never deforms)."""
    n: torch.Tensor        # (E, 3) unit direction p2 - p1
    length: torch.Tensor   # (E,) true length
    k_ax: torch.Tensor     # (E,) EA/L
    k_bd: torch.Tensor     # (E,) 12EI/L^3


def element_geometry_host(coords: np.ndarray, conn: np.ndarray, cfg):
    """(n, length, k_ax, k_bd) as float64 numpy, computed once per mesh."""
    d = coords[conn[:, 1]] - coords[conn[:, 0]]
    length = np.linalg.norm(d, axis=1)
    l_safe = np.maximum(length, 1e-12)
    n = d / l_safe[:, None]
    k_ax = (cfg.e_mod * cfg.area) / l_safe
    k_bd = 12.0 * cfg.e_mod * cfg.moi / (l_safe ** 3)
    return n, length, k_ax, k_bd


def element_forces(u, conn, geom: ElementGeometry, active):
    """(E, 3) end force on node n1 (n2 receives -f); inactive elements
    contribute zero."""
    d = u[conn[:, 0]] - u[conn[:, 1]]
    nd = (geom.n * d).sum(dim=1)
    f = (geom.k_ax * nd)[:, None] * geom.n \
        + geom.k_bd[:, None] * (d - nd[:, None] * geom.n)
    return f * active[:, None].to(f.dtype)


def element_strain(u, conn, geom: ElementGeometry):
    """Axial strain n·(u2 - u1)/L on the undeformed geometry."""
    du = u[conn[:, 1]] - u[conn[:, 0]]
    return (geom.n * du).sum(dim=1) / geom.length.clamp_min(1e-12)
