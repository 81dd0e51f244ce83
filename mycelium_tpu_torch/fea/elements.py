"""Per-element data and strain (port of ``mycelium_tpu/fea/elements.py``).

The element is an axial truss term (EA/L)·n⊗n plus an isotropic
transverse penalty (12EI/L³)·(I − n⊗n), three translational DOF per node.
Lengths are clamped at 1e-12 against coincident nodes.

The model is built from ``element_geometry_host`` (numpy, once per mesh);
``element_geometry`` is the same on tensors, and
``element_stiffness_batch`` the dense (E, 6, 6) batch that only the
explicit assembly (``fea/assemble.py``) reads.
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



def element_geometry(coords, conn, cfg) -> ElementGeometry:
    """``ElementGeometry`` of the (N, 3) ``coords`` and (E, 2) ``conn``
    tensors, on their device and in the dtype of ``coords``."""
    d = coords[conn[:, 1]] - coords[conn[:, 0]]
    length = torch.linalg.norm(d, dim=1)
    l_safe = length.clamp_min(1e-12)
    n = d / l_safe[:, None]
    # a tensor numerator: a Python number over a tensor is a reciprocal
    # and a product in torch, one more rounding than the reference's
    k_ax = l_safe.new_tensor(cfg.e_mod * cfg.area) / l_safe
    k_bd = l_safe.new_tensor(12.0 * cfg.e_mod * cfg.moi) / (l_safe ** 3)
    return ElementGeometry(n=n, length=length, k_ax=k_ax, k_bd=k_bd)


def element_stiffness_batch(geom: ElementGeometry):
    """Dense (E, 6, 6) element stiffness batch,
    K_e = k_ax·[[nnᵀ,-nnᵀ],[-nnᵀ,nnᵀ]] + k_bd·[[P,-P],[-P,P]], P = I − nnᵀ."""
    n = geom.n
    nnT = n[:, :, None] * n[:, None, :]                   # (E,3,3)
    eye = torch.eye(3, dtype=n.dtype, device=n.device)
    blk = (geom.k_ax[:, None, None] * nnT
           + geom.k_bd[:, None, None] * (eye - nnT))      # (E,3,3)
    top = torch.cat([blk, -blk], dim=2)                   # (E,3,6)
    bot = torch.cat([-blk, blk], dim=2)
    return torch.cat([top, bot], dim=1)                   # (E,6,6)


def dot3(a, b):
    """Row-wise dot product of (E, 3) tensors, added in the fixed order
    (a0·b0 + a1·b1) + a2·b2 on every device: the order K8
    (``kernels/csrc/post_solve.cu``) takes, and on the CPU the bits of
    ``(a * b).sum(dim=1)``."""
    p = a * b
    return (p[:, 0] + p[:, 1]) + p[:, 2]


def element_forces(u, conn, geom: ElementGeometry, active):
    """(E, 3) end force on node n1 (n2 receives -f); inactive elements
    contribute zero."""
    d = u[conn[:, 0]] - u[conn[:, 1]]
    nd = dot3(geom.n, d)
    f = (geom.k_ax * nd)[:, None] * geom.n \
        + geom.k_bd[:, None] * (d - nd[:, None] * geom.n)
    return f * active[:, None].to(f.dtype)


def element_strain(u, conn, geom: ElementGeometry):
    """Axial strain n·(u2 - u1)/L on the undeformed geometry."""
    du = u[conn[:, 1]] - u[conn[:, 0]]
    return dot3(geom.n, du) / geom.length.clamp_min(1e-12)
