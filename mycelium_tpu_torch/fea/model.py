"""FEA model: static mesh data, grip masks and the operator layouts (port of
``mycelium_tpu/fea/model.py``, restricted to the chain operator with the
tree preconditioner under the unified tree/chain node order).

Everything index-shaped is built once per mesh on the host in numpy and
moved to one device; per-step "assembly" is masking fractured elements.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .chain import ChainPlan, build_chain_plan, greedy_path_cover
from .elements import ElementGeometry, element_forces, element_geometry_host
from .tree import build_tree_schedule, element_k3
from .tree_factor import (FastFactorData, TreePlan, build_fast_factor_data,
                          build_tree_plan)

DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclass(frozen=True)
class FeaModel:
    coords: torch.Tensor       # (N, 3)
    conn: torch.Tensor         # (E, 2) int64
    geom: ElementGeometry
    # ELL layout: node i receives sign[i, d] x the force of element
    # incident[i, d]; padding points at the sentinel element E, sign 0
    incident: torch.Tensor     # (N, deg_max) int64
    sign: torch.Tensor         # (N, deg_max)
    top_nodes: torch.Tensor    # (N,) bool grip masks
    bot_nodes: torch.Tensor
    free_nodes: torch.Tensor   # (N,) bool ~top & ~bot
    chain: ChainPlan
    tree: TreePlan
    tree_fast: FastFactorData | None   # None when no node is free

    @property
    def n_nodes(self) -> int:
        return self.coords.shape[0]

    @property
    def n_elems(self) -> int:
        return self.conn.shape[0]

    @property
    def n_dof(self) -> int:
        return 3 * self.coords.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.coords.dtype

    @property
    def device(self) -> torch.device:
        return self.coords.device


def _build_incidence(conn: np.ndarray, n_nodes: int):
    """Host-side ELL tables (static per mesh): incident element, sign, and
    the other endpoint (the reference's device anchoring reads the last;
    the port anchors on the host)."""
    n_elems = conn.shape[0]
    deg = np.zeros(n_nodes, dtype=np.int64)
    np.add.at(deg, conn[:, 0], 1)
    np.add.at(deg, conn[:, 1], 1)
    deg_max = max(int(deg.max()) if n_nodes else 0, 1)
    incident = np.full((n_nodes, deg_max), n_elems, dtype=np.int32)
    sign = np.zeros((n_nodes, deg_max), dtype=np.float64)
    neighbor = np.full((n_nodes, deg_max), n_nodes, dtype=np.int32)
    ends = np.concatenate([conn[:, 0], conn[:, 1]]).astype(np.int64)
    elem = np.concatenate([np.arange(n_elems), np.arange(n_elems)])
    sgn = np.concatenate([np.ones(n_elems), -np.ones(n_elems)])
    other = np.concatenate([conn[:, 1], conn[:, 0]]).astype(np.int64)
    order = np.argsort(ends, kind="stable")
    sorted_nodes = ends[order]
    offsets = np.zeros(n_nodes + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(np.bincount(ends, minlength=n_nodes))
    slot = np.arange(2 * n_elems) - offsets[sorted_nodes]
    incident[sorted_nodes, slot] = elem[order]
    sign[sorted_nodes, slot] = sgn[order]
    neighbor[sorted_nodes, slot] = other[order]
    return incident, sign, neighbor


def _unified_order(schedule, n_nodes: int) -> np.ndarray:
    """Tree-schedule slots first (slot s at chain position s), then the
    remaining (gripped) nodes along a greedy path cover of their induced
    subgraph."""
    slots = (np.concatenate([lv.slots for lv in schedule.levels])
             if schedule.levels else np.zeros((0,), np.int64)).astype(np.int64)
    in_slot = np.zeros(n_nodes, bool)
    in_slot[slots] = True
    rest = np.nonzero(~in_slot)[0]
    if len(rest):
        remap = np.full(n_nodes, -1, np.int64)
        remap[rest] = np.arange(len(rest))
        conn = np.asarray(schedule.conn, np.int64)
        gg = conn[~in_slot[conn[:, 0]] & ~in_slot[conn[:, 1]]]
        if len(gg):
            sub_perm = greedy_path_cover(remap[gg].astype(np.int32),
                                         len(rest))
            rest = rest[sub_perm]
    return np.concatenate([slots, rest])


def build_model(coords: np.ndarray, conn: np.ndarray, cfg,
                device) -> FeaModel:
    """Prepare all static solve data for a mesh on ``device``.

    Grips: nodes within cfg.grip_length of y_max are the top grip, of
    y_min the bottom grip; bottom wins where both apply."""
    if cfg.operator != "chain" or cfg.precond != "tree":
        raise NotImplementedError(
            f"operator={cfg.operator!r}, precond={cfg.precond!r}: the port "
            "builds operator='chain' with precond='tree' only (ROADMAP "
            "queue A: the other operators and preconditioners come with "
            "the solver sweep)")
    dtype = DTYPES[cfg.dtype]
    device = torch.device(device)
    coords = np.asarray(coords, dtype=np.float64)
    conn_np = np.asarray(conn, dtype=np.int32).reshape(-1, 2)
    n_nodes = coords.shape[0]

    y = coords[:, 1]
    top = np.abs(y - y.max()) < cfg.grip_length
    bot = np.abs(y - y.min()) < cfg.grip_length
    top = top & ~bot
    free = ~(top | bot)

    incident, sign, _ = _build_incidence(conn_np, n_nodes)
    n_host, length, k_ax, k_bd = element_geometry_host(coords, conn_np, cfg)

    schedule = build_tree_schedule(conn_np, n_nodes, free,
                                   max_path_len=cfg.tree_max_path_len)
    chain_host = build_chain_plan(coords, conn_np, n_host, k_ax, k_bd,
                                  perm=_unified_order(schedule, n_nodes))
    k3 = element_k3(n_host, k_ax, k_bd)
    tree_plan = build_tree_plan(schedule, k3, dtype, device,
                                dense_tail=cfg.tree_dense_tail)
    tree_fast = (build_fast_factor_data(schedule, k3, chain_host, dtype,
                                        device)
                 if schedule.levels else None)

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)

    def i(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    def b(a):
        return torch.as_tensor(np.asarray(a, bool), device=device)

    return FeaModel(
        coords=f(coords), conn=i(conn_np),
        geom=ElementGeometry(n=f(n_host), length=f(length), k_ax=f(k_ax),
                             k_bd=f(k_bd)),
        incident=i(incident), sign=f(sign),
        top_nodes=b(top), bot_nodes=b(bot), free_nodes=b(free),
        chain=ChainPlan.from_host(chain_host, dtype, device),
        tree=tree_plan, tree_fast=tree_fast)


def apply_stiffness(model: FeaModel, u, active):
    """Matrix-free K·u on node-major (N, 3) -> (N, 3): per-element end
    forces reduced through the gather-only ELL incidence table."""
    f = element_forces(u, model.conn, model.geom, active)
    f_pad = torch.cat([f, f.new_zeros((1, 3))])
    return (model.sign[:, :, None] * f_pad[model.incident]).sum(dim=1)
