"""FEA model: static mesh data, grip masks and the operator layouts (port of
``mycelium_tpu/fea/model.py``), plus the per-node 3x3 diagonal blocks of
the block-Jacobi preconditioners and their inverses (K5's plain set-up
takes its blocks in chain order from ``tree_factor.chain_diag``).

Every model carries the ELL tables, the chain plan and the tree plan under
the unified tree/chain node order, whatever the configuration: the
reference builds the chain only for operator='chain' and the tree only for
precond='tree', and orders a chain without a tree by a plain path cover.
One order for every configuration keeps the coarse clusters (runs of chain
positions) the same for every solver, as the reference's sweep has them.

Everything index-shaped is built once per mesh on the host in numpy and
moved to one device; per-step "assembly" is masking fractured elements.
The node sums whose terms collide (the 'scatter' operator, the diagonal
blocks) add in one fixed order through ``kernels.ordered_sum`` over the
model's node incidence CSR, so the card gives the CPU's bits.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..devices import DEFAULT_DEVICE, resolve
from ..kernels.ordered_sum import ordered_sum
from ..utils import profiling
from .blocks import block_planes
from .chain import ChainPlan, build_chain_plan, greedy_path_cover
from .elements import ElementGeometry, element_forces, element_geometry_host
from .tree import build_tree_schedule, element_k3
from .tree_factor import (FastFactorData, TreeKernelTables, TreePlan,
                          build_fast_factor_data, build_tree_kernel_tables,
                          build_tree_plan, build_pcr_launch)

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
    neighbor: torch.Tensor     # (N, deg_max) int64 other end (sentinel N)
    top_nodes: torch.Tensor    # (N,) bool grip masks
    bot_nodes: torch.Tensor
    free_nodes: torch.Tensor   # (N,) bool ~top & ~bot
    chain: ChainPlan
    tree: TreePlan
    tree_fast: FastFactorData | None   # None when no node is free
    tree_tables: TreeKernelTables | None = None   # K6's index tables
    # K6 bound to this model (kernels.TreeCgLaunch): the tables' pointers,
    # the scratch and the result buffers, built once; None where the model
    # cannot run the kernel
    tree_launch: object | None = None
    # K7 bound to this model (kernels.AnchoredLaunch): the grip reachability
    # of an active mask in one launch, for CUDA tensors; made with every
    # model, it allocates its scratch at its first launch
    anchored_launch: object | None = None
    # K8 bound to this model (kernels.PostSolveLaunch): a ramp step's
    # post-solve and record rows in one launch, for CUDA tensors; made with
    # every model, it allocates its scratch at its first launch
    post_launch: object | None = None
    # the model can run the whole-solve kernel K6 (float32, a forest whose
    # tables K6 can read, within the card's memory): a fact of the model,
    # whatever configuration built it. fea/solve.py::solve_route sends
    # cg + tree on the chain operator there; False leaves it on the hybrid
    tree_kernel: bool = False
    # the coarse plans by cluster layout (fea/coarse.py::CoarsePlans), each
    # built at its first use
    coarse_plans: object | None = None
    # K5 bound to this model (kernels.ChainCgLaunch): made with every model,
    # it allocates its scratch and buffers at the model's first cg + coarse
    # solve
    chain_launch: object | None = None
    # K2 and K3 bound to the plan's PCR levels (kernels.PcrLaunch): made
    # with every model whose forest has levels, it allocates K2's buffers at
    # the model's first factorization on the card (the hybrid route's)
    pcr_launch: object | None = None
    # the node incidence CSR (``node_incidence_csr``, int32): node i's
    # entries 2·e + side at node_ent[node_ptr[i]:node_ptr[i + 1]]
    node_ptr: torch.Tensor | None = None
    node_ent: torch.Tensor | None = None

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
    the other endpoint (read by the device-side grip reachability)."""
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


def node_incidence_csr(conn: np.ndarray, n_nodes: int):
    """(ptr (n_nodes + 1,), ent) int32: node i's element ends as entries
    2·e + side, the elements whose first end is i in element order, then
    those whose second end is i: the order of the sequential
    ``index_add_`` over conn[:, 0], then over conn[:, 1]."""
    conn = np.asarray(conn, np.int64).reshape(-1, 2)
    n_elems = conn.shape[0]
    ends = np.concatenate([conn[:, 0], conn[:, 1]])
    ent = np.concatenate([2 * np.arange(n_elems), 2 * np.arange(n_elems) + 1])
    order = np.argsort(ends, kind="stable")
    ptr = np.zeros(n_nodes + 1, np.int64)
    ptr[1:] = np.cumsum(np.bincount(ends, minlength=n_nodes))
    return ptr.astype(np.int32), ent[order].astype(np.int32)


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
                device=DEFAULT_DEVICE) -> FeaModel:
    """Prepare all static solve data for a mesh on ``device`` (the card
    unless the caller passes "cpu").

    Grips: nodes within cfg.grip_length of y_max are the top grip, of
    y_min the bottom grip; bottom wins where both apply.

    Under a profiler it is the span ``fea.build``, with the children
    ``fea.build.schedule`` (the forest schedule), ``fea.build.chain`` (the
    node order and the chain plan), ``fea.build.tree`` (the tree plan and
    its factor data) and ``fea.build.kernels`` (``with_kernels``)."""
    with profiling.span("fea.build"):
        return _build_model(coords, conn, cfg, device)


def _build_model(coords, conn, cfg, device) -> FeaModel:
    dtype = DTYPES[cfg.dtype]
    device = resolve(device)
    coords = np.asarray(coords, dtype=np.float64)
    conn_np = np.asarray(conn, dtype=np.int32).reshape(-1, 2)
    n_nodes = coords.shape[0]

    y = coords[:, 1]
    top = np.abs(y - y.max()) < cfg.grip_length
    bot = np.abs(y - y.min()) < cfg.grip_length
    top = top & ~bot
    free = ~(top | bot)

    incident, sign, neighbor = _build_incidence(conn_np, n_nodes)
    n_host, length, k_ax, k_bd = element_geometry_host(coords, conn_np, cfg)

    with profiling.span("fea.build.schedule"):
        schedule = build_tree_schedule(conn_np, n_nodes, free,
                                       max_path_len=cfg.tree_max_path_len)
    with profiling.span("fea.build.chain"):
        chain_host = build_chain_plan(coords, conn_np, n_host, k_ax, k_bd,
                                      perm=_unified_order(schedule, n_nodes))
    with profiling.span("fea.build.tree"):
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

    model = FeaModel(
        coords=f(coords), conn=i(conn_np),
        geom=ElementGeometry(n=f(n_host), length=f(length), k_ax=f(k_ax),
                             k_bd=f(k_bd)),
        incident=i(incident), sign=f(sign), neighbor=i(neighbor),
        top_nodes=b(top), bot_nodes=b(bot), free_nodes=b(free),
        chain=ChainPlan.from_host(chain_host, dtype, device),
        tree=tree_plan, tree_fast=tree_fast)
    with profiling.span("fea.build.kernels"):
        return with_kernels(model)


def with_kernels(model: FeaModel) -> FeaModel:
    """``model`` with its node incidence CSR and its whole-solve kernels:
    its coarse plans, K5's launch (bound at its first solve), K7's (bound
    at its first refresh), K8's (bound at its first post-solve) and, where
    its forest has levels, K2 bound to its levels, the tree kernel's index
    tables, whether it can run that kernel and, if it can, the kernel's
    launch bound to it."""
    from ..kernels.anchored import AnchoredLaunch
    from ..kernels.chain_cg import ChainCgLaunch
    from ..kernels.post_solve import PostSolveLaunch
    from ..kernels.tree_cg import TreeCgLaunch
    from .coarse import CoarsePlans
    plans = CoarsePlans(model.chain, model.n_elems)
    ptr, ent = node_incidence_csr(model.conn.cpu().numpy(), model.n_nodes)
    model = replace(model, node_ptr=torch.as_tensor(ptr, device=model.device),
                    node_ent=torch.as_tensor(ent, device=model.device),
                    coarse_plans=plans, chain_launch=ChainCgLaunch(
        plans, model.free_nodes, model.top_nodes, model.bot_nodes),
                    anchored_launch=AnchoredLaunch(
        model.conn, model.top_nodes, model.bot_nodes),
                    post_launch=PostSolveLaunch(
        model.conn, model.geom, model.top_nodes))
    launch = None
    if model.tree.meta.level_steps:
        tables = build_tree_kernel_tables(model.tree, model.conn)
        launch = TreeCgLaunch(model.chain, model.tree, model.tree_fast,
                              tables, model.conn, model.top_nodes,
                              model.bot_nodes)
        model = replace(model, tree_tables=tables, tree_launch=launch,
                        pcr_launch=build_pcr_launch(model.tree))
    fits = tree_kernel_fits(model)
    return replace(model, tree_kernel=fits,
                   tree_launch=launch if fits else None)


# The one memory guard of the whole-solve tree kernel K6: the bytes the
# kernel touches (its tables, the factorization's coefficients and state,
# the CG vectors). It is not a residency limit and no speed threshold:
# measured against the hybrid within one call on an H100 (chip_smoke.py,
# profile_fea.py), K6 was 6-13x faster from 3 MB to 999 MB (22k to 3M DOF),
# well past the 50 MB L2, because the hybrid is bound by its ~2,000 launches
# and host reads, not by bytes. The grown networks of the xlarge pipeline
# (profile_fea.py --grown benchmark/configs/pipeline-xlarge.json, growth
# seeds 42 and 43: 2.96M DOF, 840 and 843 MB) stay below it: their cold
# solves took 6.2 and 4.5-4.9 ms on K6 against 65-68 and 9.7-12 ms on the
# hybrid.
# Beyond what was measured the model stays on the hybrid, whose
# factorization is computed level by level.
TREE_KERNEL_MAX_BYTES = 1000 * 1000 * 1000
# K6's windows must fit a block's shared memory (227 KB on the H100)
TREE_KERNEL_MAX_SMEM = 227 * 1024


def tree_kernel_bytes(model: FeaModel) -> int:
    """Bytes K6 touches in one solve of ``model``: the static tables it is
    handed, the solve's inputs and the buffers its launch holds
    (``kernels.TreeCgLaunch.nbytes``)."""
    from ..kernels.tree_cg import TreeCgLaunch
    launch = model.tree_launch or TreeCgLaunch(
        model.chain, model.tree, model.tree_fast, model.tree_tables,
        model.conn, model.top_nodes, model.bot_nodes)
    return launch.nbytes()


def tree_kernel_fits(model: FeaModel) -> bool:
    """Whether this model can run K6: a forest with levels whose fills and
    attachments point from earlier levels to later, float32, and the
    kernel's bytes and shared memory within the card's. Which solves
    go there is the solve-time configuration's matter (``solve_route``)."""
    from ..kernels.tree_cg import smem_bytes
    tk = model.tree_tables
    return bool(tk is not None and tk.ordered
                and model.dtype == torch.float32
                and smem_bytes(tk) <= TREE_KERNEL_MAX_SMEM
                and tree_kernel_bytes(model) <= TREE_KERNEL_MAX_BYTES)


def apply_stiffness(model: FeaModel, u, active, operator: str = "ell"):
    """Matrix-free K·u on node-major (N, 3) -> (N, 3): per-element end
    forces reduced through the gather-only ELL incidence table ('ell'), or
    summed at the element ends in the node incidence CSR's order
    ('scatter')."""
    f = element_forces(u, model.conn, model.geom, active)
    if operator == "scatter":
        # column 2·e + side: f at the first end, -f at the second
        ends = torch.stack([f, -f], dim=1).reshape(-1, 3)
        return ordered_sum(ends.T, model.node_ptr, model.node_ent,
                           model.n_nodes).T.contiguous()
    f_pad = torch.cat([f, f.new_zeros((1, 3))])
    return (model.sign[:, :, None] * f_pad[model.incident]).sum(dim=1)


def diag_blocks(model: FeaModel, active, cfg, free_nodes=None):
    """Per-node 3x3 diagonal blocks of the BC'd operator: free nodes get
    their stiffness block + reg·I, grip (and pinned) nodes the identity."""
    n = model.geom.n
    nnT = n[:, :, None] * n[:, None, :]
    eye = torch.eye(3, dtype=n.dtype, device=n.device)
    blk = (model.geom.k_ax[:, None, None] * nnT
           + model.geom.k_bd[:, None, None] * (eye - nnT))
    blk = blk * active[:, None, None].to(blk.dtype)
    out = ordered_sum(blk.reshape(-1, 9).T, model.node_ptr, model.node_ent,
                      model.n_nodes, shift=1).T.reshape(-1, 3, 3)
    out = out + cfg.reg * eye
    free = model.free_nodes if free_nodes is None else free_nodes
    return torch.where(free[:, None, None], out, eye)


def invert_blocks(blocks):
    """Batched scale-stabilized 3x3 adjugate inverse."""
    tiny = 1e-300 if blocks.dtype == torch.float64 else 1e-30
    scale = blocks.abs().amax(dim=(1, 2), keepdim=True).clamp(min=tiny)
    b = blocks / scale
    a00, a01, a02 = b[:, 0, 0], b[:, 0, 1], b[:, 0, 2]
    a10, a11, a12 = b[:, 1, 0], b[:, 1, 1], b[:, 1, 2]
    a20, a21, a22 = b[:, 2, 0], b[:, 2, 1], b[:, 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    adj = torch.stack([torch.stack([c00, c01, c02], dim=-1),
                       torch.stack([c10, c11, c12], dim=-1),
                       torch.stack([c20, c21, c22], dim=-1)], dim=1)
    return adj / (det[:, None, None] * scale)


def inverse_planes(d9):
    """The (9, N) planes of the blocks' inverses (``invert_blocks``) from
    the (9, N) planes of the blocks (``tree_factor.chain_diag``)."""
    return block_planes(invert_blocks(d9.T.reshape(-1, 3, 3)))
