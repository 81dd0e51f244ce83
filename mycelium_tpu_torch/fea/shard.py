"""The domain-decomposed CG solve over the ranks of a process group (port of
``mycelium_tpu/fea/shard.py::sharded_cg_solver``): one process a rank,
``torch.distributed`` in place of ``shard_map``.

Nodes and elements are split in even blocks over the ranks, each padded
to a rank multiple: padded elements have zero stiffness and point at node
0, padded nodes are pinned with zero prescribed values. With
``precond="coarse"`` the nodes are padded to ranks · 128 · kblk, so that
no coarse cluster crosses a rank. An operator apply is

- ``all_gather_into_tensor`` of the rank's block of u into the full
  (Np, 3) field;
- the forces of the rank's elements (``elements.element_forces``);
- their node sums into an (Np, 3) buffer through ``kernels.ordered_sum``
  over the rank's node incidence CSR, built once with the solver, in
  element order, first ends then second ends (the order of the CPU's two
  sequential ``index_add_`` calls, so the card gives the CPU's bits; no
  float atomics);
- ``reduce_scatter_tensor`` of that buffer onto the ranks' blocks.

Each dot product is one ``all_reduce``; every rank reads the same |r| and
takes the same decisions, with pcg's stall exit. The preconditioners:

- 'tree': redundant, as the JAX package's: every rank gathers the
  chain-order residual and runs the whole forest apply
  (``tree_factor.tree_apply_chain_planes``, K3 through the model's bound
  launch on the card) plus tree_coarse_weight times the coarse correction
  (``solve.chain_preconditioner``), and keeps its block; the
  factorization (K2 on the card) may be passed in per call;
- 'coarse': block-Jacobi plus the cluster coarse correction, restricted
  on the rank's clusters, the coarse residual all-gathered (dof order
  basis·3·nbc + component·nbc + cluster), the replicated inverse
  (``coarse.coarse_inverse``), prolonged locally;
- anything else: block-Jacobi (``model.invert_blocks(diag_blocks(...))``).

With 'coarse' or 'tree' the solve runs in chain order. The solution comes
back on every rank as the full (N, 3) tensor in node order.
"""

from __future__ import annotations

import warnings

import torch
import torch.distributed as dist

from .bc import prescribed_values
from .coarse import (BLOCK, coarse_cluster_blocks, coarse_inverse, n_basis,
                     plan_nb, ramp_weight)
from .elements import ElementGeometry, element_forces
from .model import FeaModel, diag_blocks, invert_blocks, node_incidence_csr
from .solve import (STALL_ACCEPT, STALL_WINDOW, SolveResult,
                    chain_preconditioner, compute_tree_factor, free_mask)
from ..kernels.ordered_sum import ordered_sum

# all_gather_into_tensor and reduce_scatter_tensor are the names every
# supported torch has (2.11 has no *_single forms; 2.13 has both and calls
# these two deprecated)
_DEPRECATED = (r"`torch\.distributed\.(all_gather_into_tensor|"
               r"reduce_scatter_tensor)` is deprecated")


def _collective(fn, *args, **kw):
    """``fn(*args, **kw)`` with the deprecation notice of the two names
    above silenced."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=_DEPRECATED,
                                category=FutureWarning)
        return fn(*args, **kw)


def _pad_rows(x, m: int, fill=0):
    """``x`` with rows of ``fill`` appended up to a multiple of ``m``."""
    pad = (-x.shape[0]) % m
    if pad == 0:
        return x
    return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])


def _mv3(m, v):
    """(n, 3, 3) blocks times (n, 3) vectors, component by component."""
    return torch.stack([m[:, i, 0] * v[:, 0] + m[:, i, 1] * v[:, 1]
                        + m[:, i, 2] * v[:, 2] for i in range(3)], dim=1)


class ShardedSolver:
    """``sharded_cg_solver``'s solve: (active, dy_top, dy_bot, x0
    [, anchored, tree_factor_val]) -> ``SolveResult`` with the full (N, 3)
    solution on every rank. Built once per model and group: the padding,
    the rank's elements and its node incidence CSR."""

    def __init__(self, model: FeaModel, cfg, group=None):
        if not dist.is_initialized():
            raise RuntimeError("sharded_cg_solver needs a process group "
                               "(utils.dist.initialize_distributed or "
                               "initialize_single)")
        self.model, self.cfg, self.group = model, cfg, group
        self.n_ranks = dist.get_world_size(group)
        self.me = dist.get_rank(group)
        N, E, dev = model.n_nodes, model.n_elems, model.device
        self.use_coarse = cfg.precond == "coarse"
        # a forest with no free node: the preconditioner does not matter,
        # block-Jacobi as the JAX package
        self.use_tree = cfg.precond == "tree" and model.tree_fast is not None
        self.kblk = coarse_cluster_blocks(plan_nb(N), cfg) \
            if self.use_coarse else 1
        self.width = BLOCK * self.kblk
        quantum = self.n_ranks * self.width if self.use_coarse \
            else self.n_ranks
        self.Np = N + (-N) % quantum
        self.S_loc = self.Np // self.n_ranks
        self.permuted = self.use_coarse or self.use_tree
        conn = model.conn
        if self.permuted:
            conn = model.chain.inv_perm[conn]
        # the rank's block of elements, padded: zero stiffness, node 0
        E_loc = -(-E // self.n_ranks)
        lo, hi = self.me * E_loc, (self.me + 1) * E_loc
        self.elems = slice(lo, hi)
        geom = model.geom
        self.conn_l = _pad_rows(conn, self.n_ranks)[lo:hi]
        self.geom_l = ElementGeometry(
            n=_pad_rows(geom.n, self.n_ranks)[lo:hi],
            length=_pad_rows(geom.length, self.n_ranks, 1.0)[lo:hi],
            k_ax=_pad_rows(geom.k_ax, self.n_ranks)[lo:hi],
            k_bd=_pad_rows(geom.k_bd, self.n_ranks)[lo:hi])
        ptr, ent = node_incidence_csr(self.conn_l.cpu().numpy(), self.Np)
        self.ptr = torch.as_tensor(ptr, device=dev)
        self.ent = torch.as_tensor(ent, device=dev)
        self.rows = slice(self.me * self.S_loc, (self.me + 1) * self.S_loc)
        if self.use_coarse:
            self.nbc_loc = self.S_loc // self.width
            self.nbas = n_basis(cfg)
            self.rampw = ramp_weight(torch.arange(self.width, device=dev),
                                     self.width, model.dtype)

    # -- collectives -------------------------------------------------------

    def gather(self, x_l):
        """The ranks' blocks, (n, ...) each, stacked in rank order: for
        (S_loc, ...) blocks the full (Np, ...) tensor."""
        out = x_l.new_empty((self.n_ranks * x_l.shape[0],)
                            + tuple(x_l.shape[1:]))
        _collective(dist.all_gather_into_tensor, out, x_l.contiguous(),
                    group=self.group)
        return out

    def dot(self, a, b):
        t = (a * b).sum().reshape(1)
        dist.all_reduce(t, group=self.group)
        return t[0]

    # -- operator ----------------------------------------------------------

    def stiffness(self, u_l, active_l):
        """The rank's block of K·u (unconstrained, free rows or not)."""
        f = element_forces(self.gather(u_l), self.conn_l, self.geom_l,
                           active_l)
        ends = torch.stack([f, -f], dim=1).reshape(-1, 3)
        contrib = ordered_sum(ends.T, self.ptr, self.ent,
                              self.Np).T.contiguous()
        out = u_l.new_empty((self.S_loc, 3))
        _collective(dist.reduce_scatter_tensor, out, contrib,
                    group=self.group)
        return out

    # -- preconditioners ---------------------------------------------------

    def coarse(self, r_l, freef, ainv):
        """The cluster coarse correction of the rank's block: the cluster
        sums added in float64 and rounded once, the replicated product in
        float64, as ``coarse.coarse_chain_apply``."""
        f64, dtype = torch.float64, r_l.dtype
        nl, w = self.nbc_loc, self.width
        rcl = (r_l * freef).reshape(nl, w, 3)
        parts = [rcl.to(f64).sum(1)]
        if self.nbas == 2:
            parts.append((rcl * self.rampw[None, :, None]).to(f64).sum(1))
        rc = self.gather(torch.stack(parts).to(dtype)[None])
        # (ranks, basis, cluster, comp) -> basis·3·nbc + comp·nbc + cluster
        rc = rc.permute(1, 3, 0, 2).reshape(-1)
        zc = (ainv.to(f64) @ rc.to(f64)).to(dtype)
        zme = zc.reshape(self.nbas, 3, self.n_ranks, nl)[:, :, self.me]
        zn = zme[0].T[:, None, :].expand(nl, w, 3)
        if self.nbas == 2:
            zn = zn + zme[1].T[:, None, :] * self.rampw[None, :, None]
        return zn.reshape(-1, 3) * freef

    def tree_pc(self, pc_chain, r_l):
        """The redundant forest apply: the full chain-order residual on
        every rank, the rank's block of z kept."""
        N = self.model.n_nodes
        r_full = self.gather(r_l)[:N]
        return self.local(pc_chain(r_full.T.contiguous()).T)

    def local(self, x, fill=0):
        """The rank's block of an (N, ...) tensor in the solve's order,
        padded with ``fill``."""
        return _pad_rows(x, self.Np, fill)[self.rows]

    def local_active(self, active):
        """The rank's block of the (E,) active mask, padded with False."""
        return _pad_rows(active.to(torch.bool), self.n_ranks,
                         False)[self.elems]

    # -- solve -------------------------------------------------------------

    def __call__(self, active, dy_top: float, dy_bot: float, x0,
                 anchored=None, tree_factor_val=None) -> SolveResult:
        model, cfg = self.model, self.cfg
        N, dtype = model.n_nodes, model.dtype
        active = active.to(torch.bool)
        free = free_mask(model, anchored)
        u_k = prescribed_values(model, dy_top, dy_bot)
        x0 = x0.to(dtype)
        if self.use_tree:
            fac = tree_factor_val if tree_factor_val is not None else \
                compute_tree_factor(model, active, cfg, anchored)
            pc_chain = chain_preconditioner(model, active, cfg, free, fac)
        else:
            inv_b = invert_blocks(diag_blocks(model, active, cfg, free))
        if self.use_coarse:
            ainv = coarse_inverse(model, active, free, cfg,
                                  self.Np // BLOCK, self.kblk)
        if self.permuted:
            perm = model.chain.perm
            u_k, free, x0 = u_k[perm], free[perm], x0[perm]
            if not self.use_tree:
                inv_b = inv_b[perm]

        local = self.local
        active_l = self.local_active(active)
        free_l = local(free, False)
        freef = free_l[:, None]
        freev = freef.to(dtype)
        u_k_l, x0_l = local(u_k), local(x0)
        reg = cfg.reg

        def matvec(u_l):
            v = torch.where(freef, u_l, 0.0)
            return torch.where(freef, self.stiffness(v, active_l) + reg * v,
                               u_l)

        if self.use_tree:
            def precond(r_l):
                return self.tree_pc(pc_chain, r_l)
        else:
            inv_b_l = local(inv_b)
            if self.use_coarse:
                def precond(r_l):
                    return _mv3(inv_b_l, r_l) + self.coarse(r_l, freev, ainv)
            else:
                def precond(r_l):
                    return _mv3(inv_b_l, r_l)

        b = torch.where(freef, -self.stiffness(u_k_l, active_l), u_k_l)
        bf = torch.where(freef, b, 0.0)
        bnorm = float(torch.sqrt(self.dot(bf, bf)))
        tol = max(cfg.rtol * bnorm, cfg.atol)
        near_window = max(STALL_WINDOW // 8, 8)

        x = torch.where(freef, x0_l, u_k_l)
        r = b - matvec(x)
        z = precond(r)
        p = z
        rz = self.dot(r, z)
        rnorm = float(torch.sqrt(self.dot(r, r)))
        k, best, since = 0, rnorm, 0
        while True:
            win = near_window if rnorm <= STALL_ACCEPT * tol \
                else STALL_WINDOW
            if not (k < cfg.max_iter and rnorm > tol and since < win):
                break
            ap = matvec(p)
            pap = self.dot(p, ap)
            alpha = torch.where(pap > 0, rz / torch.where(pap > 0, pap, 1.0),
                                0.0)
            x = x + alpha * p
            r = r - alpha * ap
            z = precond(r)
            rz_new = self.dot(r, z)
            beta = torch.where(rz > 0, rz_new / torch.where(rz > 0, rz, 1.0),
                               0.0)
            p = z + beta * p
            rz = rz_new
            rnorm = float(torch.sqrt(self.dot(r, r)))
            k += 1
            improved = rnorm < best * (1.0 - 1e-3)
            best = min(best, rnorm)
            since = 0 if improved else since + 1
        stalled = since >= near_window
        converged = rnorm <= tol or (stalled and rnorm <= STALL_ACCEPT * tol)
        x_full = self.gather(x)[:N]
        if self.permuted:
            x_full = x_full[model.chain.inv_perm]
        return SolveResult(x=x_full, iters=k, resnorm=rnorm,
                           converged=converged)


def sharded_cg_solver(model: FeaModel, cfg, group=None) -> ShardedSolver:
    """The solve of ``model`` domain-decomposed over the ranks of
    ``group`` (the default group if None): call it as (active, dy_top,
    dy_bot, x0[, anchored, tree_factor_val]). Every rank of the group
    calls it with the same arguments."""
    return ShardedSolver(model, cfg, group)
