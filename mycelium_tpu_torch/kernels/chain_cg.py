"""K5: the whole cg + coarse solve in one launch, its set-up included (CUDA
kernel + plain PyTorch version).

Replaces ``mycelium_tpu/fea/pallas_cg.py::_cg_kernel`` and the set-up the
reference computes around it in XLA. The source note in
``csrc/chain_cg.cu`` says what bounds it and how.

The kernel takes a solve's own inputs in the model's layout (the active
mask by element, the anchored mask and the start vector by node, the
grips' displacements) and does the set-up itself; ``ChainCgLaunch`` binds
the model's static tables, the cluster layout's contribution lists (the
model's ``fea/coarse.py::CoarsePlans``) and the scratch once. The plain
version is in three parts, which the CPU path runs and the card-side
checks hold the kernel against: ``chain_cg_setup_plain`` (the set-up in PyTorch
operations, in the kernel's order), ``chain_cg_plain`` (the solve on
chain-ordered inputs) and the permutation back to node order.

Chain layout: ``uk`` (prescribed values) and ``x0`` are (3, N) component
planes in chain order, ``freem``/``cact`` (N,) and ``jact`` (Jp,) 0/1
masks, ``c9`` the (9, N) row-major planes of the per-position 3x3
block-Jacobi inverse, ``ainv`` the (nc, nc) inverse of the normalised
coarse matrix and ``s`` its (nc,) scaling over clusters of ``width``
consecutive positions (nc = 3·nbc, or 6·nbc with the linear basis).

The solve is B5's: b = pin·uk − free·(K uk), x = free·x0 + pin·uk, PCG
on the BC'd operator with z = c9·r + free·(zc[cluster] + ramp·zc'[cluster])
where zc = s·ainv·(s·rc), rc the cluster sums of free·r [and ramp·free·r];
stop when k ≥ max_iter or r·r ≤ rtol²·|free·b|²; no atol, no stall exit,
no restarts. Returns x and stats (3,) = [iterations, |r|, tol].
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .chain_matvec import chain_matvec_plain

THREADS = 256                      # grid_reduce.cuh::THREADS
# floats of a launch's stats: [iterations, |r|, tol, barriers]
STATS_FLOATS = 4


def work_layout(n: int, jp: int, nc: int, nblk: int, nbas: int) -> dict:
    """name -> (offset, shape) of the float32 scratch of one solve, in the
    order ``csrc/chain_cg.cu::fill_args`` lays it out: the prescribed
    values and the CG vectors in chain order (p twice, in turns), the
    masks, the block-Jacobi inverse, the restricted residual, the coarse
    entries by block, the coarse matrix, its scaling and the two
    Gauss-Jordan buffers; "total" -> the number of floats."""
    out, off = {}, 0
    d = 3 * nbas
    for name, shape in (
            ("uk", (3, n)), ("x", (3, n)), ("r", (3, n)), ("z", (3, n)),
            ("p0", (3, n)), ("p1", (3, n)), ("ap", (3, n)), ("freem", (n,)),
            ("cact", (n,)), ("jact", (jp,)), ("c9", (9, n)), ("rc", (nc,)),
            ("ablk", (nblk, d, d)), ("a", (nc, nc)), ("s", (nc,)),
            ("g0", (nc, nc)), ("g1", (nc, nc))):
        out[name] = (off, shape)
        size = 1
        for k in shape:
            size *= k
        off += size
    out["total"] = off
    return out


def gauss_jordan_phases(nc: int) -> int:
    """Phases of the coarse inverse in the kernel: two pivots a phase."""
    return -(-nc // 2)


def barrier_count(nc: int, iters: int) -> int:
    """Grid-wide barriers of a launch that takes ``iters`` iterations:
    after the set-up, after the normalisation and r0, one a phase of the
    coarse inverse, after the first preconditioner, three an iteration."""
    return 3 + gauss_jordan_phases(nc) + 3 * iters


def chain_cg_setup_plain(cplan, plan, free_nodes, top_nodes, bot_nodes,
                         active, anchored, dy_top: float, dy_bot: float, x0,
                         reg: float) -> dict:
    """The plain set-up of one solve, any device and dtype, in the
    kernel's order of operations: the masks, the prescribed values and the
    start vector (free·x0 + pin·uk, under "x") in chain order, the
    block-Jacobi inverse ``c9``, the coarse matrix ``a`` over ``plan``'s
    clusters, its scaling ``s`` and the inverse ``ainv`` of the normalised
    matrix. ``active`` (E,) bool, ``anchored`` (N,) bool or None and ``x0``
    (N, 3) are in node order."""
    from ..fea.chain import plan_active_masks_bool
    from ..fea.coarse import coarse_matrix, coarse_normalize, gauss_jordan
    from ..fea.model import inverse_planes
    from ..fea.tree_factor import chain_diag
    dtype = cplan.chain_kbd.dtype
    free = free_nodes if anchored is None else free_nodes & anchored
    free_chain = free[cplan.perm]
    cact_b, jact_b = plan_active_masks_bool(cplan, active)
    cact, jact = cact_b.to(dtype), jact_b.to(dtype)
    uy = top_nodes.to(dtype) * dy_top + bot_nodes.to(dtype) * dy_bot
    zero = torch.zeros_like(uy)
    uk = torch.stack([zero, uy, zero], dim=1)[cplan.perm].T.contiguous()
    freem = free_chain.to(dtype)
    x = freem * x0.to(dtype)[cplan.perm].T + (1.0 - freem) * uk
    c9 = inverse_planes(chain_diag(cplan, cact, jact, free_chain, reg))
    a = coarse_matrix(plan, cplan, active, free_chain, reg, dtype)
    s, an = coarse_normalize(a)
    return dict(uk=uk, x=x.contiguous(), freem=freem, cact=cact, jact=jact,
                c9=c9, a=a, s=s, ainv=gauss_jordan(an))


def chain_cg_plain(plan, uk, x0, freem, cact, jact, c9, ainv, s, nbc: int,
                   width: int, use_ramp: bool, rtol: float, reg: float,
                   max_iter: int):
    """The plain PyTorch version, any device and dtype: the port's
    block-Jacobi product and coarse correction (``fea/blocks.py``,
    ``fea/coarse.py``), which add their sums in float64 as the kernel does;
    its dots do the same. It reads r·r on the host once per iteration for
    its stop test."""
    from ..fea.blocks import mv3_planes
    from ..fea.coarse import coarse_chain_apply, ramp_weight
    n = uk.shape[1]
    dtype = uk.dtype
    f64 = torch.float64
    rampw = ramp_weight(torch.arange(nbc * width, device=uk.device) % width,
                        width, dtype)
    pinm = 1.0 - freem

    def dot(a, b):
        return (a.to(f64) * b.to(f64)).sum().to(dtype)

    def matvec(u):
        return chain_matvec_plain(plan, u, freem, cact, jact, reg, True)

    def precond(r):
        return mv3_planes(c9, r) + coarse_chain_apply(
            ainv, freem, r, n, nbc, width, rampw, use_ramp, scale=s)

    kuk = chain_matvec_plain(plan, uk, freem, cact, jact, reg, False)
    b = pinm * uk - freem * kuk
    fb = freem * b
    rt = torch.tensor(rtol, dtype=dtype, device=uk.device)
    tol2 = rt * rt * dot(fb, fb)
    x = freem * x0 + pinm * uk
    r = b - matvec(x)
    z = precond(r)
    p = z
    rz = dot(r, z)
    rr = dot(r, r)
    k = 0
    while k < max_iter and bool(rr > tol2):
        ap = matvec(p)
        pap = dot(p, ap)
        alpha = torch.where(pap > 0, rz / torch.where(pap > 0, pap, 1.0),
                            0.0)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = dot(r, z)
        beta = torch.where(rz > 0, rz_new / torch.where(rz > 0, rz, 1.0),
                           0.0)
        p = z + beta * p
        rz = rz_new
        rr = dot(r, r)
        k += 1
    stats = torch.stack([rr.new_tensor(float(k)), rr.sqrt(), tol2.sqrt()])
    return x, stats


def _check(name, t, shape, dtype):
    if t.device.type != "cuda" or t.dtype != dtype or \
            tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"chain_cg: {name} must be a contiguous {dtype} CUDA tensor "
            f"of shape {tuple(shape)}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


@functools.cache
def resident_blocks(device_index: int) -> int:
    """Blocks of K5's cooperative grid that a card holds at once (SMs ×
    the blocks per SM the occupancy calculator allows): the grid never
    asks for more, as grid-wide synchronisation needs."""
    per, sms = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = build.library().chain_cg_grid_blocks(ctypes.byref(per),
                                                  ctypes.byref(sms))
    build.check(rc, "chain_cg_grid_blocks")
    return per.value * sms.value


def layout_of(n_nodes: int, cfg) -> tuple:
    """(nbc, width, nbas) of the coarse space of ``cfg`` on a mesh of
    ``n_nodes`` (``fea/coarse.py::cluster_layout``)."""
    from ..fea.coarse import cluster_layout, n_basis
    _, _, nbc, width = cluster_layout(n_nodes, cfg)
    return nbc, width, n_basis(cfg)


class ChainCgLaunch:
    """K5 bound to one model (``fea/model.py::with_kernels`` makes it for
    every model; nothing is allocated until the model's first cg + coarse
    solve). Per cluster layout it takes the model's coarse plan
    (``plans``, a ``fea/coarse.py::CoarsePlans``), validates the static
    tensors once, keeps their pointers in one prebuilt argument array and
    owns the scratch (sized once by ``work_layout``), the per-block partial
    sums, two result buffers and two stats buffers. ``solve`` passes only
    what changes.

    Who owns the result: ``solve`` returns one of the launch's two
    (N, 3) buffers, in turns, and a view of its stats. A returned ``x``
    (and stats) stays valid through the next solve of this launch and is
    overwritten by the one after; a caller that keeps it longer copies it.

    On a CPU model there is nothing to bind: ``solve`` runs the plain
    version and returns fresh tensors."""

    def __init__(self, plans, free_nodes, top_nodes, bot_nodes):
        self.plans = plans
        self.cplan = cplan = plans.cplan
        self.free_nodes, self.top_nodes, self.bot_nodes = (free_nodes,
                                                           top_nodes,
                                                           bot_nodes)
        self.n = cplan.perm.shape[0]
        self.jp = cplan.ja.shape[0]
        self.n_elems = plans.n_elems
        self.device = cplan.perm.device
        self.cuda = self.device.type == "cuda"
        self._bound = {}
        self._turn = 0
        self._last = None

    def on(self, device) -> "ChainCgLaunch":
        """A launch of the same model with its tables on ``device``."""
        from ..devices import moved
        return ChainCgLaunch(self.plans.on(device), *moved(
            (self.free_nodes, self.top_nodes, self.bot_nodes), device))

    def layout(self, nbc: int, width: int, nbas: int) -> dict:
        plan = self.plans.get(nbc, width, nbas)
        return work_layout(self.n, self.jp, plan.nc,
                           plan.blk_row.shape[0], nbas)

    def static_tensors(self, plan) -> tuple:
        """(name, tensor, shape, dtype) of the model's tables and the
        coarse plan in the order of the enum Ptr in csrc/chain_cg.cu."""
        cp, k = self.cplan, self.cplan.k32
        n, jp, nbc = self.n, self.jp, plan.nbc
        nblk = plan.blk_row.shape[0]
        f32, i32, b8 = torch.float32, torch.int32, torch.bool
        return (
            ("perm", k.perm, (n,), i32),
            ("chain_elem", k.chain_elem, (n,), i32),
            ("jump_elem", k.jump_elem, (jp,), i32),
            ("chain_pack", k.chain_pack, (n, 4), f32),
            ("chain_kbd", cp.chain_kbd, (n,), f32),
            ("jump_pack", k.jump_pack, (jp, 4), f32),
            ("jump_kbd", cp.jump_kbd, (jp,), f32),
            ("ja", k.ja, (jp,), i32), ("jb", k.jb, (jp,), i32),
            ("jump_ptr", k.jump_ptr, (n + 1,), i32),
            ("jump_ent", k.jump_ent, k.jump_ent.shape, i32),
            ("free_nodes", self.free_nodes, (n,), b8),
            ("top_nodes", self.top_nodes, (n,), b8),
            ("bot_nodes", self.bot_nodes, (n,), b8),
            ("blk_ptr", plan.blk_ptr, (nblk + 1,), i32),
            ("blk_ent", plan.blk_ent, plan.blk_ent.shape, i32),
            ("blk_map", plan.blk_map, (nbc * nbc,), i32))

    def io_bytes(self, nbc: int, width: int, nbas: int) -> int:
        """Bytes one solve must move whatever the kernel's design: the
        static tables and the coarse plan read once, the solve's inputs
        (the active and anchored masks, x0) read once, x and the stats
        written once."""
        plan = self.plans.get(nbc, width, nbas)
        static = sum(t.numel() * t.element_size()
                     for _, t, _, _ in self.static_tensors(plan))
        return static + self.n_elems + self.n + 2 * 12 * self.n + 16

    def _bind(self, key: tuple) -> dict:
        """Validate once, allocate once, build the argument arrays once,
        for one cluster layout."""
        if key in self._bound:
            return self._bound[key]
        if self.cplan.k32 is None:
            raise ValueError("chain_cg: the plan has no kernel tables "
                             "(ChainPlan.with_kernel_tables)")
        plan = self.plans.get(*key)
        named = self.static_tensors(plan)
        for name, t, shape, dt in named:
            _check(name, t, shape, dt)
        dev, f32 = self.device, torch.float32
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        grid = max(1, min(plan.nbc, resident_blocks(index)))
        work = torch.empty(self.layout(*key)["total"], dtype=f32, device=dev)
        # the per-block float64 partial sums of the four dot products
        part = torch.empty(4 * grid, dtype=torch.float64, device=dev)
        ptrs = [t.data_ptr() for _, t, _, _ in named] + [work.data_ptr(),
                                                         part.data_ptr()]
        # the order of the enum Int in csrc/chain_cg.cu
        ints = [self.n, self.jp, self.n_elems, plan.nbc, plan.width,
                plan.nbas, plan.blk_row.shape[0], grid]
        b = dict(grid=grid, work=work, part=part, index=index,
                 x=[torch.empty((self.n, 3), dtype=f32, device=dev)
                    for _ in range(2)],
                 stats=[torch.zeros(STATS_FLOATS, dtype=f32, device=dev)
                        for _ in range(2)],
                 ptrs=(ctypes.c_void_p * len(ptrs))(*ptrs),
                 ints=(ctypes.c_longlong * len(ints))(*ints),
                 n_ptrs=len(ptrs), n_ints=len(ints))
        self._lib = build.library()
        self._bound[key] = b
        return b

    def _inputs(self, active, anchored, x0):
        """The solve's tensors as the kernel reads them; raises on a wrong
        type, shape, device or layout."""
        if active.dtype != torch.bool:
            active = active.to(torch.bool)
        _check("active", active, (self.n_elems,), torch.bool)
        if anchored is not None:
            _check("anchored", anchored, (self.n,), torch.bool)
        _check("x0", x0, (self.n, 3), torch.float32)
        return active, anchored, x0

    def _launch(self, b, active, anchored, x0, x, stats, dy_top, dy_bot,
                rtol, reg, max_iter, setup_only):
        active, anchored, x0 = self._inputs(active, anchored, x0)
        rc = self._lib.chain_cg_f32(
            b["ptrs"], b["n_ptrs"], b["ints"], b["n_ints"],
            active.data_ptr(),
            None if anchored is None else anchored.data_ptr(),
            x0.data_ptr(), x.data_ptr(), stats.data_ptr(), dy_top, dy_bot,
            rtol, reg, int(max_iter), int(setup_only),
            build.raw_stream(b["index"]))
        if rc != 0:
            build.check(rc, "chain_cg_f32")

    def solve(self, active, anchored, dy_top: float, dy_bot: float, x0,
              cfg):
        """One solve under ``cfg`` (its coarse layout, rtol, reg and
        max_iter): x (N, 3) in node order and stats (3,). ``active`` (E,)
        bool, ``anchored`` (N,) bool or None and ``x0`` (N, 3) are in the
        model's own order. One cooperative launch for a CUDA model
        (float32 only, raises otherwise), the plain version for a CPU
        model."""
        if not self.cuda:
            return self.plain(active, anchored, dy_top, dy_bot, x0, cfg)
        b = self._bind(layout_of(self.n, cfg))
        self._turn ^= 1
        x, stats = b["x"][self._turn], b["stats"][self._turn]
        self._launch(b, active, anchored, x0, x, stats, dy_top, dy_bot,
                     cfg.rtol, cfg.reg, cfg.max_iter, False)
        build.count_launch("chain_cg")
        self._last = stats
        return x, stats[:3]

    def last_barriers(self) -> int:
        """Grid-wide barriers the last launch crossed (a host read)."""
        return int(self._last[3])

    def setup(self, active, anchored, dy_top: float, dy_bot: float, x0,
              cfg) -> dict:
        """The set-up alone, as ``chain_cg_setup_plain`` returns it: the
        kernel launched with its solve cut after the coarse inverse on a
        CUDA model (views of the launch's work buffer), the plain set-up on
        a CPU model. The solve path does not call it."""
        key = layout_of(self.n, cfg)
        plan = self.plans.get(*key)
        if not self.cuda:
            return chain_cg_setup_plain(
                self.cplan, plan, self.free_nodes, self.top_nodes,
                self.bot_nodes, active, anchored, dy_top, dy_bot, x0,
                cfg.reg)
        b = self._bind(key)
        stats = torch.zeros(STATS_FLOATS, dtype=torch.float32,
                            device=self.device)
        x = torch.empty((self.n, 3), dtype=torch.float32, device=self.device)
        self._launch(b, active, anchored, x0, x, stats, dy_top, dy_bot, 0.0,
                     cfg.reg, 0, True)
        lay = self.layout(*key)
        out = {}
        for name in ("uk", "x", "freem", "cact", "jact", "c9", "a", "s",
                     "g0", "g1"):
            off, shape = lay[name]
            size = 1
            for d in shape:
                size *= d
            out[name] = b["work"][off:off + size].view(shape)
        out["ainv"] = out.pop("g1" if gauss_jordan_phases(plan.nc) % 2
                              else "g0")
        out.pop("g0", None)
        out.pop("g1", None)
        return out

    def plain(self, active, anchored, dy_top: float, dy_bot: float, x0,
              cfg, setup: dict | None = None):
        """The plain version of ``solve`` on the launch's own device: the
        plain set-up (or ``setup``, what ``setup`` of this launch returned
        for the same inputs and reg), ``chain_cg_plain`` and the
        permutation back to node order; fresh tensors."""
        nbc, width, nbas = layout_of(self.n, cfg)
        s = setup or chain_cg_setup_plain(
            self.cplan, self.plans.get(nbc, width, nbas), self.free_nodes,
            self.top_nodes, self.bot_nodes, active, anchored, dy_top, dy_bot,
            x0, cfg.reg)
        x0_p = x0.to(self.cplan.chain_kbd.dtype)[self.cplan.perm].T
        x_p, stats = chain_cg_plain(
            self.cplan, s["uk"], x0_p.contiguous(), s["freem"], s["cact"],
            s["jact"], s["c9"], s["ainv"], s["s"], nbc, width, nbas == 2,
            cfg.rtol, cfg.reg, cfg.max_iter)
        return x_p.T[self.cplan.inv_perm], stats
