"""K6: the whole spanning-forest-preconditioned CG solve in one launch
(CUDA kernel + plain PyTorch version).

Replaces ``mycelium_tpu/fea/pallas_tree.py::_tree_cg_kernel``. The source
note in ``csrc/tree_cg.cu`` says what bounds it and how.

The kernel takes a solve's own inputs in the model's layout (the active
mask by element, the free mask and the start vector by node, the grips'
displacements) and does the set-up itself; ``TreeCgLaunch`` binds the
model's static tables and the scratch once. The plain version is in three
parts, which the CPU path runs and the card-side checks hold the kernel
against: ``tree_cg_setup_plain`` (the set-up in PyTorch operations),
``tree_cg_plain`` (the solve on chain-ordered inputs) and the permutation
back to node order.

Chain layout: ``uk`` (prescribed values) and ``x0`` are (3, N) component
planes in chain order, ``freem``/``cact`` (N,) and ``jact`` (Jp,) 0/1
masks; ``cplan`` is the port's ``ChainPlan``, ``tplan`` the ``TreePlan``
and ``tables`` its ``TreeKernelTables``. ``d9`` (9, S) is the forest
diagonal, ``bel`` (9, S) the left-edge element couplings and ``katt``
(P, 2, 3, 3) the attachment element couplings of this solve
(``fea/tree_factor.py::tree_factor_inputs``); slot s is chain position s.

The solve is B4's: every level factored by PCR (no dense tail, no coarse
stage), b = pin·uk − free·(K uk), x = free·x0 + pin·uk, PCG on the BC'd
operator with the forest solve on the slots and the identity after them,
stop when k ≥ max_iter or r·r ≤ rtol²·|free·b|²; no atol, no restarts. B4
has no stall exit; K6 has the reference pcg's (``fea/solve.py::pcg``, whose
solves above B4's memory gate K6 takes): it also stops once |r| has not
improved by 0.1% on its best for STALL_WINDOW iterations, or for
NEAR_WINDOW iterations while |r| ≤ STALL_ACCEPT·tol. Returns x and stats
(4,) = [iterations, |r|, tol, iterations without improvement], from which
``stall_converged`` reads pcg's verdict.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import replace

import torch

from . import build
from .chain_matvec import chain_matvec_plain

CHUNK = build.TREE_CG_CHUNK
WINDOW = build.TREE_CG_WINDOW
THREADS = 256                      # grid_reduce.cuh::THREADS
# the stall exit of the reference's pcg (mycelium_tpu/fea/solve.py:202-203,
# 254): its defaults, the only values its callers pass
STALL_WINDOW = 256
NEAR_WINDOW = max(STALL_WINDOW // 8, 8)
STALL_ACCEPT = 10.0
# the smallest cooperative grid, as a share of the card's SMs: see
# grid_rule
MIN_GRID_SHARE = 4


def smem_bytes(tables) -> int:
    """Dynamic shared memory of a block: the larger of a path-aligned
    window's factorization state (2·45 planes of WINDOW floats, where a
    level is windowed), the halo window of the apply on a level that keeps
    global rounds (two buffers of three planes of CHUNK + 2·(2^rounds − 1)
    floats) and the operator's tile."""
    tile = 3 * (THREADS + 2) + 3 * (THREADS + 1)
    floats = max(tile, 6 * WINDOW)
    if any(tables.windowed):
        floats = max(floats, 90 * WINDOW)
    if tables.max_steps_global >= 0:
        floats = max(floats,
                     6 * (CHUNK + 2 * ((1 << tables.max_steps_global) - 1)))
    return 4 * floats


def work_layout(n: int, jp: int, S: int, P: int, tables) -> dict:
    """name -> (offset, shape) of the float32 scratch of one solve, in the
    order ``csrc/tree_cg.cu::fill_args`` lays it out: the prescribed values
    and the CG vectors in chain order, the masks, the set-up's numerics
    (d9, bel, katt), the forward solutions and block inverses, per path and
    side the attachment couplings and Schur corrections and the fill
    couplings, the ping-pong state of the levels on global rounds, the
    coefficients; "total" -> the number of floats."""
    out, off = {}, 0
    for name, shape in (
            ("uk", (3, n)), ("x", (3, n)), ("r", (3, n)), ("z", (3, n)),
            ("p", (3, n)), ("ap", (3, n)), ("freem", (n,)), ("cact", (n,)),
            ("jact", (jp,)), ("d9", (9, S)), ("bel", (9, S)), ("y", (3, S)),
            ("dinv", (9, S)), ("katt", (P, 2, 3, 3)), ("ab", (2 * P, 9)),
            ("dg", (2 * P, 9)), ("fill", (P, 9)),
            ("state", (90, tables.smax_global)),
            ("al", (tables.coef_floats,)), ("be", (tables.coef_floats,))):
        out[name] = (off, shape)
        size = 1
        for d in shape:
            size *= d
        off += size
    out["total"] = off
    return out


def work_floats(n: int, jp: int, S: int, P: int, tables) -> int:
    return work_layout(n, jp, S, P, tables)["total"]


def barrier_count(tables, iters: int) -> int:
    """Grid-wide barriers of one launch that takes ``iters`` iterations:
    one after the set-up; one a windowed level to factor, rounds + 2 on a
    level that keeps global rounds; 2·levels − 1 a preconditioner apply;
    an iteration adds the operator's, the update's (none when it rides the
    first level's windows) and the direction's."""
    L = len(tables.windowed)
    rounds = tables.lvl[2].tolist()
    factor = sum(1 if w else k + 2 for w, k in zip(tables.windowed, rounds))
    apply_ = 2 * L - 1
    per_iter = 1 + (0 if tables.windowed[0] else 1) + apply_ + 1
    return 1 + factor + apply_ + iters * per_iter


def stall_converged(rnorm: float, tol: float, since: int) -> bool:
    """pcg's verdict on a solve that ended with |r| = ``rnorm`` after
    ``since`` iterations without improvement: on its tolerance, or on a
    plateau within STALL_ACCEPT·tol."""
    return rnorm <= tol or (since >= NEAR_WINDOW
                            and rnorm <= STALL_ACCEPT * tol)


def tree_cg_plain(cplan, tplan, tables, uk, x0, freem, cact, jact, d9, bel,
                  katt, rtol: float, reg: float, max_iter: int):
    """The plain PyTorch version, any device and dtype: the port's level
    factorization and forest apply (``fea/tree_factor.py``) with every
    level on PCR, K1's plain operator, and CG with float64 dots and the
    stall exit in the kernel's float32 arithmetic. It reads r·r on the
    host once per iteration for its stop tests. ``tables`` is not read."""
    from ..fea.tree_factor import (TreeFactor, tree_apply_chain_planes,
                                   tree_factor_levels)
    dtype = uk.dtype
    f64 = torch.float64
    S = tplan.n_slots
    L = len(tplan.meta.level_steps)
    plan_all = replace(tplan, meta=replace(tplan.meta, n_pcr=-1))
    alphas, betas, dinvs, att_b, _, _ = tree_factor_levels(
        plan_all, d9, bel, katt, L)
    factor = TreeFactor(alphas=alphas, betas=betas, dinvs=dinvs, att_b=att_b)
    pinm = 1.0 - freem

    def dot(a, b):
        return (a.to(f64) * b.to(f64)).sum().to(dtype)

    def matvec(u):
        return chain_matvec_plain(cplan, u, freem, cact, jact, reg, True)

    def precond(r):
        return torch.cat([tree_apply_chain_planes(plan_all, factor, r),
                          r[:, S:]], dim=1)

    kuk = chain_matvec_plain(cplan, uk, freem, cact, jact, reg, False)
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
    tol = tol2.sqrt()
    rnorm = rr.sqrt()
    best = rnorm
    k = since = 0
    while k < max_iter and bool(rr > tol2):
        near = bool(rnorm <= STALL_ACCEPT * tol)
        if since >= (NEAR_WINDOW if near else STALL_WINDOW):
            break
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
        rnorm = rr.sqrt()
        since = 0 if bool(rnorm < best * 0.999) else since + 1
        best = torch.minimum(best, rnorm)
    return x, torch.stack([rr.new_tensor(float(k)), rnorm, tol,
                           rr.new_tensor(float(since))])


def tree_cg_setup_plain(cplan, tplan, fast, conn, top_nodes, bot_nodes,
                        active, free, dy_top: float, dy_bot: float, x0,
                        reg_pc: float) -> dict:
    """The plain set-up of one solve, any device and dtype: the masks, the
    prescribed values and the start vector gathered into chain order and
    the per-solve numerics of the factorization, each by PyTorch
    operations. ``free`` (N,) bool and ``x0`` (N, 3) are in node order."""
    from ..fea.chain import plan_active_masks_bool
    from ..fea.tree_factor import tree_factor_inputs
    dtype = cplan.chain_kax.dtype
    cact_b, jact_b = plan_active_masks_bool(cplan, active)
    free_chain_b = free[cplan.perm]
    uy = top_nodes.to(dtype) * dy_top + bot_nodes.to(dtype) * dy_bot
    zero = torch.zeros_like(uy)
    uk = torch.stack([zero, uy, zero], dim=1)[cplan.perm].T.contiguous()
    x0_p = x0.to(dtype)[cplan.perm].T.contiguous()
    d9, bel, katt = tree_factor_inputs(
        tplan, fast, cplan, active, free, free_chain_b, reg_pc, conn,
        cact_b, jact_b)
    return dict(uk=uk, x0=x0_p, freem=free_chain_b.to(dtype),
                cact=cact_b.to(dtype), jact=jact_b.to(dtype),
                d9=d9.contiguous(), bel=bel.contiguous(), katt=katt)


def _check(name, t, shape, dtype):
    if t.device.type != "cuda" or t.dtype != dtype or \
            tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"tree_cg: {name} must be a contiguous {dtype} CUDA tensor "
            f"of shape {tuple(shape)}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


@functools.cache
def resident_blocks(device_index: int, smem: int) -> tuple:
    """(blocks per SM, SMs) of the cooperative kernel on a card for
    ``smem`` bytes of dynamic shared memory a block, from the occupancy
    calculator: at most their product of blocks are co-resident, as
    grid-wide synchronisation needs."""
    per, sms = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = build.library().tree_cg_grid_blocks(smem, ctypes.byref(per),
                                                 ctypes.byref(sms))
    build.check(rc, "tree_cg_grid_blocks")
    return per.value, sms.value


def grid_rule(n: int, per_sm: int, sms: int) -> int:
    """Blocks of the cooperative grid for a mesh of ``n`` positions: one
    thread a position, but at least a quarter of the SMs and never more
    than are resident. A grid-wide barrier costs more the more blocks
    cross it, and a small mesh has no work for the blocks that would only
    wait there."""
    want = -(-n // THREADS)
    return max(1, min(per_sm * sms, max(sms // MIN_GRID_SHARE, want)))


class TreeCgLaunch:
    """K6 bound to one model: built once (``fea/model.py::
    with_kernels``), it validates the model's static tensors, keeps
    their pointers in one prebuilt argument array and owns the scratch
    (sized once by ``work_floats``), the per-block partial sums, two result
    buffers and two stats buffers. ``solve`` passes only what changes.

    Who owns the result: ``solve`` returns one of the launch's two
    (N, 3) buffers, in turns, and a view of its stats. A returned ``x``
    (and stats) stays valid through the next solve of this launch and is
    overwritten by the one after; a caller that keeps it longer copies it.
    The ramp keeps at most the previous step's solution (for its warm
    start) while it solves the next, and copies the records.

    On a CPU model there is nothing to bind: ``solve`` runs the plain
    version and returns fresh tensors."""

    def __init__(self, cplan, tplan, fast, tables, conn, top_nodes,
                 bot_nodes):
        self.cplan, self.tplan, self.fast, self.tables = (cplan, tplan, fast,
                                                          tables)
        self.conn, self.top_nodes, self.bot_nodes = conn, top_nodes, bot_nodes
        self.n = cplan.perm.shape[0]
        self.jp = cplan.ja.shape[0]
        self.n_elems = conn.shape[0]
        self.S, self.P = tplan.n_slots, tplan.n_paths
        self.L = len(tplan.meta.level_steps)
        self.device = cplan.perm.device
        self.cuda = self.device.type == "cuda"
        self._bound = False
        self._turn = 0

    def on(self, device) -> "TreeCgLaunch":
        """A launch of the same model with its tables on ``device``."""
        from ..devices import moved
        return TreeCgLaunch(*moved(
            (self.cplan, self.tplan, self.fast, self.tables, self.conn,
             self.top_nodes, self.bot_nodes), device))

    def layout(self) -> dict:
        return work_layout(self.n, self.jp, self.S, self.P, self.tables)

    def static_tensors(self) -> tuple:
        """(name, tensor, shape, dtype) of the model's tables in the order
        of the enum Ptr in csrc/tree_cg.cu."""
        cp, k, tk, fast = self.cplan, self.cplan.k32, self.tables, self.fast
        n, jp, S, P, L = self.n, self.jp, self.S, self.P, self.L
        f32, i32, i64, b8 = (torch.float32, torch.int32, torch.int64,
                             torch.bool)
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
            ("chain_tree", fast.chain_tree, (n,), b8),
            ("jump_tree", fast.jump_tree, (jp,), b8),
            ("top_nodes", self.top_nodes, (n,), b8),
            ("bot_nodes", self.bot_nodes, (n,), b8),
            ("left_k3", fast.left_k3, (9, S), f32),
            ("left_elem", tk.left_elem, (S,), i32),
            ("att_elem", tk.att_elem, (2 * P,), i32),
            ("att_na", tk.att_na, (2 * P,), i32),
            ("att_nb", tk.att_nb, (2 * P,), i32),
            ("att_k3", tk.att_k3, (2 * P, 9), f32),
            ("lvl", tk.lvl, (4, L + 1), i64),
            ("wlv", tk.wlv, (2, L + 1), i64),
            ("win_start", tk.win_start, tk.win_start.shape, i32),
            ("win_len", tk.win_len, tk.win_start.shape, i32),
            ("left_fill", tk.left_fill, (S,), i32),
            ("first_path", tk.first_path, (S,), i32),
            ("last_path", tk.last_path, (S,), i32),
            ("fg", tk.fg, (P,), i32), ("lg", tk.lg, (P,), i32),
            ("has_fill", tk.has_fill, (P,), i32),
            ("att_tgt", tk.att_tgt, (2 * P,), i32),
            ("att_fill", tk.att_fill, (2 * P,), i32),
            ("att_flip", tk.att_flip, (2 * P,), i32),
            ("att_ptr", tk.att_ptr, (S + 1,), i32),
            ("att_ent", tk.att_ent, tk.att_ent.shape, i32))

    def io_bytes(self) -> int:
        """Bytes one solve must move whatever the kernel's design: the
        static tables it is handed and the solve's inputs (the active and
        free masks, x0) read once, x and the stats written once."""
        static = sum(t.numel() * t.element_size()
                     for _, t, _, _ in self.static_tensors())
        return static + self.n_elems + self.n + 2 * 12 * self.n + 16

    def nbytes(self) -> int:
        """Bytes the kernel touches in one solve: ``io_bytes`` and the
        buffers this launch holds (the scratch, the second result and
        stats; the few KB of partial sums are not counted)."""
        return self.io_bytes() + 4 * self.layout()["total"] \
            + 12 * self.n + 16

    def _bind(self) -> None:
        """Validate once, allocate once, build the argument arrays once."""
        tk = self.tables
        if not tk.ordered:
            raise ValueError("tree_cg: the schedule's fills and attachments "
                             "do not all point from an earlier level to a "
                             "later")
        if self.L < 1:
            raise ValueError("tree_cg: the forest has no level")
        if self.cplan.k32 is None:
            raise ValueError("tree_cg: the plan has no kernel tables "
                             "(ChainPlan.with_kernel_tables)")
        named = self.static_tensors()
        for name, t, shape, dt in named:
            _check(name, t, shape, dt)
        dev, f32 = self.device, torch.float32
        index = self._index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        self.smem = smem_bytes(tk)
        per_sm, sms = resident_blocks(index, self.smem)
        self.grid = grid_rule(self.n, per_sm, sms)
        self.work = torch.empty(self.layout()["total"], dtype=f32, device=dev)
        # the per-block float64 partial sums of the four dot products
        self.part = torch.empty(4 * self.grid, dtype=torch.float64,
                                device=dev)
        self._x = [torch.empty((self.n, 3), dtype=f32, device=dev)
                   for _ in range(2)]
        # [iterations, |r|, tol, iterations without improvement, barriers]
        self._stats = [torch.empty(5, dtype=f32, device=dev)
                       for _ in range(2)]
        ptrs = [t.data_ptr() for _, t, _, _ in named] + [
            self.work.data_ptr(), self.part.data_ptr()]
        # the order of the enum Int in csrc/tree_cg.cu
        ints = [self.n, self.jp, self.n_elems, self.S, self.P, self.L,
                tk.smax_global, tk.coef_floats, self.grid, self.smem,
                STALL_WINDOW, NEAR_WINDOW]
        self._ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
        self._ints = (ctypes.c_longlong * len(ints))(*ints)
        self._n_ptrs, self._n_ints = len(ptrs), len(ints)
        self._lib = build.library()
        self._bound = True

    def _inputs(self, active, free, x0):
        """The solve's tensors as the kernel reads them; raises on a wrong
        type, shape, device or layout."""
        if active.dtype != torch.bool:
            active = active.to(torch.bool)
        _check("active", active, (self.n_elems,), torch.bool)
        _check("free", free, (self.n,), torch.bool)
        _check("x0", x0, (self.n, 3), torch.float32)
        return active, free, x0

    def solve(self, active, free, dy_top: float, dy_bot: float, x0,
              rtol: float, reg: float, reg_pc: float, max_iter: int):
        """One solve: x (N, 3) in node order and stats (4,)
        (``tree_cg_plain``). ``active`` (E,) bool, ``free`` (N,) bool
        and ``x0`` (N, 3) are in the model's own order. One cooperative
        launch for a CUDA model (float32 only, raises otherwise), the plain
        version for a CPU model."""
        if not self.cuda:
            return self.plain(active, free, dy_top, dy_bot, x0, rtol, reg,
                              reg_pc, max_iter)
        if not self._bound:
            self._bind()
        active, free, x0 = self._inputs(active, free, x0)
        self._turn ^= 1
        x, stats = self._x[self._turn], self._stats[self._turn]
        rc = self._lib.tree_cg_f32(
            self._ptrs, self._n_ptrs, self._ints, self._n_ints,
            active.data_ptr(), free.data_ptr(), x0.data_ptr(), x.data_ptr(),
            stats.data_ptr(), dy_top, dy_bot, rtol, reg, reg_pc,
            STALL_ACCEPT, int(max_iter), build.raw_stream(self._index))
        if rc != 0:
            build.check(rc, "tree_cg_f32")
        build.count_launch("tree_cg")
        return x, stats[:4]

    def last_barriers(self) -> int:
        """Grid-wide barriers the last launch crossed (a host read)."""
        return int(self._stats[self._turn][4])

    def setup(self, active, free, dy_top: float, dy_bot: float, x0,
              reg_pc: float) -> dict:
        """The set-up phase alone, as ``tree_cg_setup_plain`` returns it
        (``x0`` there is the start vector free·x0 + pin·uk here, under
        "x"): the kernel's first phase launched as a kernel of its own on
        a CUDA model, views of the launch's work buffer; the plain set-up
        on a CPU model. The solve path does not call it."""
        if not self.cuda:
            out = tree_cg_setup_plain(
                self.cplan, self.tplan, self.fast, self.conn, self.top_nodes,
                self.bot_nodes, active, free, dy_top, dy_bot, x0, reg_pc)
            out["x"] = out["freem"] * out.pop("x0") \
                + (1.0 - out["freem"]) * out["uk"]
            return out
        if not self._bound:
            self._bind()
        active, free, x0 = self._inputs(active, free, x0)
        rc = self._lib.tree_cg_setup_f32(
            self._ptrs, self._n_ptrs, self._ints, self._n_ints,
            active.data_ptr(), free.data_ptr(), x0.data_ptr(), dy_top,
            dy_bot, reg_pc,
            torch.cuda.current_stream(self.device).cuda_stream)
        build.check(rc, "tree_cg_setup_f32")
        lay = self.layout()
        out = {}
        for name in ("uk", "x", "freem", "cact", "jact", "d9", "bel",
                     "katt"):
            off, shape = lay[name]
            size = 1
            for d in shape:
                size *= d
            out[name] = self.work[off:off + size].view(shape)
        return out

    def plain(self, active, free, dy_top: float, dy_bot: float, x0,
              rtol: float, reg: float, reg_pc: float, max_iter: int):
        """The plain version of ``solve`` on the launch's own device: the
        plain set-up, ``tree_cg_plain`` and the permutation back to node
        order; fresh tensors."""
        s = tree_cg_setup_plain(
            self.cplan, self.tplan, self.fast, self.conn, self.top_nodes,
            self.bot_nodes, active, free, dy_top, dy_bot, x0, reg_pc)
        x_p, stats = tree_cg_plain(
            self.cplan, self.tplan, self.tables, s["uk"], s["x0"],
            s["freem"], s["cact"], s["jact"], s["d9"], s["bel"], s["katt"],
            rtol, reg, max_iter)
        return x_p.T[self.cplan.inv_perm], stats


def barrier_probe(grid: int, syncs: int, device) -> None:
    """Launch ``syncs`` grid-wide barriers on a cooperative grid of
    ``grid`` blocks of K6's block size, with no work between them (timed
    by the caller)."""
    out = torch.empty(1, dtype=torch.int32, device=device)
    rc = build.library().tree_cg_barrier_probe(
        int(grid), int(syncs), out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    build.check(rc, "tree_cg_barrier_probe")
