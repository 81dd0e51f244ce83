"""K6: the whole spanning-forest-preconditioned CG solve in one launch
(CUDA kernel + plain PyTorch version).

Replaces ``mycelium_tpu/fea/pallas_tree.py::_tree_cg_kernel``. The source
note in ``csrc/tree_cg.cu`` says what bounds it and how.

Inputs are in the port's chain layout: ``uk`` (prescribed values) and
``x0`` are (3, N) component planes in chain order, ``freem``/``cact`` (N,)
and ``jact`` (Jp,) 0/1 masks; ``cplan`` is the port's ``ChainPlan`` (the
operator's tables, as K1 reads them), ``tplan`` the ``TreePlan`` and
``tables`` its ``TreeKernelTables``. ``d9`` (9, S) is the forest diagonal,
``bel`` (9, S) the left-edge element couplings and ``katt`` (P, 2, 3, 3)
the attachment element couplings of this solve
(``fea/tree_factor.py::tree_factor_inputs``); slot s is chain position s.

The solve is B4's: every level factored by PCR (no dense tail, no coarse
stage), b = pin·uk − free·(K uk), x = free·x0 + pin·uk, PCG on the BC'd
operator with the forest solve on the slots and the identity after them,
stop when k ≥ max_iter or r·r ≤ rtol²·|free·b|²; no atol, no stall exit, no
restarts. Returns x (3, N) and stats (3,) = [iterations, |r|, tol].
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import replace

import torch

from . import build
from .chain_matvec import chain_matvec_plain

CHUNK = build.TREE_CG_CHUNK


def smem_bytes(max_steps: int) -> int:
    """Dynamic shared memory of the apply window: two buffers of three
    planes of CHUNK + 2·(2^rounds − 1) floats."""
    return 4 * 6 * (CHUNK + 2 * ((1 << max_steps) - 1))


def work_floats(n: int, S: int, P: int, tables) -> int:
    """float32 scratch of one solve: r, z, p, Ap (3N each); the forward
    solutions (3S) and block inverses (9S); per path and side the
    attachment couplings and Schur corrections (18P each) and the fill
    couplings (9P); the ping-pong factorization state (2·45 planes of the
    largest level); the coefficients (alphas and betas)."""
    return (12 * n + 12 * S + 45 * P + 90 * tables.smax
            + 2 * tables.coef_floats)


def tree_cg_plain(cplan, tplan, tables, uk, x0, freem, cact, jact, d9, bel,
                  katt, rtol: float, reg: float, max_iter: int):
    """The plain PyTorch version, any device and dtype: the port's level
    factorization and forest apply (``fea/tree_factor.py``) with every
    level on PCR, K1's plain operator, and CG with float64 dots. It reads
    r·r on the host once per iteration for its stop test. ``tables`` is
    not read."""
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
            f"tree_cg: {name} must be a contiguous {dtype} CUDA tensor "
            f"of shape {tuple(shape)}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


@functools.cache
def grid_blocks(device_index: int, smem: int) -> int:
    """Blocks of the cooperative grid on a card for ``smem`` bytes of
    dynamic shared memory a block: SMs × the blocks per SM that the
    occupancy calculator allows (all co-resident, as grid-wide
    synchronisation needs)."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = build.library().tree_cg_grid_blocks(smem, ctypes.byref(out))
    build.check(rc, "tree_cg_grid_blocks")
    return out.value


def tree_cg(cplan, tplan, tables, uk, x0, freem, cact, jact, d9, bel, katt,
            rtol: float, reg: float, max_iter: int):
    """The whole solve: one cooperative launch of the CUDA kernel for CUDA
    tensors (float32 only, raises otherwise), the plain version for CPU
    tensors."""
    if uk.device.type == "cpu":
        return tree_cg_plain(cplan, tplan, tables, uk, x0, freem, cact, jact,
                             d9, bel, katt, rtol, reg, max_iter)
    n = uk.shape[1]
    jp = cplan.ja.shape[0]
    S, P = tplan.n_slots, tplan.n_paths
    L = len(tplan.meta.level_steps)
    if not tables.ordered:
        raise ValueError("tree_cg: the schedule's fills and attachments do "
                         "not all point from an earlier level to a later")
    f32, i64, i32 = torch.float32, torch.int64, torch.int32
    # the order of the enum Ptr in csrc/tree_cg.cu
    named = (
        ("uk", uk, (3, n), f32), ("x0", x0, (3, n), f32),
        ("freem", freem, (n,), f32), ("cact", cact, (n,), f32),
        ("jact", jact, (jp,), f32),
        ("chain_n", cplan.chain_n, (3, n), f32),
        ("chain_kax", cplan.chain_kax, (n,), f32),
        ("chain_kbd", cplan.chain_kbd, (n,), f32),
        ("jump_n", cplan.jump_n, (3, jp), f32),
        ("jump_kax", cplan.jump_kax, (jp,), f32),
        ("jump_kbd", cplan.jump_kbd, (jp,), f32),
        ("ja", cplan.ja, (jp,), i64), ("jb", cplan.jb, (jp,), i64),
        ("jump_ptr", cplan.jump_ptr, (n + 1,), i64),
        ("jump_ent", cplan.jump_ent, cplan.jump_ent.shape, i64),
        ("d9", d9, (9, S), f32), ("bel", bel, (9, S), f32),
        ("katt", katt, (P, 2, 3, 3), f32),
        ("lvl", tables.lvl, (4, L + 1), i64),
        ("left_fill", tables.left_fill, (S,), i32),
        ("first_path", tables.first_path, (S,), i32),
        ("last_path", tables.last_path, (S,), i32),
        ("fg", tables.fg, (P,), i32), ("lg", tables.lg, (P,), i32),
        ("has_fill", tables.has_fill, (P,), i32),
        ("att_tgt", tables.att_tgt, (2 * P,), i32),
        ("att_fill", tables.att_fill, (2 * P,), i32),
        ("att_flip", tables.att_flip, (2 * P,), i32),
        ("att_ptr", tables.att_ptr, (S + 1,), i32),
        ("att_ent", tables.att_ent, tables.att_ent.shape, i32))
    for name, t, shape, dt in named:
        _check(name, t, shape, dt)
    smem = smem_bytes(tables.max_steps)
    G = grid_blocks(uk.device.index if uk.device.index is not None
                    else torch.cuda.current_device(), smem)
    x = torch.empty_like(uk)
    stats = torch.empty(3, dtype=f32, device=uk.device)
    work = torch.empty(work_floats(n, S, P, tables), dtype=f32,
                       device=uk.device)
    # the per-block float64 partial sums of the four dot products
    part = torch.empty(4 * G, dtype=torch.float64, device=uk.device)
    ptrs = [t.data_ptr() for _, t, _, _ in named] + [
        x.data_ptr(), stats.data_ptr(), work.data_ptr(), part.data_ptr()]
    # the order of the enum Int in csrc/tree_cg.cu
    ints = [n, jp, S, P, L, tables.smax, tables.coef_floats, int(max_iter),
            G, smem]
    rc = build.library().tree_cg_f32(
        (ctypes.c_void_p * len(ptrs))(*ptrs), len(ptrs),
        (ctypes.c_longlong * len(ints))(*ints), len(ints), float(rtol),
        float(reg), build.stream_handle(uk))
    build.check(rc, "tree_cg_f32")
    build.count_launch("tree_cg")
    return x, stats
