"""K1: chain-ordered stiffness matvec (CUDA kernel + plain PyTorch version).

Replaces ``mycelium_tpu/fea/pallas_tree_big.py::_matvec_kernel``. The
source note in ``csrc/chain_matvec.cu`` says what bounds it and how.

Vectors are (3, N) component planes in chain order. ``plan`` is the
port's ``fea.chain.ChainPlan`` (only its tables are read):
``chain_n`` (3, N), ``chain_kax``/``chain_kbd`` (N,), ``jump_n`` (3, Jp),
``jump_kax``/``jump_kbd``/``ja``/``jb`` (Jp,), and the per-node jump CSR
``jump_ptr`` (N+1,) / ``jump_ent`` (2J,) that the kernel sums without
atomics; the kernel reads the plan's 32-bit copies and packed tables
(``plan.k32``). ``free``/``cact``/``jact`` are 0/1 masks in the vector dtype.

bc=True: the SPD boundary-conditioned operator
``free·(K(free·u) + reg·free·u) + (1 - free)·u``; bc=False: raw ``K·u``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build


def _shift_up(x):
    """y[:, i] = x[:, i+1], zero at the end."""
    return F.pad(x[:, 1:], (0, 1))


def _shift_down(x):
    """y[:, i] = x[:, i-1], zero at the start."""
    return F.pad(x[:, :-1], (1, 0))


def chain_matvec_plain(plan, u, free, cact, jact, reg: float, bc: bool):
    """The plain PyTorch version (gather/scatter), any device."""
    n = u.shape[1]
    uf = u * free if bc else u
    cn = plan.chain_n
    d = uf - _shift_up(uf)                       # u[p] - u[p+1]
    nd = cn[0] * d[0] + cn[1] * d[1] + cn[2] * d[2]
    kax_nd = plan.chain_kax * nd
    f = (kax_nd * cn + plan.chain_kbd * (d - nd * cn)) * cact
    out = f - _shift_down(f)                     # +f to p, -f to p+1

    upad = F.pad(uf, (0, 1))                     # padding jumps hit col N
    dj = upad[:, plan.ja] - upad[:, plan.jb]
    jn = plan.jump_n
    ndj = jn[0] * dj[0] + jn[1] * dj[1] + jn[2] * dj[2]
    fj = ((plan.jump_kax * ndj) * jn
          + plan.jump_kbd * (dj - ndj * jn)) * jact
    out = F.pad(out, (0, 1))
    out.index_add_(1, plan.ja, fj)
    out.index_add_(1, plan.jb, -fj)
    out = out[:, :n]
    if bc:
        return free * (out + reg * uf) + (1.0 - free) * u
    return out


def _check(name, t, shape, dtype):
    if t.device.type != "cuda" or t.dtype != dtype or \
            tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"chain_matvec: {name} must be a contiguous {dtype} CUDA tensor "
            f"of shape {tuple(shape)}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


class ChainOperator:
    """K·u on the chain layout with the plan and one solve's masks bound
    once: the tensors are validated here, and on the card their pointers
    are kept in one prebuilt argument array, so ``apply`` passes only
    ``u``, ``out`` and the stream. The CUDA kernel for CUDA tensors
    (float32 only, raises otherwise), the plain version for CPU tensors.
    The operator keeps references to the tensors it was given; they must
    not be resized while it lives."""

    def __init__(self, plan, free, cact, jact, reg: float):
        self.plan, self.free, self.cact, self.jact = plan, free, cact, jact
        self.reg = float(reg)
        self.n = free.shape[0]
        self.cuda = free.device.type == "cuda"
        if not self.cuda:
            return
        n, jp = self.n, plan.ja.shape[0]
        k = plan.k32
        if k is None:
            raise ValueError("chain_matvec: the plan has no kernel tables "
                             "(ChainPlan.with_kernel_tables)")
        f32, i32 = torch.float32, torch.int32
        # the order of the enum Ptr in csrc/chain_matvec.cu
        named = (("free", free, (n,), f32), ("cact", cact, (n,), f32),
                 ("jact", jact, (jp,), f32),
                 ("chain_pack", k.chain_pack, (n, 4), f32),
                 ("chain_kbd", plan.chain_kbd, (n,), f32),
                 ("jump_pack", k.jump_pack, (jp, 4), f32),
                 ("jump_kbd", plan.jump_kbd, (jp,), f32),
                 ("ja", k.ja, (jp,), i32), ("jb", k.jb, (jp,), i32),
                 ("jump_ptr", k.jump_ptr, (n + 1,), i32),
                 ("jump_ent", k.jump_ent, k.jump_ent.shape, i32))
        for name, t, shape, dt in named:
            _check(name, t, shape, dt)
        self._ptrs = (ctypes.c_void_p * len(named))(
            *(t.data_ptr() for _, t, _, _ in named))
        self._n_ptrs = len(named)
        self._fn = build.library().chain_matvec_f32
        self._device = free.device
        self._index = free.device.index if free.device.index is not None \
            else torch.cuda.current_device()

    def apply(self, u, bc: bool, out=None):
        """(A u) for bc=True, the raw K·u for bc=False; (3, N) planes.
        ``out`` (same shape, may not alias ``u``) saves the allocation."""
        if not self.cuda:
            res = chain_matvec_plain(self.plan, u, self.free, self.cact,
                                     self.jact, self.reg, bc)
            return res if out is None else out.copy_(res)
        if u.dtype != torch.float32 or u.device != self._device or \
                u.shape != (3, self.n) or not u.is_contiguous():
            _check("u", u, (3, self.n), torch.float32)
            raise ValueError(f"chain_matvec: u is on {u.device}, the "
                             f"operator on {self._device}")
        if out is None:
            out = torch.empty_like(u)
        elif out.dtype != u.dtype or out.device != u.device or \
                out.shape != u.shape or not out.is_contiguous() or \
                out.data_ptr() == u.data_ptr():
            raise ValueError("chain_matvec: out must be a contiguous float32 "
                             "tensor of u's shape and device, not u itself")
        rc = self._fn(self._ptrs, self._n_ptrs, self.n, self.reg,
                      u.data_ptr(), out.data_ptr(), 1 if bc else 0,
                      build.raw_stream(self._index))
        if rc != 0:
            build.check(rc, "chain_matvec_f32")
        build.count_launch("chain_matvec")
        return out


def chain_matvec(plan, u, free, cact, jact, reg: float, bc: bool):
    """K·u on the chain layout, one shot: the CUDA kernel for a CUDA tensor
    (float32 only, raises otherwise), the plain version for a CPU tensor.
    A caller that applies the operator more than once binds a
    ``ChainOperator``."""
    if u.device.type == "cpu":
        return chain_matvec_plain(plan, u, free, cact, jact, reg, bc)
    if free.device.type != "cuda":
        _check("free", free, free.shape, torch.float32)
    return ChainOperator(plan, free, cact, jact, reg).apply(u, bc)
