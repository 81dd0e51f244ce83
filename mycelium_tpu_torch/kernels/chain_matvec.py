"""K1: chain-ordered stiffness matvec (CUDA kernel + plain PyTorch version).

Replaces ``mycelium_tpu/fea/pallas_tree_big.py::_matvec_kernel``. The
source note in ``csrc/chain_matvec.cu`` says what bounds it and how.

Vectors are (3, N) component planes in chain order. ``plan`` is the
port's ``fea.chain.ChainPlan`` (only its tables are read):
``chain_n`` (3, N), ``chain_kax``/``chain_kbd`` (N,), ``jump_n`` (3, Jp),
``jump_kax``/``jump_kbd``/``ja``/``jb`` (Jp,), and the per-node jump CSR
``jump_ptr`` (N+1,) / ``jump_ent`` (2J,) that the kernel sums without
atomics. ``free``/``cact``/``jact`` are 0/1 masks in the vector dtype.

bc=True: the SPD boundary-conditioned operator
``free·(K(free·u) + reg·free·u) + (1 - free)·u``; bc=False: raw ``K·u``.
"""

from __future__ import annotations

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


def chain_matvec(plan, u, free, cact, jact, reg: float, bc: bool):
    """K·u on the chain layout: the CUDA kernel for a CUDA tensor (float32
    only, raises otherwise), the plain version for a CPU tensor."""
    if u.device.type == "cpu":
        return chain_matvec_plain(plan, u, free, cact, jact, reg, bc)
    n = u.shape[1]
    jp = plan.ja.shape[0]
    f32, i64 = torch.float32, torch.int64
    for name, t, shape, dt in (
            ("u", u, (3, n), f32), ("free", free, (n,), f32),
            ("cact", cact, (n,), f32), ("jact", jact, (jp,), f32),
            ("chain_n", plan.chain_n, (3, n), f32),
            ("chain_kax", plan.chain_kax, (n,), f32),
            ("chain_kbd", plan.chain_kbd, (n,), f32),
            ("jump_n", plan.jump_n, (3, jp), f32),
            ("jump_kax", plan.jump_kax, (jp,), f32),
            ("jump_kbd", plan.jump_kbd, (jp,), f32),
            ("ja", plan.ja, (jp,), i64), ("jb", plan.jb, (jp,), i64),
            ("jump_ptr", plan.jump_ptr, (n + 1,), i64),
            ("jump_ent", plan.jump_ent, plan.jump_ent.shape, i64)):
        _check(name, t, shape, dt)
    out = torch.empty_like(u)
    lib = build.library()
    rc = lib.chain_matvec_f32(
        u.data_ptr(), free.data_ptr(), cact.data_ptr(), jact.data_ptr(),
        plan.chain_n.data_ptr(), plan.chain_kax.data_ptr(),
        plan.chain_kbd.data_ptr(), plan.jump_n.data_ptr(),
        plan.jump_kax.data_ptr(), plan.jump_kbd.data_ptr(),
        plan.ja.data_ptr(), plan.jb.data_ptr(), jp,
        plan.jump_ptr.data_ptr(), plan.jump_ent.data_ptr(), out.data_ptr(),
        n, float(reg), int(bool(bc)), build.stream_handle(u))
    build.check(rc, "chain_matvec_f32")
    build.count_launch("chain_matvec")
    return out
