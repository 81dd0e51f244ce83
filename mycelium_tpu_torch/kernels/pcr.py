"""K2/K3: one PCR level of the spanning-forest factorization and its
apply (CUDA kernels + plain PyTorch versions).

Replace ``mycelium_tpu/fea/pallas_factor.py::_factor_kernel`` (K2) and
``_apply_kernel``/``_apply_kernel_chunked`` (K3). The source note in
``csrc/pcr.cu`` says what bounds them and how.

A 3x3 block batch is a (9, S) tensor of row-major component planes, a
3-vector batch a (3, S) tensor (or (3, S, K) for K right-hand sides in the
plain version). Row i of the block tridiagonal couples to i-1 through
L_i = B[i]^T and to i+1 through R_i = B[i+1]; slots outside [0, S) read as
zero (the TPU versions roll; both are exact because couplings vanish at
path ends). The plain functions are the counterparts of
``mycelium_tpu/fea/tree_jax.py::_pcr_coeffs``/``_pcr_apply``.

K2 and K3 are bound once per plan (``PcrLaunch``, built with the model by
``fea/tree_factor.py::build_pcr_launch``). K2: a level cut into
path-aligned windows is one launch that allocates nothing and reads
nothing back; a level with a longer path goes to the unbound
``pcr_factor``, which takes any level on the global rounds. K3: the
hybrid's whole forest apply, one launch a level and sweep that fuses the
level's right-hand side and store with its rounds (``PcrLaunch.apply``, on
CUDA tensors only: its plain version is ``fea/tree_factor.py``'s
level-by-level sweep); the unbound ``pcr_apply`` runs a level's rounds
alone.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import build
from .ordered_sum import ordered_sum


def transpose9(m):
    """(9, ...) component planes of 3x3 blocks, each block transposed: a
    copy through a transposed view, so no index list crosses to the
    device."""
    return m.reshape((3, 3) + tuple(m.shape[1:])).transpose(0, 1) \
        .reshape(m.shape)


def _sh(x, k: int):
    """y[:, i] = x[:, i+k] along dim 1, zero outside (k may be < 0)."""
    if k == 0:
        return x
    n = x.shape[1]
    if abs(k) >= n:
        return torch.zeros_like(x)
    pad = [0, 0] * (x.dim() - 2)
    if k > 0:
        return F.pad(x[:, k:], pad + [0, k])
    return F.pad(x[:, :k], pad + [-k, 0])


def _mm9(a, b):
    """Block product of (9, S) plane stacks."""
    a3 = a.reshape(3, 3, -1)
    b3 = b.reshape(3, 3, -1)
    return (a3[:, 0:1] * b3[0:1] + a3[:, 1:2] * b3[1:2]
            + a3[:, 2:3] * b3[2:3]).reshape(9, -1)


def _mv9(m, v):
    """(9, S) blocks times (3, S[, K]) vectors."""
    m3 = m.reshape(3, 3, *m.shape[1:])
    if v.dim() == 3:
        m3 = m3[..., None]
    return m3[:, 0] * v[0] + m3[:, 1] * v[1] + m3[:, 2] * v[2]


def _inv9(m):
    """Adjugate inverse of (9, S) blocks; a zero determinant reads as 1."""
    a, b, c, d, e, f, g, h, i = m
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(det != 0, det, torch.ones_like(det))
    return torch.stack(
        (A / det, -(b * i - c * h) / det, (b * f - c * e) / det,
         B / det, (a * i - c * g) / det, -(a * f - c * d) / det,
         C / det, -(a * h - b * g) / det, (a * e - b * d) / det))


def pcr_coeffs_plain(D, B, steps: int):
    """PCR recurrence: returns (alphas, betas) (steps, 9, S) and dinv
    (9, S)."""
    L = transpose9(B)
    R = _sh(B, 1)
    alphas, betas = [], []
    s = 1
    for _ in range(steps):
        dinv = _inv9(D)
        a = _mm9(L, _sh(dinv, -s))
        b = _mm9(R, _sh(dinv, s))
        D = D - (_mm9(a, _sh(R, -s)) + _mm9(b, _sh(L, s)))
        L = -_mm9(a, _sh(L, -s))
        R = -_mm9(b, _sh(R, s))
        alphas.append(a)
        betas.append(b)
        s *= 2
    empty = D.new_zeros((0, 9, D.shape[1]))
    al = torch.stack(alphas) if alphas else empty
    be = torch.stack(betas) if betas else empty
    return al, be, _inv9(D)


def pcr_apply_plain(alphas, betas, dinv, r):
    """x = T^{-1} r from the PCR coefficients; r (3, S) or (3, S, K)."""
    s = 1
    for k in range(alphas.shape[0]):
        r = r - (_mv9(alphas[k], _sh(r, -s)) + _mv9(betas[k], _sh(r, s)))
        s *= 2
    return _mv9(dinv, r)


def corner_rhs(fg, lg, S: int, dtype, device):
    """(18, S) unit right-hand sides: plane 6*i + j is component i of
    column j, with columns 0:3 at every path's first slot and 3:6 at its
    last."""
    rhs = torch.zeros((3, 6, S), dtype=dtype, device=device)
    one = torch.ones((), dtype=dtype, device=device)
    for i in range(3):
        rhs[i, i].index_put_((fg,), one, accumulate=True)
        rhs[i, 3 + i].index_put_((lg,), one, accumulate=True)
    return rhs.reshape(18, S)


def pcr_factor_plain(D, B, fg, lg, steps: int):
    """Coefficients plus the 6-column corner solve: (al, be, dinv, xc),
    xc (18, S) with plane 6*i + j = component i of corner column j."""
    S = D.shape[1]
    al, be, dinv = pcr_coeffs_plain(D, B, steps)
    rhs = corner_rhs(fg, lg, S, D.dtype, D.device)
    X = pcr_apply_plain(al, be, dinv, rhs.reshape(3, 6, S).transpose(1, 2))
    return al, be, dinv, X.transpose(1, 2).reshape(18, S)


def _check(fn, name, t, shape, dtype=torch.float32):
    if t.device.type != "cuda" or t.dtype != dtype or \
            tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{fn}: {name} must be a contiguous {dtype} CUDA tensor of shape "
            f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def corner_flags(fg, lg, S: int, device):
    """(S,) int32: bit 0 at every path's first slot, bit 1 at its last: the
    corner right-hand sides as K2 reads them."""
    c = torch.zeros(S, dtype=torch.int32, device=device)
    c[fg] = 1
    c[lg] = c[lg] + 2
    return c


def _launch_k2(D, B, corner, al, be, dinv, xc, work, win_start, win_len,
               n_win: int, S: int, steps: int, stream) -> None:
    def ptr(t):
        return t.data_ptr() if t is not None else None
    rc = build.library().pcr_factor_f32(
        D.data_ptr(), B.data_ptr(), corner.data_ptr(), al.data_ptr(),
        be.data_ptr(), dinv.data_ptr(), xc.data_ptr(), ptr(work),
        ptr(win_start), ptr(win_len), n_win, S, steps, stream)
    build.check(rc, "pcr_factor_f32")
    build.count_launch("pcr_factor")


def _factor_global(D, B, corner, steps: int):
    """K2 on its global rounds (steps + 2 launches), outputs and work
    space allocated here."""
    S = D.shape[1]
    al = torch.empty((steps, 9, S), dtype=D.dtype, device=D.device)
    be = torch.empty_like(al)
    dinv = torch.empty((9, S), dtype=D.dtype, device=D.device)
    xc = torch.empty((18, S), dtype=D.dtype, device=D.device)
    work = torch.empty((90, S), dtype=D.dtype, device=D.device)
    _launch_k2(D, B, corner, al, be, dinv, xc, work, None, None, 0, S, steps,
               build.stream_handle(D))
    return al, be, dinv, xc


def pcr_factor(D, B, fg, lg, steps: int):
    """One PCR level's factorization, unbound: K2 on its global rounds for
    CUDA tensors (float32 only, raises otherwise; allocates its outputs),
    the plain version for CPU tensors."""
    if D.device.type == "cpu":
        return pcr_factor_plain(D, B, fg, lg, steps)
    S = D.shape[1]
    _check("pcr_factor", "D", D, (9, S))
    _check("pcr_factor", "B", B, (9, S))
    return _factor_global(D, B, corner_flags(fg, lg, S, D.device), steps)


class SweepTables(NamedTuple):
    """What K3's bound sweep reads of the plan, host arrays (slots and
    paths global, the PCR levels first): ``first_path``/``last_path``
    (t0,) the path that starts / ends at each PCR slot (-1 for none);
    ``att_ptr`` (n_slots + 1,) and ``att_ent`` the attachment CSR by
    junction slot (entries 2·path + side); ``att_tgt`` (2·P_pcr,) each PCR
    path end's junction slot (n_slots for none); ``tail_ptr`` (Sd + 1,)
    and ``tail_ent`` the CSR's entries at the dense tail's slots that come
    from PCR paths; ``ordered``: every attachment of a PCR path points from
    its level to a later one, and no path starts or ends twice at a
    slot."""
    level_offsets: tuple
    path_offsets: tuple
    n_slots: int
    first_path: np.ndarray
    last_path: np.ndarray
    att_ptr: np.ndarray
    att_ent: np.ndarray
    att_tgt: np.ndarray
    tail_ptr: np.ndarray
    tail_ent: np.ndarray
    ordered: bool


class PcrLaunch:
    """K2 and K3 bound to the PCR levels of one plan. Per level: its slots
    and rounds, its corner flags, and, where its paths tile it and none is
    longer than the kernels' window, its path-aligned windows (level-local
    first slots and lengths); and the sweep's tables (``SweepTables``).

    K2 (``factor``): a windowed level is one launch into the launch's own
    output buffers, so it allocates nothing and reads nothing back; another
    level goes to the unbound global rounds (``pcr_factor``'s, which
    allocate). One set of buffers, a view per windowed level, allocated at
    the first factorization on the card: a factorization overwrites the
    previous one's coefficients of those levels, so a caller that keeps a
    factorization (the ramp keeps one at a time) copies it before it
    factors again.

    K3 (``apply``, CUDA tensors only): the forest apply of a factorization
    it is handed (never K2's buffers: the ramp keeps a copied
    factorization), one launch a level and sweep, on the level's windows
    or, where it has none, in the halo form; the dense tail's right-hand
    side is one ``ordered_sum``. Each apply writes fresh buffers, so a
    result stays valid while the caller holds it (bicgstab applies the
    preconditioner twice an iteration). Its plain version is
    ``fea/tree_factor.py``'s ``tree_forward_sweep``, ``tree_tail_solve``
    and ``tree_backward_sweep``, to which ``tree_apply_chain_planes``
    sends CPU tensors.

    ``levels``: per level (S, steps, corner (S,) int32 host array, windows
    (first slots, lengths) host arrays or None)."""

    def __init__(self, levels, sweep: SweepTables, device):
        self.device = torch.device(device)
        self.sizes = [int(S) for S, _, _, _ in levels]
        self.steps = [int(k) for _, k, _, _ in levels]
        self.windowed = tuple(w is not None and len(w[0]) > 0
                              for _, _, _, w in levels)

        def i32(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                   device=self.device)
        self.corner = [i32(c) for _, _, c, _ in levels]
        self.windows = [(i32(w[0]), i32(w[1]), len(w[0])) if ok
                        else (None, None, 0)
                        for (_, _, _, w), ok in zip(levels, self.windowed)]
        self.level_offsets = tuple(int(x) for x in sweep.level_offsets)
        self.path_offsets = tuple(int(x) for x in sweep.path_offsets)
        self.n_slots = int(sweep.n_slots)
        self.ordered = bool(sweep.ordered)
        self.first_path, self.last_path, self.att_ptr, self.att_ent, \
            self.att_tgt, self.tail_ptr, self.tail_ent = (
                i32(a) for a in (sweep.first_path, sweep.last_path,
                                 sweep.att_ptr, sweep.att_ent,
                                 sweep.att_tgt, sweep.tail_ptr,
                                 sweep.tail_ent))
        L = len(self.sizes)
        t0, P = self.level_offsets[L], self.path_offsets[L]
        bad = [name for name, ok in (
            ("level sizes", self.sizes == [
                b - a for a, b in zip(self.level_offsets,
                                      self.level_offsets[1:])]),
            ("first_path", tuple(self.first_path.shape) == (t0,)),
            ("last_path", tuple(self.last_path.shape) == (t0,)),
            ("att_ptr", tuple(self.att_ptr.shape) == (self.n_slots + 1,)),
            ("att_tgt", tuple(self.att_tgt.shape) == (2 * P,)),
            ("tail_ptr", tuple(self.tail_ptr.shape)
             == (self.n_slots - t0 + 1,)))
            if not ok]
        if bad:
            raise ValueError(f"PcrLaunch: the sweep's tables do not fit the "
                             f"levels: {bad}")
        # per level the addresses K3 reads: its windows (None for the halo
        # form), its slots' CSR pointers and path ends
        self._level_ptrs = [
            tuple(t.data_ptr() if t is not None else None for t in (
                start, lens, self.att_ptr[s0:], self.first_path[s0:],
                self.last_path[s0:]))
            for (start, lens, _), s0 in zip(self.windows,
                                           self.level_offsets)]
        self._out = None
        index = self.device.index if self.device.index is not None \
            else (torch.cuda.current_device()
                  if self.device.type == "cuda" else 0)
        self._stream = functools.partial(build.raw_stream, index)

    def _allocate(self) -> None:
        # per windowed level and slot: the round coefficients (2·steps·9),
        # dinv (9) and the corner solutions (18)
        n = sum((18 * k + 27) * S for S, k, w in
                zip(self.sizes, self.steps, self.windowed) if w)
        flat = torch.empty(n, dtype=torch.float32, device=self.device)
        self._out, off = [], 0
        for S, k, w in zip(self.sizes, self.steps, self.windowed):
            parts = []
            for shape in ((k, 9, S), (k, 9, S), (9, S), (18, S)) if w else ():
                n = math.prod(shape)
                parts.append(flat[off:off + n].view(shape))
                off += n
            self._out.append(tuple(parts))

    def factor(self, li: int, D, B):
        """Level ``li``'s factorization (al, be, dinv, xc) from its (9, S)
        D and B: on CUDA tensors (float32 only, raises otherwise) one
        launch on a windowed level, the global rounds on another; on CPU
        tensors the plain version."""
        if D.device.type == "cpu":
            return self.plain(li, D, B)
        S, steps = self.sizes[li], self.steps[li]
        _check("pcr_factor", "D", D, (9, S))
        _check("pcr_factor", "B", B, (9, S))
        if not self.windowed[li]:
            return _factor_global(D, B, self.corner[li], steps)
        if self._out is None:
            self._allocate()
        al, be, dinv, xc = self._out[li]
        start, lens, n_win = self.windows[li]
        _launch_k2(D, B, self.corner[li], al, be, dinv, xc, None, start,
                   lens, n_win, S, steps, self._stream())
        return al, be, dinv, xc

    def plain(self, li: int, D, B):
        """The plain version of level ``li`` on D's device: the oracle, on
        copies of the same inputs on the CPU."""
        c = self.corner[li].to(D.device)
        fg = torch.nonzero(c & 1).flatten()
        lg = torch.nonzero(c & 2).flatten()
        return pcr_factor_plain(D, B, fg, lg, self.steps[li])

    # K3: the hybrid's forest apply -------------------------------------

    def _check_sweep(self, factor, rp) -> None:
        L = len(self.sizes)
        if not self.ordered:
            raise ValueError("PcrLaunch: the plan's attachments do not all "
                             "point from an earlier PCR level to a later "
                             "one; the bound sweep cannot take it")
        for li in range(L):
            S, k = self.sizes[li], self.steps[li]
            _check("pcr_sweep", "alphas", factor.alphas[li], (k, 9, S))
            _check("pcr_sweep", "betas", factor.betas[li], (k, 9, S))
            _check("pcr_sweep", "dinv", factor.dinvs[li], (9, S))
            if not self.windowed[li] and k > apply_max_steps():
                raise ValueError(f"pcr_sweep: level {li}'s {k} rounds "
                                 "exceed the halo window "
                                 f"({apply_max_steps()})")
        _check("pcr_sweep", "att_b", factor.att_b,
               (self.path_offsets[L], 2, 3, 3))
        if rp.device != factor.att_b.device or rp.dtype != torch.float32 \
                or rp.dim() != 2 or rp.shape[0] != 3 \
                or rp.shape[1] < self.n_slots or rp.stride(1) != 1:
            raise ValueError(f"pcr_sweep: rp must be float32 (3, >= "
                             f"{self.n_slots}) planes with unit column "
                             f"stride on the factor's device, got "
                             f"{rp.dtype} {tuple(rp.shape)} strides "
                             f"{rp.stride()} on {rp.device}")

    def sweep_level(self, li: int, backward: bool, factor, rp, u,
                    nv) -> None:
        """One K3 launch on CUDA tensors, which the callers (``forward``,
        ``backward``) check: level ``li`` of the forward sweep (reads rp
        and the earlier levels' products in nv, writes the level's y into
        u and its path ends' products into nv) or of the backward sweep
        (reads u at the junctions, writes u = y - T^{-1} z on the
        level)."""
        s0, s1 = self.level_offsets[li], self.level_offsets[li + 1]
        n_win = self.windows[li][2]
        start, lens, ptr, first, last = self._level_ptrs[li]
        rc = build.library().pcr_sweep_f32(
            int(backward), factor.alphas[li].data_ptr(),
            factor.betas[li].data_ptr(), factor.dinvs[li].data_ptr(), start,
            lens, n_win, ptr, self.att_ent.data_ptr(), first, last,
            self.att_tgt.data_ptr(), factor.att_b.data_ptr(), rp.data_ptr(),
            rp.stride(0), u.data_ptr(), u.stride(0), nv.data_ptr(), s0,
            s1 - s0, self.n_slots, self.steps[li], self._stream())
        build.check(rc, "pcr_sweep_f32")
        build.count_launch("pcr_apply")

    def forward(self, factor, rp):
        """The forward sweep on CUDA tensors: (u, nv), u (3, n_slots) with
        each PCR level's y = T_l^{-1} r_l on its slots (the tail's slots
        unwritten), nv (2·P_pcr, 3) the negated attachment products of the
        PCR paths' ends. One launch a level."""
        self._check_sweep(factor, rp)
        L = len(self.sizes)
        u = rp.new_empty((3, self.n_slots))
        nv = rp.new_empty((2 * self.path_offsets[L], 3))
        for li in range(L):
            self.sweep_level(li, False, factor, rp, u, nv)
        return u, nv

    def tail_rhs(self, nv, rp):
        """The dense tail's right-hand side (3, Sd): rp on its slots plus
        the PCR paths' products that attach there, in the CSR's order
        (one ``ordered_sum``)."""
        t0 = self.level_offsets[len(self.sizes)]
        return ordered_sum(nv.T, self.tail_ptr, self.tail_ent,
                           self.n_slots - t0, init=rp[:, t0:self.n_slots])

    def backward(self, factor, u) -> None:
        """The backward sweep in place on ``forward``'s u, whose tail
        slots hold the dense tail's solution: u = y - T_l^{-1} z_l, level
        by level from the last. One launch a level."""
        for li in range(len(self.sizes) - 1, -1, -1):
            self.sweep_level(li, True, factor, u, u, u)

    def apply(self, factor, rp):
        """z = K_tree^{-1} r: the (3, n_slots) slot part, a fresh tensor.
        CUDA float32 tensors only (raises otherwise): 2 K3 launches a PCR level, and with a dense tail one
        ``ordered_sum`` and its product with ``factor.sinv``."""
        u, nv = self.forward(factor, rp)
        t0 = self.level_offsets[len(self.sizes)]
        if self.n_slots > t0:
            r_tail = self.tail_rhs(nv, rp)
            u[:, t0:] = (factor.sinv @ r_tail.T.reshape(-1)).reshape(-1, 3).T
        self.backward(factor, u)
        return u


@functools.cache
def apply_max_steps() -> int:
    """Most PCR rounds K3's shared-memory window takes."""
    return build.library().pcr_apply_max_steps()


def pcr_apply(alphas, betas, dinv, r):
    """u = T^{-1} r on one level: K3 for CUDA tensors (float32 only,
    raises otherwise), the plain version for CPU tensors."""
    if r.device.type == "cpu":
        return pcr_apply_plain(alphas, betas, dinv, r)
    steps = alphas.shape[0]
    S = r.shape[1]
    _check("pcr_apply", "alphas", alphas, (steps, 9, S))
    _check("pcr_apply", "betas", betas, (steps, 9, S))
    _check("pcr_apply", "dinv", dinv, (9, S))
    _check("pcr_apply", "r", r, (3, S))
    if steps > apply_max_steps():
        raise ValueError(f"pcr_apply: {steps} rounds exceed the kernel's "
                         f"window ({apply_max_steps()}); bound the path "
                         "length with tree_max_path_len")
    u = torch.empty_like(r)
    rc = build.library().pcr_apply_f32(
        alphas.data_ptr(), betas.data_ptr(), dinv.data_ptr(), r.data_ptr(),
        u.data_ptr(), S, steps, build.stream_handle(r))
    build.check(rc, "pcr_apply_f32")
    build.count_launch("pcr_apply")
    return u
