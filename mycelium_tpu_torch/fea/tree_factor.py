"""Spanning-forest preconditioner on the device (port of
``mycelium_tpu/fea/tree_jax.py``: ``build_tree_plan``, ``FastFactorData``,
``chain_tree_diag``, ``tree_factor_fast``, the dense junction tail and
``tree_apply_chain_planes``).

The host schedule (``fea/tree.py``) is flattened into one global slot
space; under the unified ordering (``model._unified_order``) slot s IS
chain position s, so the factorization assembles its diagonal from chain
shifts and the apply works on chain-ordered residual planes directly.
Each level's block-tridiagonal solves run as parallel cyclic reduction:
K2 (``kernels.pcr_factor``) factors a level, K3 (``kernels.pcr_apply``)
applies it, on CUDA tensors; on CPU tensors the same wrappers run their
plain versions (the counterparts of ``_pcr_coeffs``/``_pcr_apply``).
The trailing levels whose slots fit ``tree_dense_tail`` are solved as one
dense junction-Schur inverse (``torch.linalg.inv``, as the reference).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..kernels.pcr import TRANSPOSE9, pcr_apply, pcr_factor
from .tree import KIND_ELEM, KIND_FILL, KIND_NONE, TreeSchedule


@dataclass(frozen=True)
class TreeMeta:
    """Static shape info of the flattened schedule."""
    level_offsets: tuple        # slot-space offset per level, + total
    path_offsets: tuple         # path-space offset per level, + total
    level_steps: tuple          # PCR rounds per level
    k_scale: float = 1.0        # median element stiffness (reg floor ref)
    n_pcr: int = -1             # levels eliminated by PCR (-1: all)


def n_pcr_levels(meta: TreeMeta) -> int:
    return len(meta.level_steps) if meta.n_pcr < 0 else meta.n_pcr


def pcr_split(sizes, dense_tail: int) -> int:
    """Number of leading levels kept on PCR: the trailing levels whose
    combined slot count fits ``dense_tail`` go to the dense tail."""
    if dense_tail <= 0:
        return len(sizes)
    suffix = 0
    k = len(sizes)
    while k > 0 and suffix + sizes[k - 1] <= dense_tail:
        suffix += sizes[k - 1]
        k -= 1
    return k


@dataclass(frozen=True)
class TreePlan:
    """Device form of the schedule; slot/path arrays of all levels are
    concatenated and delimited by meta.level_offsets/path_offsets."""
    meta: TreeMeta
    tree_edge: torch.Tensor      # (E,) bool spanning-forest membership
    k3: torch.Tensor             # (E, 3, 3) element couplings
    slots: torch.Tensor          # (S,) node id per global slot
    left_elem: torch.Tensor      # (S,) left-edge element (sentinel E)
    left_fill: torch.Tensor      # (S,) left-edge fill = producing path (P)
    left_fill_flip: torch.Tensor  # (S,) bool
    first_gpos: torch.Tensor     # (P,) global slot of the path's start
    last_gpos: torch.Tensor      # (P,)
    att_elem: torch.Tensor       # (P, 2) (sentinel E)
    att_fill: torch.Tensor       # (P, 2) (sentinel P)
    att_flip: torch.Tensor       # (P, 2) bool
    att_tgt: torch.Tensor        # (P, 2) junction slot (sentinel S)
    has_fill: torch.Tensor       # (P,) bool
    dense_eid: torch.Tensor      # (Ed,) tree elements inside the tail
    dense_i: torch.Tensor        # (Ed,) local tail rows
    dense_j: torch.Tensor        # (Ed,)

    @property
    def n_slots(self) -> int:
        return self.slots.shape[0]

    @property
    def n_paths(self) -> int:
        return self.first_gpos.shape[0]


@dataclass(frozen=True)
class TreeFactor:
    """Per-solve numeric factorization. PCR coefficients cover the first
    meta.n_pcr levels; the tail levels' slots go through ``sinv``."""
    alphas: tuple                # per PCR level (steps, 9, S_l)
    betas: tuple
    dinvs: tuple                 # per PCR level (9, S_l) block inverses
    att_b: torch.Tensor          # (P_pcr, 2, 3, 3) attachment couplings
    sinv: Optional[torch.Tensor] = None   # (3Sd, 3Sd) dense tail inverse


@dataclass(frozen=True)
class FastMeta:
    level_left_fill: tuple       # per level: has KIND_FILL left edges
    left_is_chain_shift: bool = False   # left edge of slot s is chain
                                        # edge s-1 for every KIND_ELEM slot


@dataclass(frozen=True)
class FastFactorData:
    """Static tables of the gather-free factorization (unified order)."""
    chain_tree: torch.Tensor     # (N,) bool chain slot's element in forest
    jump_tree: torch.Tensor      # (Jp,) bool
    left_k3: torch.Tensor        # (9, S) left-edge k3 component planes
    ja: torch.Tensor             # (Jp,) int64 (sentinel N)
    jb: torch.Tensor             # (Jp,)
    meta: FastMeta


def build_tree_plan(schedule: TreeSchedule, k3: np.ndarray, dtype, device,
                    dense_tail: int = 0) -> TreePlan:
    """Flatten the host schedule (+ element couplings) onto the device.
    ``dense_tail`` > 0 folds the trailing levels whose combined slot count
    fits it into one dense junction solve."""
    lv_off, pa_off = [0], [0]
    steps = []
    slots, le, lf, lff = [], [], [], []
    fgp, lgp = [], []
    a_e, a_f, a_fl, a_tg = [], [], [], []
    hasf = []
    E = len(schedule.conn)

    # fill id == global producing-path index
    fill_to_path = {}
    p_base = 0
    for lv in schedule.levels:
        for p, f in enumerate(lv.fill_out):
            if f >= 0:
                fill_to_path[int(f)] = p_base + p
        p_base += len(lv.first_pos)
    P_tot = p_base

    lv_starts = []
    s_base = 0
    for lv in schedule.levels:
        lv_starts.append(s_base)
        s_base += len(lv.slots)
    S_tot = s_base

    s_base = 0
    for lv in schedule.levels:
        S = len(lv.slots)
        P = len(lv.first_pos)
        slots.append(lv.slots)
        is_e = lv.left_kind == KIND_ELEM
        is_f = lv.left_kind == KIND_FILL
        le.append(np.where(is_e, lv.left_id, E))
        lf.append(np.where(
            is_f, [fill_to_path.get(int(i), P_tot) for i in lv.left_id],
            P_tot))
        lff.append(lv.left_flip & is_f)
        fgp.append(lv.first_pos.astype(np.int64) + s_base)
        lgp.append(lv.last_pos.astype(np.int64) + s_base)
        a_e.append(np.where(lv.att_kind == KIND_ELEM, lv.att_id, E))
        a_f.append(np.where(
            lv.att_kind == KIND_FILL,
            np.vectorize(lambda i: fill_to_path.get(int(i), P_tot))(
                lv.att_id) if lv.att_id.size else lv.att_id,
            P_tot))
        a_fl.append(lv.att_flip)
        a_tg.append(np.where(lv.att_kind == KIND_NONE, S_tot,
                             np.asarray([[lv_starts[l] for l in row]
                                         for row in lv.att_level])
                             + lv.att_pos))
        hasf.append(lv.fill_out >= 0)
        lens = lv.last_pos - lv.first_pos + 1
        maxlen = int(lens.max()) if len(lens) else 1
        steps.append(max(int(np.ceil(np.log2(max(maxlen, 1)))), 0))
        lv_off.append(lv_off[-1] + S)
        pa_off.append(pa_off[-1] + P)
        s_base += S

    k3_np = np.asarray(k3, np.float64)
    k_scale = (float(np.median(np.trace(k3_np, axis1=1, axis2=2) / 3.0))
               if len(k3_np) else 1.0)

    def idx(xs, shape=(0,)):
        a = np.concatenate(xs) if xs else np.zeros(shape)
        return torch.as_tensor(a.astype(np.int64), device=device)

    def flag(xs, shape=(0,)):
        a = np.concatenate(xs) if xs else np.zeros(shape)
        return torch.as_tensor(a.astype(bool), device=device)

    tree_edge = torch.as_tensor(np.asarray(schedule.tree_edge, bool),
                                device=device)
    k3_t = torch.as_tensor(k3_np, dtype=dtype, device=device)
    empty = torch.zeros((0,), dtype=torch.int64, device=device)
    if not schedule.levels:   # fully gripped: nothing to eliminate
        return TreePlan(
            meta=TreeMeta(level_offsets=(0,), path_offsets=(0,),
                          level_steps=(), k_scale=k_scale, n_pcr=0),
            tree_edge=tree_edge, k3=k3_t, slots=empty, left_elem=empty,
            left_fill=empty, left_fill_flip=flag([]), first_gpos=empty,
            last_gpos=empty, att_elem=idx([], (0, 2)),
            att_fill=idx([], (0, 2)), att_flip=flag([], (0, 2)),
            att_tgt=idx([], (0, 2)), has_fill=flag([]), dense_eid=empty,
            dense_i=empty, dense_j=empty)

    sizes = [lv_off[i + 1] - lv_off[i] for i in range(len(lv_off) - 1)]
    n_pcr = pcr_split(sizes, dense_tail)
    t0 = lv_off[n_pcr]
    slots_cat = np.concatenate(slots).astype(np.int64)
    node_to_slot = np.full(len(schedule.free), -1, np.int64)
    node_to_slot[slots_cat] = np.arange(len(slots_cat))
    conn_np = np.asarray(schedule.conn, np.int64)
    te = np.nonzero(schedule.tree_edge)[0]
    sa = node_to_slot[conn_np[te, 0]]
    sb = node_to_slot[conn_np[te, 1]]
    both = (sa >= t0) & (sb >= t0)
    return TreePlan(
        meta=TreeMeta(level_offsets=tuple(lv_off),
                      path_offsets=tuple(pa_off),
                      level_steps=tuple(steps), k_scale=k_scale,
                      n_pcr=n_pcr),
        tree_edge=tree_edge, k3=k3_t,
        slots=idx(slots), left_elem=idx(le), left_fill=idx(lf),
        left_fill_flip=flag(lff), first_gpos=idx(fgp), last_gpos=idx(lgp),
        att_elem=idx(a_e), att_fill=idx(a_f), att_flip=flag(a_fl),
        att_tgt=idx(a_tg), has_fill=flag(hasf),
        dense_eid=idx([te[both]]), dense_i=idx([sa[both] - t0]),
        dense_j=idx([sb[both] - t0]))


def build_fast_factor_data(schedule: TreeSchedule, k3: np.ndarray,
                           chain_host: dict, dtype, device) -> FastFactorData:
    """Host-resolved tables of the gather-free factorization (the
    reference builds them inline in ``model.build_model``)."""
    tree_pad = np.concatenate([np.asarray(schedule.tree_edge),
                               np.zeros(1, bool)])
    lk = np.concatenate([lv.left_kind for lv in schedule.levels])
    lid = np.concatenate([lv.left_id for lv in schedule.levels])
    left_k3 = np.zeros((len(lk), 3, 3))
    is_le = lk == KIND_ELEM
    left_k3[is_le] = k3[lid[is_le]]
    # unified-order invariant (host, once per mesh): the left edge of slot
    # s is chain edge s-1 for every KIND_ELEM slot; bound-check both ends
    ce_h = np.asarray(chain_host["chain_elem"])
    ile = np.nonzero(is_le)[0]
    shift_ok = bool(len(ile) == 0
                    or (ile[0] > 0 and ile[-1] - 1 < len(ce_h)
                        and np.array_equal(lid[ile], ce_h[ile - 1])))
    return FastFactorData(
        chain_tree=torch.as_tensor(tree_pad[chain_host["chain_elem"]],
                                   device=device),
        jump_tree=torch.as_tensor(tree_pad[chain_host["jump_elem"]],
                                  device=device),
        left_k3=torch.as_tensor(left_k3.transpose(1, 2, 0).reshape(9, -1),
                                dtype=dtype, device=device),
        ja=torch.as_tensor(np.asarray(chain_host["ja"], np.int64),
                           device=device),
        jb=torch.as_tensor(np.asarray(chain_host["jb"], np.int64),
                           device=device),
        meta=FastMeta(level_left_fill=tuple(
            bool(np.any(lv.left_kind == KIND_FILL))
            for lv in schedule.levels), left_is_chain_shift=shift_ok))


# ---------------------------------------------------------------------------
# batched 3x3 block algebra on (P, 3, 3) / (P, 3), component-unrolled in the
# reference's order
# ---------------------------------------------------------------------------

def _mm(a, b):
    return (a[:, :, 0:1] * b[:, 0:1, :] + a[:, :, 1:2] * b[:, 1:2, :]
            + a[:, :, 2:3] * b[:, 2:3, :])


def _mv(m, v):
    return m[:, :, 0] * v[:, 0:1] + m[:, :, 1] * v[:, 1:2] \
        + m[:, :, 2] * v[:, 2:3]


def _mtv(m, v):
    return m[:, 0, :] * v[:, 0:1] + m[:, 1, :] * v[:, 1:2] \
        + m[:, 2, :] * v[:, 2:3]


def _pad1(x, value):
    return torch.cat([x, x.new_full((1,) + tuple(x.shape[1:]), value)])


def chain_tree_diag(plan: TreePlan, fast: FastFactorData, cplan,
                    active, free_chain, reg: float, chain_act_b=None,
                    jump_act_b=None):
    """(9, N) component planes of the tree-PC diagonal in CHAIN order:
    chain shifts plus one jump scatter. Pinned rows are identity."""
    dtype = plan.k3.dtype
    if chain_act_b is None or jump_act_b is None:
        act_pad = _pad1(active.to(torch.bool), False)
        chain_act_b = act_pad[cplan.chain_elem]
        jump_act_b = act_pad[cplan.jump_elem]
    m_c = (chain_act_b & fast.chain_tree).to(dtype)
    nc = cplan.chain_n
    kd_c = (cplan.chain_kax - cplan.chain_kbd) * m_c
    kb_c = cplan.chain_kbd * m_c
    m_j = (jump_act_b & fast.jump_tree).to(dtype)
    njp = cplan.jump_n
    kd_j = (cplan.jump_kax - cplan.jump_kbd) * m_j
    kb_j = cplan.jump_kbd * m_j
    n_chain = free_chain.shape[0]
    kj = []
    for i in range(3):
        for j in range(3):
            k3j = njp[i] * njp[j] * kd_j
            kj.append(k3j + kb_j if i == j else k3j)
    kj = torch.stack(kj)                                    # (9, Jp)
    jidx = torch.cat([fast.ja, fast.jb])
    jump = kj.new_zeros((9, n_chain + 1))                   # col N: padding
    jump.index_add_(1, jidx, torch.cat([kj, kj], dim=1))
    zero1 = kj.new_zeros((1,))
    planes = []
    for i in range(3):
        for j in range(3):
            # (kax - kbd) n n^T + kbd I, the association of element_k3
            k3c = nc[i] * nc[j] * kd_c
            if i == j:
                k3c = k3c + kb_c
            p = k3c + torch.cat([zero1, k3c[:-1]])         # both ends
            p = p + jump[3 * i + j, :n_chain]
            if i == j:
                p = torch.where(free_chain, p + reg, 1.0)
            else:
                p = torch.where(free_chain, p, 0.0)
            planes.append(p)
    return torch.stack(planes)


def _dense_tail_factor(plan: TreePlan, D_tail, dacc_tail, ke, fill_B):
    """Dense inverse of the tail levels' junction-Schur system, assembled
    in the flat (3Sd, 3Sd) layout. D_tail/dacc_tail (9, Sd); ke (Ed,3,3);
    fill_B (P+1, 9)."""
    meta = plan.meta
    S_tot = plan.n_slots
    t0 = meta.level_offsets[n_pcr_levels(meta)]
    Sd = S_tot - t0
    M = D_tail.new_zeros((3 * Sd, 3 * Sd))
    ar = torch.arange(Sd, device=M.device)
    p_pcr = meta.path_offsets[n_pcr_levels(meta)]
    if p_pcr:
        tgt = plan.att_tgt[:p_pcr]
        both = (plan.has_fill[:p_pcr]
                & (tgt[:, 0] >= t0) & (tgt[:, 0] < S_tot)
                & (tgt[:, 1] >= t0) & (tgt[:, 1] < S_tot))
        fb = fill_B[:p_pcr].reshape(-1, 3, 3) * both[:, None, None]
        ti = (tgt[:, 0] - t0).clamp(0, Sd - 1)
        tj = (tgt[:, 1] - t0).clamp(0, Sd - 1)
    di, dj = plan.dense_i, plan.dense_j
    for a in range(3):
        for b in range(3):
            M.index_put_((3 * ar + a, 3 * ar + b),
                         D_tail[3 * a + b] + dacc_tail[3 * a + b],
                         accumulate=True)
            M.index_put_((3 * di + a, 3 * dj + b), ke[:, a, b],
                         accumulate=True)
            M.index_put_((3 * dj + a, 3 * di + b), ke[:, b, a],
                         accumulate=True)
            if p_pcr:
                M.index_put_((3 * ti + a, 3 * tj + b), fb[:, a, b],
                             accumulate=True)
                M.index_put_((3 * tj + a, 3 * ti + b), fb[:, b, a],
                             accumulate=True)
    return torch.linalg.inv(M)


def left_couplings(plan: TreePlan, fast: FastFactorData, active,
                   free_chain, n_elems: int, chain_act_b=None):
    """(9, S) left-edge element couplings B[s] = K[slot s-1, slot s]:
    the static k3 table masked by active and both-ends-free (fill edges
    are added per level by the factorization)."""
    S_tot = plan.n_slots
    if chain_act_b is not None and fast.meta.left_is_chain_shift:
        # unified order: the left edge of slot s is chain edge s-1
        la = torch.cat([chain_act_b.new_zeros((1,)),
                        chain_act_b[:S_tot - 1]]) & (plan.left_elem < n_elems)
    else:
        la = _pad1(active.to(torch.bool), False)[plan.left_elem]
    fc = free_chain[:S_tot]
    fprev = torch.cat([fc.new_zeros((1,)), fc[:-1]])
    return -fast.left_k3 * (la & fc & fprev).to(fast.left_k3.dtype)


def tree_factor_fast(plan: TreePlan, fast: FastFactorData, cplan,
                     active, free_now, free_chain, reg: float, conn,
                     chain_act_b=None, jump_act_b=None) -> TreeFactor:
    """The numeric factorization under the unified ordering. Every PCR
    level goes through ``kernels.pcr_factor`` (K2 on CUDA), which returns
    the level's coefficients and its 6-column corner solve together."""
    meta = plan.meta
    k3 = plan.k3
    S_tot = plan.n_slots
    P_tot = plan.n_paths
    dtype = k3.dtype
    E = conn.shape[0]

    D_g = chain_tree_diag(plan, fast, cplan, active, free_chain, reg,
                          chain_act_b, jump_act_b)[:, :S_tot]
    B_elem = left_couplings(plan, fast, active, free_chain, E, chain_act_b)
    act_pad = _pad1(active.to(torch.bool), False)
    conn_pad = _pad1(conn, 0)
    tree_pad = _pad1(plan.tree_edge, False)
    free_pad = _pad1(free_now, False)
    k3_pad = _pad1(k3, 0.0)

    def k_att(idx):
        flat = idx.reshape(-1)
        c = conn_pad[flat]
        m = (act_pad[flat] & tree_pad[flat] & free_pad[c[:, 0]]
             & free_pad[c[:, 1]] & (c[:, 0] != c[:, 1]))
        out = -k3_pad[flat] * m[:, None, None].to(dtype)
        return out.reshape(tuple(idx.shape) + (3, 3))

    fill_B = k3.new_zeros((P_tot + 1, 9))                  # row-major
    dacc = k3.new_zeros((9, S_tot + 1))

    alphas, betas, dinvs, attb = [], [], [], []
    L = n_pcr_levels(meta)
    for li in range(L):
        s0, s1 = meta.level_offsets[li], meta.level_offsets[li + 1]
        p0, p1 = meta.path_offsets[li], meta.path_offsets[li + 1]
        D_l = D_g[:, s0:s1] + dacc[:, s0:s1]
        B_l = B_elem[:, s0:s1]
        if fast.meta.level_left_fill[li]:
            bf = fill_B[plan.left_fill[s0:s1]]             # (S_l, 9)
            flip = plan.left_fill_flip[s0:s1]
            B_l = B_l + torch.where(flip, bf[:, TRANSPOSE9].T, bf.T)

        fg = plan.first_gpos[p0:p1] - s0
        lg = plan.last_gpos[p0:p1] - s0
        ab = k_att(plan.att_elem[p0:p1]) \
            + fill_B[plan.att_fill[p0:p1]].reshape(-1, 2, 3, 3)
        ab = torch.where(plan.att_flip[p0:p1, :, None, None],
                         ab.transpose(-1, -2), ab)
        attb.append(ab)

        al, be, dinv, xc = pcr_factor(D_l.contiguous(), B_l.contiguous(),
                                      fg, lg, meta.level_steps[li])
        alphas.append(al)
        betas.append(be)
        dinvs.append(dinv)
        x3 = xc.reshape(3, 6, -1)
        Mff = x3[:, 0:3][:, :, fg].permute(2, 0, 1)
        Mll = x3[:, 3:6][:, :, lg].permute(2, 0, 1)
        Mfl = x3[:, 3:6][:, :, fg].permute(2, 0, 1)
        bl, br = ab[:, 0], ab[:, 1]
        dg_l = -_mm(_mm(bl, Mff), bl.transpose(-1, -2))
        dg_r = -_mm(_mm(br, Mll), br.transpose(-1, -2))
        tgt = plan.att_tgt[p0:p1]
        dacc.index_add_(1, tgt[:, 0], dg_l.reshape(-1, 9).T)
        dacc.index_add_(1, tgt[:, 1], dg_r.reshape(-1, 9).T)
        fb = -_mm(_mm(bl, Mfl), br.transpose(-1, -2))
        fb = fb * plan.has_fill[p0:p1, None, None]
        fill_B[p0:p1] = fb.reshape(-1, 9)

    att_b = torch.cat(attb) if attb else k3.new_zeros((0, 2, 3, 3))
    t0 = meta.level_offsets[L]
    sinv = (_dense_tail_factor(plan, D_g[:, t0:S_tot], dacc[:, t0:S_tot],
                               k_att(plan.dense_eid), fill_B)
            if S_tot > t0 else None)
    return TreeFactor(alphas=tuple(alphas), betas=tuple(betas),
                      dinvs=tuple(dinvs), att_b=att_b, sinv=sinv)


def tree_apply_chain_planes(plan: TreePlan, factor: TreeFactor, rp):
    """z = K_tree^{-1} r on chain-ordered (3, >= S_tot) residual planes;
    returns the (3, S_tot) slot part (callers append the grip rows)."""
    meta = plan.meta
    L = n_pcr_levels(meta)
    S_tot = plan.n_slots
    t0 = meta.level_offsets[L]
    racc = torch.cat([rp[:, :S_tot], rp.new_zeros((3, 1))], dim=1)

    ys = []
    for li in range(L):
        s0, s1 = meta.level_offsets[li], meta.level_offsets[li + 1]
        p0, p1 = meta.path_offsets[li], meta.path_offsets[li + 1]
        y = pcr_apply(factor.alphas[li], factor.betas[li], factor.dinvs[li],
                      racc[:, s0:s1].contiguous())
        ys.append(y)
        ab = factor.att_b[p0:p1]
        fg = plan.first_gpos[p0:p1] - s0
        lg = plan.last_gpos[p0:p1] - s0
        tgt = plan.att_tgt[p0:p1]
        v0 = _mv(ab[:, 0], y[:, fg].T)
        v1 = _mv(ab[:, 1], y[:, lg].T)
        racc.index_add_(1, tgt[:, 0], -v0.T)
        racc.index_add_(1, tgt[:, 1], -v1.T)

    u_all = rp.new_zeros((3, S_tot + 1))
    if S_tot > t0:
        r_tail = racc[:, t0:S_tot].T.reshape(-1)
        u_all[:, t0:S_tot] = (factor.sinv @ r_tail).reshape(-1, 3).T
    for li in range(L - 1, -1, -1):
        s0, s1 = meta.level_offsets[li], meta.level_offsets[li + 1]
        p0, p1 = meta.path_offsets[li], meta.path_offsets[li + 1]
        ab = factor.att_b[p0:p1]
        fg = plan.first_gpos[p0:p1] - s0
        lg = plan.last_gpos[p0:p1] - s0
        tgt = plan.att_tgt[p0:p1]
        z0 = _mtv(ab[:, 0], u_all[:, tgt[:, 0]].T)
        z1 = _mtv(ab[:, 1], u_all[:, tgt[:, 1]].T)
        z = rp.new_zeros((3, s1 - s0))
        z.index_add_(1, fg, z0.T)
        z.index_add_(1, lg, z1.T)
        corr = pcr_apply(factor.alphas[li], factor.betas[li],
                         factor.dinvs[li], z)
        u_all[:, s0:s1] = ys[li] - corr
    return u_all[:, :S_tot]
