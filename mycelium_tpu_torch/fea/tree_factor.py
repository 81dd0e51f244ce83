"""Spanning-forest preconditioner on the device (port of
``mycelium_tpu/fea/tree_jax.py``: ``build_tree_plan``, ``FastFactorData``,
``chain_tree_diag``, ``tree_factor_fast``, the dense junction tail and
``tree_apply_chain_planes``).

The host schedule (``fea/tree.py``) is flattened into one global slot
space; under the unified ordering (``model._unified_order``) slot s IS
chain position s, so the factorization assembles its diagonal from chain
shifts and the apply works on chain-ordered residual planes directly.
Each level's block-tridiagonal solves run as parallel cyclic reduction:
K2 factors a level and K3 applies it, on CUDA tensors through the plan's
bound launch (``kernels.PcrLaunch``, ``build_pcr_launch``: one K2 launch
a level, one K3 launch a level and sweep); on CPU tensors the plain
versions (the counterparts of ``_pcr_coeffs``/``_pcr_apply``). The
trailing levels whose slots fit ``tree_dense_tail`` are solved as one
dense junction-Schur inverse (``torch.linalg.inv``, as the reference),
its matrix summed in one fixed order (``dense_tail_matrix``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ..kernels.build import TREE_CG_WINDOW
from ..kernels.ordered_sum import ordered_sum
from ..kernels.pcr import (PcrLaunch, SweepTables, pcr_apply, pcr_factor,
                           transpose9)
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
    # the attachments by junction slot (``attachment_csr``): slot s's
    # entries 2·path + side are att_ent[att_ptr[s]:att_ptr[s+1]], in the
    # order (level, side, path) of a sequential index_add_ over the levels
    att_ptr: Optional[torch.Tensor] = None   # (S+1,) int32
    att_ent: Optional[torch.Tensor] = None   # (n_att,) int32
    # the dense tail's matrix by entry (``dense_tail_list``): entry
    # dense_pos[i] of the flat (3Sd, 3Sd) matrix is the sum of the terms
    # dense_ent[dense_ptr[i]:dense_ptr[i+1]], in the order in which the
    # sequential index_put_ of the reference's assembly adds them;
    # dense_fill (P_pcr,) the PCR paths whose fill lands in the tail
    dense_pos: Optional[torch.Tensor] = None  # (n_entries,) int64
    dense_ptr: Optional[torch.Tensor] = None  # (n_entries+1,) int32
    dense_ent: Optional[torch.Tensor] = None  # (n_terms,) int32
    dense_fill: Optional[torch.Tensor] = None  # (P_pcr,) bool

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
    # the cluster coarse inverse (tree_coarse_weight > 0): it shares the
    # factor's (active, free) invariants, so the ramp reuses it with it
    coarse_ainv: Optional[torch.Tensor] = None


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


def attachment_csr(tgt: np.ndarray, path_offsets, S: int):
    """The attachments by junction slot: ``tgt`` (P, 2) junction slots (S
    for none). Returns host (ptr (S+1,), ent) int64, slot s's entries
    2·path + side in the order (level, side, path) in which a sequential
    ``index_add_`` over the levels, side 0 then side 1, adds them."""
    tgt = np.asarray(tgt, np.int64).reshape(-1)
    path_level = np.repeat(np.arange(len(path_offsets) - 1),
                           np.diff(np.asarray(path_offsets, np.int64)))
    ent = np.nonzero(tgt < S)[0]
    key = np.lexsort((ent >> 1, ent & 1, path_level[ent >> 1], tgt[ent]))
    ptr = np.zeros(S + 1, np.int64)
    ptr[1:] = np.cumsum(np.bincount(tgt[ent], minlength=S))
    return ptr, ent[key]


def dense_tail_list(meta: TreeMeta, att_tgt: np.ndarray, has_fill,
                    dense_i: np.ndarray, dense_j: np.ndarray, S: int):
    """The dense tail's matrix as a contribution list, host arrays: (pos,
    ptr, ent, fill). The terms of one factorization are, flat: the
    diagonal blocks D + dacc (9, Sd) at c·Sd + i, the tail's element
    couplings ke (Ed, 3, 3) at 9Sd + 9e + 3a + b and the fill couplings
    of the PCR paths fb (P_pcr, 3, 3) at 9Sd + 9Ed + 9p + 3a + b. Each
    entry pos (row·3Sd + col) receives ent[ptr[i]:ptr[i+1]] in the order
    in which the reference's assembly (per (a, b): the diagonal, both
    orientations of ke, both of fb; each by index) adds them. ``fill``:
    the PCR paths with a fill whose two junctions lie in the tail (the
    others add a zero, clamped into the tail as the reference does)."""
    L = n_pcr_levels(meta)
    t0, p_pcr = meta.level_offsets[L], meta.path_offsets[L]
    Sd, Ed = S - t0, len(dense_i)
    tgt = np.asarray(att_tgt, np.int64).reshape(-1, 2)[:p_pcr]
    fill = (np.asarray(has_fill, bool)[:p_pcr]
            & (tgt[:, 0] >= t0) & (tgt[:, 0] < S)
            & (tgt[:, 1] >= t0) & (tgt[:, 1] < S))
    if Sd <= 0:
        z = np.zeros(0, np.int64)
        return z, np.zeros(1, np.int64), z, fill
    n = 3 * Sd
    ar, e9 = np.arange(Sd), 9 * Sd + 9 * np.arange(Ed)
    f9 = 9 * Sd + 9 * Ed + 9 * np.arange(p_pcr)
    di, dj = np.asarray(dense_i, np.int64), np.asarray(dense_j, np.int64)
    ti, tj = (np.clip(tgt[:, k] - t0, 0, Sd - 1) for k in (0, 1))
    pos, term = [], []
    for a in range(3):
        for b in range(3):
            calls = [(ar, ar, (3 * a + b) * Sd + ar),
                     (di, dj, e9 + 3 * a + b), (dj, di, e9 + 3 * b + a)]
            if p_pcr:
                calls += [(ti, tj, f9 + 3 * a + b), (tj, ti, f9 + 3 * b + a)]
            for r, c, t in calls:
                pos.append((3 * r + a) * n + 3 * c + b)
                term.append(t)
    pos, term = np.concatenate(pos), np.concatenate(term)
    order = np.argsort(pos, kind="stable")
    upos, counts = np.unique(pos[order], return_counts=True)
    return upos, np.concatenate([[0], np.cumsum(counts)]), term[order], fill


def with_host_lists(plan: "TreePlan") -> "TreePlan":
    """``plan`` with its attachment CSR and its dense tail's contribution
    list, built on the host once."""
    def host(t):
        return t.cpu().numpy()
    S = plan.n_slots
    ptr, ent = attachment_csr(host(plan.att_tgt), plan.meta.path_offsets, S)
    pos, dptr, dent, fill = dense_tail_list(
        plan.meta, host(plan.att_tgt), host(plan.has_fill),
        host(plan.dense_i), host(plan.dense_j), S)
    dev = plan.att_tgt.device

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)
    return replace(plan, att_ptr=i32(ptr), att_ent=i32(ent),
                   dense_pos=torch.as_tensor(pos, device=dev),
                   dense_ptr=i32(dptr), dense_ent=i32(dent),
                   dense_fill=torch.as_tensor(fill, device=dev))


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
        return with_host_lists(TreePlan(
            meta=TreeMeta(level_offsets=(0,), path_offsets=(0,),
                          level_steps=(), k_scale=k_scale, n_pcr=0),
            tree_edge=tree_edge, k3=k3_t, slots=empty, left_elem=empty,
            left_fill=empty, left_fill_flip=flag([]), first_gpos=empty,
            last_gpos=empty, att_elem=idx([], (0, 2)),
            att_fill=idx([], (0, 2)), att_flip=flag([], (0, 2)),
            att_tgt=idx([], (0, 2)), has_fill=flag([]), dense_eid=empty,
            dense_i=empty, dense_j=empty))

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
    return with_host_lists(TreePlan(
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
        dense_j=idx([sb[both] - t0])))


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
        left_k3=torch.as_tensor(np.ascontiguousarray(
            left_k3.transpose(1, 2, 0).reshape(9, -1)), dtype=dtype,
            device=device),
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


def chain_diag(cplan, m_c, m_j, free_chain, reg: float):
    """(9, N) component planes of the per-position 3x3 diagonal block in
    CHAIN order: the chain slots' stiffness at both ends plus one jump
    scatter, each element through its mask (``m_c`` (N,), ``m_j`` (Jp,) in
    the plan's dtype); reg on a free row's diagonal, identity on a pinned
    row. The jump terms add in the order of the per-node jump CSR
    (``kernels.ordered_sum``: on the card too), as K5's and K6's set-up add
    them (``chain_op::diag_block``): the card and the CPU give the same
    bits."""
    nc = cplan.chain_n
    kd_c = (cplan.chain_kax - cplan.chain_kbd) * m_c
    kb_c = cplan.chain_kbd * m_c
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
    csr = cplan.k32 if kj.device.type == "cuda" else cplan
    jump = ordered_sum(kj, csr.jump_ptr, csr.jump_ent, n_chain, shift=1)
    zero1 = kj.new_zeros((1,))
    planes = []
    for i in range(3):
        for j in range(3):
            # (kax - kbd) n n^T + kbd I, the association of element_k3
            k3c = nc[i] * nc[j] * kd_c
            if i == j:
                k3c = k3c + kb_c
            p = k3c + torch.cat([zero1, k3c[:-1]])         # both ends
            p = p + jump[3 * i + j]
            if i == j:
                p = torch.where(free_chain, p + reg, 1.0)
            else:
                p = torch.where(free_chain, p, 0.0)
            planes.append(p)
    return torch.stack(planes)


def chain_tree_diag(plan: TreePlan, fast: FastFactorData, cplan,
                    active, free_chain, reg: float, chain_act_b=None,
                    jump_act_b=None):
    """(9, N) component planes of the tree-PC diagonal in CHAIN order:
    ``chain_diag`` through the forest's elements. Pinned rows are
    identity."""
    dtype = plan.k3.dtype
    if chain_act_b is None or jump_act_b is None:
        act_pad = _pad1(active.to(torch.bool), False)
        chain_act_b = act_pad[cplan.chain_elem]
        jump_act_b = act_pad[cplan.jump_elem]
    return chain_diag(cplan, (chain_act_b & fast.chain_tree).to(dtype),
                      (jump_act_b & fast.jump_tree).to(dtype), free_chain,
                      reg)


def dense_tail_matrix(plan: TreePlan, D_tail, dacc_tail, ke, fill_B):
    """The tail levels' junction-Schur matrix in the flat (3Sd, 3Sd)
    layout. D_tail/dacc_tail (9, Sd); ke (Ed, 3, 3); fill_B (P+1, 9).
    Each entry is the sum of its terms in the plan's contribution list
    (``dense_tail_list``), one after another on every device
    (``kernels.ordered_sum``): the bits of the reference's sequential
    ``index_put_`` assembly on the CPU, and the same on the card."""
    meta = plan.meta
    L = n_pcr_levels(meta)
    Sd = plan.n_slots - meta.level_offsets[L]
    p_pcr = meta.path_offsets[L]
    terms = [(D_tail + dacc_tail).reshape(-1), ke.reshape(-1)]
    if p_pcr:
        terms.append((fill_B[:p_pcr] * plan.dense_fill[:, None]).reshape(-1))
    n = plan.dense_pos.shape[0]
    sums = ordered_sum(torch.cat(terms)[None], plan.dense_ptr,
                       plan.dense_ent, n)
    M = D_tail.new_zeros(9 * Sd * Sd)
    M[plan.dense_pos] = sums[0]
    return M.view(3 * Sd, 3 * Sd)


def _dense_tail_factor(plan: TreePlan, D_tail, dacc_tail, ke, fill_B):
    """Dense inverse of the tail levels' junction-Schur system
    (``dense_tail_matrix``)."""
    return torch.linalg.inv(dense_tail_matrix(plan, D_tail, dacc_tail, ke,
                                              fill_B))


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


def attachment_couplings(plan: TreePlan, active, free_now, conn, idx):
    """-k3 of the elements ``idx`` (any shape, sentinel E), masked by
    active, forest membership, both ends free and not a self-loop:
    idx.shape + (3, 3)."""
    act_pad = _pad1(active.to(torch.bool), False)
    conn_pad = _pad1(conn, 0)
    tree_pad = _pad1(plan.tree_edge, False)
    free_pad = _pad1(free_now, False)
    k3_pad = _pad1(plan.k3, 0.0)
    flat = idx.reshape(-1)
    c = conn_pad[flat]
    m = (act_pad[flat] & tree_pad[flat] & free_pad[c[:, 0]]
         & free_pad[c[:, 1]] & (c[:, 0] != c[:, 1]))
    out = -k3_pad[flat] * m[:, None, None].to(plan.k3.dtype)
    return out.reshape(tuple(idx.shape) + (3, 3))


def tree_factor_inputs(plan: TreePlan, fast: FastFactorData, cplan,
                       active, free_now, free_chain, reg: float, conn,
                       chain_act_b=None, jump_act_b=None):
    """The per-solve numeric inputs of the factorization: the (9, S) forest
    diagonal, the (9, S) left-edge element couplings and the (P, 2, 3, 3)
    attachment element couplings."""
    S_tot = plan.n_slots
    D_g = chain_tree_diag(plan, fast, cplan, active, free_chain, reg,
                          chain_act_b, jump_act_b)[:, :S_tot]
    B_elem = left_couplings(plan, fast, active, free_chain, conn.shape[0],
                            chain_act_b)
    katt = attachment_couplings(plan, active, free_now, conn, plan.att_elem)
    return D_g, B_elem, katt


def tree_factor_levels(plan: TreePlan, D_g, B_elem, katt, n_levels: int,
                       level_left_fill=None, launch=None):
    """The first ``n_levels`` levels' PCR factorization from
    ``tree_factor_inputs``: every level goes through K2, which returns the
    level's coefficients and its 6-column corner solve together: on CUDA
    tensors the plan's bound launch (``launch``, a
    ``kernels.PcrLaunch``: one launch a windowed level) or, without
    one, the unbound ``kernels.pcr_factor``; on CPU tensors the plain
    version. Each junction slot's Schur corrections add in the order
    (level, side, path) of the plan's attachment CSR, on every device
    (``kernels.ordered_sum``), the order of a sequential ``index_add_``.
    Returns (alphas, betas, dinvs, att_b, fill_B, dacc);
    ``level_left_fill[li]`` False skips a level's fill gather."""
    meta = plan.meta
    k3 = plan.k3
    P, S_tot = plan.n_paths, plan.n_slots
    fill_B = k3.new_zeros((P + 1, 9))                       # row-major
    # the Schur corrections by attachment entry 2·path + side; a level's
    # entries are written once it is factored, so a slot's sum at its own
    # level holds exactly the earlier levels' terms (the rest are +0)
    dg = k3.new_zeros((P, 2, 9))
    dg_planes = dg.view(2 * P, 9).T

    alphas, betas, dinvs, attb = [], [], [], []
    for li in range(n_levels):
        s0, s1 = meta.level_offsets[li], meta.level_offsets[li + 1]
        p0, p1 = meta.path_offsets[li], meta.path_offsets[li + 1]
        D_l = D_g[:, s0:s1] + ordered_sum(dg_planes, plan.att_ptr[s0:s1 + 1],
                                          plan.att_ent, s1 - s0)
        B_l = B_elem[:, s0:s1]
        if level_left_fill is None or level_left_fill[li]:
            bf = fill_B[plan.left_fill[s0:s1]].T             # (9, S_l)
            flip = plan.left_fill_flip[s0:s1]
            B_l = B_l + torch.where(flip, transpose9(bf), bf)

        fg = plan.first_gpos[p0:p1] - s0
        lg = plan.last_gpos[p0:p1] - s0
        ab = katt[p0:p1] \
            + fill_B[plan.att_fill[p0:p1]].reshape(-1, 2, 3, 3)
        ab = torch.where(plan.att_flip[p0:p1, :, None, None],
                         ab.transpose(-1, -2), ab)
        attb.append(ab)

        D_l, B_l = D_l.contiguous(), B_l.contiguous()
        al, be, dinv, xc = (
            pcr_factor(D_l, B_l, fg, lg, meta.level_steps[li])
            if launch is None else launch.factor(li, D_l, B_l))
        alphas.append(al)
        betas.append(be)
        dinvs.append(dinv)
        x3 = xc.reshape(3, 6, -1)
        Mff = x3[:, 0:3][:, :, fg].permute(2, 0, 1)
        Mll = x3[:, 3:6][:, :, lg].permute(2, 0, 1)
        Mfl = x3[:, 3:6][:, :, fg].permute(2, 0, 1)
        bl, br = ab[:, 0], ab[:, 1]
        dg[p0:p1, 0] = -_mm(_mm(bl, Mff), bl.transpose(-1, -2)).reshape(-1, 9)
        dg[p0:p1, 1] = -_mm(_mm(br, Mll), br.transpose(-1, -2)).reshape(-1, 9)
        fb = -_mm(_mm(bl, Mfl), br.transpose(-1, -2))
        fb = fb * plan.has_fill[p0:p1, None, None]
        fill_B[p0:p1] = fb.reshape(-1, 9)

    att_b = torch.cat(attb) if attb else k3.new_zeros((0, 2, 3, 3))
    dacc = torch.cat([ordered_sum(dg_planes, plan.att_ptr, plan.att_ent,
                                  S_tot), k3.new_zeros((9, 1))], dim=1)
    return tuple(alphas), tuple(betas), tuple(dinvs), att_b, fill_B, dacc


def tree_factor_fast(plan: TreePlan, fast: FastFactorData, cplan,
                     active, free_now, free_chain, reg: float, conn,
                     chain_act_b=None, jump_act_b=None,
                     launch=None) -> TreeFactor:
    """The numeric factorization under the unified ordering: the first
    meta.n_pcr levels by PCR (through K2's bound ``launch`` on the card,
    ``build_pcr_launch``), the rest as one dense junction inverse."""
    meta = plan.meta
    S_tot = plan.n_slots
    D_g, B_elem, katt = tree_factor_inputs(
        plan, fast, cplan, active, free_now, free_chain, reg, conn,
        chain_act_b, jump_act_b)
    L = n_pcr_levels(meta)
    alphas, betas, dinvs, att_b, fill_B, dacc = tree_factor_levels(
        plan, D_g, B_elem, katt, L, fast.meta.level_left_fill, launch)
    t0 = meta.level_offsets[L]
    sinv = (_dense_tail_factor(
        plan, D_g[:, t0:S_tot], dacc[:, t0:S_tot],
        attachment_couplings(plan, active, free_now, conn, plan.dense_eid),
        fill_B) if S_tot > t0 else None)
    return TreeFactor(alphas=alphas, betas=betas, dinvs=dinvs, att_b=att_b,
                      sinv=sinv)


def tree_forward_sweep(plan: TreePlan, factor: TreeFactor, rp):
    """The forward half of ``tree_apply_chain_planes``: per PCR level
    y = T_l^{-1} r_l, where r_l is rp on the level's slots minus the
    attachment products of earlier levels' paths, added to each junction
    slot in the plan's attachment order (level, side, path) on every
    device (``kernels.ordered_sum``); and the dense tail's right-hand side
    the same way. Returns (ys, r_tail (3, S - t0))."""
    meta = plan.meta
    L = n_pcr_levels(meta)
    S_tot = plan.n_slots
    # minus the attachment products by entry 2·path + side
    nv = rp.new_zeros((plan.n_paths, 2, 3))
    nv_planes = nv.view(-1, 3).T

    def rhs(a, b):
        return ordered_sum(nv_planes, plan.att_ptr[a:b + 1], plan.att_ent,
                           b - a, init=rp[:, a:b])

    ys = []
    for li in range(L):
        s0, s1 = meta.level_offsets[li], meta.level_offsets[li + 1]
        p0, p1 = meta.path_offsets[li], meta.path_offsets[li + 1]
        y = pcr_apply(factor.alphas[li], factor.betas[li], factor.dinvs[li],
                      rhs(s0, s1))
        ys.append(y)
        ab = factor.att_b[p0:p1]
        fg = plan.first_gpos[p0:p1] - s0
        lg = plan.last_gpos[p0:p1] - s0
        nv[p0:p1, 0] = -_mv(ab[:, 0], y[:, fg].T)
        nv[p0:p1, 1] = -_mv(ab[:, 1], y[:, lg].T)
    return ys, rhs(meta.level_offsets[L], S_tot)


def tree_tail_solve(factor: TreeFactor, r_tail):
    """The dense tail's solution (3, Sd) of its right-hand side."""
    if r_tail.shape[1] == 0:
        return r_tail
    return (factor.sinv @ r_tail.T.reshape(-1)).reshape(-1, 3).T


def tree_backward_sweep(plan: TreePlan, factor: TreeFactor, ys, u_tail):
    """The backward half of ``tree_apply_chain_planes``: per PCR level from
    the last, u = y - T_l^{-1} z_l, where z_l at a path's first and last
    slot is the transposed attachment coupling times the junction's
    value (side 0, then side 1); ``u_tail`` (3, S - t0) the dense tail's
    solution. Returns the (3, S_tot) slot part."""
    meta = plan.meta
    L = n_pcr_levels(meta)
    S_tot = plan.n_slots
    t0 = meta.level_offsets[L]
    u_all = u_tail.new_zeros((3, S_tot + 1))
    if S_tot > t0:
        u_all[:, t0:S_tot] = u_tail
    for li in range(L - 1, -1, -1):
        s0, s1 = meta.level_offsets[li], meta.level_offsets[li + 1]
        p0, p1 = meta.path_offsets[li], meta.path_offsets[li + 1]
        ab = factor.att_b[p0:p1]
        fg = plan.first_gpos[p0:p1] - s0
        lg = plan.last_gpos[p0:p1] - s0
        tgt = plan.att_tgt[p0:p1]
        z0 = _mtv(ab[:, 0], u_all[:, tgt[:, 0]].T)
        z1 = _mtv(ab[:, 1], u_all[:, tgt[:, 1]].T)
        z = u_tail.new_zeros((3, s1 - s0))
        z.index_add_(1, fg, z0.T)
        z.index_add_(1, lg, z1.T)
        corr = pcr_apply(factor.alphas[li], factor.betas[li],
                         factor.dinvs[li], z)
        u_all[:, s0:s1] = ys[li] - corr
    return u_all[:, :S_tot]


def tree_apply_chain_planes(plan: TreePlan, factor: TreeFactor, rp,
                            launch: Optional[PcrLaunch] = None):
    """z = K_tree^{-1} r on chain-ordered (3, >= S_tot) residual planes;
    returns the (3, S_tot) slot part (callers append the grip rows). On
    CUDA tensors with the plan's bound launch (``launch``,
    ``build_pcr_launch``) K3's fused sweeps, 2 launches a PCR level;
    otherwise the plain version, level by level (``tree_forward_sweep``,
    the dense tail, ``tree_backward_sweep``), whose levels go through the
    unbound ``kernels.pcr_apply``: its plain version on the CPU, K3's
    halo form on the card (K6's plain version)."""
    if launch is not None and rp.device.type == "cuda":
        return launch.apply(factor, rp)
    ys, r_tail = tree_forward_sweep(plan, factor, rp)
    return tree_backward_sweep(plan, factor, ys,
                               tree_tail_solve(factor, r_tail))


# ---------------------------------------------------------------------------
# index tables of the whole-solve kernel K6 (kernels/tree_cg.py)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TreeKernelTables:
    """The plan as K6 reads it (built once per mesh): int32 index arrays
    with -1 for "none", entry 2·path + side for a path's two attachments,
    a CSR of the attachment entries by junction slot, each slot's
    entries in the order (level, side, path) in which a sequential
    ``index_add_`` over the levels adds them, the static numbers of the
    per-solve set-up (left-edge and attachment elements with their end
    nodes and couplings), and the path-aligned windows of every level."""
    lvl: torch.Tensor           # (4, L+1) int64: slot offsets, path offsets,
                                # rounds, coefficient offsets (floats)
    left_fill: torch.Tensor     # (S,) 2·producing path + flip, -1
    first_path: torch.Tensor    # (S,) the path that starts at the slot, -1
    last_path: torch.Tensor     # (S,)
    fg: torch.Tensor            # (P,) first slot
    lg: torch.Tensor            # (P,) last slot
    has_fill: torch.Tensor      # (P,)
    att_tgt: torch.Tensor       # (2P,) junction slot, S for none
    att_fill: torch.Tensor      # (2P,) producing path, -1
    att_flip: torch.Tensor      # (2P,)
    att_ptr: torch.Tensor       # (S+1,)
    att_ent: torch.Tensor       # (n_att,)
    smax: int                   # slots of the largest level
    coef_floats: int            # sum over levels of rounds · 9 · slots
    max_steps: int
    ordered: bool               # every fill and attachment points from an
                                # earlier level to a later one
    # the per-solve set-up
    left_elem: torch.Tensor     # (S,) int32 left-edge element, -1
    att_elem: torch.Tensor      # (2P,) int32 attachment element; -1 where
                                # there is none, it is no forest edge or it
                                # is a self-loop
    att_na: torch.Tensor        # (2P,) int32 its end nodes (0 for none)
    att_nb: torch.Tensor
    att_k3: torch.Tensor        # (2P, 9) its coupling k3, 0 for none
    # path-aligned windows: runs of consecutive whole paths of at most
    # ``window`` slots; a level whose longest path is longer has none and
    # keeps the global rounds (``windowed[li]`` False)
    window: int
    windowed: tuple             # per level
    wlv: torch.Tensor           # (2, L+1) int64: window offsets, windowed
    win_start: torch.Tensor     # (n_windows,) int32 first slot (global)
    win_len: torch.Tensor       # (n_windows,) int32
    smax_global: int            # slots of the largest level on global rounds
    max_steps_global: int       # its most rounds (-1: none)


# slots of a path-aligned window of K6: the kernel's compile-time constant
TREE_WINDOW = TREE_CG_WINDOW


def path_windows(fg, lg, lo, po, window: int):
    """Per level the windows of at most ``window`` slots that cut only at
    path ends, packed greedily in path order: (windowed flags, window
    offsets per level (L+1,), starts, lengths), host arrays, slots global.
    A level is windowed when its paths tile its slot range in order and
    none is longer than ``window``."""
    L = len(lo) - 1
    flags, off, starts, lens = [], [0], [], []
    for li in range(L):
        f, l = fg[po[li]:po[li + 1]], lg[po[li]:po[li + 1]]
        tiled = bool(len(f) and f[0] == lo[li] and l[-1] == lo[li + 1] - 1
                     and np.array_equal(f[1:], l[:-1] + 1)
                     and np.all(l >= f))
        ok = tiled and int((l - f + 1).max()) <= window
        flags.append(ok)
        if ok:
            ends = np.concatenate([f, [lo[li + 1]]])    # path boundaries
            i = 0
            while i < len(f):
                j = int(np.searchsorted(ends, ends[i] + window,
                                        side="right")) - 1
                starts.append(ends[i])
                lens.append(ends[j] - ends[i])
                i = j
        off.append(len(starts))
    return (tuple(flags), np.asarray(off, np.int64),
            np.asarray(starts, np.int64), np.asarray(lens, np.int64))


def build_pcr_launch(plan: TreePlan, window: int = TREE_WINDOW) -> PcrLaunch:
    """K2 and K3 bound to the plan's PCR levels (``kernels.PcrLaunch``):
    per level its corner flags and K6's path-aligned windows, where the
    level has them (``window`` is lowered by tests only), and the sweep's
    tables (``kernels.pcr.SweepTables``)."""
    meta = plan.meta
    L = n_pcr_levels(meta)
    S = plan.n_slots
    lo = np.asarray(meta.level_offsets, np.int64)[:L + 1]
    po = np.asarray(meta.path_offsets, np.int64)[:L + 1]
    fg, lg = plan.first_gpos.cpu().numpy(), plan.last_gpos.cpu().numpy()
    windowed, woff, wstart, wlen = path_windows(fg, lg, lo, po, window)
    levels = []
    for li in range(L):
        sl = int(lo[li + 1] - lo[li])
        corner = np.zeros(sl, np.int32)
        corner[fg[po[li]:po[li + 1]] - lo[li]] |= 1
        corner[lg[po[li]:po[li + 1]] - lo[li]] |= 2
        w = slice(woff[li], woff[li + 1])
        levels.append((sl, meta.level_steps[li], corner,
                       (wstart[w] - lo[li], wlen[w]) if windowed[li]
                       else None))
    # the sweep: the path ends by PCR slot, the attachments by junction
    t0, P = int(lo[L]), int(po[L])
    first_path = np.full(t0, -1, np.int64)
    last_path = np.full(t0, -1, np.int64)
    first_path[fg[:P]] = np.arange(P)
    last_path[lg[:P]] = np.arange(P)
    ptr = plan.att_ptr.cpu().numpy().astype(np.int64)
    ent = plan.att_ent.cpu().numpy().astype(np.int64)
    tgt = plan.att_tgt[:P].cpu().numpy().reshape(-1)
    slot = np.repeat(np.arange(S), np.diff(ptr))
    from_pcr = (ent >> 1) < P
    tail = (slot >= t0) & from_pcr
    tail_ptr = np.concatenate([[0], np.cumsum(np.bincount(
        slot[tail] - t0, minlength=S - t0))])
    slot_level = np.repeat(np.arange(L), np.diff(lo))
    path_level = np.repeat(np.arange(L), np.diff(po))
    at_pcr = slot < t0
    ordered = bool(
        np.all(from_pcr[at_pcr])
        and np.all(path_level[ent[at_pcr] >> 1] < slot_level[slot[at_pcr]])
        and np.all((tgt >= S) | (tgt >= lo[1:][np.repeat(path_level, 2)]))
        and len(np.unique(fg[:P])) == P and len(np.unique(lg[:P])) == P)
    return PcrLaunch(levels, SweepTables(
        level_offsets=tuple(lo), path_offsets=tuple(po), n_slots=S,
        first_path=first_path, last_path=last_path, att_ptr=ptr,
        att_ent=ent, att_tgt=tgt, tail_ptr=tail_ptr,
        tail_ent=ent[tail], ordered=ordered), plan.slots.device)


def build_tree_kernel_tables(plan: TreePlan, conn,
                             window: int = TREE_WINDOW) -> TreeKernelTables:
    """``conn`` (E, 2) is the model's element table; ``window`` (at most
    the kernel's compile-time ``TREE_WINDOW``) is lowered by tests to
    exercise the levels that cannot be windowed."""
    meta = plan.meta
    L = len(meta.level_steps)
    S, P = plan.n_slots, plan.n_paths
    dev = plan.slots.device
    lo = np.asarray(meta.level_offsets, np.int64)
    po = np.asarray(meta.path_offsets, np.int64)
    steps = np.asarray(meta.level_steps + (0,), np.int64)
    sizes = np.diff(lo)
    coef = np.concatenate([[0], np.cumsum(steps[:L] * 9 * sizes)])
    slot_level = np.repeat(np.arange(L), sizes)
    path_level = np.repeat(np.arange(L), np.diff(po))

    def host(t):
        return t.cpu().numpy()

    lf, lff = host(plan.left_fill), host(plan.left_fill_flip)
    left_fill = np.where(lf < P, 2 * lf + lff, -1)
    fg, lg = host(plan.first_gpos), host(plan.last_gpos)
    first_path = np.full(S, -1, np.int64)
    last_path = np.full(S, -1, np.int64)
    first_path[fg] = np.arange(P)
    last_path[lg] = np.arange(P)
    tgt = host(plan.att_tgt).reshape(-1)
    af = host(plan.att_fill).reshape(-1)
    att_fill = np.where(af < P, af, -1)
    ent = np.nonzero(tgt < S)[0]                  # entry = 2·path + side
    att_ptr, att_ent = attachment_csr(tgt, po, S)
    has_lf = left_fill >= 0
    ordered = bool(
        np.all(path_level[lf[has_lf]] < slot_level[has_lf])
        and np.all(path_level[af[af < P]]
                   < path_level[np.nonzero(af < P)[0] >> 1])
        and np.all(slot_level[tgt[ent]] > path_level[ent >> 1])
        and len(np.unique(fg)) == P and len(np.unique(lg)) == P)

    # the set-up's static numbers, as attachment_couplings and
    # left_couplings gather them
    conn_np = host(conn).astype(np.int64)
    E = conn_np.shape[0]
    le = host(plan.left_elem)
    ae = host(plan.att_elem).reshape(-1)
    real = ae < E
    aes = np.where(real, ae, 0)
    na = np.where(real, conn_np[aes, 0] if E else 0, 0)
    nb = np.where(real, conn_np[aes, 1] if E else 0, 0)
    ok = real & (host(plan.tree_edge)[aes] if E else False) & (na != nb)
    k3 = host(plan.k3).reshape(E, 9)
    att_k3 = np.where(real[:, None], k3[aes] if E else 0.0, 0.0)

    if window > TREE_WINDOW:
        raise ValueError(f"window {window} exceeds the kernel's "
                         f"{TREE_WINDOW}")
    windowed, woff, wstart, wlen = path_windows(fg, lg, lo, po, window)
    glob = [li for li in range(L) if not windowed[li]]

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=dev)

    return TreeKernelTables(
        lvl=torch.as_tensor(np.stack([lo, po, steps, coef]), device=dev),
        left_fill=i32(left_fill), first_path=i32(first_path),
        last_path=i32(last_path), fg=i32(fg), lg=i32(lg),
        has_fill=i32(host(plan.has_fill)), att_tgt=i32(tgt),
        att_fill=i32(att_fill), att_flip=i32(host(plan.att_flip).reshape(-1)),
        att_ptr=i32(att_ptr), att_ent=i32(att_ent),
        smax=int(sizes.max()) if L else 0, coef_floats=int(coef[-1]),
        max_steps=int(steps.max()), ordered=ordered,
        left_elem=i32(np.where(le < E, le, -1)),
        att_elem=i32(np.where(ok, ae, -1)), att_na=i32(na), att_nb=i32(nb),
        att_k3=torch.as_tensor(np.ascontiguousarray(att_k3),
                               dtype=plan.k3.dtype, device=dev),
        window=int(window), windowed=windowed,
        wlv=torch.as_tensor(np.stack([
            woff, np.asarray(windowed + (False,), np.int64)]), device=dev),
        win_start=i32(wstart), win_len=i32(wlen),
        smax_global=max([int(sizes[li]) for li in glob], default=0),
        max_steps_global=max([int(steps[li]) for li in glob], default=-1))


# ---------------------------------------------------------------------------
# grip reachability accelerated by the tree hierarchy
# ---------------------------------------------------------------------------

def _span_or(seg, left_act, steps: int):
    """OR-propagate boolean seg values along contiguous active spans of a
    concatenated-path array, in ``steps`` doubling rounds. left_act[i] marks
    the edge (i-1, i) active; propagation never crosses inactive edges or
    path boundaries (left_act is False there)."""
    conn = torch.roll(left_act, -1)          # conn[i] = left_act[i+1]
    s = 1
    for _ in range(steps):
        seg = seg | (torch.roll(seg, -s) & conn)
        seg = seg | (torch.roll(seg, s) & torch.roll(conn, s))
        conn = conn & torch.roll(conn, -s)
        s *= 2
    return seg


def tree_anchored(plan: TreePlan, model, active):
    """Nodes reachable from a grip through active elements (port of
    ``mycelium_tpu/fea/tree_jax.py::tree_anchored``), on the model's device.

    Each fixpoint trip is one plain neighbour sweep (grip seeding and cycle
    edges) plus a sweep in slot space that hops a whole path in
    log2(longest path) doubling rounds and crosses the attachments, so a
    handful of trips do where the plain sweep (``anchored_mask_device``)
    needs the graph's diameter. Fill edges count as inactive: only the hop
    length shrinks. One host read a trip (the ``changed`` flag)."""
    meta = plan.meta
    L = len(meta.level_steps)
    grip = model.top_nodes | model.bot_nodes
    S_tot = plan.n_slots
    false1 = torch.zeros((1,), dtype=torch.bool, device=grip.device)
    act_pad = torch.cat([active.to(torch.bool), false1])
    link_ok = act_pad[model.incident]                     # (N, deg)
    left_act = act_pad[plan.left_elem]                    # (S,)
    att_act = act_pad[plan.att_elem]                      # (P, 2)
    tgt = plan.att_tgt
    anch = grip
    while True:
        anch_pad = torch.cat([anch, false1])
        nb = anch_pad[model.neighbor] & link_ok
        anch1 = anch | nb.any(dim=1) | grip
        sv = torch.cat([anch1[plan.slots], false1])       # (S+1,)
        for li in range(L):
            s0, s1 = meta.level_offsets[li], meta.level_offsets[li + 1]
            p0, p1 = meta.path_offsets[li], meta.path_offsets[li + 1]
            la = left_act[s0:s1]
            sv[s0:s1] = _span_or(sv[s0:s1], la, meta.level_steps[li])
            for side, ends in ((0, plan.first_gpos[p0:p1]),
                               (1, plan.last_gpos[p0:p1])):
                t = tgt[p0:p1, side]
                aa = att_act[p0:p1, side]
                sv[ends] = sv[ends] | (sv[t] & aa)
                # several paths may share a junction: count, then test
                hit = torch.zeros(S_tot + 1, dtype=torch.int32,
                                  device=sv.device)
                hit.index_add_(0, t, (sv[ends] & aa).to(torch.int32))
                sv = sv | (hit > 0)
            sv[s0:s1] = _span_or(sv[s0:s1], la, meta.level_steps[li])
        anch2 = anch1.clone()
        anch2[plan.slots] = anch2[plan.slots] | sv[:S_tot]
        if not bool((anch2 != anch).any()):               # the host read
            return anch2
        anch = anch2
