"""The sums of the PyTorch routes whose terms collide on a target add in
one fixed order on every device (``kernels/ordered_sum.py``), and on the
CPU that order gives the bits of the sequential ``index_add_`` it
replaced:

- ``ordered_sum``'s plain version against a loop that adds each
  segment's terms one after another, as the kernel's threads do (float32
  and float64, strided terms, a start value, a CSR slice, shifted
  entries);
- ``chain_diag`` (the jump terms by the per-node jump CSR), the coarse
  Galerkin matrix (each entry over its block's contribution list), the
  hybrid factorization's Schur corrections ``dacc`` and its forward
  sweep's right-hand sides ``racc`` (by the plan's attachment CSR, in the
  order (level, side, path)) against the former ``index_add_`` code, bit
  for bit, on meshes whose junctions take several attachments, intact and
  5% fractured.

The card half (two runs bit-equal, and equal to the CPU) is in
test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

from mycelium_tpu_torch.config import hybrid_fea_config
from mycelium_tpu_torch.fea import coarse
from mycelium_tpu_torch.fea import tree_factor as tf
from mycelium_tpu_torch.fea.chain import plan_active_masks_bool
from mycelium_tpu_torch.fea.model import build_model
from mycelium_tpu_torch.fea.ramp import anchored_mask_host
from mycelium_tpu_torch.fea.tree_solve import preconditioner_reg
from mycelium_tpu_torch.kernels.ordered_sum import ordered_sum_plain
from mycelium_tpu_torch.kernels.pcr import pcr_factor
from tests.torch_support import (grip_for, random_forest_mesh,
                                 synthetic_mesh)

MESHES = {"forest900": lambda: random_forest_mesh(900, 18, 4),
          "forest2000": lambda: random_forest_mesh(2000, 40, 9),
          "synthetic8000": lambda: synthetic_mesh(8000)}


def _loop_sum(vals, ptr, ent, n, init, shift):
    """What each of the kernel's threads does: start from init (or 0) and
    add its segment's terms one after another."""
    out = np.zeros((vals.shape[0], n), vals.dtype) if init is None \
        else init.copy()
    for s in range(n):
        for j in range(ptr[s], ptr[s + 1]):
            e = j if ent is None else ent[j] >> shift
            for k in range(vals.shape[0]):
                out[k, s] = out[k, s] + vals[k, e]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ordered_sum_adds_in_csr_order(dtype):
    rng = np.random.default_rng(7)
    n, T, K = 37, 300, 5
    deg = rng.integers(0, 12, n + 4)
    ptr = np.concatenate([[0], np.cumsum(deg)])
    ent = rng.integers(0, 2 * T, ptr[-1])
    rows = torch.as_tensor(rng.standard_normal((2 * T, K)) * 1e3,
                           dtype=dtype)
    vals = rows.T                                 # strided (K, 2T) planes
    init = torch.as_tensor(rng.standard_normal((K, n + 9)),
                           dtype=dtype)[:, 5:5 + n]
    for sl, e, i, shift in ((slice(0, n + 1), ent, None, 0),
                            (slice(3, n + 4), ent, init, 1),
                            (slice(0, n + 1), None, init, 0)):
        p = torch.as_tensor(ptr[sl])
        et = None if e is None else torch.as_tensor(e)
        got = ordered_sum_plain(vals, p, et, n, i, shift)
        ref = _loop_sum(vals.numpy(), ptr[sl], e, n,
                        None if i is None else i.numpy(), shift)
        assert got.is_contiguous() and got.shape == (K, n)
        np.testing.assert_array_equal(got.numpy(), ref)


def _case(name, frac, dtype="float32"):
    coords, conn = MESHES[name]()
    cfg = hybrid_fea_config(dtype=dtype, grip_length=grip_for(coords),
                            tree_dense_tail=64, tree_coarse_weight=0.25)
    m = build_model(coords, conn, cfg, "cpu")
    rng = np.random.default_rng(3)
    act = rng.random(m.n_elems) >= frac
    grip = (m.top_nodes | m.bot_nodes).numpy()
    anch = anchored_mask_host(np.asarray(conn), act, grip)
    free = m.free_nodes & torch.as_tensor(anch)
    return m, cfg, torch.as_tensor(act), free


def _old_chain_diag(cplan, m_c, m_j, free_chain, reg):
    """chain_diag as it was: the jump terms by one index_add_ over
    cat([ja, jb])."""
    nc = cplan.chain_n
    kd_c = (cplan.chain_kax - cplan.chain_kbd) * m_c
    kb_c = cplan.chain_kbd * m_c
    njp = cplan.jump_n
    kd_j = (cplan.jump_kax - cplan.jump_kbd) * m_j
    kb_j = cplan.jump_kbd * m_j
    n_chain = free_chain.shape[0]
    kj = torch.stack([njp[i] * njp[j] * kd_j + (kb_j if i == j else 0.0)
                      for i in range(3) for j in range(3)])
    jump = kj.new_zeros((9, n_chain + 1))
    jump.index_add_(1, torch.cat([cplan.ja, cplan.jb]),
                    torch.cat([kj, kj], dim=1))
    zero1 = kj.new_zeros((1,))
    planes = []
    for i in range(3):
        for j in range(3):
            k3c = nc[i] * nc[j] * kd_c
            if i == j:
                k3c = k3c + kb_c
            p = k3c + torch.cat([zero1, k3c[:-1]])
            p = p + jump[3 * i + j, :n_chain]
            if i == j:
                p = torch.where(free_chain, p + reg, 1.0)
            else:
                p = torch.where(free_chain, p, 0.0)
            planes.append(p)
    return torch.stack(planes)


def _old_coarse_sum(vals, ptr, ent, n, init=None, shift=0,
                    long_segments=False):
    """coarse_matrix's entries as they were summed: one flat index_add_
    over the terms in the plan's order (``long_segments``, the kernel's
    choice of mode, changes nothing here)."""
    assert ent is None and init is None
    dd = vals.shape[0]
    terms = vals.T.reshape(-1)
    counts = (ptr[1:] - ptr[:-1]).long()
    blk = torch.repeat_interleave(torch.arange(n), counts)
    target = (blk[:, None] * dd + torch.arange(dd)[None, :]).reshape(-1)
    sums = torch.zeros(n * dd, dtype=vals.dtype)
    sums.index_add_(0, target, terms)
    return sums.reshape(n, dd).T


def _old_factor_levels(plan, D_g, B_elem, katt, n_levels, level_left_fill):
    """tree_factor_levels as it was: dacc accumulated by index_add_ level
    after level."""
    meta, k3 = plan.meta, plan.k3
    t9 = [0, 3, 6, 1, 4, 7, 2, 5, 8]
    fill_B = k3.new_zeros((plan.n_paths + 1, 9))
    dacc = k3.new_zeros((9, plan.n_slots + 1))
    out = []
    for li in range(n_levels):
        s0, s1 = meta.level_offsets[li], meta.level_offsets[li + 1]
        p0, p1 = meta.path_offsets[li], meta.path_offsets[li + 1]
        D_l = D_g[:, s0:s1] + dacc[:, s0:s1]
        B_l = B_elem[:, s0:s1]
        if level_left_fill[li]:
            bf = fill_B[plan.left_fill[s0:s1]]
            B_l = B_l + torch.where(plan.left_fill_flip[s0:s1],
                                    bf[:, t9].T, bf.T)
        fg = plan.first_gpos[p0:p1] - s0
        lg = plan.last_gpos[p0:p1] - s0
        ab = katt[p0:p1] \
            + fill_B[plan.att_fill[p0:p1]].reshape(-1, 2, 3, 3)
        ab = torch.where(plan.att_flip[p0:p1, :, None, None],
                         ab.transpose(-1, -2), ab)
        al, be, dinv, xc = pcr_factor(D_l.contiguous(), B_l.contiguous(),
                                      fg, lg, meta.level_steps[li])
        out.append((al, be, dinv))
        x3 = xc.reshape(3, 6, -1)
        Mff = x3[:, 0:3][:, :, fg].permute(2, 0, 1)
        Mll = x3[:, 3:6][:, :, lg].permute(2, 0, 1)
        Mfl = x3[:, 3:6][:, :, fg].permute(2, 0, 1)
        bl, br = ab[:, 0], ab[:, 1]
        dg_l = -tf._mm(tf._mm(bl, Mff), bl.transpose(-1, -2))
        dg_r = -tf._mm(tf._mm(br, Mll), br.transpose(-1, -2))
        tgt = plan.att_tgt[p0:p1]
        dacc.index_add_(1, tgt[:, 0], dg_l.reshape(-1, 9).T)
        dacc.index_add_(1, tgt[:, 1], dg_r.reshape(-1, 9).T)
        fb = -tf._mm(tf._mm(bl, Mfl), br.transpose(-1, -2))
        fill_B[p0:p1] = (fb * plan.has_fill[p0:p1, None, None]).reshape(-1,
                                                                         9)
    return out, fill_B, dacc


def _old_apply(plan, factor, rp):
    """tree_apply_chain_planes as it was: racc by index_add_. Returns each
    level's forward right-hand side and the result."""
    meta = plan.meta
    L = tf.n_pcr_levels(meta)
    S = plan.n_slots
    t0 = meta.level_offsets[L]
    racc = torch.cat([rp[:, :S], rp.new_zeros((3, 1))], dim=1)
    seen, ys = [], []
    for li in range(L):
        s0, s1 = meta.level_offsets[li], meta.level_offsets[li + 1]
        p0, p1 = meta.path_offsets[li], meta.path_offsets[li + 1]
        r = racc[:, s0:s1].contiguous()
        seen.append(r)
        y = tf.pcr_apply(factor.alphas[li], factor.betas[li],
                         factor.dinvs[li], r)
        ys.append(y)
        ab = factor.att_b[p0:p1]
        fg = plan.first_gpos[p0:p1] - s0
        lg = plan.last_gpos[p0:p1] - s0
        tgt = plan.att_tgt[p0:p1]
        racc.index_add_(1, tgt[:, 0], -tf._mv(ab[:, 0], y[:, fg].T).T)
        racc.index_add_(1, tgt[:, 1], -tf._mv(ab[:, 1], y[:, lg].T).T)
    u = rp.new_zeros((3, S + 1))
    u[:, t0:S] = (factor.sinv @ racc[:, t0:S].T.reshape(-1)).reshape(-1,
                                                                      3).T
    for li in range(L - 1, -1, -1):
        s0, s1 = meta.level_offsets[li], meta.level_offsets[li + 1]
        p0, p1 = meta.path_offsets[li], meta.path_offsets[li + 1]
        ab = factor.att_b[p0:p1]
        tgt = plan.att_tgt[p0:p1]
        z = rp.new_zeros((3, s1 - s0))
        z.index_add_(1, plan.first_gpos[p0:p1] - s0,
                     tf._mtv(ab[:, 0], u[:, tgt[:, 0]].T).T)
        z.index_add_(1, plan.last_gpos[p0:p1] - s0,
                     tf._mtv(ab[:, 1], u[:, tgt[:, 1]].T).T)
        u[:, s0:s1] = ys[li] - tf.pcr_apply(factor.alphas[li],
                                            factor.betas[li],
                                            factor.dinvs[li], z)
    return seen, u[:, :S]


@pytest.mark.parametrize("frac", [0.0, 0.05])
@pytest.mark.parametrize("name", list(MESHES))
def test_fixed_order_sums_equal_index_add(name, frac, monkeypatch):
    m, cfg, act, free = _case(name, frac)
    plan, cplan = m.tree, m.chain
    # junctions that take several attachments
    assert int(torch.diff(plan.att_ptr).max()) >= 2
    free_chain = free[cplan.perm]
    cab, jab = plan_active_masks_bool(cplan, act)
    reg_pc = preconditioner_reg(m, cfg)

    # chain_diag: the jump terms
    mc = (cab & m.tree_fast.chain_tree).to(m.dtype)
    mj = (jab & m.tree_fast.jump_tree).to(m.dtype)
    assert int(torch.diff(cplan.jump_ptr).max()) >= 2
    assert torch.equal(tf.chain_diag(cplan, mc, mj, free_chain, reg_pc),
                       _old_chain_diag(cplan, mc, mj, free_chain, reg_pc))

    # the coarse Galerkin matrix, float64 sums rounded once
    nb, kblk, nbc, width = coarse.cluster_layout(m.n_nodes, cfg)
    cp = m.coarse_plans.get(nbc, width, coarse.n_basis(cfg))
    a = coarse.coarse_matrix(cp, cplan, act, free_chain, cfg.reg, m.dtype)
    monkeypatch.setattr(coarse, "ordered_sum", _old_coarse_sum)
    assert torch.equal(a, coarse.coarse_matrix(cp, cplan, act, free_chain,
                                               cfg.reg, m.dtype))
    monkeypatch.undo()

    # the hybrid's Schur corrections (dacc) and what they feed
    D_g, B_elem, katt = tf.tree_factor_inputs(
        plan, m.tree_fast, cplan, act, free, free_chain, reg_pc, m.conn,
        cab, jab)
    L = tf.n_pcr_levels(plan.meta)
    assert 2 <= L < len(plan.meta.level_steps)      # a dense tail too
    lf = m.tree_fast.meta.level_left_fill
    al, be, dinv, att_b, fill_B, dacc = tf.tree_factor_levels(
        plan, D_g, B_elem, katt, L, lf)
    old, fill_old, dacc_old = _old_factor_levels(plan, D_g, B_elem, katt, L,
                                                 lf)
    assert torch.equal(dacc, dacc_old) and torch.equal(fill_B, fill_old)
    assert bool(dacc.any())
    for li, (a_, b_, d_) in enumerate(old):
        assert torch.equal(al[li], a_) and torch.equal(be[li], b_)
        assert torch.equal(dinv[li], d_)

    # the forward sweep's right-hand sides (racc)
    factor = tf.tree_factor_fast(plan, m.tree_fast, cplan, act, free,
                                 free_chain, reg_pc, m.conn, cab, jab)
    rng = np.random.default_rng(5)
    rp = torch.as_tensor(rng.standard_normal((3, m.n_nodes)), dtype=m.dtype)
    seen = []
    real = tf.pcr_apply

    def record(al_, be_, dinv_, r):
        seen.append(r)
        return real(al_, be_, dinv_, r)

    monkeypatch.setattr(tf, "pcr_apply", record)
    u = tf.tree_apply_chain_planes(plan, factor, rp)
    monkeypatch.undo()
    ref, u_old = _old_apply(plan, factor, rp)
    for r_new, r_old in zip(seen[:L], ref):
        assert torch.equal(r_new, r_old)
    assert torch.equal(u, u_old)


def test_fixed_order_sums_equal_index_add_float64():
    """The same in float64 (the ordered sums take the model's dtype)."""
    m, cfg, act, free = _case("forest900", 0.05, "float64")
    plan, cplan = m.tree, m.chain
    free_chain = free[cplan.perm]
    cab, jab = plan_active_masks_bool(cplan, act)
    reg_pc = preconditioner_reg(m, cfg)
    D_g, B_elem, katt = tf.tree_factor_inputs(
        plan, m.tree_fast, cplan, act, free, free_chain, reg_pc, m.conn,
        cab, jab)
    L = tf.n_pcr_levels(plan.meta)
    lf = m.tree_fast.meta.level_left_fill
    *_, fill_B, dacc = tf.tree_factor_levels(plan, D_g, B_elem, katt, L, lf)
    _, fill_old, dacc_old = _old_factor_levels(plan, D_g, B_elem, katt, L, lf)
    assert dacc.dtype == torch.float64 and bool(dacc.any())
    assert torch.equal(dacc, dacc_old) and torch.equal(fill_B, fill_old)
    mc = (cab & m.tree_fast.chain_tree).to(m.dtype)
    mj = (jab & m.tree_fast.jump_tree).to(m.dtype)
    assert torch.equal(tf.chain_diag(cplan, mc, mj, free_chain, reg_pc),
                       _old_chain_diag(cplan, mc, mj, free_chain, reg_pc))
