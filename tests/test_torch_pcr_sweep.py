"""K3's bound sweep (``kernels.PcrLaunch.apply``) and the dense tail's
fixed-order assembly, on the CPU.

- The bound sweep emulated on the CPU in the kernels' order of work, from
  the launch's own tables (``torch_support.emulate_pcr_sweep``: per level
  the fused right-hand side, the rounds window by window, the fused
  store) equals the plain version bit for bit (torch.equal): each level's
  y and the dense tail's right-hand side of ``tree_forward_sweep``, and
  the result of ``tree_apply_chain_planes`` fed the same tail solution;
  also with a window of 8 slots, where a level keeps the halo form. The
  launch itself takes CUDA tensors only: on the CPU
  ``tree_apply_chain_planes`` runs the plain version.
- The launch's tables: the windows tile each PCR level at path ends, the
  path ends by slot are the plan's ``first_gpos``/``last_gpos``, the tail
  CSR is the attachment CSR's PCR entries at the tail's slots.
- The dense tail's matrix summed over its contribution list
  (``dense_tail_matrix``) equals the former ``index_put_`` assembly bit
  for bit, float32 and float64; its inverse is held to the JAX package's
  in test_torch_tree_factor.py (1e-10).

The card halves (the kernels against these, twice) are in
test_torch_kernels.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mycelium_tpu_torch.config import hybrid_fea_config
from mycelium_tpu_torch.fea import tree_factor as tf
from mycelium_tpu_torch.fea.model import build_model
from mycelium_tpu_torch.fea.ramp import anchored_mask_host
from mycelium_tpu_torch.fea.tree_solve import preconditioner_reg
from tests.torch_support import (emulate_pcr_sweep, grip_for,
                                 random_forest_mesh, synthetic_mesh)

MESHES = {"forest900": lambda: random_forest_mesh(900, 18, 4),
          "synthetic8000": lambda: synthetic_mesh(8000)}


def _case(name, frac, dtype="float32"):
    """A hybrid model (dense tail 64: 2 or more PCR levels and a tail),
    its factorization with ``frac`` of the elements fractured (islands
    pinned) and a random residual."""
    coords, conn = MESHES[name]()
    cfg = hybrid_fea_config(grip_length=grip_for(coords), tree_dense_tail=64,
                            dtype=dtype)
    m = build_model(coords, conn, cfg, "cpu")
    rng = np.random.default_rng(3)
    act = rng.random(m.n_elems) >= frac
    grip = (m.top_nodes | m.bot_nodes).numpy()
    anch = torch.as_tensor(anchored_mask_host(np.asarray(conn), act, grip))
    free = m.free_nodes & anch
    act = torch.as_tensor(act)
    factor = tf.tree_factor_fast(m.tree, m.tree_fast, m.chain, act, free,
                                 free[m.chain.perm],
                                 preconditioner_reg(m, cfg), m.conn)
    rp = torch.as_tensor(rng.standard_normal((3, m.n_nodes)), dtype=m.dtype)
    return m, act, free, factor, rp


def _check_sweep(plan, launch, factor, rp):
    meta = plan.meta
    L = tf.n_pcr_levels(meta)
    assert L >= 2 and plan.n_slots > meta.level_offsets[L]
    ys, r_tail = tf.tree_forward_sweep(plan, factor, rp)
    u_tail = tf.tree_tail_solve(factor, r_tail)
    fwd, r_tail_k, u = emulate_pcr_sweep(launch, factor, rp, u_tail)
    for li in range(L):
        s0, s1 = meta.level_offsets[li], meta.level_offsets[li + 1]
        assert torch.equal(fwd[:, s0:s1], ys[li]), li
    assert torch.equal(r_tail_k, r_tail)
    assert torch.equal(u, tf.tree_backward_sweep(plan, factor, ys, u_tail))
    assert torch.equal(u, tf.tree_apply_chain_planes(plan, factor, rp,
                                                     launch))
    with pytest.raises(ValueError, match="CUDA"):
        launch.apply(factor, rp)


@pytest.mark.parametrize("frac", [0.0, 0.05])
@pytest.mark.parametrize("name", list(MESHES))
def test_bound_sweep_equals_plain(name, frac):
    m, _, _, factor, rp = _case(name, frac)
    launch = m.pcr_launch
    assert all(launch.windowed) and launch.ordered
    _check_sweep(m.tree, launch, factor, rp)


@pytest.mark.parametrize("name", list(MESHES))
def test_bound_sweep_with_a_halo_level_equals_plain(name):
    """A window shorter than a level's longest path: that level keeps the
    halo form (the plain apply of the whole level), the others are cut
    finer; the sweep is still the plain version's."""
    m, _, _, factor, rp = _case(name, 0.05)
    launch = tf.build_pcr_launch(m.tree, window=8)
    assert not all(launch.windowed) and any(launch.windowed)
    _check_sweep(m.tree, launch, factor, rp)


@pytest.mark.parametrize("name", list(MESHES))
def test_sweep_tables(name):
    m, *_ = _case(name, 0.0)
    plan, launch = m.tree, m.pcr_launch
    meta = plan.meta
    L = tf.n_pcr_levels(meta)
    lo, po = meta.level_offsets, meta.path_offsets
    fg, lg = plan.first_gpos.numpy(), plan.last_gpos.numpy()
    assert launch.level_offsets == tuple(lo[:L + 1])
    assert launch.path_offsets == tuple(po[:L + 1])
    for li in range(L):
        start, lens, n = launch.windows[li]
        start, lens = start.numpy(), lens.numpy()
        firsts = set((fg[po[li]:po[li + 1]] - lo[li]).tolist())
        assert n == len(start) > 0
        assert start[0] == 0 and lens.sum() == lo[li + 1] - lo[li]
        assert np.array_equal(start[1:], (start + lens)[:-1])
        assert lens.max() <= tf.TREE_WINDOW
        assert set(start.tolist()) <= firsts
    P, t0 = po[L], lo[L]
    fp, lp = launch.first_path.numpy(), launch.last_path.numpy()
    assert fp.shape == lp.shape == (t0,)
    assert np.array_equal(fp[fg[:P]], np.arange(P))
    assert np.array_equal(lp[lg[:P]], np.arange(P))
    assert (fp >= 0).sum() == (lp >= 0).sum() == P
    ptr, ent = plan.att_ptr.numpy(), plan.att_ent.numpy()
    tp, te = launch.tail_ptr.numpy(), launch.tail_ent.numpy()
    for s in range(t0, plan.n_slots):
        e = ent[ptr[s]:ptr[s + 1]]
        assert np.array_equal(te[tp[s - t0]:tp[s - t0 + 1]],
                              e[(e >> 1) < P])
    assert len(te) > 0
    tgt = launch.att_tgt.numpy()
    assert np.array_equal(tgt, plan.att_tgt[:P].numpy().reshape(-1))


def _old_dense_tail_matrix(plan, D_tail, dacc_tail, ke, fill_B):
    """The dense tail's matrix as it was assembled: index_put_ with
    accumulate, per (a, b) the diagonal, both orientations of ke and of
    the fill blocks."""
    meta = plan.meta
    S_tot = plan.n_slots
    t0 = meta.level_offsets[tf.n_pcr_levels(meta)]
    Sd = S_tot - t0
    M = D_tail.new_zeros((3 * Sd, 3 * Sd))
    ar = torch.arange(Sd)
    p_pcr = meta.path_offsets[tf.n_pcr_levels(meta)]
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
    return M


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", list(MESHES))
def test_dense_tail_matrix_equals_index_put(name, dtype):
    m, act, free, _, _ = _case(name, 0.05, dtype)
    plan = m.tree
    free_chain = free[m.chain.perm]
    reg = preconditioner_reg(m, hybrid_fea_config())
    D_g, B_elem, katt = tf.tree_factor_inputs(
        plan, m.tree_fast, m.chain, act, free, free_chain, reg, m.conn)
    L = tf.n_pcr_levels(plan.meta)
    *_, fill_B, dacc = tf.tree_factor_levels(
        plan, D_g, B_elem, katt, L, m.tree_fast.meta.level_left_fill)
    t0, S = plan.meta.level_offsets[L], plan.n_slots
    ke = tf.attachment_couplings(plan, act, free, m.conn, plan.dense_eid)
    args = (plan, D_g[:, t0:S], dacc[:, t0:S], ke, fill_B)
    M = tf.dense_tail_matrix(*args)
    assert M.dtype == getattr(torch, dtype) and S - t0 > 0
    assert bool(plan.dense_fill.any()) and len(plan.dense_i) > 0
    assert torch.equal(M, _old_dense_tail_matrix(*args))
    # a term list with several terms on an entry
    assert int(torch.diff(plan.dense_ptr).max()) >= 2


def test_pcr_launch_refuses_an_unordered_plan():
    """The bound sweep needs every attachment of a PCR path to point from
    its level to a later one: a plan where a level-1 path attaches to a
    level-0 slot gives a launch that raises at its first apply, before any
    launch."""
    m, _, _, factor, rp = _case("forest900", 0.0)
    assert m.pcr_launch.ordered
    po = m.tree.meta.path_offsets
    tgt = m.tree.att_tgt.clone()
    tgt[po[1], 0] = 0
    launch = tf.build_pcr_launch(dataclasses.replace(m.tree, att_tgt=tgt))
    assert not launch.ordered
    with pytest.raises(ValueError, match="attachments"):
        launch._check_sweep(factor, rp)
