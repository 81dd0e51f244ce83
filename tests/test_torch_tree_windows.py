"""The path-aligned windows of the whole-solve tree kernel K6 and what its
set-up phase computes, proven on the plain versions on the CPU:

- the window table (``fea/tree_factor.py::path_windows``) covers every slot
  of every windowed level exactly once, cuts only at path ends, respects
  the window, and flags exactly the levels whose longest path exceeds it;
- one level's plain factorization and apply run window by window (slices
  of the level handed to ``pcr_factor_plain``/``pcr_apply_plain``) equal
  the whole-level ones exactly (``torch.equal``: only the sign of a zero
  may differ), float32 and float64, intact and 5% fractured, on every
  level of the forest: PCR never couples two paths, which is what lets the
  kernel run a window's rounds in one block's shared memory with no halo;
- the kernel's set-up in numpy (``torch_support.emulate_tree_setup``: its
  tables, its order of operations, the diagonal's jump terms added in the
  order of the per-node jump CSR) equals the plain set-up bit for bit;
- the 32-bit tables equal the 64-bit ones, and an index past 2^31 raises.
"""

import numpy as np
import pytest
import torch

from mycelium_tpu_torch.config import FeaConfig
from mycelium_tpu_torch.fea.chain import index32
from mycelium_tpu_torch.fea.model import build_model
from mycelium_tpu_torch.fea.ramp import anchored_mask_host
from mycelium_tpu_torch.fea.tree_factor import (TREE_WINDOW,
                                                build_tree_kernel_tables,
                                                path_windows)
from mycelium_tpu_torch.fea.tree_solve import preconditioner_reg
from mycelium_tpu_torch.kernels import (pcr_apply_plain, pcr_factor_plain,
                                        tree_cg_setup_plain)
from tests.torch_support import (all_levels, emulate_tree_setup, grip_for,
                                 np_of, random_forest_mesh, scene,
                                 synthetic_mesh)

MESHES = {
    "test_I": lambda: scene("test_I"), "test_t": lambda: scene("test_t"),
    "test_y": lambda: scene("test_y"), "test_X": lambda: scene("test_X"),
    "forest260": lambda: random_forest_mesh(260, 8, 11),
    "forest900": lambda: random_forest_mesh(900, 18, 4),
    "synthetic2000": lambda: synthetic_mesh(2000),
    "synthetic8000": lambda: synthetic_mesh(8000),
}


def _model(name, dtype="float32", max_path_len=128):
    coords, conn = MESHES[name]()
    cfg = FeaConfig(dtype=dtype, operator="chain", precond="tree",
                    grip_length=grip_for(coords), tree_reg_rel=1e-7,
                    tree_max_path_len=max_path_len)
    return build_model(coords, conn, cfg, "cpu"), cfg, conn


def _solve_case(m, conn, frac, seed=0):
    rng = np.random.default_rng(seed)
    act = rng.random(m.n_elems) >= frac
    grip = np_of(m.top_nodes | m.bot_nodes)
    anch = anchored_mask_host(np.asarray(conn), act, grip)
    return torch.as_tensor(act), m.free_nodes & torch.as_tensor(anch)


@pytest.mark.parametrize("window", [4, 32, TREE_WINDOW])
@pytest.mark.parametrize("name", list(MESHES))
def test_windows_tile_the_levels(name, window):
    m, _, _ = _model(name)
    if m.tree_tables is None:
        pytest.skip("no free node between the grips: no forest")
    plan = m.tree
    tk = build_tree_kernel_tables(plan, m.conn, window=window)
    lo, po = plan.meta.level_offsets, plan.meta.path_offsets
    fg, lg = np_of(plan.first_gpos), np_of(plan.last_gpos)
    L = len(plan.meta.level_steps)
    assert tk.window == window and len(tk.windowed) == L
    woff = tk.wlv[0].tolist()
    assert tk.wlv[1].tolist() == [int(w) for w in tk.windowed] + [0]
    ws, wl = np_of(tk.win_start), np_of(tk.win_len)
    assert woff[0] == 0 and woff[-1] == len(ws) == len(wl)
    for li in range(L):
        longest = int((lg[po[li]:po[li + 1]] - fg[po[li]:po[li + 1]]
                       + 1).max())
        assert tk.windowed[li] == (longest <= window), (li, longest)
        s, n = ws[woff[li]:woff[li + 1]], wl[woff[li]:woff[li + 1]]
        if not tk.windowed[li]:
            assert len(s) == 0
            continue
        # the windows tile the level in order, none empty, none too long
        assert s[0] == lo[li] and s[-1] + n[-1] == lo[li + 1]
        np.testing.assert_array_equal(s[1:], s[:-1] + n[:-1])
        assert n.min() >= 1 and n.max() <= window
        # a window starts where a path starts and ends where one ends
        assert np.isin(s, fg[po[li]:po[li + 1]]).all()
        assert np.isin(s + n - 1, lg[po[li]:po[li + 1]]).all()
        # greedy: the next path would not have fitted
        nxt = np.searchsorted(fg[po[li]:po[li + 1]], s[1:])
        first_len = (lg[po[li]:po[li + 1]] - fg[po[li]:po[li + 1]] + 1)[nxt]
        assert (n[:-1] + first_len > window).all()
    glob = [li for li in range(L) if not tk.windowed[li]]
    sizes = np.diff(lo)
    assert tk.smax_global == max([sizes[li] for li in glob], default=0)
    assert tk.max_steps_global == max(
        [plan.meta.level_steps[li] for li in glob], default=-1)


def test_windows_refuse_what_the_kernel_cannot_hold():
    m, _, _ = _model("forest260")
    with pytest.raises(ValueError):
        build_tree_kernel_tables(m.tree, m.conn, window=TREE_WINDOW + 1)
    # paths that do not tile the level in order: no windows
    lo, po = np.array([0, 6]), np.array([0, 2])
    for fg, lg in (([3, 0], [5, 2]), ([0, 4], [2, 5]), ([0, 3], [2, 4])):
        flags, off, s, n = path_windows(np.array(fg), np.array(lg), lo, po, 8)
        assert flags == (False,) and off.tolist() == [0, 0] and len(s) == 0
    flags, off, s, n = path_windows(np.array([0, 3]), np.array([2, 5]), lo,
                                    po, 4)
    assert flags == (True,) and s.tolist() == [0, 3] and n.tolist() == [3, 3]


@pytest.mark.parametrize("frac", [0.0, 0.05])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["test_y", "test_X", "forest260",
                                  "forest900", "synthetic2000",
                                  "synthetic8000"])
def test_window_by_window_equals_the_whole_level(name, dtype, frac):
    """Every level, cut into windows of at most 32 and at most TREE_WINDOW
    slots (and 8 where the paths allow it): coefficients, block inverses,
    corner solutions and one apply on a random right-hand side."""
    m, cfg, conn = _model(name, dtype, max_path_len=24)
    if m.tree_tables is None:
        pytest.skip("no free node between the grips: no forest")
    act, free = _solve_case(m, conn, frac)
    levels = all_levels(m, act, free, preconditioner_reg(m, cfg))
    assert len(levels) == len(m.tree.meta.level_steps)
    gen = torch.Generator().manual_seed(3)
    checked = 0
    for window in (8, 32, TREE_WINDOW):
        tk = build_tree_kernel_tables(m.tree, m.conn, window=window)
        woff = tk.wlv[0].tolist()
        for li, (D, B, fg, lg, steps) in enumerate(levels):
            if not tk.windowed[li]:
                continue
            s0 = m.tree.meta.level_offsets[li]
            whole = pcr_factor_plain(D, B, fg, lg, steps)
            r = torch.randn((3, D.shape[1]), dtype=D.dtype, generator=gen)
            u = pcr_apply_plain(whole[0], whole[1], whole[2], r)
            for w in range(woff[li], woff[li + 1]):
                a = int(tk.win_start[w]) - s0
                b = a + int(tk.win_len[w])
                inside = (fg >= a) & (fg < b)
                assert torch.equal(inside, (lg >= a) & (lg < b))
                part = pcr_factor_plain(
                    D[:, a:b].contiguous(), B[:, a:b].contiguous(),
                    fg[inside] - a, lg[inside] - a, steps)
                assert torch.equal(part[0], whole[0][:, :, a:b])
                assert torch.equal(part[1], whole[1][:, :, a:b])
                assert torch.equal(part[2], whole[2][:, a:b])
                assert torch.equal(part[3], whole[3][:, a:b])
                assert torch.equal(
                    pcr_apply_plain(part[0], part[1], part[2], r[:, a:b]),
                    u[:, a:b])
                checked += 1
    assert checked >= 3 * len(levels)


@pytest.mark.parametrize("frac", [0.0, 0.05])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["test_y", "test_X", "forest260",
                                  "forest900", "synthetic2000",
                                  "synthetic8000"])
def test_kernel_set_up_order_equals_the_plain_set_up(name, dtype, frac):
    """The set-up as the kernel computes it against ``tree_cg_setup_plain``:
    equal bits (tolerance 0; ``==`` so that a zero's sign does not count).
    The diagonal is the one that matters: the plain version adds a
    position's jump terms with ``index_add_`` over cat([ja, jb]), on the CPU
    one after another, ja entries in ascending j and then jb entries, which
    is the order of the jump CSR the kernel walks."""
    m, cfg, conn = _model(name, dtype)
    if m.tree_launch is None and dtype == "float32":
        pytest.skip("no free node between the grips: no forest")
    launch = m.tree_launch
    if launch is None:      # a float64 model cannot run K6 but has tables
        if m.tree_tables is None:
            pytest.skip("no free node between the grips: no forest")
        from mycelium_tpu_torch.kernels import TreeCgLaunch
        launch = TreeCgLaunch(m.chain, m.tree, m.tree_fast, m.tree_tables,
                              m.conn, m.top_nodes, m.bot_nodes)
    act, free = _solve_case(m, conn, frac, seed=4)
    x0 = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (m.n_nodes, 3)), dtype=m.dtype)
    reg_pc = preconditioner_reg(m, cfg)
    want = tree_cg_setup_plain(m.chain, m.tree, m.tree_fast, m.conn,
                               m.top_nodes, m.bot_nodes, act, free, 0.013,
                               -0.007, x0, reg_pc)
    want["x"] = want["freem"] * want.pop("x0") \
        + (1.0 - want["freem"]) * want["uk"]
    got = emulate_tree_setup(launch, act, free, 0.013, -0.007, x0, reg_pc)
    assert set(got) == set(want)
    for key, ref in want.items():
        assert got[key].dtype == np_of(ref).dtype, key
        assert got[key].shape == tuple(ref.shape), key
        assert (got[key] == np_of(ref)).all(), key
    # the diagonal saw jumps, and fracture masked some of every table
    jptr = np_of(m.chain.k32.jump_ptr)
    if name.startswith(("forest", "synthetic")):
        assert np.diff(jptr)[:launch.S].sum() > 0
        assert np.abs(got["katt"]).max() > 0 and np.abs(got["bel"]).max() > 0


@pytest.mark.parametrize("name", list(MESHES))
def test_32_bit_tables_equal_the_64_bit_ones(name):
    m, _, _ = _model(name)
    cp, k = m.chain, m.chain.k32
    for f in ("perm", "chain_elem", "jump_elem", "ja", "jb", "jump_ptr",
              "jump_ent"):
        a, b = getattr(k, f), getattr(cp, f)
        assert a.dtype == torch.int32 and a.is_contiguous(), f
        assert torch.equal(a.long(), b), f
    for pack, n3, kax in ((k.chain_pack, cp.chain_n, cp.chain_kax),
                          (k.jump_pack, cp.jump_n, cp.jump_kax)):
        assert pack.is_contiguous() and pack.shape == (kax.shape[0], 4)
        assert torch.equal(pack[:, :3].T, n3)
        assert torch.equal(pack[:, 3], kax)
    # a node's entries: its ja rows in ascending j, then its jb rows
    ptr, ent = np_of(k.jump_ptr), np_of(k.jump_ent)
    ja, jb = np_of(k.ja), np_of(k.jb)
    for q in np.nonzero(np.diff(ptr))[0]:
        e = ent[ptr[q]:ptr[q + 1]]
        keys = list(zip(e & 1, e >> 1))
        assert keys == sorted(keys)
        assert all((ja if side == 0 else jb)[j] == q for side, j in keys)


def test_an_index_past_32_bits_raises():
    ok = index32(torch.tensor([0, 2 ** 31 - 1]), "ok")
    assert ok.dtype == torch.int32 and ok.tolist() == [0, 2 ** 31 - 1]
    with pytest.raises(ValueError, match="32 bits"):
        index32(torch.tensor([0, 2 ** 31]), "jump_ent")
    assert index32(torch.zeros((0,), dtype=torch.int64), "e").numel() == 0
