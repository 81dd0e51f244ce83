"""The CUDA kernels on the card, each against its plain PyTorch version,
and the card-side boundary of the port: a CUDA tensor launches a kernel
or raises, never the plain path. Every test here needs a card and skips
without one. The file imports no jax, so it runs on a machine with
PyTorch for CUDA and no jax:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_kernels.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from mycelium_tpu_torch.config import (GROWTH_PRESETS, FeaConfig,
                                       growth_3d_config, hybrid_fea_config)
from mycelium_tpu_torch.devices import moved
from mycelium_tpu_torch.fea import build_model, solve_displacement
from mycelium_tpu_torch.fea.chain import plan_active_masks_bool
from mycelium_tpu_torch.fea.ramp import anchored_mask_host
from mycelium_tpu_torch.fea.solve import (chain_preconditioner,
                                          compute_tree_factor)
from mycelium_tpu_torch.growth import (TorchDraws, growth_step, init_state,
                                       neighbors, run_growth, summarize)
from mycelium_tpu_torch.fea.tree_factor import (build_pcr_launch,
                                                build_tree_kernel_tables)
from mycelium_tpu_torch.fea.tree_solve import preconditioner_reg
from mycelium_tpu_torch.kernels import (ChainOperator, TreeCgLaunch,
                                        anast_scan, anast_scan_plain,
                                        chain_matvec, chain_matvec_plain,
                                        launch_counts, pcr_apply,
                                        pcr_apply_plain, pcr_factor,
                                        pcr_factor_plain,
                                        reset_launch_counts)
from mycelium_tpu_torch.kernels.tree_cg import (NEAR_WINDOW, STALL_WINDOW,
                                                barrier_count,
                                                stall_converged)
from mycelium_tpu_torch.scenes import petri_dish
# imported by its own name (pytest puts tests/ on sys.path): a machine
# with an unrelated installed package named "tests" shadows tests.*
from torch_support import (all_levels, bound_sweep_pairs,  # noqa: F401
                           cuda_device, emulate_anast_by_cell,
                           fixed_order_sums,
                           grip_for, level0, many_tips_case, node_sums,
                           random_forest_mesh, rel_err, scan_args,
                           synthetic_mesh, tie_state, tie_state_3d)


def _chain_case(device, n_nodes=3000, frac=0.05):
    coords, conn = synthetic_mesh(n_nodes)
    cfg = FeaConfig(dtype="float32", operator="chain", precond="tree",
                    grip_length=grip_for(coords))
    m = build_model(coords, conn, cfg, device)
    rng = np.random.default_rng(1)
    act = torch.as_tensor(rng.random(m.n_elems) > frac, device=device)
    ca_b, ja_b = plan_active_masks_bool(m.chain, act)
    u = torch.as_tensor(rng.standard_normal((3, m.n_nodes)),
                        dtype=torch.float32, device=device)
    free = m.free_nodes[m.chain.perm].float()
    return m, cfg, u, free, ca_b.float(), ja_b.float()


@pytest.mark.parametrize("bc", [True, False])
def test_chain_matvec_matches_plain(cuda_device, bc):  # noqa: F811
    m, cfg, u, free, cact, jact = _chain_case(cuda_device)
    before = launch_counts()["chain_matvec"]
    k = chain_matvec(m.chain, u, free, cact, jact, cfg.reg, bc)
    p = chain_matvec_plain(m.chain, u, free, cact, jact, cfg.reg, bc)
    torch.cuda.synchronize()
    assert launch_counts()["chain_matvec"] == before + 1
    # the same float32 terms; only the order of a node's jump sums may
    # differ (index_add_ is atomic on the card): 1e-5 of max |K·u|
    assert rel_err(k.cpu(), p.cpu()) <= 1e-5


@pytest.mark.parametrize("bc", [True, False])
def test_chain_matvec_bit_equal_to_plain_on_host(cuda_device,  # noqa: F811
                                                 bc):
    """K1 (its body shared with K5 through chain_matvec.cuh) against the
    plain version run on the host, where index_add_ adds a node's jump
    forces in the kernel's CSR order: tolerance 0 (the same float32
    operations in the same order, no FMA contraction)."""
    m, cfg, u, free, cact, jact = _chain_case(cuda_device)
    mc, *_ = _chain_case("cpu")
    k = chain_matvec(m.chain, u, free, cact, jact, cfg.reg, bc)
    p = chain_matvec_plain(mc.chain, u.cpu(), free.cpu(), cact.cpu(),
                           jact.cpu(), cfg.reg, bc)
    assert torch.equal(k.cpu(), p)


def test_chain_matvec_rejects_bad_tensors(cuda_device):  # noqa: F811
    m, cfg, u, free, cact, jact = _chain_case(cuda_device, 1500)
    with pytest.raises(ValueError):
        chain_matvec(m.chain, u.double(), free, cact, jact, cfg.reg, True)
    strided = torch.zeros((m.n_nodes, 3), device=cuda_device).T
    with pytest.raises(ValueError):
        chain_matvec(m.chain, strided, free, cact, jact, cfg.reg, True)


def test_chain_operator_applies_like_the_one_shot(cuda_device):  # noqa: F811
    """The bound operator: both forms of the product equal the plain
    version on the host bit for bit, into a fresh tensor and into ``out``;
    a wrong vector raises."""
    m, cfg, u, free, cact, jact = _chain_case(cuda_device)
    mc, *_ = _chain_case("cpu")
    op = ChainOperator(m.chain, free, cact, jact, cfg.reg)
    before = launch_counts()["chain_matvec"]
    for bc in (True, False):
        p = chain_matvec_plain(mc.chain, u.cpu(), free.cpu(), cact.cpu(),
                               jact.cpu(), cfg.reg, bc)
        assert torch.equal(op.apply(u, bc).cpu(), p)
        out = torch.full_like(u, float("nan"))
        assert op.apply(u, bc, out=out) is out and torch.equal(out.cpu(), p)
    assert launch_counts()["chain_matvec"] == before + 4
    with pytest.raises(ValueError):
        op.apply(u.double(), True)
    with pytest.raises(ValueError):
        op.apply(u, True, out=u)
    with pytest.raises(ValueError):
        op.apply(u.cpu(), True)
    with pytest.raises(ValueError):
        ChainOperator(m.chain, free.double(), cact, jact, cfg.reg)


def _pcr_case(device):
    return level0(12, 0.08, dtype="float32", device=device,
                  mesh=synthetic_mesh(7375))


def test_pcr_factor_matches_plain(cuda_device):  # noqa: F811
    D, B, fg, lg, steps = _pcr_case(cuda_device)
    before = launch_counts()["pcr_factor"]
    k = pcr_factor(D, B, fg, lg, steps)
    p = pcr_factor_plain(D, B, fg, lg, steps)
    torch.cuda.synchronize()
    assert launch_counts()["pcr_factor"] == before + 1
    # the same float32 operations in the same order, no FMA contraction;
    # reg-floored blocks amplify any rounding difference: 1e-4
    for a, b in zip(k, p):
        assert rel_err(a.cpu(), b.cpu()) <= 1e-4


def _hybrid_case(device, frac=0.05):
    """A hybrid system with 2 PCR levels (synthetic_mesh(8000), dense tail
    64), so level 1's inputs carry level 0's Schur corrections and fill
    edges; a fraction of the elements fractured and the islands pinned."""
    coords, conn = synthetic_mesh(8000)
    cfg = hybrid_fea_config(warm_start=False, grip_length=grip_for(coords),
                            tree_dense_tail=64)
    m = build_model(coords, conn, cfg, device)
    rng = np.random.default_rng(4)
    act = rng.random(m.n_elems) >= frac
    anch = anchored_mask_host(np.asarray(conn), act,
                              (m.top_nodes | m.bot_nodes).cpu().numpy())
    free = m.free_nodes & torch.as_tensor(anch, device=device)
    return m, cfg, torch.as_tensor(act, device=device), free


def test_pcr_factor_launch_matches_cpu_plain(cuda_device):  # noqa: F811
    """K2 bound to the hybrid model's levels (``PcrLaunch``: one
    launch a windowed level) on every level of a factorization against
    its plain version on the CPU on copies of the same inputs: every
    output equal (torch.equal; only the sign of a zero may differ)."""
    m, cfg, act, free = _hybrid_case(cuda_device)
    launch = m.pcr_launch
    L = len(launch.windowed)
    assert L >= 2 and all(launch.windowed)
    levels = all_levels(m, act, free, preconditioner_reg(m, cfg))[:L]
    reset_launch_counts()
    for li, (D, B, fg, lg, steps) in enumerate(levels):
        k = launch.factor(li, D, B)
        p = pcr_factor_plain(D.cpu(), B.cpu(), fg.cpu(), lg.cpu(), steps)
        torch.cuda.synchronize()
        for a, b in zip(k, p):
            assert torch.equal(a.cpu(), b)
    assert launch_counts()["pcr_factor"] == L
    # a whole hybrid factorization: one launch a level
    reset_launch_counts()
    compute_tree_factor(m, act, cfg, free & m.free_nodes)
    torch.cuda.synchronize()
    assert launch_counts()["pcr_factor"] == L


def test_fixed_order_sums_bit_equal_on_card(cuda_device):  # noqa: F811
    """P7: the chain diagonal's jump terms, the coarse matrix, the hybrid's
    Schur corrections and its forward right-hand sides, K2's outputs on
    both PCR levels, the diagonal blocks and the 'scatter' operator, twice
    on the card: bit-equal to each other and to the CPU on copies of the
    same inputs (K2 there its plain version)."""
    from mycelium_tpu_torch.fea.coarse import cluster_layout, n_basis
    m, cfg, act, free = _hybrid_case(cuda_device)
    ccfg = dataclasses.replace(cfg, precond="coarse", rtol=1e-5,
                               max_iter=3000)
    _, _, nbc, width = cluster_layout(m.n_nodes, ccfg)
    plan = m.coarse_plans.get(nbc, width, n_basis(ccfg))
    gen = np.random.default_rng(6)
    rp = torch.as_tensor(gen.standard_normal((3, m.n_nodes)),
                         dtype=torch.float32, device=cuda_device)
    args = (act, free, plan, cfg.reg, preconditioner_reg(m, cfg), rp)
    one = fixed_order_sums(m, *args)
    two = fixed_order_sums(m, *args)
    cpu = dataclasses.replace(moved(m, "cpu"), pcr_launch=None)
    ref = fixed_order_sums(cpu, *moved(args, "cpu"))
    torch.cuda.synchronize()
    assert sum(n.startswith("K2 level") for n in ref) >= 8
    for n in ref:
        assert torch.equal(one[n], two[n]) and torch.equal(one[n].cpu(),
                                                           ref[n]), n


def _sweep_twice(m, launch, factor, rp):
    """K3's bound sweep twice against the plain version on the CPU: every
    pair torch.equal (only the sign of a zero may differ), 2 launches a
    PCR level and one ordered_sum (the tail's right-hand side) each."""
    L = len(launch.sizes)
    for _ in range(2):
        reset_launch_counts()
        pairs = bound_sweep_pairs(m.tree, launch, factor, rp)
        torch.cuda.synchronize()
        counts = launch_counts()
        assert counts["pcr_apply"] == 2 * L and counts["ordered_sum"] == 1
        assert len(pairs) == L + 2
        for name, (k, c) in pairs.items():
            assert torch.equal(k.cpu(), c), name


def test_pcr_sweep_matches_cpu_plain(cuda_device):  # noqa: F811
    """K3 bound to the hybrid model's levels (``PcrLaunch``: one launch a
    level and sweep on path-aligned windows) on every PCR level of a
    factorization (level 1 with Schur corrections and incoming
    attachments), forward and backward, against its plain version on the
    CPU on copies of the same inputs; and the hybrid's tree
    preconditioner makes 2 K3 launches a PCR level and at most one
    ordered_sum an apply."""
    m, cfg, act, free = _hybrid_case(cuda_device)
    launch = m.pcr_launch
    L = len(launch.sizes)
    assert L >= 2 and all(launch.windowed) and launch.ordered
    factor = compute_tree_factor(m, act, cfg, free & m.free_nodes)
    gen = np.random.default_rng(8)
    rp = torch.as_tensor(gen.standard_normal((3, m.n_nodes)),
                         dtype=torch.float32, device=cuda_device)
    _sweep_twice(m, launch, factor, rp)
    pc = chain_preconditioner(dataclasses.replace(m, tree_kernel=False),
                              act, cfg, free & m.free_nodes,
                              tree_factor_val=factor)
    reset_launch_counts()
    z = pc(rp)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["pcr_apply"] == 2 * L and counts["ordered_sum"] <= 1
    assert counts["pcr_factor"] == 0
    z2 = pc(rp)
    assert z.data_ptr() != z2.data_ptr() and torch.equal(z, z2)


def test_pcr_sweep_halo_level_matches_cpu_plain(cuda_device):  # noqa: F811
    """The same with windows of 8 slots: a level with a longer path runs
    the sweep's halo form, the other levels finer windows."""
    m, cfg, act, free = _hybrid_case(cuda_device)
    launch = build_pcr_launch(m.tree, window=8)
    assert not all(launch.windowed) and any(launch.windowed)
    factor = compute_tree_factor(m, act, cfg, free & m.free_nodes)
    gen = np.random.default_rng(9)
    rp = torch.as_tensor(gen.standard_normal((3, m.n_nodes)),
                         dtype=torch.float32, device=cuda_device)
    _sweep_twice(m, launch, factor, rp)


def test_dense_tail_inverse_same_bits_twice(cuda_device):  # noqa: F811
    """The dense tail's matrix adds in one fixed order on the card
    (fixed_order_sums holds it to the CPU); two factorizations of the same
    system give the same inverse bit for bit."""
    m, cfg, act, free = _hybrid_case(cuda_device)
    one = compute_tree_factor(m, act, cfg, free & m.free_nodes).sinv.clone()
    two = compute_tree_factor(m, act, cfg, free & m.free_nodes).sinv
    assert one.shape[0] > 0 and torch.equal(one, two)


def test_ordered_sum_matches_cpu_plain(cuda_device):  # noqa: F811
    """The fixed-order sum against its plain version on the CPU on copies
    of the same inputs, twice: long segments (the coarse blocks: a block a
    segment; float64 and float32, terms as rows and as planes, through
    entries, 9 and 36 columns; and a thread a sum), short ones (the attachment CSR, float32,
    terms as rows, a start value as planes), shifted entries (the jump
    CSR, terms as planes)."""
    from mycelium_tpu_torch.fea.coarse import cluster_layout, n_basis
    from mycelium_tpu_torch.kernels import ordered_sum, ordered_sum_plain
    m, cfg, _, _ = _hybrid_case(cuda_device)
    ccfg = dataclasses.replace(cfg, precond="coarse")
    _, _, nbc, width = cluster_layout(m.n_nodes, ccfg)
    plan = m.coarse_plans.get(nbc, width, n_basis(ccfg))
    gen = np.random.default_rng(10)

    def rand(shape, dtype):
        return torch.as_tensor(gen.standard_normal(shape), dtype=dtype,
                               device=cuda_device)
    nblk, nent = plan.blk_row.shape[0], plan.blk_ent.shape[0]
    S, P = m.tree.n_slots, m.tree.n_paths
    jp, n = m.chain.ja.shape[0], m.n_nodes
    perm = torch.randperm(nent, generator=torch.Generator().manual_seed(1))
    cases = [
        (rand((nent, 9), torch.float64).T, plan.blk_ptr, None, nblk, None,
         0, True),
        # long segments as planes with a start value, through entries, and
        # 36 columns (the linear basis)
        (rand((9, nent), torch.float32), plan.blk_ptr, None, nblk,
         rand((9, nblk), torch.float32), 0, True),
        (rand((9, nent), torch.float64), plan.blk_ptr,
         perm.to(torch.int32).to(cuda_device), nblk, None, 0, True),
        (rand((nent, 36), torch.float64).T, plan.blk_ptr, None, nblk,
         rand((36, nblk), torch.float64), 0, True),
        # the coarse blocks a thread a sum, too
        (rand((nent, 9), torch.float64).T, plan.blk_ptr, None, nblk, None,
         0, False),
        (rand((2 * P, 9), torch.float32).T, m.tree.att_ptr, m.tree.att_ent,
         S, rand((9, S), torch.float32), 0, False),
        (rand((9, jp), torch.float32), m.chain.k32.jump_ptr,
         m.chain.k32.jump_ent, n, None, 1, False)]
    assert int(torch.diff(plan.blk_ptr).max()) > 16
    for vals, ptr, ent, n_seg, init, shift, long_ in cases:
        k1 = ordered_sum(vals, ptr, ent, n_seg, init, shift, long_)
        k2 = ordered_sum(vals, ptr, ent, n_seg, init, shift, long_)
        c = ordered_sum_plain(*moved((vals, ptr, ent), "cpu"), n_seg,
                              None if init is None else init.cpu(), shift)
        torch.cuda.synchronize()
        assert torch.equal(k1, k2) and torch.equal(k1.cpu(), c)


def test_pcr_apply_matches_plain(cuda_device):  # noqa: F811
    D, B, fg, lg, steps = _pcr_case(cuda_device)
    al, be, dinv, _ = pcr_factor(D, B, fg, lg, steps)
    gen = torch.Generator(cuda_device).manual_seed(0)
    r = torch.randn((3, D.shape[1]), device=cuda_device, generator=gen)
    before = launch_counts()["pcr_apply"]
    k = pcr_apply(al, be, dinv, r)
    p = pcr_apply_plain(al, be, dinv, r)
    torch.cuda.synchronize()
    assert launch_counts()["pcr_apply"] == before + 1
    assert rel_err(k.cpu(), p.cpu()) <= 1e-5


def test_pcr_wrappers_reject_bad_tensors(cuda_device):  # noqa: F811
    D, B, fg, lg, steps = _pcr_case(cuda_device)
    with pytest.raises(ValueError):
        pcr_factor(D.double(), B.double(), fg, lg, steps)
    al, be, dinv, _ = pcr_factor(D, B, fg, lg, steps)
    strided = torch.zeros((D.shape[1], 3), device=cuda_device).T
    with pytest.raises(ValueError):
        pcr_apply(al, be, dinv, strided)
    with pytest.raises(ValueError):
        pcr_apply(al.double(), be.double(), dinv.double(),
                  strided.contiguous().double())


def test_float64_model_on_card_raises(cuda_device):  # noqa: F811
    """The card path is float32 only, as the reference's hybrid is."""
    coords, conn = random_forest_mesh(260, 8, 11)
    cfg = FeaConfig(dtype="float64", operator="chain", precond="tree",
                    grip_length=0.1)
    m = build_model(coords, conn, cfg, cuda_device)
    act = torch.ones(m.n_elems, dtype=torch.bool, device=cuda_device)
    x0 = torch.zeros((m.n_nodes, 3), dtype=torch.float64,
                     device=cuda_device)
    with pytest.raises(ValueError):
        solve_displacement(m, act, 0.01, -0.01, x0, cfg)


@pytest.mark.parametrize("dense_tail", [256, 0])
def test_solve_on_card_goes_through_the_kernels(cuda_device,  # noqa: F811
                                                dense_tail):
    """A float32 hybrid solve on the card launches all three kernels and agrees
    with the plain path on the host to 5e-4 of the largest displacement
    (float32 CG to rtol 1e-6 on both). Without the dense tail every level
    is PCR, down to one-slot levels with zero rounds."""
    coords, conn = random_forest_mesh(900, 18, 4)
    cfg = FeaConfig(dtype="float32", operator="chain", precond="tree",
                    grip_length=0.1, rtol=1e-6, tree_dense_tail=dense_tail)
    # the hybrid: this mesh is below the whole-solve kernel's gate
    m = dataclasses.replace(build_model(coords, conn, cfg, cuda_device),
                            tree_kernel=False)
    mc = dataclasses.replace(build_model(coords, conn, cfg, "cpu"),
                             tree_kernel=False)
    act = torch.ones(m.n_elems, dtype=torch.bool)
    x0 = torch.zeros((m.n_nodes, 3))
    reset_launch_counts()
    res = solve_displacement(m, act.to(cuda_device), 0.01, -0.01,
                             x0.to(cuda_device), cfg)
    counts = launch_counts()
    fea = ("chain_matvec", "pcr_factor", "pcr_apply")
    assert res.converged and all(counts[k] > 0 for k in fea), counts
    assert counts["anast_scan"] == 0
    if dense_tail == 0:
        assert 0 in m.tree.meta.level_steps and m.tree.meta.n_pcr == len(
            m.tree.meta.level_steps)
    ref = solve_displacement(mc, act, 0.01, -0.01, x0, cfg)
    assert np.isfinite(res.x.cpu().numpy()).all()
    assert rel_err(res.x.cpu(), ref.x) <= 5e-4


def _grown_demo(device, steps=30):
    cfg = dataclasses.replace(GROWTH_PRESETS["demo"], t_steps=steps)
    st, _, hist = run_growth(cfg, device=device)
    return cfg, st, hist


def _grown_demo_plain_scan(device, steps):
    """run_growth's loop with K4 swapped for its plain version."""
    cfg = dataclasses.replace(GROWTH_PRESETS["demo"], t_steps=steps)
    draws = TorchDraws(cfg.seed, device)
    st, ea = init_state(cfg, petri_dish(cfg), device=device, draws=draws)
    walls = ea.wall_center.shape[0] > 0
    hist = []
    for _ in range(steps):
        st = growth_step(st, ea, cfg, draws.step(cfg.max_hyphae,
                                                 st.sub.dtype, walls),
                         scan=anast_scan_plain)
        hist.append(summarize(st, cfg))
    return cfg, st, hist


def _scan_args(st, cfg):
    g = neighbors.check_layout(cfg).g
    grid, _ = neighbors.grid_insert_finalized(st.grid, st, cfg)
    tb = neighbors.tip_tables(st, cfg)
    return (st.tip, tb.scan_cell, st.start, st.end, grid.ids, grid.geo,
            grid.count, cfg.max_per_cell, tb.ov_slot, tb.ov_start,
            tb.ov_count, g, st.capacity, tb.tips)


def test_anast_scan_matches_plain(cuda_device):  # noqa: F811
    """K4 on a state grown on the card: (d², tt, id) bit-equal to the
    plain version (tolerance 0: the same float32 operations in the same
    order, the fused multiply-adds exact on both sides)."""
    cfg, st, _ = _grown_demo(cuda_device)
    args = _scan_args(st, cfg)
    before = launch_counts()["anast_scan"]
    k = anast_scan(*args)
    p = anast_scan_plain(*args)
    torch.cuda.synchronize()
    assert launch_counts()["anast_scan"] == before + 1
    assert int((k[2] < st.capacity).sum()) > 100
    for a, b in zip(k, p):
        assert torch.equal(a, b)


def test_anast_scan_bit_equal_on_tie_state(cuda_device):  # noqa: F811
    """K4 on the tie-heavy state (duplicated segments, tips at bitwise
    equal distances from candidates in different cells, sources and
    ranks): bit-equal to the plain version on the card and to the CPU
    emulation of its order of work."""
    cfg, st = tie_state(cuda_device)
    args = scan_args(st, cfg)
    before = launch_counts()["anast_scan"]
    k = anast_scan(*args)
    p = anast_scan_plain(*args)
    e = emulate_anast_by_cell(args)
    torch.cuda.synchronize()
    assert launch_counts()["anast_scan"] == before + 1
    assert int((k[2] < st.capacity).sum()) >= 100
    for a, b, c in zip(k, p, e):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)


def test_growth_through_anast_scan_equals_plain(cuda_device):  # noqa: F811
    """The same draws grown through K4 and through its plain version give
    the same trajectory; K4 launches once per step."""
    reset_launch_counts()
    cfg, st_k, hist_k = _grown_demo(cuda_device, 40)
    assert launch_counts()["anast_scan"] == 40
    _, st_p, hist_p = _grown_demo_plain_scan(cuda_device, 40)
    assert [{k: v for k, v in row.items() if k != "step"}
            for row in hist_k] == hist_p
    assert hist_k[-1]["anastomosed"] > 0
    for f in ("start", "end", "sub", "state", "prev", "hypha", "tip"):
        assert torch.equal(getattr(st_k, f), getattr(st_p, f)), f
    assert not bool(st_k.overflow)


def test_anast_scan_rejects_bad_tensors(cuda_device):  # noqa: F811
    cfg, st, _ = _grown_demo(cuda_device, 5)
    args = list(_scan_args(st, cfg))
    bad = list(args)
    bad[2] = args[2].double()
    with pytest.raises(ValueError):
        anast_scan(*bad)
    bad = list(args)
    bad[1] = args[1].long()
    with pytest.raises(ValueError):
        anast_scan(*bad)


# the wider layouts: 3D grids (gz > 1) and the 9-cell window
LAYOUTS = {"3d": growth_3d_config(),
           "9cell": dataclasses.replace(GROWTH_PRESETS["demo"], t_steps=30,
                                        voxel_size=0.05),
           "3d9": growth_3d_config(voxel_size=0.05)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_anast_scan_matches_plain_on_wider_layouts(layout,
                                                   cuda_device):  # noqa: F811
    """K4 on a state grown on the card in 3D (gz 5, the corner window),
    with the 9-cell window in 2D, and both (gz 7, voxel 0.05): (d², tt,
    id) bit-equal to the plain version (tolerance 0), and to the CPU
    emulation of its order of work."""
    cfg = LAYOUTS[layout]
    st, _, _ = run_growth(cfg, device=cuda_device)
    args = scan_args(st, cfg)
    assert args[-2:] == {"3d": (5, 4), "9cell": (1, 9),
                         "3d9": (7, 9)}[layout]
    before = launch_counts()["anast_scan"]
    k = anast_scan(*args)
    p = anast_scan_plain(*args)
    e = emulate_anast_by_cell(args)
    torch.cuda.synchronize()
    assert launch_counts()["anast_scan"] == before + 1
    assert int((k[2] < st.capacity).sum()) > 100
    for a, b, c in zip(k, p, e):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)


def test_anast_scan_bit_equal_on_tie_state_3d(cuda_device):  # noqa: F811
    """K4 on the 3D tie-heavy state (ties at bitwise-equal d² in
    different z cells and ranks of one column): bit-equal to the plain
    version, whose position order is rank·gz + cz."""
    cfg, st = tie_state_3d(cuda_device)
    args = scan_args(st, cfg)
    k = anast_scan(*args)
    p = anast_scan_plain(*args)
    torch.cuda.synchronize()
    assert int((k[2] < st.capacity).sum()) >= 100
    for a, b in zip(k, p):
        assert torch.equal(a, b)


def test_growth_3d_through_anast_scan_equals_plain(cuda_device):  # noqa: F811
    """The reference 3D configuration grown through K4 and through its
    plain version with the same draws: the same trajectory."""
    cfg = growth_3d_config()
    reset_launch_counts()
    st_k, _, hist_k = run_growth(cfg, device=cuda_device)
    assert launch_counts()["anast_scan"] == cfg.t_steps
    draws = TorchDraws(cfg.seed, cuda_device)
    st, ea = init_state(cfg, petri_dish(cfg), device=cuda_device,
                        draws=draws)
    for _ in range(cfg.t_steps):
        st = growth_step(st, ea, cfg, draws.step(cfg.max_hyphae,
                                                 st.sub.dtype, True, True),
                         scan=anast_scan_plain)
    assert summarize(st, cfg) == {k: v for k, v in hist_k[-1].items()
                                  if k != "step"}
    assert hist_k[-1]["anastomosed"] > 0
    for f in ("start", "end", "theta", "phi", "sub", "state", "prev",
              "hypha", "tip"):
        assert torch.equal(getattr(st_k, f), getattr(st, f)), f
    assert not bool(st_k.overflow)


@pytest.mark.parametrize("three_d", [False, True], ids=["corner", "column"])
def test_anast_scan_more_than_32_tips_a_cell(three_d,
                                             cuda_device):  # noqa: F811
    """P11: K4 takes a cell's tips in groups of 32. A growth whose tip
    table holds more than 40 tips in one cell (``many_tips_case``: 2D,
    the corner form; 3D, the column form) grown through K4 equals the
    same draws grown through its plain version, and on its last state K4's
    (d², tt, id) equal the plain version's bit for bit."""
    cfg, env = many_tips_case(three_d)
    reset_launch_counts()
    st_k, _, _ = run_growth(cfg, env=env, device=cuda_device)
    assert launch_counts()["anast_scan"] == cfg.t_steps
    draws = TorchDraws(cfg.seed, cuda_device)
    st, ea = init_state(cfg, env, device=cuda_device, draws=draws)
    for _ in range(cfg.t_steps):
        st = growth_step(st, ea, cfg,
                         draws.step(cfg.max_hyphae, st.sub.dtype, True,
                                    cfg.three_d),
                         scan=anast_scan_plain)
    for f in ("start", "end", "theta", "phi", "sub", "state", "prev",
              "hypha", "tip"):
        assert torch.equal(getattr(st_k, f), getattr(st, f)), f
    assert not bool(st_k.overflow)
    args = scan_args(st_k, cfg)
    assert args[-2:] == ((4, 4) if three_d else (1, 4))
    assert int(args[13][2].max()) > 40
    k = anast_scan(*args)
    p = anast_scan_plain(*args)
    torch.cuda.synchronize()
    assert int((k[2] < st_k.capacity).sum()) > 40
    for a, b in zip(k, p):
        assert torch.equal(a, b)


def _cg_case(device, n_nodes=7375, frac=0.05, basis="const", max_iter=3000):
    """A cold cg + coarse solve of the full ramp system on a synthetic
    mesh, a fraction of the elements fractured and the islands pinned:
    (model, active, anchored, x0, cfg) on ``device``."""
    coords, conn = synthetic_mesh(n_nodes)
    cfg = FeaConfig(dtype="float32", operator="chain", precond="coarse",
                    grip_length=grip_for(coords), rtol=1e-5,
                    max_iter=max_iter, coarse_basis=basis)
    m = build_model(coords, conn, cfg, device)
    rng = np.random.default_rng(2)
    act_np = rng.random(m.n_elems) > frac
    grip = (m.top_nodes | m.bot_nodes).cpu().numpy()
    anch = torch.as_tensor(anchored_mask_host(np.asarray(conn), act_np, grip),
                           device=device)
    x0 = torch.zeros((m.n_nodes, 3), device=device)
    return m, torch.as_tensor(act_np, device=device), anch, x0, cfg


def _cg_cpu(m, act, anch, x0, cfg):
    """K5's plain version on the CPU on copies of the same inputs."""
    return m.chain_launch.on("cpu").plain(*moved((act, anch), "cpu"), 0.02,
                                          -0.02, x0.cpu(), cfg)


@pytest.mark.parametrize("basis", ["const", "linear"])
def test_chain_cg_setup_matches_plain(cuda_device, basis):  # noqa: F811
    """The kernel's set-up (masks, prescribed values, start vector,
    block-Jacobi inverse, coarse matrix, its scaling and inverse) equals
    the plain set-up on the CPU bit for bit: both add in one order."""
    m, act, anch, x0, cfg = _cg_case(cuda_device, basis=basis)
    got = m.chain_launch.setup(act, anch, 0.02, -0.02, x0, cfg)
    want = m.chain_launch.on("cpu").setup(*moved((act, anch), "cpu"), 0.02,
                                          -0.02, x0.cpu(), cfg)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.parametrize("max_iter", [1, 10])
@pytest.mark.parametrize("basis", ["const", "linear"])
def test_chain_cg_matches_plain_early(cuda_device, max_iter,  # noqa: F811
                                      basis):
    """K5 against its plain version on the CPU after 1 and 10 iterations:
    the same float32 operations, float64 sums in another order: 1e-6 of
    max |x|."""
    m, act, anch, x0, cfg = _cg_case(cuda_device, basis=basis,
                                     max_iter=max_iter)
    before = launch_counts()["chain_cg"]
    xk, sk = m.chain_launch.solve(act, anch, 0.02, -0.02, x0, cfg)
    xp, sp = _cg_cpu(m, act, anch, x0, cfg)
    torch.cuda.synchronize()
    assert launch_counts()["chain_cg"] == before + 1
    assert int(sk[0]) == int(sp[0]) == max_iter
    assert rel_err(xk.cpu(), xp) <= 1e-6
    assert rel_err(sk[1:].cpu(), sp[1:]) <= 1e-5


def test_chain_cg_matches_plain_at_309k_shapes(cuda_device):  # noqa: F811
    """At the shapes of the sweep path's largest solve (103,000 nodes: 403
    clusters, more than the card's resident blocks, so a block loops over
    clusters; the Gauss-Jordan inverse at nc 1,209), on its own inputs
    (intact, cold): the set-up equals the plain set-up on the CPU bit for
    bit, and x after 1 and 10 iterations its plain version on the CPU
    within 1e-6 of max |x|, the iterations equal."""
    from mycelium_tpu_torch.kernels.chain_cg import layout_of, resident_blocks
    m, act, anch, x0, cfg = _cg_case(cuda_device, n_nodes=103000, frac=0.0)
    nbc, _, _ = layout_of(m.n_nodes, cfg)
    assert nbc > resident_blocks(torch.cuda.current_device())
    cpu = m.chain_launch.on("cpu")
    cpu_in = moved((act, anch), "cpu")
    got = m.chain_launch.setup(act, anch, 0.02, -0.02, x0, cfg)
    want = cpu.setup(*cpu_in, 0.02, -0.02, x0.cpu(), cfg)
    assert want["ainv"].shape == (1209, 1209)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k
    for it in (1, 10):
        ci = dataclasses.replace(cfg, max_iter=it)
        xk, sk = m.chain_launch.solve(act, anch, 0.02, -0.02, x0, ci)
        xp, sp = cpu.plain(*cpu_in, 0.02, -0.02, x0.cpu(), ci, setup=want)
        assert int(sk[0]) == int(sp[0]) == it
        assert rel_err(xk.cpu(), xp) <= 1e-6


def test_chain_cg_converged_matches_plain(cuda_device):  # noqa: F811
    """Converged (rtol 1e-5, ~300 iterations at 22k DOF): the iterations
    equal to the CPU plain version's and x within 1e-6 of max |x|."""
    m, act, anch, x0, cfg = _cg_case(cuda_device)
    xk, sk = m.chain_launch.solve(act, anch, 0.02, -0.02, x0, cfg)
    xp, sp = _cg_cpu(m, act, anch, x0, cfg)
    ik, ip = int(sk[0]), int(sp[0])
    assert float(sk[1]) <= float(sk[2]) and float(sp[1]) <= float(sp[2])
    assert ik > 50 and ik == ip
    assert rel_err(xk.cpu(), xp) <= 1e-6


def test_chain_cg_is_deterministic(cuda_device):  # noqa: F811
    """No float atomics: two launches on the same inputs give the same x
    and the same stats, bit for bit; so do two models built afresh, in
    this process and in another."""
    import subprocess
    import sys
    m, act, anch, x0, cfg = _cg_case(cuda_device, max_iter=200)
    x1, s1 = m.chain_launch.solve(act, anch, 0.02, -0.02, x0, cfg)
    x1, s1 = x1.clone(), s1.clone()
    x2, s2 = m.chain_launch.solve(act, anch, 0.02, -0.02, x0, cfg)
    assert torch.equal(x1, x2) and torch.equal(s1, s2)
    cfg = dataclasses.replace(cfg, max_iter=3000)
    runs = []
    for _ in range(2):
        mf, act, anch, x0, _ = _cg_case(cuda_device)
        res = solve_displacement(mf, act, 0.02, -0.02, x0, cfg, anch)
        runs.append((res.iters, res.x.cpu().numpy().tobytes()))
    assert runs[0] == runs[1]
    code = ("import sys, hashlib; sys.path[:0] = sys.argv[1:]; "
            "import torch_support as ts, test_torch_kernels as tk; "
            "from mycelium_tpu_torch.fea import solve_displacement; "
            "import dataclasses, torch; "
            "m, a, an, x0, c = tk._cg_case(torch.device('cuda')); "
            "c = dataclasses.replace(c, max_iter=3000); "
            "r = solve_displacement(m, a, 0.02, -0.02, x0, c, an); "
            "print(r.iters, hashlib.sha256(r.x.cpu().numpy().tobytes())"
            ".hexdigest())")
    import hashlib
    import os
    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-c", code, here,
                          os.path.dirname(here)], capture_output=True,
                         text=True, check=True, timeout=600)
    iters, digest = out.stdout.split()[-2:]
    assert int(iters) == runs[0][0]
    assert digest == hashlib.sha256(runs[0][1]).hexdigest()


def test_chain_cg_rejects_bad_tensors(cuda_device):  # noqa: F811
    m, act, anch, x0, cfg = _cg_case(cuda_device, 1500)
    launch = m.chain_launch
    with pytest.raises(ValueError):
        launch.solve(act, anch, 0.02, -0.02, x0.double(), cfg)
    with pytest.raises(ValueError):       # (N, 3) but not contiguous
        launch.solve(act, anch, 0.02, -0.02, x0.T.contiguous().T, cfg)
    with pytest.raises(ValueError):       # the anchored mask of a smaller mesh
        launch.solve(act, anch[:-1].contiguous(), 0.02, -0.02, x0, cfg)
    with pytest.raises(ValueError):       # the active mask on the host
        launch.solve(act.cpu(), anch, 0.02, -0.02, x0, cfg)


def test_cg_coarse_solve_goes_through_k5(cuda_device):  # noqa: F811
    """solve_displacement with cg + coarse on the chain operator is one K5
    launch (and no K1-K3 launch), and agrees with the plain path on the
    host: the same iterations, x within 1e-6 of max |x|."""
    coords, conn = synthetic_mesh(3000)
    cfg = FeaConfig(dtype="float32", operator="chain", precond="coarse",
                    grip_length=grip_for(coords), rtol=1e-5, max_iter=3000)
    m = build_model(coords, conn, cfg, cuda_device)
    mc = build_model(coords, conn, cfg, "cpu")
    act = torch.ones(m.n_elems, dtype=torch.bool)
    x0 = torch.zeros((m.n_nodes, 3))
    reset_launch_counts()
    res = solve_displacement(m, act.to(cuda_device), 0.01, -0.01,
                             x0.to(cuda_device), cfg)
    counts = launch_counts()
    assert res.converged and counts["chain_cg"] == 1, counts
    assert counts["chain_matvec"] == counts["pcr_apply"] == 0
    ref = solve_displacement(mc, act, 0.01, -0.01, x0, cfg)
    assert ref.converged and res.iters == ref.iters
    assert rel_err(res.x.cpu(), ref.x) <= 1e-6


def _tree_case(device, n_nodes=7375, frac=0.05, max_iter=20000,
               rough=False, min_levels=1, window=None):
    """K6's launch and the arguments of a cold cg + tree solve of the full
    ramp system on a synthetic mesh, a fraction of the elements fractured
    and the islands pinned. ``rough``: zero load and a random start
    instead, so that one iteration moves x by alpha·M^-1(-A x0), one apply
    of the factored preconditioner on a vector with no smoothness.
    ``window``: a launch whose tables were cut for that window instead of
    the kernel's own, so that the levels with a longer path keep the global
    rounds."""
    coords, conn = synthetic_mesh(n_nodes)
    cfg = FeaConfig(dtype="float32", operator="chain", precond="tree",
                    grip_length=grip_for(coords), rtol=1e-6,
                    tree_reg_rel=1e-7, max_iter=max_iter)
    m = build_model(coords, conn, cfg, device)
    assert m.tree_kernel and len(m.tree.meta.level_steps) >= min_levels
    launch = m.tree_launch
    if window is not None:
        launch = TreeCgLaunch(
            m.chain, m.tree, m.tree_fast,
            build_tree_kernel_tables(m.tree, m.conn, window=window), m.conn,
            m.top_nodes, m.bot_nodes)
    rng = np.random.default_rng(2)
    act_np = rng.random(m.n_elems) >= frac
    grip = (m.top_nodes | m.bot_nodes).cpu().numpy()
    anch = torch.as_tensor(anchored_mask_host(conn, act_np, grip),
                           device=device)
    x0 = torch.as_tensor(rng.standard_normal((m.n_nodes, 3)) * rough,
                         dtype=torch.float32, device=device)
    dy = 0.0 if rough else 0.02
    return launch, (torch.as_tensor(act_np, device=device),
                    m.free_nodes & anch, dy, -dy, x0, cfg.rtol, cfg.reg,
                    preconditioner_reg(m, cfg), cfg.max_iter)


@pytest.mark.parametrize("rtol,converged", [(1e-6, False), (0.03, True)])
def test_tree_cg_stall_exit_matches_plain(cuda_device, rtol,  # noqa: F811
                                          converged):
    """K6's stall exit on the card. A 5% fractured random forest in float32
    with every level on PCR stalls far from rtol 1e-6
    (tests/test_torch_stall.py): the kernel stops one STALL_WINDOW after
    its last improvement, not converged; with rtol 0.03 one NEAR_WINDOW
    after, on the plateau, converged. Against its plain version on the CPU
    on copies of the same inputs: the same iterations, the same count
    without improvement and the same verdict, x within 1e-6 of max |x|."""
    coords, conn = random_forest_mesh(260, 8, 11)
    cfg = FeaConfig(dtype="float32", operator="chain", precond="tree",
                    grip_length=grip_for(coords), rtol=rtol,
                    tree_reg_rel=1e-7, max_iter=2000, warm_start=False,
                    cg_restarts=0, tree_dense_tail=0)
    m = build_model(coords, conn, cfg, cuda_device)
    assert m.tree_kernel
    rng = np.random.default_rng(0)
    act_np = rng.random(m.n_elems) >= 0.05
    grip = (m.top_nodes | m.bot_nodes).cpu().numpy()
    anch = torch.as_tensor(anchored_mask_host(conn, act_np, grip),
                           device=cuda_device)
    args = (torch.as_tensor(act_np, device=cuda_device), m.free_nodes & anch,
            0.02, -0.02, torch.zeros((m.n_nodes, 3), device=cuda_device),
            cfg.rtol, cfg.reg, preconditioner_reg(m, cfg), cfg.max_iter)
    xk, sk = m.tree_launch.solve(*args)
    xc, sc = m.tree_launch.on("cpu").plain(*moved(args, "cpu"))
    sk = sk.cpu()
    window = NEAR_WINDOW if converged else STALL_WINDOW
    assert int(sk[0]) == int(sc[0]) and window < int(sk[0]) < window + 20
    assert int(sk[3]) == int(sc[3]) >= window
    verdicts = [stall_converged(float(st[1]), float(st[2]), int(st[3]))
                for st in (sk, sc)]
    assert verdicts == [converged, converged]
    assert rel_err(xk.cpu(), xc) <= 1e-6


# K6 after one iteration or one apply, as a share of the largest entry.
# Against the plain version on the card: the same float32 operations, but
# the plain version adds a junction's Schur corrections and attachment
# products with index_add_ (float atomics, any order), and each further
# level's adjugate inverses amplify the difference (readings on an H100 up
# to 5.7e-5 on these forests of 3 and 5 levels). Against the plain version
# on the CPU on copies of the same inputs, where index_add_ adds in the
# kernel's order: bit-equal in every recorded run; the bound leaves a few
# float32 ulps for a host whose vector sums round otherwise. The second is
# what can see a fault in a small level.
ONE_STEP_TOL = 5e-4
ONE_STEP_TOL_SEQUENTIAL = 1e-6


def _one_step(launch, args):
    """(share against plain on the card, share against plain on the CPU)
    of the change of x over one iteration."""
    args = args[:-1] + (1,)
    start = args[1][:, None] * args[4]   # free·x0, what every side starts from
    xk, sk = launch.solve(*args)
    xp, sp = launch.plain(*args)
    xc, sc = launch.on("cpu").plain(*moved(args, "cpu"))
    assert int(sk[0]) == int(sp[0]) == int(sc[0]) == 1
    dk, dc = (xk - start).cpu(), xc - start.cpu()
    assert float(dc.abs().max()) > 0
    return rel_err(dk, (xp - start).cpu()), rel_err(dk, dc)


@pytest.mark.parametrize("frac", [0.0, 0.05])
def test_tree_cg_matches_plain(cuda_device, frac):  # noqa: F811
    """K6 against its plain version after 1 iteration (ONE_STEP_TOL of
    max |x| on the card, ONE_STEP_TOL_SEQUENTIAL on the CPU) and converged
    (1e-5, iterations within 1), where CG has damped the difference."""
    launch, args = _tree_case(cuda_device, frac=frac, min_levels=3)
    before = launch_counts()["tree_cg"]
    card, cpu = _one_step(launch, args)
    assert launch_counts()["tree_cg"] == before + 1
    assert card <= ONE_STEP_TOL and cpu <= ONE_STEP_TOL_SEQUENTIAL
    xk, sk = launch.solve(*args)
    xp, sp = launch.plain(*args)
    assert float(sk[1]) <= float(sk[2]) and float(sp[1]) <= float(sp[2])
    assert 1 <= int(sk[0]) < 50 and abs(int(sk[0]) - int(sp[0])) <= 1
    assert rel_err(xk.cpu(), xp.cpu()) <= 1e-5
    # every level windowed: one barrier a level to factor
    assert all(launch.tables.windowed)
    assert launch.last_barriers() == barrier_count(launch.tables, int(sk[0]))


@pytest.mark.parametrize("frac", [0.0, 0.05])
@pytest.mark.parametrize("n_nodes", [7375, 33000])
def test_tree_cg_one_apply_matches_plain(cuda_device, n_nodes,  # noqa: F811
                                         frac):
    """One apply of K6's factored preconditioner on a random vector against
    the plain version's, on forests of 3 and 5 levels, where fills, flips
    and attachments cross several levels: zero load, a random start, one
    iteration, the change of x. On the deeper forest also the load case
    after one iteration."""
    levels = {7375: 3, 33000: 5}[n_nodes]
    card, cpu = _one_step(*_tree_case(cuda_device, n_nodes, frac, rough=True,
                                      min_levels=levels))
    assert card <= ONE_STEP_TOL and cpu <= ONE_STEP_TOL_SEQUENTIAL
    if n_nodes == 33000:
        card, cpu = _one_step(*_tree_case(cuda_device, n_nodes, frac,
                                          min_levels=levels))
        assert card <= ONE_STEP_TOL and cpu <= ONE_STEP_TOL_SEQUENTIAL


@pytest.mark.parametrize("frac", [0.0, 0.05])
@pytest.mark.parametrize("n_nodes", [7375, 33000])
def test_tree_cg_setup_matches_plain(cuda_device, n_nodes,  # noqa: F811
                                     frac):
    """The kernel's set-up phase, launched alone, against the plain set-up
    on the CPU on copies of the same inputs: the masks, the prescribed
    values, the start vector, the forest diagonal (its jump terms added in
    the CSR's order, which is a sequential index_add_'s), the left-edge and
    the attachment couplings: equal values, tolerance 0."""
    launch, args = _tree_case(cuda_device, n_nodes, frac, rough=True)
    active, free, _, _, x0, _, _, reg_pc, _ = args
    got = launch.setup(active, free, 0.013, -0.007, x0, reg_pc)
    want = launch.on("cpu").setup(active.cpu(), free.cpu(), 0.013, -0.007,
                                  x0.cpu(), reg_pc)
    assert set(got) == set(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        assert bool((got[name].cpu() == want[name]).all()), name


@pytest.mark.parametrize("window", [16, 64])
def test_tree_cg_global_rounds_match_windowed(cuda_device,  # noqa: F811
                                              window):
    """A launch whose tables leave the levels with a path longer than
    ``window`` on global rounds (one barrier a round, halo windows in the
    apply) against the plain version on the CPU and against the all-windowed
    launch: the two forms compute the same numbers."""
    launch, args = _tree_case(cuda_device, frac=0.05)
    forced, _ = _tree_case(cuda_device, frac=0.05, window=window)
    assert not all(forced.tables.windowed) and any(forced.tables.windowed)
    card, cpu = _one_step(forced, args)
    assert card <= ONE_STEP_TOL and cpu <= ONE_STEP_TOL_SEQUENTIAL
    xw, sw = launch.solve(*args)
    xg, sg = forced.solve(*args)
    assert int(sw[0]) == int(sg[0])
    assert rel_err(xg.cpu(), xw.cpu()) <= 1e-6
    assert forced.last_barriers() == barrier_count(forced.tables, int(sg[0]))
    assert forced.last_barriers() > launch.last_barriers()


def test_tree_cg_is_deterministic(cuda_device):  # noqa: F811
    """No float atomics, in the set-up neither: two launches on the same
    inputs give the same x and the same stats, bit for bit; the two results
    are different buffers."""
    launch, args = _tree_case(cuda_device)
    x1, s1 = launch.solve(*args)
    x2, s2 = launch.solve(*args)
    assert x1.data_ptr() != x2.data_ptr()
    assert torch.equal(x1, x2) and torch.equal(s1, s2)


def test_tree_cg_consecutive_solves_keep_no_state(cuda_device):  # noqa: F811
    """Two consecutive solves of one launch with different masks and
    prescribed values equal two solves of fresh launches: nothing of the
    first is left in the scratch, and the first result is still intact
    after the second."""
    launch, a1 = _tree_case(cuda_device, frac=0.05)
    _, a2 = _tree_case(cuda_device, frac=0.0)
    a2 = a2[:2] + (0.011, -0.017) + a2[4:]
    x1, s1 = launch.solve(*a1)
    x2, s2 = launch.solve(*a2)
    f1, _ = _tree_case(cuda_device)
    f2, _ = _tree_case(cuda_device)
    y1, t1 = f1.solve(*a1)
    y2, t2 = f2.solve(*a2)
    assert torch.equal(x1, y1) and torch.equal(s1, t1)
    assert torch.equal(x2, y2) and torch.equal(s2, t2)
    assert not torch.equal(x1, x2)


def test_tree_cg_rejects_bad_tensors(cuda_device):  # noqa: F811
    launch, args = _tree_case(cuda_device, 3000)
    args = list(args)
    bad = list(args)
    bad[4] = args[4].double()                # x0
    with pytest.raises(ValueError):
        launch.solve(*bad)
    bad = list(args)
    bad[4] = args[4].T.contiguous().T        # x0: (N, 3) but not contiguous
    with pytest.raises(ValueError):
        launch.solve(*bad)
    bad = list(args)
    bad[1] = args[1][:-1].contiguous()       # free of the wrong size
    with pytest.raises(ValueError):
        launch.solve(*bad)
    bad = list(args)
    bad[0] = args[0].cpu()                   # active on the host
    with pytest.raises(ValueError):
        launch.solve(*bad)
    unordered = TreeCgLaunch(
        launch.cplan, launch.tplan, launch.fast,
        dataclasses.replace(launch.tables, ordered=False), launch.conn,
        launch.top_nodes, launch.bot_nodes)
    with pytest.raises(ValueError):
        unordered.solve(*args)
    short = TreeCgLaunch(
        launch.cplan, launch.tplan, launch.fast,
        dataclasses.replace(launch.tables, fg=launch.tables.fg[:-1]),
        launch.conn, launch.top_nodes, launch.bot_nodes)
    with pytest.raises(ValueError):
        short.solve(*args)


def test_cg_tree_solve_goes_through_k6(cuda_device):  # noqa: F811
    """Below the gate solve_displacement with cg + tree is one K6 launch
    (and no K1-K3 launch), whatever the coarse weight, and agrees with the
    plain path on the host to 1e-4 of max |x|; above it (forced) it is the
    hybrid."""
    coords, conn = random_forest_mesh(900, 18, 4)
    cfg = FeaConfig(dtype="float32", operator="chain", precond="tree",
                    grip_length=0.1, rtol=1e-6, tree_coarse_weight=0.25)
    m = build_model(coords, conn, cfg, cuda_device)
    mc = build_model(coords, conn, cfg, "cpu")
    assert m.tree_kernel and mc.tree_kernel
    act = torch.ones(m.n_elems, dtype=torch.bool)
    x0 = torch.zeros((m.n_nodes, 3))
    reset_launch_counts()
    res = solve_displacement(m, act.to(cuda_device), 0.01, -0.01,
                             x0.to(cuda_device), cfg)
    counts = launch_counts()
    assert res.converged and counts["tree_cg"] == 1, counts
    assert counts["chain_matvec"] == counts["pcr_factor"] \
        == counts["pcr_apply"] == 0
    ref = solve_displacement(mc, act, 0.01, -0.01, x0, cfg)
    assert ref.converged and abs(res.iters - ref.iters) <= 1
    assert rel_err(res.x.cpu(), ref.x) <= 1e-4
    reset_launch_counts()
    hyb = solve_displacement(dataclasses.replace(m, tree_kernel=False),
                             act.to(cuda_device), 0.01, -0.01,
                             x0.to(cuda_device), cfg)
    counts = launch_counts()
    assert hyb.converged and counts["tree_cg"] == 0
    assert counts["pcr_factor"] > 0 and counts["pcr_apply"] > 0
    assert rel_err(hyb.x.cpu(), ref.x) <= 5e-4


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_node_sums_bit_equal_on_card(cuda_device, dtype):  # noqa: F811
    """The diagonal blocks and the 'scatter' operator through
    ``ordered_sum`` over the node incidence CSR: twice the same bits on the
    card, and the CPU's."""
    coords, conn = synthetic_mesh(8000)
    cfg = FeaConfig(dtype=dtype, grip_length=grip_for(coords))
    m = build_model(coords, conn, cfg, cuda_device)
    gen = np.random.default_rng(4)
    act = torch.as_tensor(gen.random(m.n_elems) > 0.05, device=cuda_device)
    free = m.free_nodes
    u = torch.as_tensor(gen.standard_normal((m.n_nodes, 3)),
                        dtype=m.dtype, device=cuda_device)
    reset_launch_counts()
    one = node_sums(m, act, free, cfg.reg, u)
    two = node_sums(m, act, free, cfg.reg, u)
    torch.cuda.synchronize()
    assert launch_counts()["ordered_sum"] == 4
    ref = node_sums(moved(m, "cpu"), act.cpu(), free.cpu(), cfg.reg, u.cpu())
    for n in ref:
        assert torch.equal(one[n], two[n]), n
        assert torch.equal(one[n].cpu(), ref[n]), n


def test_ramp_resume_bit_equal_on_k6(cuda_device, tmp_path):  # noqa: F811
    """A ramp on K6 split by a checkpoint and resumed equals the unsplit
    run bit for bit: the warm start comes from the file, never from a
    launch buffer."""
    from mycelium_tpu_torch.fea import run_ramp
    coords, conn = synthetic_mesh(2000)
    cfg = hybrid_fea_config(n_steps=12, displacement_max=0.025,
                            grip_length=grip_for(coords))
    m = build_model(coords, conn, cfg, cuda_device)
    assert m.tree_kernel
    reset_launch_counts()
    full = run_ramp(coords, conn, cfg, model=m)
    assert launch_counts()["tree_cg"] >= 12
    ckpt = str(tmp_path / "fea.npz")
    run_ramp(coords, conn, cfg, model=m, checkpoint_path=ckpt,
             checkpoint_every=7)
    res = run_ramp(coords, conn, cfg, model=m, resume_from=ckpt)
    assert (~full.active_record[-1]).any(), "no element fractured"
    for f in ("stress_record", "active_record", "disp_record",
              "force_disp", "cg_iters"):
        np.testing.assert_array_equal(getattr(res, f), getattr(full, f),
                                      err_msg=f)


def test_growth_resume_bit_equal_on_k4(cuda_device, tmp_path):  # noqa: F811
    """Growth split at step 20 of 40 and resumed through K4 equals the
    unsplit run in every field (the generator's CUDA state travels in the
    file)."""
    from mycelium_tpu_torch.io.checkpoint import (GROWTH_FIELDS,
                                                  load_growth_state)
    cfg = dataclasses.replace(GROWTH_PRESETS["demo"], t_steps=40)
    reset_launch_counts()
    full, _, hist = run_growth(cfg, device=cuda_device)
    assert launch_counts()["anast_scan"] == 40
    ckpt = str(tmp_path / "growth.npz")
    run_growth(dataclasses.replace(cfg, t_steps=20), device=cuda_device,
               checkpoint_path=ckpt, checkpoint_every=20)
    st, draws = load_growth_state(ckpt, cfg, cuda_device)
    res, _, hist_r = run_growth(cfg, device=cuda_device, initial_state=st,
                                draws=draws)
    assert hist_r == hist[20:]
    for k in GROWTH_FIELDS:
        a, b = getattr(res, k), getattr(full, k)
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), k
    with pytest.raises(ValueError, match="cuda generator"):
        load_growth_state(ckpt, cfg, "cpu")


@pytest.fixture
def one_rank_group(cuda_device):  # noqa: F811
    """A process group of this process alone on NCCL, destroyed after."""
    from mycelium_tpu_torch.utils.dist import initialize_single
    initialize_single(cuda_device)
    yield cuda_device
    torch.distributed.destroy_process_group()


def test_one_rank_nccl_sharded_solve_matches_hybrid(one_rank_group):
    """The sharded tree solve on one NCCL rank (K2, K3 and ordered_sum)
    against the single-device hybrid of the same system: 1e-3 of max |x|
    and iterations within ±1."""
    from mycelium_tpu_torch.fea.shard import sharded_cg_solver
    dev = one_rank_group
    assert torch.distributed.get_backend() == "nccl"
    coords, conn = synthetic_mesh(7375)
    cfg = hybrid_fea_config(warm_start=False)
    m = dataclasses.replace(build_model(coords, conn, cfg, dev),
                            tree_kernel=False)
    act = torch.ones(m.n_elems, dtype=torch.bool, device=dev)
    x0 = torch.zeros((m.n_nodes, 3), device=dev)
    ref = solve_displacement(m, act, 0.01, -0.01, x0, cfg)
    reset_launch_counts()
    res = sharded_cg_solver(m, cfg)(act, 0.01, -0.01, x0)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert res.converged and ref.converged
    for k in ("pcr_factor", "pcr_apply", "ordered_sum"):
        assert counts[k] > 0, counts
    assert abs(res.iters - ref.iters) <= 1
    assert rel_err(res.x.cpu(), ref.x.cpu()) <= 1e-3


def test_cli_trace_names_a_cuda_kernel(cuda_device, tmp_path):  # noqa: F811
    """``fea --trace DIR`` on the card writes a Chrome trace whose events
    include a launch of one of the port's kernels (K6 or the hybrid's,
    whichever route the preset takes)."""
    import json
    import os
    import subprocess
    import sys
    from mycelium_tpu_torch.io import export_geometry
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    coords, conn = synthetic_mesh(7375)
    d = tmp_path / "mesh"
    export_geometry(str(d), coords[conn[:, 0]], coords[conn[:, 1]])
    out = subprocess.run(
        [sys.executable, "-m", "mycelium_tpu_torch.cli", "fea", str(d),
         "--fea-steps", "3", "--no-plots", "--trace",
         str(tmp_path / "trace")], cwd=root,
        env=dict(os.environ, PYTHONPATH=root), capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    kernels = {e.get("name", "") for e in events["traceEvents"]
               if e.get("cat") == "kernel"}
    ours = ("tree_cg", "pcr_", "chain_matvec", "ordered_sum")
    assert any(o in k for k in kernels for o in ours), sorted(kernels)[:20]
