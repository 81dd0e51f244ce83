"""Shared pieces of the PyTorch-port tests (tests/test_torch_*.py): the
test meshes, the PCR level inputs, the replay of the JAX package's random
draws, the tie-heavy scan state and the fixed-order sums (which
``chip_smoke.py`` holds to the CPU too), and the fixture that hands a CUDA
device to the tests that need the card. Imports nothing of jax or the JAX
package at module level, so the card's tests (test_torch_kernels.py) and
``chip_smoke.py`` run where jax is not installed."""

import contextlib

import numpy as np
import pytest
import torch

from mycelium_tpu_torch import meshes, scenes


def random_forest_mesh(n_nodes=600, n_extra=12, seed=0):
    """The mesh of tests/test_tree_pc.py::random_forest_mesh (same seeds,
    same arrays): chains that branch, plus a few cycle-closing edges."""
    rng = np.random.default_rng(seed)
    coords = [np.zeros(3)]
    conn = []
    while len(coords) < n_nodes:
        start = int(rng.integers(0, len(coords)))
        phi = rng.uniform(0, 2 * np.pi)
        pos = coords[start].copy()
        prev = start
        for _ in range(int(rng.integers(2, 14))):
            if len(coords) >= n_nodes:
                break
            phi += rng.uniform(-0.4, 0.4)
            pos = pos + np.array([np.cos(phi), np.sin(phi), 0.0]) * 0.05
            coords.append(pos)
            conn.append([prev, len(coords) - 1])
            prev = len(coords) - 1
    for _ in range(n_extra):
        a, b = rng.integers(0, n_nodes, 2)
        if a != b:
            conn.append([a, b])
    return np.asarray(coords), np.asarray(conn, np.int32)


def synthetic_mesh(n_nodes):
    return meshes.synthetic_mesh(n_nodes)


def scene(name):
    sc = scenes.SCENES[name]()
    return sc.coords, sc.conn


def grip_for(coords, frac=0.15):
    """A grip length that leaves the middle of the mesh free."""
    y = coords[:, 1]
    return frac * float(y.max() - y.min())


def np_of(t):
    return t.detach().cpu().numpy()


def rel_err(a, b):
    """max |a - b| / max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if b.size == 0:
        return 0.0
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def level0(seed, frac, dtype="float64", device="cpu", mesh=None):
    """(D, B, fg, lg, steps) of the largest PCR level as the
    factorization builds it, under a partly fractured mask with the
    islands it cuts off pinned (as the ramp pins them)."""
    from mycelium_tpu_torch.config import FeaConfig
    from mycelium_tpu_torch.fea.chain import plan_active_masks_bool
    from mycelium_tpu_torch.fea.model import build_model
    from mycelium_tpu_torch.fea.ramp import anchored_mask_host
    from mycelium_tpu_torch.fea.tree_factor import (chain_tree_diag,
                                                    left_couplings)
    coords, conn = mesh if mesh is not None else \
        random_forest_mesh(900, 18, seed)
    cfg = FeaConfig(dtype=dtype, operator="chain", precond="tree",
                    grip_length=grip_for(coords, 0.08))
    m = build_model(coords, conn, cfg, device)
    rng = np.random.default_rng(seed)
    act_np = rng.random(m.n_elems) > frac
    grip = (m.top_nodes | m.bot_nodes).cpu().numpy()
    anch = torch.as_tensor(anchored_mask_host(np.asarray(conn), act_np,
                                              grip), device=device)
    act = torch.as_tensor(act_np, device=device)
    free_chain = (m.free_nodes & anch)[m.chain.perm]
    cab, jab = plan_active_masks_bool(m.chain, act)
    meta = m.tree.meta
    S = meta.level_offsets[1]
    reg_pc = max(cfg.reg, cfg.tree_reg_rel * meta.k_scale)
    D = chain_tree_diag(m.tree, m.tree_fast, m.chain, act, free_chain,
                        reg_pc, cab, jab)[:, :S].contiguous()
    B = left_couplings(m.tree, m.tree_fast, act, free_chain, m.n_elems,
                       cab)[:, :S].contiguous()
    p1 = meta.path_offsets[1]
    return D, B, m.tree.first_gpos[:p1], m.tree.last_gpos[:p1], \
        meta.level_steps[0]


def all_levels(model, active, free, reg_pc):
    """[(D, B, fg, lg, steps)] of every level as the all-PCR factorization
    (what K6 factors) hands them to ``pcr_factor``: the diagonal with the
    earlier levels' Schur corrections, the left couplings with their fill
    edges, the paths' first and last slots within the level."""
    from dataclasses import replace
    from mycelium_tpu_torch.fea import tree_factor as tf
    from mycelium_tpu_torch.fea.chain import plan_active_masks_bool
    plan = replace(model.tree, meta=replace(model.tree.meta, n_pcr=-1))
    cab, jab = plan_active_masks_bool(model.chain, active)
    D, B, katt = tf.tree_factor_inputs(
        plan, model.tree_fast, model.chain, active, free,
        free[model.chain.perm], reg_pc, model.conn, cab, jab)
    seen = []
    real = tf.pcr_factor

    def record(D_l, B_l, fg, lg, steps):
        seen.append((D_l, B_l, fg, lg, steps))
        return real(D_l, B_l, fg, lg, steps)

    tf.pcr_factor = record
    try:
        tf.tree_factor_levels(plan, D, B, katt, len(plan.meta.level_steps))
    finally:
        tf.pcr_factor = real
    return seen


def emulate_tree_setup(launch, active, free, dy_top, dy_bot, x0, reg_pc):
    """K6's set-up phase (csrc/tree_cg.cu::setup_phase) in numpy, from the
    tables the kernel is handed and in its order of operations, one
    rounding an operation in the model's dtype; the jump terms of the
    diagonal are added one after another in the order of the per-node jump
    CSR. Returns the dict ``TreeCgLaunch.setup`` returns."""
    cp, k, tk, fast = launch.cplan, launch.cplan.k32, launch.tables, \
        launch.fast
    dt = np_of(cp.chain_kbd).dtype.type
    n, S, P, E = launch.n, launch.S, launch.P, launch.n_elems
    active, free = np_of(active).astype(bool), np_of(free).astype(bool)
    perm = np_of(k.perm)

    def elem_active(e):
        e = np_of(e)
        return (e >= 0) & (e < E) & active[np.clip(e, 0, max(E - 1, 0))]

    def edge_k3(pack, kbd, m):
        pack, kbd = np_of(pack), np_of(kbd)
        kd = (pack[:, 3] - kbd) * m
        kb = kbd * m
        planes = []
        for i in range(3):
            for j in range(3):
                v = pack[:, i] * pack[:, j] * kd
                planes.append(v + kb if i == j else v)
        return np.stack(planes)

    fr = free[perm]
    freem = fr.astype(dt)
    cab, jab = elem_active(k.chain_elem), elem_active(k.jump_elem)
    uy = np_of(launch.top_nodes)[perm].astype(dt) * dt(dy_top) \
        + np_of(launch.bot_nodes)[perm].astype(dt) * dt(dy_bot)
    uk = np.stack([np.zeros_like(uy), uy, np.zeros_like(uy)])
    x = freem * np_of(x0).astype(dt)[perm].T + (dt(1) - freem) * uk
    kc = edge_k3(k.chain_pack, cp.chain_kbd,
                 (cab & np_of(fast.chain_tree)).astype(dt))
    km = np.concatenate([np.zeros((9, 1), dt), kc[:, :-1]], axis=1)
    kj = edge_k3(k.jump_pack, cp.jump_kbd,
                 (jab & np_of(fast.jump_tree)).astype(dt))
    jptr, jent = np_of(k.jump_ptr), np_of(k.jump_ent)
    acc = np.zeros((9, S), dt)
    for q in np.nonzero(np.diff(jptr)[:S])[0]:
        for e in range(jptr[q], jptr[q + 1]):
            acc[:, q] = acc[:, q] + kj[:, jent[e] >> 1]
    p = kc[:, :S] + km[:, :S]
    p = p + acc
    d9 = np.stack([np.where(fr[:S], p[c] + dt(reg_pc), dt(1)) if c % 4 == 0
                   else np.where(fr[:S], p[c], dt(0)) for c in range(9)])
    fprev = np.concatenate([[False], fr[:S][:-1]]) if S else fr[:0]
    m = (elem_active(tk.left_elem) & fr[:S] & fprev).astype(dt)
    bel = -np_of(fast.left_k3) * m
    ok = elem_active(tk.att_elem) & free[np_of(tk.att_na)] \
        & free[np_of(tk.att_nb)]
    katt = (-np_of(tk.att_k3) * ok.astype(dt)[:, None]).reshape(P, 2, 3, 3)
    return dict(uk=uk, x=x, freem=freem, cact=cab.astype(dt),
                jact=jab.astype(dt), d9=d9, bel=bel, katt=katt)


def emulate_chain_setup(launch, active, anchored, dy_top, dy_bot, x0, cfg):
    """K5's set-up (csrc/chain_cg.cu: setup_phase, normalize_phase and the
    Gauss-Jordan pivots) in numpy, from the tables the kernel is handed and
    in its order of operations: float32 arithmetic one rounding an
    operation, each coarse entry a float64 sum over the block's
    contribution codes in list order, rounded once. Returns the dict
    ``ChainCgLaunch.setup`` returns."""
    from mycelium_tpu_torch.kernels.chain_cg import layout_of
    f32, f64 = np.float32, np.float64
    cp, k = launch.cplan, launch.cplan.k32
    n, E = launch.n, launch.n_elems
    nbc, width, nbas = layout_of(n, cfg)
    plan = launch.plans.get(nbc, width, nbas)
    active = np_of(active).astype(bool)
    free = np_of(launch.free_nodes).astype(bool)
    if anchored is not None:
        free = free & np_of(anchored).astype(bool)
    perm = np_of(k.perm)
    cpack, ckbd = np_of(k.chain_pack), np_of(cp.chain_kbd)
    jpack, jkbd = np_of(k.jump_pack), np_of(cp.jump_kbd)
    ja, jb = np_of(k.ja), np_of(k.jb)
    jptr, jent = np_of(k.jump_ptr), np_of(k.jump_ent)

    def act(e):
        return 0 <= e < E and active[e]

    cact = np.array([act(e) for e in np_of(k.chain_elem)], f32)
    jact = np.array([act(e) for e in np_of(k.jump_elem)], f32)
    fr = free[perm]
    freem = fr.astype(f32)
    uy = (np_of(launch.top_nodes)[perm].astype(f32) * f32(dy_top)
          + np_of(launch.bot_nodes)[perm].astype(f32) * f32(dy_bot))
    uk = np.stack([np.zeros(n, f32), uy, np.zeros(n, f32)])
    x = freem * np_of(x0).astype(f32)[perm].T + (f32(1) - freem) * uk

    def edge_k3(nk, kbd, m):
        kd, kb = (nk[3] - kbd) * m, kbd * m
        return np.array([nk[i] * nk[j] * kd + (kb if i == j else f32(0))
                         if i == j else nk[i] * nk[j] * kd
                         for i in range(3) for j in range(3)], f32)

    reg = f32(cfg.reg)
    c9 = np.zeros((9, n), f32)
    for q in range(n):
        kc = edge_k3(cpack[q], ckbd[q], cact[q])
        km = edge_k3(cpack[q - 1], ckbd[q - 1], cact[q - 1]) if q else \
            np.zeros(9, f32)
        acc = np.zeros(9, f32)
        for e in range(jptr[q], jptr[q + 1]):
            j = jent[e] >> 1
            acc = acc + edge_k3(jpack[j], jkbd[j], jact[j])
        d = (kc + km) + acc
        d = np.where(np.arange(9) % 4 == 0, d + reg if fr[q] else f32(1),
                     d if fr[q] else f32(0)).astype(f32)
        scale = max(np.abs(d).max(), f32(1e-30))
        b = d / scale
        a00, a01, a02, a10, a11, a12, a20, a21, a22 = b
        cof = np.array([a11 * a22 - a12 * a21, a02 * a21 - a01 * a22,
                        a01 * a12 - a02 * a11, a12 * a20 - a10 * a22,
                        a00 * a22 - a02 * a20, a02 * a10 - a00 * a12,
                        a10 * a21 - a11 * a20, a01 * a20 - a00 * a21,
                        a00 * a11 - a01 * a10], f32)
        det = a00 * cof[0] + a01 * cof[3] + a02 * cof[6]
        c9[:, q] = cof / (det * scale)

    def ramp(q):
        return (f32(q % width) - f32(0.5) * f32(width - 1)) / (
            f32(0.5) * f32(width))

    def w(q, f):
        return 0.0 if not fr[q] else (f64(ramp(q)) if f else 1.0)

    d = 3 * nbas
    nc = plan.nc
    codes = np_of(plan.blk_ent)
    ptr = np_of(plan.blk_ptr)
    a = np.zeros((nc, nc), f32)
    for blk, (rc, cc) in enumerate(zip(np_of(plan.blk_row),
                                       np_of(plan.blk_col))):
        for inner in range(d * d):
            fa, kc = divmod(inner // d, 3)
            fb, kc2 = divmod(inner % d, 3)
            acc = 0.0
            for code in codes[ptr[blk]:ptr[blk + 1]]:
                src, kind = code >> 4, code & 15
                if kind == 8:
                    pr = pc = src
                    v = f64(reg) if kc == kc2 else 0.0
                else:
                    jump = kind >= 4
                    ea, eb = (ja[src], jb[src]) if jump else (src, src + 1)
                    nk, kbd = (jpack[src], jkbd[src]) if jump else \
                        (cpack[src], ckbd[src])
                    m = jact[src] if jump else cact[src]
                    pr = eb if kind & 1 else ea
                    pc = eb if kind & 2 else ea
                    k3 = f64(nk[kc]) * f64(nk[kc2])
                    k3 = k3 * (f64(nk[3]) - f64(kbd))
                    if kc == kc2:
                        k3 = k3 + f64(kbd)
                    k3 = k3 * f64(m)
                    v = k3 if (kind & 1) == ((kind >> 1) & 1) else -k3
                    v = f64(v)
                acc = acc + (w(pr, fa) * w(pc, fb)) * v
            a[fa * 3 * nbc + kc * nbc + rc, fb * 3 * nbc + kc2 * nbc + cc] = \
                f32(acc)
    dg = np.diag(a)
    sc = np.where(dg > 0, f32(1) / np.sqrt(np.maximum(dg, f32(1e-30))),
                  f32(1)).astype(f32)
    eye = np.eye(nc, dtype=bool)
    an = (sc[:, None] * a) * sc[None, :]
    an = an + np.where(eye, f32(1e-5), f32(0))
    an = (an + np.where(eye & ~(dg > 0)[:, None], f32(1), f32(0))).astype(f32)
    g = an
    for kk in range(nc):
        p = f32(1) / g[kk, kk]
        rk = np.where(np.arange(nc) == kk, p, g[kk] * p).astype(f32)
        f = g[:, kk].copy()
        nxt = g - f[:, None] * rk[None, :]
        nxt[:, kk] = -(f * p)
        nxt[kk] = rk
        g = nxt.astype(f32)
    return dict(uk=uk, x=x, freem=freem, cact=cact, jact=jact, c9=c9, a=a,
                s=sc, ainv=g)


def tie_state(device="cpu", n_pairs=160, n_mirror=40, seed=5):
    """The tie-heavy state of the anastomosis scan (K4), where many
    candidates sit at bitwise-equal distances and only the visiting order
    decides: ``n_pairs`` hyphae of two segments each (a finalized parent,
    in the grid once the scan inserts the backlog, and an active tip
    child, in the overlay), every point on a lattice of 2^-6 mm, so
    distances come out exact and many are bitwise equal; about a third of
    the parents are duplicated by another hypha's parent and a fifth of
    the children by another's child, and the tips crowd a 1 mm square
    (several to a corner cell). Then 2·``n_mirror`` hyphae more put a
    segment one lattice step to either side of each of the first
    ``n_mirror`` tips, a finalized parent on one side and a tip child on
    the other: ties at the same d² whose projections differ, so the pick
    shows in the snapped end. Returns (cfg, state)."""
    from mycelium_tpu_torch.config import GrowthConfig
    from mycelium_tpu_torch.growth.draws import TorchDraws
    from mycelium_tpu_torch.growth.state import (ACTIVE, PASSIVE,
                                                 ensure_grid, init_state)
    cfg = GrowthConfig(max_segments=1024, max_hyphae=512, h0_per_point=2,
                       inoculum_nx=2, inoculum_ny=2)
    rng = np.random.default_rng(seed)
    q = 2.0 ** -6
    dirs = np.array([[1, 0], [0, 1], [-1, 0], [0, -1], [1, 1], [1, -1],
                     [-1, 1], [-1, -1]], np.float64)
    a = rng.integers(-32, 32, (n_pairs, 2)) * q
    step = dirs[rng.integers(0, 8, n_pairs)] * 3 * q
    dup = rng.random(n_pairs) < 0.35
    src = rng.integers(0, n_pairs, n_pairs)
    a[dup], step[dup] = a[src[dup]], step[src[dup]]
    b = a + step
    step2 = dirs[rng.integers(0, 8, n_pairs)] * 2 * q
    c = b + step2
    dupc = rng.random(n_pairs) < 0.2
    b[dupc], c[dupc] = b[src[dupc]], c[src[dupc]]
    tips = c[:n_mirror]
    a, b, c = (np.concatenate([x, tips + np.array(s1) * q,
                               tips + np.array(s2) * q])
               for x, s1, s2 in ((a, (1, -1), (-1, -3)), (b, (1, 2), (-1, -1)),
                                 (c, (1, 4), (-1, 2))))
    st, _ = init_state(cfg, device=device,
                       draws=TorchDraws(cfg.seed, device))
    N, H = cfg.max_segments, cfg.max_hyphae
    start = torch.zeros((N, 3))
    end = torch.zeros((N, 3))
    state = torch.zeros(N, dtype=torch.int8)
    prev = torch.full((N,), -1, dtype=torch.int32)
    hypha = torch.full((N,), -1, dtype=torch.int32)
    P = len(a)
    z = np.zeros((P, 1))
    start[:P] = torch.as_tensor(np.hstack([a, z]), dtype=torch.float32)
    end[:P] = torch.as_tensor(np.hstack([b, z]), dtype=torch.float32)
    start[P:2 * P] = end[:P]
    end[P:2 * P] = torch.as_tensor(np.hstack([c, z]), dtype=torch.float32)
    state[:P], state[P:2 * P] = PASSIVE, ACTIVE
    hypha[:P] = hypha[P:2 * P] = torch.arange(P, dtype=torch.int32)
    prev[P:2 * P] = torch.arange(P, dtype=torch.int32)
    tip = torch.full((H,), -1, dtype=torch.int32)
    tip[:P] = torch.arange(P, 2 * P, dtype=torch.int32)
    st = ensure_grid(st.replace(
        grid=None, n_seg=2 * P, n_hyp=P, **{k: v.to(device) for k, v in dict(
            start=start, end=end, state=state, prev=prev, hypha=hypha,
            tip=tip).items()}), cfg)
    return cfg, st


class _KeepLevels:
    """K2's bound launch, keeping a copy of each level's outputs."""

    def __init__(self, launch):
        self.launch, self.levels = launch, []

    def factor(self, li, D, B):
        out = self.launch.factor(li, D, B)
        self.levels.append(tuple(t.clone() for t in out))
        return out


def fixed_order_sums(model, act, free, coarse_plan, reg, reg_pc, rp):
    """The sums of the PyTorch routes whose terms collide on a target
    (fault P7), on the device of ``model``'s tensors, as a dict of copies
    by name: the chain diagonal's jump terms, the coarse Galerkin matrix
    over ``coarse_plan``, the hybrid factorization's Schur corrections
    (dacc), the dense tail's matrix, and its forward sweep's right-hand
    sides (racc: each level's K3 solution, level by level through the
    unbound K3, and the dense tail's right-hand side); and each PCR level's
    K2 outputs (al, be, dinv, xc), whose inputs carry the earlier levels'
    Schur corrections and fill edges. K2 goes through ``model.pcr_launch``;
    a model without one (a CPU copy) gets a launch built on its device,
    which runs the plain version there."""
    from mycelium_tpu_torch.fea.chain import plan_active_masks_bool
    from mycelium_tpu_torch.fea.coarse import coarse_matrix
    from mycelium_tpu_torch.fea.tree_factor import (
        TreeFactor, attachment_couplings, build_pcr_launch, chain_diag,
        dense_tail_matrix, n_pcr_levels, tree_factor_inputs,
        tree_factor_levels, tree_forward_sweep)
    tree, fast, cplan = model.tree, model.tree_fast, model.chain
    free_chain = free[cplan.perm]
    cab, jab = plan_active_masks_bool(cplan, act)
    out = {"chain_diag": chain_diag(
        cplan, (cab & fast.chain_tree).to(model.dtype),
        (jab & fast.jump_tree).to(model.dtype), free_chain, reg_pc),
        "coarse_matrix": coarse_matrix(coarse_plan, cplan, act, free_chain,
                                       reg, model.dtype)}
    D_g, B_elem, katt = tree_factor_inputs(tree, fast, cplan, act, free,
                                           free_chain, reg_pc, model.conn,
                                           cab, jab)
    keep = _KeepLevels(model.pcr_launch or build_pcr_launch(tree))
    L = n_pcr_levels(tree.meta)
    al, be, dinv, att_b, fill_B, out["dacc"] = tree_factor_levels(
        tree, D_g, B_elem, katt, L, fast.meta.level_left_fill, keep)
    t0, S = tree.meta.level_offsets[L], tree.n_slots
    if S > t0:
        out["dense tail matrix"] = dense_tail_matrix(
            tree, D_g[:, t0:S], out["dacc"][:, t0:S], attachment_couplings(
                tree, act, free, model.conn, tree.dense_eid), fill_B)
    for li, level in enumerate(keep.levels):
        out.update({f"K2 level {li} {n}": t for n, t in
                    zip(("al", "be", "dinv", "xc"), level)})
    ys, out["racc tail"] = tree_forward_sweep(
        tree, TreeFactor(alphas=al, betas=be, dinvs=dinv, att_b=att_b), rp)
    out.update({f"racc level {i}": y for i, y in enumerate(ys)})
    return {k: v.clone() for k, v in out.items()}


class JaxDraws:
    """A draw source (mycelium_tpu_torch/growth/draws.py) that replays the
    JAX package's key chain, so the port sees the reference's numbers:
    init_state splits its key in 3 (theta0, phi0); each growth_step splits
    the state key in 2 and grow splits its half in 3 (branch, extension,
    child uniforms); enforce_walls splits the kept key in 3 per sweep
    (normals rnd, tan) and the last split is the next step's key."""

    def __init__(self, seed, device="cpu"):
        import jax
        self.jax = jax
        self.key = jax.random.PRNGKey(seed)
        self.device = device

    def _jd(self, dtype):
        import jax.numpy as jnp
        return {torch.float32: jnp.float32, torch.float64: jnp.float64}[dtype]

    def _t(self, x):
        return torch.tensor(np.asarray(x), device=self.device)

    def init(self, n0, dtype):
        from mycelium_tpu_torch.growth.draws import InitDraws
        r = self.jax.random
        self.key, k_th, k_ph = r.split(self.key, 3)
        jd = self._jd(dtype)
        return InitDraws(theta=self._t(r.uniform(k_th, (n0,), jd)),
                         phi=self._t(r.uniform(k_ph, (n0,), jd)))

    def grow_draws(self, k_grow, H, dtype):
        """The uniforms ``grow`` draws from its key."""
        r = self.jax.random
        jd = self._jd(dtype)
        return [self._t(r.uniform(k, (H,), jd))
                for k in r.split(k_grow, 3)]

    def wall_draws(self, key, H, dtype):
        """(key after the sweeps, rnd (3, H, 3), tan (3, H, 3))."""
        r = self.jax.random
        jd = self._jd(dtype)
        rnd, tan = [], []
        for _ in range(3):
            key, k_dir, k_tan = r.split(key, 3)
            rnd.append(np.asarray(r.normal(k_dir, (H, 3), jd)))
            tan.append(np.asarray(r.normal(k_tan, (H, 3), jd)))
        return key, self._t(np.stack(rnd)), self._t(np.stack(tan))

    def step(self, H, dtype, walls):
        from mycelium_tpu_torch.growth.draws import StepDraws
        key, k_grow = self.jax.random.split(self.key)
        u = self.grow_draws(k_grow, H, dtype)
        rnd = tan = None
        if walls:
            key, rnd, tan = self.wall_draws(key, H, dtype)
        self.key = key
        return StepDraws(*u, wall_rnd=rnd, wall_tan=tan)


def emulate_pcr_windows(launch, li, D, B):
    """K2's windowed launch on level ``li`` on the CPU: the plain
    factorization of each of the launch's windows alone (its slices of D
    and B, the corner columns from the launch's flags, the level's
    rounds), put together; None for a level that keeps the global rounds.
    The kernel reads R = B[s + 1] across a window's end, where a path
    starts: that coupling must be zero."""
    from mycelium_tpu_torch.kernels import pcr_factor_plain
    start, lens, n = launch.windows[li]
    if not n:
        return None
    steps, c = launch.steps[li], launch.corner[li].cpu()
    S = D.shape[1]
    out = [D.new_empty((steps, 9, S)), D.new_empty((steps, 9, S)),
           D.new_empty((9, S)), D.new_empty((18, S))]
    for ws, wl in zip(start.tolist(), lens.tolist()):
        we = ws + wl
        assert we == S or not bool(B[:, we].any())
        cw = c[ws:we]
        parts = pcr_factor_plain(D[:, ws:we], B[:, ws:we],
                                 torch.nonzero(cw & 1).flatten(),
                                 torch.nonzero(cw & 2).flatten(), steps)
        for o, p in zip(out, parts):
            o[..., ws:we] = p
    return out


def _csr_add(init, ptr, ent, src):
    """init (3, n) plus, for each column s, src[ent[j]] for j from ptr[s]
    to ptr[s + 1] - 1, added one after another (the kernels' order)."""
    out = init.clone()
    start, deg = ptr[:-1].long(), (ptr[1:] - ptr[:-1]).long()
    ent = ent.long()
    for k in range(int(deg.max()) if len(deg) else 0):
        has = deg > k
        out[:, has] = out[:, has] + src[ent[start[has] + k]].T
    return out


def _level_apply(launch, li, factor, rhs):
    """K3's rounds on level ``li`` as the bound launch runs them: the plain
    apply of each path-aligned window alone, put together; on a level
    with no windows (the halo form) the plain apply of the whole level."""
    from mycelium_tpu_torch.kernels import pcr_apply_plain
    al, be, dinv = factor.alphas[li], factor.betas[li], factor.dinvs[li]
    start, lens, n = launch.windows[li]
    if not n:
        return pcr_apply_plain(al, be, dinv, rhs)
    out = torch.empty_like(rhs)
    for ws, wl in zip(start.tolist(), lens.tolist()):
        w = slice(ws, ws + wl)
        out[:, w] = pcr_apply_plain(al[..., w], be[..., w], dinv[:, w],
                                    rhs[:, w])
    return out


def emulate_pcr_sweep(launch, factor, rp, u_tail=None):
    """K3's bound sweep (``PcrLaunch.apply``) on the CPU in the kernels'
    order of work, from the launch's own tables: per level, each slot's
    forward right-hand side (rp plus the negated attachment products of
    earlier levels' path ends in the CSR's order), the rounds window by
    window (``_level_apply``), the store of y and of the level's own path
    ends' products; the dense tail's right-hand side from the tail CSR;
    then per level from the last the backward right-hand side (ab^T·u at
    the junction, side 0 then side 1) and u = y - T^{-1} z. ``u_tail``
    replaces the tail's solution (the tail's matrix product is not
    bit-equal across BLAS libraries). Returns (the forward result with
    each level's y on its slots, the tail's right-hand side, u)."""
    from mycelium_tpu_torch.fea.tree_factor import tree_tail_solve
    L = len(launch.sizes)
    lo, po, S = launch.level_offsets, launch.path_offsets, launch.n_slots
    t0 = lo[L]
    ptr, ent = launch.att_ptr.cpu(), launch.att_ent.cpu()
    fp, lp = launch.first_path.cpu().long(), launch.last_path.cpu().long()
    tgt = launch.att_tgt.cpu().long()
    ab = factor.att_b.reshape(-1, 3, 3)
    u = rp.new_zeros((3, S))
    nv = rp.new_zeros((2 * po[L], 3))

    def ends(s0, s1):
        for side, paths in ((0, fp[s0:s1]), (1, lp[s0:s1])):
            has = paths >= 0
            yield has, 2 * paths[has] + side

    for li in range(L):
        s0, s1 = lo[li], lo[li + 1]
        y = _level_apply(launch, li, factor,
                         _csr_add(rp[:, s0:s1], ptr[s0:s1 + 1], ent, nv))
        u[:, s0:s1] = y
        for has, e in ends(s0, s1):
            m, v = ab[e], y[:, has].T
            nv[e] = -(m[:, :, 0] * v[:, 0:1] + m[:, :, 1] * v[:, 1:2]
                      + m[:, :, 2] * v[:, 2:3])
    forward = u.clone()
    r_tail = _csr_add(rp[:, t0:S], launch.tail_ptr.cpu(),
                      launch.tail_ent.cpu(), nv)
    u[:, t0:] = tree_tail_solve(factor, r_tail) if u_tail is None \
        else u_tail
    for li in range(L - 1, -1, -1):
        s0, s1 = lo[li], lo[li + 1]
        z = rp.new_zeros((3, s1 - s0))
        for has, e in ends(s0, s1):
            t = tgt[e]
            w = rp.new_zeros((len(e), 3))
            w[t < S] = u[:, t[t < S]].T
            m = ab[e]
            z[:, has] = z[:, has] + (m[:, 0, :] * w[:, 0:1]
                                     + m[:, 1, :] * w[:, 1:2]
                                     + m[:, 2, :] * w[:, 2:3]).T
        u[:, s0:s1] = u[:, s0:s1] - _level_apply(launch, li, factor, z)
    return forward, r_tail, u


def bound_sweep_pairs(plan, launch, factor, rp):
    """K3's bound sweep on the card (``launch``: forward, the dense tail's
    right-hand side, backward fed the card's tail solution) beside its
    plain version on the CPU on copies of the same inputs (the same tail
    solution): a dict of (card, CPU) pairs by name, each level's y, the
    tail's right-hand side and the result. On CPU tensors (a rehearsal of
    chip_smoke.py on the CPU) ``emulate_pcr_sweep`` stands for the
    card."""
    from mycelium_tpu_torch.devices import moved
    from mycelium_tpu_torch.fea.tree_factor import (
        n_pcr_levels, tree_backward_sweep, tree_forward_sweep,
        tree_tail_solve)
    meta = plan.meta
    L = n_pcr_levels(meta)
    t0 = meta.level_offsets[L]
    if rp.device.type == "cpu":
        fwd, r_tail, u = emulate_pcr_sweep(launch, factor, rp)
        u_tail = u[:, t0:]
    else:
        u, nv = launch.forward(factor, rp)
        fwd = u.clone()
        r_tail = launch.tail_rhs(nv, rp) if plan.n_slots > t0 \
            else rp.new_zeros((3, 0))
        u_tail = tree_tail_solve(factor, r_tail)
        u[:, t0:] = u_tail
        launch.backward(factor, u)
    plan_c, factor_c = moved(plan, "cpu"), moved(factor, "cpu")
    ys, r_tail_c = tree_forward_sweep(plan_c, factor_c, rp.cpu())
    out = {f"K3 forward level {li}": (
        fwd[:, meta.level_offsets[li]:meta.level_offsets[li + 1]], ys[li])
        for li in range(L)}
    out["K3 tail right-hand side"] = (r_tail, r_tail_c)
    out["K3 backward"] = (u, tree_backward_sweep(plan_c, factor_c, ys,
                                                 u_tail.cpu()))
    return out


def scan_args(st, cfg):
    """K4's arguments for a state, as ``detect_anastomosis`` builds them
    (the tip table by corner cell last)."""
    from mycelium_tpu_torch.growth import neighbors
    g = neighbors.check_layout(cfg)
    grid, _ = neighbors.grid_insert_finalized(st.grid, st, cfg)
    tb = neighbors.tip_tables(st, cfg)
    return (st.tip, tb.scan_cell, st.start, st.end, grid.ids, grid.geo,
            grid.count, cfg.max_per_cell, tb.ov_slot, tb.ov_start,
            tb.ov_count, g, st.capacity, tb.tips)


def emulate_anast_by_cell(args, ties=None):
    """K4's order of work on the CPU: by corner cell, each cell's tips
    against its window's candidates laid end to end in visiting order
    ((offset, source, rank)), the winner the least (d², position), a NaN
    read as +inf, kept only below +inf; rows outside the table (inf, 0,
    N). The distances by the plain version's arithmetic. ``ties``, a dict,
    counts the tips whose least d² more than one candidate attains, by
    what the tied candidates differ in: "cell", "source", "rank" (same
    cell and source)."""
    from mycelium_tpu_torch.kernels.anast import (OFFS, _dist,
                                                  _inv_sq_length)
    (tip, cell, start, end, gids, ggeo, gcount, cap, ov_slot, ov_start,
     ov_count, g, N, tips) = [x.cpu() if torch.is_tensor(x) else x
                              for x in args]
    order, tstart, tcount = (t.cpu() for t in tips)
    H = tip.shape[0]
    d2 = torch.full((H,), float("inf"))
    tt = torch.zeros(H)
    ids = torch.full((H,), N, dtype=torch.int32)
    for m in torch.nonzero(tcount).flatten().tolist():
        cx, cy = divmod(m, g)
        cid, geo, run = [], [], []
        for o, (dr, dc) in enumerate(OFFS):
            x, y = cx + dr, cy + dc
            if x < 0 or y < 0:
                continue
            c = x * g + y
            e = c * cap + torch.arange(int(gcount[c]))
            cid.append(gids[e].long())
            geo.append(ggeo[e][:, :7])
            k = int(ov_start[c]) + torch.arange(int(ov_count[c]))
            oid = ov_slot[k].long()
            sl = oid.clamp(max=N - 1)
            oa = start[sl]
            oab = end[sl] - oa
            geo.append(torch.cat([oa, oab, _inv_sq_length(oab)[:, None]],
                                 dim=1))
            cid.append(oid)
            run += [torch.full((len(e),), 2 * o), torch.full((len(k),),
                                                             2 * o + 1)]
        cid, geo, run = torch.cat(cid), torch.cat(geo), torch.cat(run)
        hy = order[int(tstart[m]):int(tstart[m]) + int(tcount[m])].long()
        slot = tip[hy].long()
        D2, TT = _dist(end[slot][:, None, :], geo[None, :, 0:3],
                       geo[None, :, 3:6], geo[None, :, 6])
        ok = (cid[None, :] < N) & (cid[None, :] != slot[:, None]) \
            & ~torch.isnan(D2)
        D2 = torch.where(ok, D2, torch.full_like(D2, float("inf")))
        if D2.shape[1] == 0:
            continue
        dmin = D2.amin(dim=1)
        first = torch.argmax((D2 == dmin[:, None]).to(torch.uint8), dim=1)
        keep = dmin < float("inf")
        if ties is not None:
            for i in torch.nonzero(keep).flatten().tolist():
                r = run[D2[i] == dmin[i]]
                if len(r) > 1:
                    kind = ("cell" if len(torch.unique(r // 2)) > 1 else
                            "source" if len(torch.unique(r)) > 1 else "rank")
                    ties[kind] = ties.get(kind, 0) + 1
        hk = hy[keep]
        d2[hk] = dmin[keep]
        tt[hk] = TT[keep, first[keep]]
        ids[hk] = cid[first[keep]].to(torch.int32)
    return d2, tt, ids


@contextlib.contextmanager
def jax_coarse_in_float64():
    """The JAX package assembles and inverts the cluster coarse operator in
    float32 whatever the dtype (``jnp.float32`` in
    mycelium_tpu/fea/pallas_cg.py). Inside this block its float32 is
    float64, so the port's float64 coarse operator can be held to the
    reference's formula tightly. Use it around the JAX calls only; nothing
    in the JAX package changes."""
    import jax.numpy as jnp
    f32 = jnp.float32
    jnp.float32 = jnp.float64
    try:
        yield
    finally:
        jnp.float32 = f32


@pytest.fixture
def cuda_device():
    """torch.device('cuda'), or a skip when this machine has no card
    (decided when the test runs, not when the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")
