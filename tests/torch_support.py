"""Shared pieces of the PyTorch-port tests (tests/test_torch_*.py): the
test meshes, the PCR level inputs, the replay of the JAX package's random
draws, and the fixture that hands a CUDA device to the tests that need the
card. Imports nothing of jax or the JAX package at module level, so the
card's tests (test_torch_kernels.py) run where jax is not installed."""

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
