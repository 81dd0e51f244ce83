"""The bound launches on the CPU, where they run their plain versions:

- ``kernels.TreeCgLaunch`` (K6 bound to a model): two consecutive solves
  with different masks and prescribed values equal two fresh
  ``tree_cg_plain`` solves (no stale state, no aliasing of a returned x);
  its ``setup`` returns the plain set-up; ``solve_displacement`` goes
  through the model's launch; the bytes it counts are what
  ``tree_kernel_bytes`` reports and grow with the mesh; the grid rule and
  the barrier count follow their formulas;
- ``kernels.ChainOperator`` (K1 bound to a plan and a solve's masks):
  ``apply`` equals ``chain_matvec_plain`` for both forms of the product,
  with and without ``out``, and the hybrid solves through it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mycelium_tpu_torch.config import FeaConfig
from mycelium_tpu_torch.fea import model as tmodel
from mycelium_tpu_torch.fea.chain import plan_active_masks_bool
from mycelium_tpu_torch.fea.model import build_model
from mycelium_tpu_torch.fea.ramp import anchored_mask_host
from mycelium_tpu_torch.fea.solve import solve_displacement
from mycelium_tpu_torch.fea.tree_factor import build_tree_kernel_tables
from mycelium_tpu_torch.fea.tree_solve import (preconditioner_reg,
                                               tree_cg_inputs)
from mycelium_tpu_torch.kernels import (ChainOperator, TreeCgLaunch,
                                        chain_matvec, chain_matvec_plain,
                                        tree_cg_plain)
from mycelium_tpu_torch.kernels import tree_cg as tcg
from tests.torch_support import (grip_for, np_of, random_forest_mesh, scene,
                                 synthetic_mesh)

MESHES = {
    "test_y": lambda: scene("test_y"), "test_X": lambda: scene("test_X"),
    "forest260": lambda: random_forest_mesh(260, 8, 11),
    "forest900": lambda: random_forest_mesh(900, 18, 4),
    "synthetic2000": lambda: synthetic_mesh(2000),
    "synthetic8000": lambda: synthetic_mesh(8000),
}


def _model(name, **kw):
    coords, conn = MESHES[name]()
    cfg = FeaConfig(**{**dict(dtype="float32", operator="chain",
                              precond="tree", grip_length=grip_for(coords),
                              rtol=1e-6, tree_reg_rel=1e-7, max_iter=300,
                              warm_start=False), **kw})
    return build_model(coords, conn, cfg, "cpu"), cfg, conn


def _case(m, conn, frac, seed, rough=0.0):
    """(active, anchored, x0); x0 is zero unless ``rough`` scales a random
    start (a float32 solve from a rough start may not reach rtol 1e-6)."""
    rng = np.random.default_rng(seed)
    act = rng.random(m.n_elems) >= frac
    grip = np_of(m.top_nodes | m.bot_nodes)
    anch = anchored_mask_host(np.asarray(conn), act, grip)
    x0 = torch.as_tensor(rough * rng.standard_normal((m.n_nodes, 3)),
                         dtype=m.dtype)
    return torch.as_tensor(act), torch.as_tensor(anch), x0


@pytest.mark.parametrize("name", list(MESHES))
def test_consecutive_solves_equal_fresh_plain_solves(name):
    m, cfg, conn = _model(name)
    launch = m.tree_launch
    assert m.tree_kernel and isinstance(launch, TreeCgLaunch)
    # a fractured forest with cycles may not reach rtol 1e-6 in float32:
    # the synthetic meshes carry the fractured case
    frac = 0.05 if name.startswith("synthetic") else 0.0
    cases = [(_case(m, conn, frac, 1), 0.02, -0.02),
             (_case(m, conn, 0.0, 2), 0.011, -0.017)]
    got = []
    for (act, anch, x0), dt, db in cases:      # one launch, two solves
        got.append(launch.solve(act, m.free_nodes & anch, dt, db, x0,
                                cfg.rtol, cfg.reg,
                                preconditioner_reg(m, cfg), cfg.max_iter))
    for ((act, anch, x0), dt, db), (x, stats) in zip(cases, got):
        xp, sp = tree_cg_plain(*tree_cg_inputs(m, act, dt, db, x0, cfg,
                                               anch))
        assert x.shape == (m.n_nodes, 3) and x.dtype == torch.float32
        assert torch.equal(x, xp.T[m.chain.inv_perm])
        assert stats.shape == (4,) and torch.equal(stats, sp)
        assert float(stats[1]) <= float(stats[2]) and int(stats[0]) >= 1
    assert got[0][0].data_ptr() != got[1][0].data_ptr()
    assert not torch.equal(got[0][0], got[1][0])


@pytest.mark.parametrize("name", ["forest260", "synthetic2000"])
def test_solve_displacement_goes_through_the_launch(name, monkeypatch):
    m, cfg, conn = _model(name)
    act, anch, x0 = _case(m, conn, 0.05 * name.startswith("synthetic"), 3)
    calls = []
    real = TreeCgLaunch.solve

    def spy(self, *a):
        calls.append(self)
        return real(self, *a)

    monkeypatch.setattr(TreeCgLaunch, "solve", spy)
    res = solve_displacement(m, act, 0.02, -0.02, x0, cfg, anch)
    again = solve_displacement(m, act, 0.02, -0.02, x0, cfg, anch)
    assert calls == [m.tree_launch, m.tree_launch]
    xp, sp = tree_cg_plain(*tree_cg_inputs(m, act, 0.02, -0.02, x0, cfg,
                                           anch))
    assert torch.equal(res.x, xp.T[m.chain.inv_perm])
    assert torch.equal(again.x, res.x)
    assert res.iters == int(sp[0]) and res.converged
    # a model that cannot run the kernel has no launch and takes the hybrid
    off = dataclasses.replace(m, tree_kernel=False)
    hyb = solve_displacement(off, act, 0.02, -0.02, x0, cfg, anch)
    assert len(calls) == 2 and hyb.converged
    assert float((hyb.x - res.x).abs().max()) \
        <= 1e-4 * float(res.x.abs().max())


def test_setup_on_the_cpu_is_the_plain_set_up():
    m, cfg, conn = _model("forest900")
    act, anch, x0 = _case(m, conn, 0.05, 4, rough=0.01)
    free = m.free_nodes & anch
    out = m.tree_launch.setup(act, free, 0.02, -0.02, x0,
                              preconditioner_reg(m, cfg))
    args = tree_cg_inputs(m, act, 0.02, -0.02, x0, cfg, anch)
    uk, x0_p, freem, cact, jact, d9, bel, katt = args[3:11]
    for key, ref in dict(uk=uk, freem=freem, cact=cact, jact=jact, d9=d9,
                         bel=bel, katt=katt,
                         x=freem * x0_p + (1 - freem) * uk).items():
        assert torch.equal(out[key], ref), key
    lay = m.tree_launch.layout()
    assert set(out) <= set(lay)
    for key, t in out.items():
        assert tuple(t.shape) == tuple(lay[key][1]), key


def test_launch_bytes_layout_and_rules(monkeypatch):
    small, _, _ = _model("synthetic2000")
    big, _, _ = _model("synthetic8000")
    for m in (small, big):
        lay = m.tree_launch.layout()
        n, jp = m.n_nodes, m.chain.ja.shape[0]
        S, P = m.tree.n_slots, m.tree.n_paths
        tk = m.tree_tables
        assert lay["total"] == tcg.work_floats(n, jp, S, P, tk) == (
            20 * n + jp + 30 * S + 63 * P + 90 * tk.smax_global
            + 2 * tk.coef_floats)
        # consecutive, in the kernel's order
        offs = [v[0] for k, v in lay.items() if k != "total"]
        assert offs == sorted(offs) and offs[0] == 0
        assert tmodel.tree_kernel_bytes(m) == m.tree_launch.nbytes()
        assert 4 * lay["total"] < m.tree_launch.nbytes() \
            <= tmodel.TREE_KERNEL_MAX_BYTES
    assert big.tree_launch.nbytes() > 2 * small.tree_launch.nbytes()
    # all levels windowed: no global state, and the window's state sets the
    # shared memory
    assert all(big.tree_tables.windowed)
    assert big.tree_tables.smax_global == 0
    assert tcg.smem_bytes(big.tree_tables) == 4 * 90 * tcg.WINDOW
    forced = build_tree_kernel_tables(big.tree, big.conn, window=16)
    assert not forced.windowed[0] and forced.smax_global > 0
    halo = 4 * 6 * (tcg.CHUNK + 2 * ((1 << forced.max_steps_global) - 1))
    assert tcg.smem_bytes(forced) == max(4 * 90 * tcg.WINDOW, halo)
    # the grid: a thread a position, at least a quarter of the SMs, never
    # more than are resident
    assert tcg.grid_rule(7375, 2, 132) == 33
    assert tcg.grid_rule(33000, 2, 132) == 129
    assert tcg.grid_rule(103000, 2, 132) == 264
    assert tcg.grid_rule(103000, 1, 132) == 132
    assert tcg.grid_rule(10, 1, 2) == 1
    # barriers: set-up, a level to factor, 2L - 1 an apply, 2L + 1 an
    # iteration when every level is windowed
    L = len(big.tree_tables.windowed)
    assert tcg.barrier_count(big.tree_tables, 2) == 1 + L + (2 * L - 1) \
        + 2 * (2 * L + 1)
    rounds = forced.lvl[2].tolist()
    assert tcg.barrier_count(forced, 0) == 1 + (rounds[0] + 2) + (L - 1) \
        + (2 * L - 1)
    assert tcg.barrier_count(forced, 3) - tcg.barrier_count(forced, 0) \
        == 3 * (2 * L + 2)
    # past the guard the model has no launch
    monkeypatch.setattr(tmodel, "TREE_KERNEL_MAX_BYTES", 1000)
    gated, _, _ = _model("synthetic2000")
    assert not gated.tree_kernel and gated.tree_launch is None
    assert gated.tree_tables is not None
    assert tmodel.tree_kernel_bytes(gated) == small.tree_launch.nbytes()
    # forcing the route on such a model raises instead of solving elsewhere
    forced_on = dataclasses.replace(gated, tree_kernel=True)
    act = torch.ones(gated.n_elems, dtype=torch.bool)
    with pytest.raises(ValueError, match="cannot run"):
        solve_displacement(forced_on, act, 0.01, -0.01,
                           torch.zeros((gated.n_nodes, 3)), _model(
                               "synthetic2000")[1])


def _op_case(name, dtype="float32", frac=0.05):
    m, cfg, conn = _model(name, dtype=dtype)
    act, anch, _ = _case(m, conn, frac, 6)
    cab, jab = plan_active_masks_bool(m.chain, act)
    free = (m.free_nodes & anch)[m.chain.perm].to(m.dtype)
    u = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (3, m.n_nodes)), dtype=m.dtype)
    return m, cfg, u, free, cab.to(m.dtype), jab.to(m.dtype)


@pytest.mark.parametrize("bc", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["test_X", "forest900", "synthetic2000"])
def test_chain_operator_equals_the_plain_matvec(name, dtype, bc):
    m, cfg, u, free, cact, jact = _op_case(name, dtype)
    op = ChainOperator(m.chain, free, cact, jact, cfg.reg)
    want = chain_matvec_plain(m.chain, u, free, cact, jact, cfg.reg, bc)
    assert torch.equal(op.apply(u, bc), want)
    out = torch.full_like(u, float("nan"))
    assert op.apply(u, bc, out=out) is out and torch.equal(out, want)
    assert torch.equal(chain_matvec(m.chain, u, free, cact, jact, cfg.reg,
                                    bc), want)
    # bound once, applied to another vector
    assert torch.equal(op.apply(2.0 * u, bc), chain_matvec_plain(
        m.chain, 2.0 * u, free, cact, jact, cfg.reg, bc))


def test_hybrid_solves_through_the_bound_operator(monkeypatch):
    m, cfg, conn = _model("synthetic2000")
    act, anch, x0 = _case(m, conn, 0.05, 8)
    built, applied = [], []
    real_init, real_apply = ChainOperator.__init__, ChainOperator.apply

    def init(self, *a):
        built.append(self)
        real_init(self, *a)

    def apply(self, u, bc, out=None):
        applied.append(bc)
        return real_apply(self, u, bc, out)

    monkeypatch.setattr(ChainOperator, "__init__", init)
    monkeypatch.setattr(ChainOperator, "apply", apply)
    res = solve_displacement(dataclasses.replace(m, tree_kernel=False), act,
                             0.02, -0.02, x0, cfg, anch)
    assert res.converged and len(built) == 1
    # one raw product for the right-hand side, then the BC'd operator
    assert applied[0] is False and all(applied[1:]) \
        and len(applied) == res.iters + 2
