"""The sharded solve and ramp (``fea/shard.py``, ``fea/ramp.py::
run_ramp_sharded``) on 1, 2 and 4 CPU ranks joined by gloo (spawned
processes, a ``file://`` store: no port), cut from tests/test_shard.py.

Each solve is held, in float64, to the JAX package's ``sharded_cg_solver``
on the virtual CPU mesh of the same number of devices and to the port's
single-device solve: displacement L2 < 1e-6 and iterations within ±1, and
every rank returns the same solution. The cases: test_X and test_y with
``archive_parity_config()`` (ELL operator, block-Jacobi); a grown network,
intact and 30% fractured with the grip-unreachable islands pinned;
``precond="coarse"`` with the const and the linear basis; ``precond=
"tree"`` with tree_coarse_weight 0.25, also with a precomputed
factorization. The sharded ramp equals ``run_ramp`` to rtol 1e-7 (atol
1e-12) with equal active records, through fracture events, and its
checkpoint resumes to the same records.

The same spawns grow JAX's sharded growth configuration
(tests/test_shard.py:230-232) for 10 steps with the segment slots split
over the ranks (``growth/shard.py``), and once more with a capacity that
4 does not divide (the last block padded): every field, count, the grid
and the stats history equal ``run_growth`` on one device bit for bit, on
every rank.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mycelium_tpu.config import archive_parity_config
from mycelium_tpu.fea import build_model as jbuild_model
from mycelium_tpu.fea.shard import default_mesh
from mycelium_tpu.fea.shard import sharded_cg_solver as jsharded
from mycelium_tpu_torch.config import GrowthConfig
from mycelium_tpu_torch.fea import build_model
from mycelium_tpu_torch.fea.ramp import anchored_mask_host, run_ramp
from mycelium_tpu_torch.fea.solve import solve_displacement
from mycelium_tpu_torch.growth import run_growth, state_mesh
from mycelium_tpu_torch.io.checkpoint import load_ramp_state
from tests.torch_support import (RAMP_RECORDS, growth_arrays,
                                 jax_coarse_in_float64, port_config,
                                 run_ranks, scene, shard_cases_rank,
                                 shard_ramp_rank)

RANKS = (1, 2, 4)
# JAX's configuration of its sharded growth test (tests/test_shard.py:
# 230-232), and the same with a capacity that 4 ranks do not divide
GROWTH = {"jax": GrowthConfig(t_steps=10, max_segments=512, max_hyphae=256,
                              h0_per_point=2, inoculum_nx=2, inoculum_ny=2,
                              max_per_cell=8, dtype="float32")}
GROWTH["padded"] = dataclasses.replace(GROWTH["jax"], max_segments=510)


def _grown():
    cfg = GrowthConfig(t_steps=10, max_segments=4096, max_hyphae=2048,
                       dtype="float32")
    st, _, _ = run_growth(cfg, device="cpu")
    return state_mesh(st)


def _anchored(coords, conn, active, cfg):
    model = build_model(coords, conn, cfg, "cpu")
    grip = (model.top_nodes | model.bot_nodes).numpy()
    return anchored_mask_host(np.asarray(conn), active, grip)


def _cases():
    """name -> (coords, conn, JAX config, active, dy, anchored, with a
    precomputed factorization)."""
    out = {}
    for name in ("test_X", "test_y"):
        c, e = scene(name)
        out[name] = (c, e, archive_parity_config(), np.ones(len(e), bool),
                     0.01, None, False)
    c, e = _grown()
    ones = np.ones(len(e), bool)
    cfg = archive_parity_config(grip_length=1.5)
    out["grown"] = (c, e, cfg, ones, 0.005, None, False)
    frac = np.random.default_rng(0).random(len(e)) > 0.3
    out["grown_fractured"] = (c, e, cfg, frac, 0.005,
                              _anchored(c, e, frac, port_config(cfg)),
                              False)
    chain = archive_parity_config(grip_length=0.3, operator="chain")
    anch = _anchored(c, e, ones, port_config(chain))
    for basis in ("const", "linear"):
        out[f"coarse_{basis}"] = (
            c, e, dataclasses.replace(chain, precond="coarse",
                                      coarse_basis=basis),
            ones, 0.005, anch, False)
    out["tree"] = (c, e, archive_parity_config(
        grip_length=0.3, operator="chain", precond="tree",
        tree_coarse_weight=0.25, tree_reg_rel=1e-7), ones, 0.005, anch, True)
    return out


@pytest.fixture(scope="module")
def cases():
    return _cases()


@pytest.fixture(scope="module")
def sharded(cases, tmp_path_factory):
    """Every case's sharded solve and the sharded growths on 1, 2 and 4
    ranks: one spawn a rank count, every rank's results."""
    port = {k: (c, e, port_config(cfg), *rest)
            for k, (c, e, cfg, *rest) in cases.items()}
    return {n: run_ranks(n, shard_cases_rank, port, GROWTH,
                         tmp_dir=tmp_path_factory.mktemp(f"ranks{n}"))
            for n in RANKS}


def _jax_sharded(case, n):
    c, e, cfg, active, dy, anchored, _ = case
    # the port orders every model's chain by its forest; the JAX package
    # does so where the model is built for the tree preconditioner
    model = jbuild_model(c, e, dataclasses.replace(cfg, precond="tree")
                         if cfg.precond == "coarse" else cfg)
    x0 = jnp.zeros((model.n_nodes, 3), jnp.float64)
    solve = jsharded(model, cfg, default_mesh(n))
    with jax_coarse_in_float64():
        res = solve(jnp.asarray(active), dy, -dy, x0,
                    None if anchored is None else jnp.asarray(anchored))
    assert bool(res.converged)
    return np.asarray(res.x), int(res.iters)


def _port_single(case):
    c, e, cfg, active, dy, anchored, _ = case
    cfg = port_config(cfg)
    model = build_model(c, e, cfg, "cpu")
    res = solve_displacement(
        model, torch.as_tensor(active), dy, -dy,
        torch.zeros((model.n_nodes, 3), dtype=model.dtype), cfg,
        None if anchored is None else torch.as_tensor(anchored))
    assert res.converged
    return res.x.numpy(), res.iters


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("name", ["test_X", "test_y", "grown",
                                  "grown_fractured", "coarse_const",
                                  "coarse_linear", "tree"])
def test_sharded_solve_matches_jax_and_single_device(cases, sharded, name,
                                                     n):
    ranks = sharded[n]
    x, iters = ranks[0][f"{name}/x"], int(ranks[0][f"{name}/iters"])
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"{name}/x"], x)
    jx, jit = _jax_sharded(cases[name], n)
    sx, sit = _port_single(cases[name])
    for tag, ref, ref_it in (("JAX sharded", jx, jit),
                             ("single device", sx, sit)):
        err = np.linalg.norm(x - ref)
        assert err < 1e-6, f"{n} ranks vs {tag}: L2 {err:.3e}"
        assert abs(iters - ref_it) <= 1, (tag, iters, ref_it)
    if cases[name][-1]:      # the factorization passed in per call
        assert np.linalg.norm(ranks[0][f"{name}/x_fac"] - sx) < 1e-6
        assert abs(int(ranks[0][f"{name}/iters_fac"]) - sit) <= 1


def _ramp_case():
    c, e = scene("test_X")
    cfg = port_config(archive_parity_config(
        operator="chain", precond="tree", tree_coarse_weight=0.25,
        tree_reg_rel=1e-7, n_steps=10, displacement_max=0.12))
    return c, e, cfg


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_ramp_matches_run_ramp(tmp_path, n):
    """The tree-PC ramp through fracture events: the factor kept while the
    mask is unchanged, the reachability refreshed after each fracture."""
    c, e, cfg = _ramp_case()
    ref = run_ramp(c, e, cfg, device="cpu")
    assert not ref.active_record[-1].any(), "the ramp never fractured"
    ranks = run_ranks(n, shard_ramp_rank, c, e, cfg, tmp_dir=tmp_path)
    for got in ranks:
        for f in ("disp_record", "stress_record", "force_disp"):
            np.testing.assert_allclose(got[f], getattr(ref, f), rtol=1e-7,
                                       atol=1e-12, err_msg=f)
        np.testing.assert_array_equal(got["active_record"],
                                      ref.active_record)


def test_sharded_ramp_checkpoint_and_resume(tmp_path):
    c, e, cfg = _ramp_case()
    ckpt = str(tmp_path / "sharded_ramp.npz")
    full = run_ranks(2, shard_ramp_rank, c, e, cfg,
                     dict(checkpoint_path=ckpt, checkpoint_every=3),
                     tmp_dir=tmp_path)[0]
    assert len(full["cg_iters"]) == 4       # full fracture at step 4
    assert load_ramp_state(ckpt)[0] == 3
    res = run_ranks(2, shard_ramp_rank, c, e, cfg,
                    dict(resume_from=ckpt), tmp_dir=tmp_path)[0]
    for f in RAMP_RECORDS:
        np.testing.assert_array_equal(res[f], full[f], err_msg=f)


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("name", sorted(GROWTH))
def test_sharded_growth_equals_run_growth(sharded, name, n):
    """A3b: growth with the slots split over n ranks equals one device's
    in every field bit for bit (sub and env_e included: every sum adds in
    the single device's order), with its grid and stats, on every rank."""
    cfg = GROWTH[name]
    st, _, hist = run_growth(cfg, device="cpu")
    ref = growth_arrays(st, hist)
    assert ref["n_seg"] > cfg.n_inoculum * cfg.h0_per_point
    assert ref["history"][-1][0] > 0      # anastomosed: the scan snapped
    for got in sharded[n]:
        for k, v in ref.items():
            np.testing.assert_array_equal(got[f"growth_{name}/{k}"], v,
                                          err_msg=k)
