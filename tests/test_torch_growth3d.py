"""3D growth (``three_d=True``: full-sphere directions, z-walls, a grid of
gz = 5 z cells): the port's run_growth against the JAX package's, step by
step, with the reference's random numbers replayed into the port
(tests/torch_support.py::JaxDraws, whose 3D key chain splits the
extension's and the child's keys once more for theta), on the reference's
3D configuration (``growth_3d_config``); its checkpoints, a JAX state and
grid carried across, and the ``grow --three-d`` / ``pipeline --three-d``
commands on the host.

The JAX package runs with ``grid_incremental=True``, its XLA grid scan,
whose arithmetic and visiting order the port copies. Tolerances
(float64): integer fields, ``n_seg``, ``n_hyp`` and ``overflow`` equal at
every step; float fields within 1e-10 of each field's largest magnitude
(uptake's run-parallel drain adds in another order, as in 2D,
tests/test_torch_growth.py); the stats history's integer columns equal and
the total length within 1e-10 relative.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mycelium_tpu import cli as jcli
from mycelium_tpu.config import GrowthConfig as JGrowthConfig
from mycelium_tpu.growth.state import ANASTOMOSED
from mycelium_tpu.growth.step import run_growth as jrun_growth
from mycelium_tpu.io import read_mesh_dir as jread_mesh_dir
from mycelium_tpu_torch import cli as tcli
from mycelium_tpu_torch.config import growth_3d_config
from mycelium_tpu_torch.convert import (growth_state_from_jax,
                                        jax_growth_arrays)
from mycelium_tpu_torch.growth import run_growth
from mycelium_tpu_torch.growth import neighbors as tnb
from mycelium_tpu_torch.growth import step as tstep
from mycelium_tpu_torch.growth.state import init_state
from mycelium_tpu_torch.io import read_mesh_dir
from mycelium_tpu_torch.io.checkpoint import (GROWTH_FIELDS,
                                              load_growth_state)
from tests.torch_support import JaxDraws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INT_FIELDS = ("state", "prev", "hypha", "tip")
FLOAT_FIELDS = ("start", "end", "theta", "phi", "sub", "env_e")
STEPS = 25
CFG = growth_3d_config(t_steps=STEPS, max_segments=1 << 12,
                       max_hyphae=1 << 11, dtype="float64")


def _fields(st):
    out = {f: np.array(np.asarray(getattr(st, f)))
           for f in INT_FIELDS + FLOAT_FIELDS}
    out["n_seg"] = int(np.asarray(st.n_seg))
    out["n_hyp"] = int(np.asarray(st.n_hyp))
    out["overflow"] = bool(np.asarray(st.overflow))
    return out


def _assert_close(s, j, where):
    for f in INT_FIELDS + ("n_seg", "n_hyp", "overflow"):
        np.testing.assert_array_equal(s[f], j[f],
                                      err_msg=f"{where} field {f}")
    for f in FLOAT_FIELDS:
        scale = max(np.abs(j[f]).max(), 1e-300)
        err = np.abs(s[f] - j[f]).max()
        assert err <= 1e-10 * scale, (where, f, err / scale)


_RUNS = {}


def trajectories():
    """(JAX per-step fields, port per-step fields, JAX history, port
    history, JAX final state, port final state, z-wall moves of the
    port)."""
    if "runs" not in _RUNS:
        jcfg = JGrowthConfig(**dataclasses.asdict(
            dataclasses.replace(CFG, grid_incremental=True)))
        ref = []
        jst, _, jhist = jrun_growth(
            jcfg, on_step=lambda t, st: ref.append(_fields(st)))
        walls = [0]
        inner = tstep.enforce_walls

        def counting_walls(st, env, cfg, draws):
            out = inner(st, env, cfg, draws)
            walls[0] += int((out.end != st.end).any(dim=1).sum())
            return out

        tstep.enforce_walls = counting_walls
        try:
            port = []
            st, _, hist = run_growth(
                CFG, device="cpu", draws=JaxDraws(CFG.seed),
                on_step=lambda t, s: port.append(_fields(s)))
        finally:
            tstep.enforce_walls = inner
        _RUNS["runs"] = (ref, port, jhist, hist, jst, st, walls[0])
    return _RUNS["runs"]


def test_3d_run_growth_matches_reference_every_step():
    ref, port, _, _, _, _, wall_moves = trajectories()
    assert len(ref) == len(port) == STEPS
    for t, (j, s) in enumerate(zip(ref, port)):
        _assert_close(s, j, f"step {t}")
    final = ref[-1]
    assert (final["state"] == ANASTOMOSED).sum() >= 1, "no snap"
    assert wall_moves >= 1, "no tip met a z-wall"
    alive = final["state"] != 0
    assert np.abs(final["end"][alive, 2]).max() > 1e-3, "flat network"
    assert final["n_seg"] > 1000 and not final["overflow"]


def test_3d_run_growth_history_matches_reference():
    _, _, jhist, hist, _, _, _ = trajectories()
    assert len(hist) == len(jhist) == STEPS
    for t, (a, b) in enumerate(zip(hist, jhist)):
        assert a.keys() == b.keys()
        for k in a:
            if k == "total_length_mm":
                assert abs(a[k] - b[k]) <= 1e-10 * abs(b[k]), (t, k)
            else:
                assert a[k] == b[k], (t, k, a[k], b[k])


def test_3d_grid_carried_across_from_jax():
    """The JAX package's final 3D grid (planes rank·gz + cz over the
    (g, g) face) carried across by ``convert.py`` equals the grid the port
    built over the same trajectory (cell-major, cell (cx·g + cy)·gz + cz)."""
    _, _, _, _, jst, st, _ = trajectories()
    grid = growth_state_from_jax(jax_growth_arrays(jst), CFG, "cpu").grid
    g, gz = tnb.grid_dims(CFG)
    assert gz == 5 and grid.count.shape[0] == g * g * gz
    assert int((grid.count > 0).reshape(g * g, gz).any(0).sum()) >= 2, \
        "the network fills one z cell only"
    assert grid.n_seen == st.grid.n_seen
    for k in ("ids", "count"):
        assert torch.equal(getattr(grid, k), getattr(st.grid, k)), k
    np.testing.assert_array_equal(grid.geo.numpy(), st.grid.geo.numpy())


def test_3d_init_seeds_the_six_sites():
    """init_state in 3D: h0_per_point hyphae at each of the 6 sites of
    ``scenes.INOCULUM_POINTS_3D``, directions on the full sphere (theta
    drawn in [0, pi)), segments of length h0."""
    cfg = growth_3d_config(max_segments=256, max_hyphae=128)
    st, ea = init_state(cfg, device="cpu", draws=JaxDraws(cfg.seed))
    n0 = 6 * cfg.h0_per_point
    assert st.n_seg == st.n_hyp == n0 and ea.inoculum.shape == (6, 3)
    assert ea.wall_center.shape == (2, 3)
    d = (st.end - st.start)[:n0]
    np.testing.assert_allclose(d.norm(dim=1).numpy(), cfg.h0, rtol=1e-6)
    assert float(d[:, 2].abs().max()) > 0.5 * cfg.h0
    theta = st.theta[:n0]
    assert float(theta.min()) >= 0 and float(theta.max()) < np.pi


def test_3d_growth_resume_bit_identical(tmp_path):
    """A 3D run split at step 12 of 25 by a checkpoint and resumed equals
    the unsplit run bit for bit, its grid (gz = 5) rebuilt from the
    backlog included."""
    cfg = growth_3d_config(max_segments=1 << 12, max_hyphae=1 << 11)
    ckpt = str(tmp_path / "growth.npz")
    full, _, hist = run_growth(cfg, device="cpu")
    run_growth(dataclasses.replace(cfg, t_steps=12), device="cpu",
               checkpoint_path=ckpt, checkpoint_every=12)
    st, draws = load_growth_state(ckpt, cfg, "cpu")
    assert st.step == 12 and st.grid.count.shape[0] == 54 * 54 * 5
    res, _, hist_r = run_growth(cfg, device="cpu", initial_state=st,
                                draws=draws)
    assert hist_r == hist[12:]
    for k in GROWTH_FIELDS:
        x, y = getattr(res, k), getattr(full, k)
        assert (torch.equal(x, y) if torch.is_tensor(x) else x == y), k
    for k in ("ids", "geo", "count"):
        assert torch.equal(getattr(res.grid, k), getattr(full.grid, k)), k
    assert int((full.state == ANASTOMOSED).sum()) > 0


def test_3d_growth_resumes_a_jax_checkpoint(tmp_path):
    """A 3D state the JAX package saved at step 12 resumes in the port
    with the file's key replayed (JaxDraws) and ends where JAX's unsplit
    run ends, within the trajectory's tolerance."""
    ref, _, jhist, _, _, _, _ = trajectories()
    jcfg = JGrowthConfig(**dataclasses.asdict(
        dataclasses.replace(CFG, grid_incremental=True, t_steps=12)))
    ckpt = str(tmp_path / "jax_growth.npz")
    jrun_growth(jcfg, checkpoint_path=ckpt, checkpoint_every=12)
    st, draws = load_growth_state(ckpt, CFG, "cpu")
    assert draws is None and st.step == 12
    res, _, hist = run_growth(CFG, device="cpu", initial_state=st,
                              draws=JaxDraws.from_key(np.load(ckpt)["key"]))
    _assert_close(_fields(res), ref[-1], "resumed")
    assert [h["segments"] for h in hist] == \
        [h["segments"] for h in jhist[12:]]


def _cli(args):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "mycelium_tpu_torch.cli"]
                          + args, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)


def test_cli_grow_three_d_matches_reference(tmp_path, monkeypatch):
    """``grow --three-d --device cpu`` writes the growth contract of the
    JAX package's ``grow --three-d`` on the same draws (the port's draw
    source replaced by the JAX key chain). The command grows in float32,
    where XLA's own sin and cos and the C library's differ in the last
    bit (from the first step on, in 2D too), so: the stats' integer
    columns equal, the total length within 1e-6 relative; the mesh's
    connectivity equal and its coordinates within 1e-6 mm (a few float32
    ulps at the dish's 2.5 mm); the same config."""
    monkeypatch.setattr(tstep, "TorchDraws",
                        lambda seed, device: JaxDraws(seed, device))
    steps = ["--steps", "12"]
    tdir, jdir = tmp_path / "port", tmp_path / "jax"
    tcli.main(["grow", "--three-d", "--device", "cpu", "--snapshots",
               "none", "--no-summary-plot", "--dir", str(tdir)] + steps)
    jcli.main(["grow", "--three-d", "--snapshots", "none",
               "--no-summary-plot", "--dir", str(jdir)] + steps)
    name = "mycelium_growth_stats.csv"
    t_rows = (tdir / name).read_text().splitlines()
    j_rows = (jdir / name).read_text().splitlines()
    assert t_rows[0] == j_rows[0] and len(t_rows) == len(j_rows) == 13
    col = t_rows[0].split(",").index("total_length_mm")
    for a, b in zip(t_rows[1:], j_rows[1:]):
        a, b = a.split(","), b.split(",")
        assert float(a[col]) == pytest.approx(float(b[col]), rel=1e-6)
        del a[col], b[col]
        assert a == b
    coords, conn = read_mesh_dir(str(tdir))
    jc, je = jread_mesh_dir(str(jdir))
    np.testing.assert_allclose(coords, jc, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(conn, je)
    assert np.abs(coords[:, 2]).max() > 1e-3
    assert (tdir / "growth_config.json").read_text() == \
        (jdir / "growth_config.json").read_text()


def test_cli_pipeline_three_d_grows_then_pulls(tmp_path):
    """``pipeline --three-d --device cpu``: 3D growth, then the pull test
    on the mesh it wrote."""
    out_dir = tmp_path / "sim"
    out = _cli(["pipeline", "--three-d", "--device", "cpu", "--steps", "12",
                "--snapshots", "none", "--fea-steps", "4", "--dir",
                str(out_dir), "--no-plots", "--no-summary-plot"])
    assert out.returncode == 0, out.stderr
    rows = (out_dir / "fea_results" / "force_displacement.csv") \
        .read_text().splitlines()
    assert rows[0] == "total_displacement,total_force" and len(rows) == 5
    coords, _ = read_mesh_dir(str(out_dir))
    assert np.abs(coords[:, 2]).max() > 1e-3
    assert '"three_d": true' in (out_dir / "growth_config.json").read_text()


def test_cli_three_d_takes_no_growth_preset(tmp_path):
    out = _cli(["grow", "--three-d", "--preset", "medium", "--device",
                "cpu", "--steps", "2", "--dir", str(tmp_path / "x")])
    assert out.returncode != 0 and "--three-d" in out.stderr
