"""The whole growth slice: the port's run_growth against the JAX package's,
step by step, with the reference's random numbers replayed into the port
(tests/torch_support.py::JaxDraws), on a 3 mm dish so that tips meet the
walls within the run; the grow and pipeline commands of the
port's CLI on the host.

Tolerances of the trajectory (float64): integer fields equal at every
step; float fields within 1e-10 of each field's largest magnitude. The
only arithmetic that differs in order is uptake's run-parallel drain
(cumprod/cumsum against XLA's, 1e-12 relative per step, as the reference's
own tests allow between its two drains, mycelium_tpu/growth/ops.py:350-352);
40 steps of it stay well inside 1e-10. The stats history: integer columns
equal, the total length within 1e-10 relative (a sum over all segments
whose order differs between the two packages).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mycelium_tpu.config import GrowthConfig as JGrowthConfig
from mycelium_tpu.growth.state import ANASTOMOSED
from mycelium_tpu.growth.step import run_growth as jrun_growth
from mycelium_tpu.io import read_mesh_dir as jread_mesh_dir
from mycelium_tpu_torch.config import GrowthConfig
from mycelium_tpu_torch.growth import run_growth, summarize
from mycelium_tpu_torch.growth import step as tstep
from mycelium_tpu_torch.growth.export import segments_to_host
from mycelium_tpu_torch.io import read_mesh_dir
from tests.torch_support import JaxDraws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INT_FIELDS = ("state", "prev", "hypha", "tip")
FLOAT_FIELDS = ("start", "end", "theta", "phi", "sub", "env_e")
STEPS = 40


def _fields(st):
    out = {f: np.array(np.asarray(getattr(st, f)))
           for f in INT_FIELDS + FLOAT_FIELDS}
    out["n_seg"] = int(np.asarray(st.n_seg))
    out["n_hyp"] = int(np.asarray(st.n_hyp))
    out["overflow"] = bool(np.asarray(st.overflow))
    return out


_RUNS = {}


def trajectories(monkeypatch):
    """(JAX per-step fields, port per-step fields, JAX history, port
    history, port final state, tips the port's walls moved)."""
    if "runs" not in _RUNS:
        cfg = GrowthConfig(t_steps=STEPS, max_segments=1 << 12,
                           max_hyphae=1 << 11, dtype="float64",
                           grid_incremental=True, dish_size=3.0,
                           substrate_width=3.0)
        jcfg = JGrowthConfig(**dataclasses.asdict(cfg))
        ref = []
        _, _, jhist = jrun_growth(
            jcfg, on_step=lambda t, st: ref.append(_fields(st)))

        walls = [0]
        inner = tstep.enforce_walls

        def counting_walls(st, env, cfg, draws):
            out = inner(st, env, cfg, draws)
            walls[0] += int((out.end != st.end).any(dim=1).sum())
            return out

        monkeypatch.setattr(tstep, "enforce_walls", counting_walls)
        port = []
        st, _, hist = run_growth(
            cfg, device="cpu", draws=JaxDraws(cfg.seed),
            on_step=lambda t, s: port.append(_fields(s)))
        _RUNS["runs"] = (ref, port, jhist, hist, st, walls[0], cfg)
    return _RUNS["runs"]


def test_run_growth_matches_reference_every_step(monkeypatch):
    ref, port, _, _, _, wall_moves, _ = trajectories(monkeypatch)
    assert len(ref) == len(port) == STEPS
    for t, (j, s) in enumerate(zip(ref, port)):
        for f in INT_FIELDS + ("n_seg", "n_hyp", "overflow"):
            np.testing.assert_array_equal(s[f], j[f],
                                          err_msg=f"step {t} field {f}")
        for f in FLOAT_FIELDS:
            scale = max(np.abs(j[f]).max(), 1e-300)
            err = np.abs(s[f] - j[f]).max()
            assert err <= 1e-10 * scale, (t, f, err / scale)
    final = ref[-1]
    assert (final["state"] == ANASTOMOSED).sum() >= 1, "no snap"
    assert wall_moves >= 1, "no tip met a wall"
    assert final["n_seg"] > 1000 and not final["overflow"]


def test_run_growth_history_matches_reference(monkeypatch):
    _, _, jhist, hist, st, _, cfg = trajectories(monkeypatch)
    assert len(hist) == len(jhist) == STEPS
    for t, (a, b) in enumerate(zip(hist, jhist)):
        assert a.keys() == b.keys()
        for k in a:
            if k == "total_length_mm":
                assert abs(a[k] - b[k]) <= 1e-10 * abs(b[k]), (t, k)
            else:
                assert a[k] == b[k], (t, k, a[k], b[k])
    last = summarize(st, cfg)
    assert {k: v for k, v in last.items() if k != "total_length_mm"} == \
        {k: v for k, v in hist[-1].items()
         if k not in ("total_length_mm", "step")}


def _cli(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "mycelium_tpu_torch.cli"]
                          + args, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)


def test_cli_grow_writes_the_growth_contract(tmp_path):
    """``grow --device cpu`` writes the stats, the mesh, the snapshots and
    the config; the mesh reads back through both packages' readers with
    one element per alive segment."""
    out_dir = tmp_path / "sim"
    out = _cli(["grow", "--device", "cpu", "--steps", "8", "--dir",
                str(out_dir), "--no-summary-plot"], tmp_path)
    assert out.returncode == 0, out.stderr
    lines = (out_dir / "mycelium_growth_stats.csv").read_text().splitlines()
    assert lines[0] == ("hyphae,segments,active_tips,passive_tips,"
                        "anastomosed,branches,total_length_mm,step")
    assert len(lines) == 9 and lines[-1].endswith(",7")
    assert len(os.listdir(out_dir / "snapshots")) == 8
    assert (out_dir / "growth_config.json").exists()
    coords, conn = read_mesh_dir(str(out_dir))
    jc, je = jread_mesh_dir(str(out_dir))
    np.testing.assert_array_equal(coords, jc)
    np.testing.assert_array_equal(conn, je)
    assert conn.shape[0] == int(lines[-1].split(",")[1])


# checkpoints (the former flag0 and flag1) are ported: their CLI cases are
# in test_torch_ramp.py; 3D growth (the former flag3) in
# test_torch_growth3d.py; PNG snapshots (flag2) in test_torch_viz.py, and
# what is left to refuse is a plot on a machine without matplotlib
@pytest.mark.parametrize("flag", [["--snapshots", "png"]], ids=["flag2"])
def test_cli_grow_refuses_what_is_not_ported(flag, tmp_path):
    """Without matplotlib a growth that would plot stops before any work:
    no output directory, a message naming the package and the options
    that turn plotting off."""
    code = ("import sys; sys.modules['matplotlib'] = None; "
            "from mycelium_tpu_torch.cli import main; main(sys.argv[1:])")
    out = subprocess.run(
        [sys.executable, "-c", code, "grow", "--device", "cpu", "--steps",
         "2", "--dir", str(tmp_path / "x"), "--no-summary-plot"] + flag,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert "matplotlib" in out.stderr
    assert "--no-plots --no-summary-plot" in out.stderr
    assert not (tmp_path / "x").exists()


def test_cli_pipeline_grows_then_pulls(tmp_path):
    """``pipeline --device cpu``: growth, then the pull test on the mesh
    the growth wrote."""
    out_dir = tmp_path / "sim"
    out = _cli(["pipeline", "--device", "cpu", "--steps", "10",
                "--snapshots", "none", "--fea-steps", "4", "--dir",
                str(out_dir), "--no-plots", "--no-summary-plot"], tmp_path)
    assert out.returncode == 0, out.stderr
    fd = (out_dir / "fea_results" / "force_displacement.csv")
    rows = fd.read_text().splitlines()
    assert rows[0] == "total_displacement,total_force" and len(rows) == 5
    assert (out_dir / "fea_config.json").exists()
    assert not (out_dir / "snapshots").exists()


def test_entry_points_need_the_card_unless_asked(tmp_path):
    """Without a card the entry points raise instead of moving to the
    CPU; the CLI stops with a message naming --device cpu."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs on it")
    from mycelium_tpu_torch.fea import build_model, run_ramp
    from mycelium_tpu_torch.growth import init_state
    from tests.torch_support import scene
    cfg = GrowthConfig(max_segments=1 << 10, max_hyphae=1 << 9)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_growth(cfg)
    from mycelium_tpu_torch.config import FeaConfig
    coords, conn = scene("test_I")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(coords, conn, FeaConfig(operator="chain",
                                            precond="tree"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_ramp(coords, conn, FeaConfig(operator="chain", precond="tree"))
    out = _cli(["grow", "--steps", "2", "--dir", str(tmp_path / "x")],
               tmp_path)
    assert out.returncode != 0 and "--device cpu" in out.stderr


def test_exported_segments_keep_the_reference_order(monkeypatch):
    """segments_to_host: alive segments by (hypha, slot), as the
    reference's per-hypha traversal visits them."""
    _, _, _, _, st, _, _ = trajectories(monkeypatch)
    starts, ends, sub, state, hypha = segments_to_host(st)
    assert (np.diff(hypha) >= 0).all()
    assert starts.shape[0] == int((st.state != 0).sum())
    slots = np.nonzero(st.state.numpy() != 0)[0]
    order = slots[np.lexsort((slots, st.hypha.numpy()[slots]))]
    np.testing.assert_array_equal(starts, st.start.numpy()[order])
