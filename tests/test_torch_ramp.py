"""The 40-step pull test: the port's run_ramp against the reference's in
float64, step by step, on meshes and displacements that make elements
fracture. Active masks must be equal; displacement (per-step L2, the
repository's parity bar), stress and force within 1e-6. The CSV records
go through the reference's writers; on the chain scenes, where both
solvers' arithmetic is exact, the files are byte-equal. On the junction
scenes they are held to a measured bound: the tree-PC solve rounds its
last bit otherwise (the port's fast factor stands in for the reference's
node-space factor, and XLA contracts some products into fused
multiply-adds), and on test_X the reaction force's sum adds in another
order; the records' reductions and post-processing are otherwise the
reference's bit for bit. Also the CLI."""

import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mycelium_tpu import scenes
from mycelium_tpu.config import FeaConfig, archive_parity_config
from mycelium_tpu.fea.ramp import run_ramp as jramp
from mycelium_tpu.io import export_geometry, write_fea_records
from mycelium_tpu_torch.fea import run_ramp
from tests.torch_support import random_forest_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSVS = ("stress_record.csv", "active_elements.csv",
        "node_displacements.csv", "force_displacement.csv")


def _scene_case(name):
    sc = scenes.SCENES[name]()
    cfg = archive_parity_config(operator="chain", precond="tree",
                                **scenes.ARCHIVE_SCENE_CONFIGS[name])
    return sc.coords, sc.conn, cfg


def _mesh_case():
    coords, conn = random_forest_mesh(400, 10, 2)
    ext = float(coords[:, 1].max() - coords[:, 1].min())
    cfg = FeaConfig(dtype="float64", operator="chain", precond="tree",
                    rtol=1e-10, tree_reg_rel=1e-7, grip_length=0.1 * ext,
                    displacement_max=0.05 * ext)
    return coords, conn, cfg


CASES = {**{n: (lambda n=n: _scene_case(n)) for n in scenes.SCENES},
         "forest": _mesh_case}


@pytest.mark.parametrize("name", list(CASES))
def test_ramp_matches_reference_f64(name):
    coords, conn, cfg = CASES[name]()
    rj = jramp(coords, conn, cfg)
    rt = run_ramp(coords, conn, cfg, device="cpu")
    assert rt.disp_record.shape == rj.disp_record.shape
    assert (~rj.active_record[-1]).any(), "no element fractured"
    np.testing.assert_array_equal(rt.active_record, rj.active_record)
    l2 = np.linalg.norm(rt.disp_record - rj.disp_record, axis=1)
    assert l2.max() < 1e-6
    s_scale = max(np.abs(rj.stress_record).max(), 1e-300)
    assert np.abs(rt.stress_record - rj.stress_record).max() < 1e-6 * s_scale
    f_scale = max(np.abs(rj.force_disp[:, 1]).max(), 1e-300)
    np.testing.assert_array_equal(rt.force_disp[:, 0], rj.force_disp[:, 0])
    assert np.abs(rt.force_disp[:, 1] - rj.force_disp[:, 1]).max() \
        < 1e-6 * f_scale


@pytest.mark.parametrize("name", ["test_I", "test_t"])
def test_csv_records_byte_equal(name, tmp_path):
    coords, conn, cfg = _scene_case(name)
    for tag, res in (("ref", jramp(coords, conn, cfg)),
                     ("port", run_ramp(coords, conn, cfg, device="cpu"))):
        write_fea_records(str(tmp_path / tag), res.stress_record,
                          res.active_record, res.disp_record, res.force_disp)
    for f in CSVS:
        assert filecmp.cmp(tmp_path / "ref" / f, tmp_path / "port" / f,
                           shallow=False), f


# the junction scenes' records against the reference's, measured: disp
# 1.83e-17 abs (3.0e-16 of its largest entry), stress 1.83e-14 (3.9e-16),
# force 2.6e-23 abs; each record's bound is 1e-15 of its largest entry
JUNCTION_BOUND = 1e-15


@pytest.mark.parametrize("name", ["test_y", "test_X"])
def test_csv_records_within_bound(name, tmp_path):
    coords, conn, cfg = _scene_case(name)
    for tag, res in (("ref", jramp(coords, conn, cfg)),
                     ("port", run_ramp(coords, conn, cfg, device="cpu"))):
        write_fea_records(str(tmp_path / tag), res.stress_record,
                          res.active_record, res.disp_record, res.force_disp)
    assert filecmp.cmp(tmp_path / "ref" / "active_elements.csv",
                       tmp_path / "port" / "active_elements.csv",
                       shallow=False)
    # the step and displacement columns are exact: they meet the bound at 0
    for f in ("stress_record.csv", "node_displacements.csv",
              "force_displacement.csv"):
        ref, port = [np.genfromtxt(tmp_path / tag / f, delimiter=",",
                                   skip_header=1) for tag in ("ref", "port")]
        assert ref.shape == port.shape
        scale = np.abs(ref).max()
        assert np.abs(ref - port).max() <= JUNCTION_BOUND * scale, f


def test_cli_fea_writes_the_records(tmp_path):
    """``python -m mycelium_tpu_torch.cli fea <dir> --device cpu`` writes
    the same records as run_ramp with its default preset (``fast``,
    tuned_fea_config), through the reference's writers; without --device it
    stops when there is no CUDA card."""
    from mycelium_tpu.io import read_mesh_dir
    from mycelium_tpu_torch.config import tuned_fea_config
    coords, conn = random_forest_mesh(300, 6, 9)
    starts, ends = coords[conn[:, 0]], coords[conn[:, 1]]
    export_geometry(str(tmp_path), starts, ends)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    args = [sys.executable, "-m", "mycelium_tpu_torch.cli", "fea",
            str(tmp_path), "--fea-steps", "6", "--grip", "0.1",
            "--disp-max", "0.02", "--no-plots"]
    out = subprocess.run(args + ["--device", "cpu"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    fea_dir = tmp_path / "fea_results"
    for f in CSVS + ("runtime.txt", "solve_runtime.txt"):
        assert (fea_dir / f).exists(), f
    c2, e2 = read_mesh_dir(str(tmp_path))
    res = run_ramp(c2, e2, tuned_fea_config(n_steps=6, grip_length=0.1,
                                            displacement_max=0.02),
                   device="cpu")
    write_fea_records(str(tmp_path / "direct"), res.stress_record,
                      res.active_record, res.disp_record, res.force_disp)
    for f in CSVS:
        assert filecmp.cmp(fea_dir / f, tmp_path / "direct" / f,
                           shallow=False), f
    if not torch.cuda.is_available():
        out = subprocess.run(args, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode != 0
        assert "CUDA" in out.stderr


def _run_cli(args):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "mycelium_tpu_torch.cli"]
                          + args, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)


def test_cli_grow_checkpoint_and_resume(tmp_path):
    """``grow --checkpoint-every`` writes growth_checkpoint.npz, and
    ``--resume`` goes on from it to the unsplit run's stats and mesh."""
    flags = ["grow", "--device", "cpu", "--snapshots", "none",
             "--no-summary-plot"]
    half, full, res = (tmp_path / d for d in ("half", "full", "res"))
    for d, extra in ((half, ["--steps", "6", "--checkpoint-every", "3"]),
                     (full, ["--steps", "12"])):
        out = _run_cli(flags + ["--dir", str(d)] + extra)
        assert out.returncode == 0, out.stderr
    ckpt = half / "growth_checkpoint.npz"
    assert int(np.load(ckpt)["step"]) == 6
    out = _run_cli(flags + ["--dir", str(res), "--steps", "12", "--resume",
                            str(ckpt)])
    assert out.returncode == 0, out.stderr
    for f in ("nodes.csv", "elements.csv"):
        assert filecmp.cmp(full / f, res / f, shallow=False), f
    stats = [(d / "mycelium_growth_stats.csv").read_text().splitlines()
             for d in (half, res, full)]
    assert stats[0] + stats[1][1:] == stats[2]


def _fea_mesh(tmp_path):
    coords, conn = random_forest_mesh(300, 6, 9)
    d = tmp_path / "mesh"
    export_geometry(str(d), coords[conn[:, 0]], coords[conn[:, 1]])
    return d, ["--device", "cpu", "--fea-steps", "6", "--grip", "0.1",
               "--disp-max", "0.02", "--no-plots"]


def test_cli_fea_checkpoint_and_resume(tmp_path):
    """``fea --fea-checkpoint-every`` writes fea_checkpoint.npz;
    ``--fea-resume`` from it writes the unsplit run's records."""
    d, flags = _fea_mesh(tmp_path)
    out = _run_cli(["fea", str(d)] + flags)
    assert out.returncode == 0, out.stderr
    os.rename(d / "fea_results", tmp_path / "unsplit")
    out = _run_cli(["fea", str(d), "--fea-checkpoint-every", "4"] + flags)
    assert out.returncode == 0, out.stderr
    ckpt = tmp_path / "at4.npz"
    os.rename(d / "fea_checkpoint.npz", ckpt)
    assert int(np.load(ckpt)["step"]) == 4
    out = _run_cli(["fea", str(d), "--fea-resume", str(ckpt)] + flags)
    assert out.returncode == 0, out.stderr
    for f in CSVS:
        assert filecmp.cmp(d / "fea_results" / f, tmp_path / "unsplit" / f,
                           shallow=False), f


def test_cli_fea_sharded_and_trace(tmp_path):
    """``fea --sharded --f64`` (a group of this process alone) writes the
    records of ``run_ramp`` (each within 1e-6 of its largest entry, the
    preset's rtol 1e-8 apart; the active masks equal); ``--trace DIR``
    writes a Chrome trace with events; ``--sharded 2`` in a one-rank group
    stops."""
    d, flags = _fea_mesh(tmp_path)
    flags = flags + ["--f64"]
    out = _run_cli(["fea", str(d)] + flags)
    assert out.returncode == 0, out.stderr
    os.rename(d / "fea_results", tmp_path / "loop")
    trace_dir = tmp_path / "trace"
    out = _run_cli(["fea", str(d), "--sharded", "--trace", str(trace_dir)]
                   + flags)
    assert out.returncode == 0, out.stderr
    import json
    events = json.loads((trace_dir / "trace.json").read_text())
    assert len(events["traceEvents"]) >= 1
    for f in ("active_elements.csv",):
        assert filecmp.cmp(d / "fea_results" / f, tmp_path / "loop" / f,
                           shallow=False), f
    for f in ("node_displacements.csv", "stress_record.csv",
              "force_displacement.csv"):
        a, b = [np.genfromtxt(x / f, delimiter=",", skip_header=1)
                for x in (tmp_path / "loop", d / "fea_results")]
        assert np.abs(b - a).max() <= 1e-6 * np.abs(a).max(), f
    out = _run_cli(["fea", str(d), "--sharded", "2"] + flags)
    assert out.returncode != 0 and "process group has 1" in out.stderr


def test_dryrun_multichip_on_two_gloo_ranks():
    out = subprocess.run([sys.executable, "-m", "mycelium_tpu_torch.dryrun",
                          "2"], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT,
                                  OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "growth: one step on 2 ranks equals one device's in every " \
        "field" in out.stdout
    assert "dryrun_multichip OK on 2 ranks (gloo)" in out.stdout
