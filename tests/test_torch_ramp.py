"""The 40-step pull test: the port's run_ramp against the reference's in
float64, step by step, on meshes and displacements that make elements
fracture. Active masks must be equal; displacement (per-step L2, the
repository's parity bar), stress and force within 1e-6. The CSV records
go through the reference's writers; on the chain scenes, where both
solvers' arithmetic is exact, the files are byte-equal. Also the CLI."""

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


def test_cli_fea_writes_the_records(tmp_path):
    """``python -m mycelium_tpu_torch.cli fea <dir> --device cpu`` writes
    the same records as run_ramp with the preset, through the reference's
    writers; without --device it stops when there is no CUDA card."""
    from mycelium_tpu.io import read_mesh_dir
    from mycelium_tpu_torch.config import hybrid_fea_config
    coords, conn = random_forest_mesh(300, 6, 9)
    starts, ends = coords[conn[:, 0]], coords[conn[:, 1]]
    export_geometry(str(tmp_path), starts, ends)
    env = dict(os.environ, PYTHONPATH=ROOT)
    args = [sys.executable, "-m", "mycelium_tpu_torch.cli", "fea",
            str(tmp_path), "--fea-steps", "6", "--grip", "0.1",
            "--disp-max", "0.02"]
    out = subprocess.run(args + ["--device", "cpu"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    fea_dir = tmp_path / "fea_results"
    for f in CSVS + ("runtime.txt", "solve_runtime.txt"):
        assert (fea_dir / f).exists(), f
    c2, e2 = read_mesh_dir(str(tmp_path))
    res = run_ramp(c2, e2, hybrid_fea_config(n_steps=6, grip_length=0.1,
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
