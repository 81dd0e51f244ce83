"""Process groups and coordinator-only IO (``utils/dist.py``): two CPU
ranks joined by gloo, spawned over a ``file://`` store (no port), and the
CLI's ``--distributed`` under the variables ``torchrun`` sets.

- two ranks each write a growth checkpoint, a sharded ramp's checkpoint
  and the records' CSVs to paths named by their rank: only rank 0's
  exist;
- a two-rank sharded solve and ramp equal the one-process ones (solve:
  L2 < 1e-6, iterations within ±1; ramp: rtol 1e-7, atol 1e-12, equal
  active records);
- ``fea --distributed --sharded 2`` in two processes writes the records
  of the one-process ramp, once;
- without a process group every guard is transparent.
"""

import filecmp
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from mycelium_tpu.config import archive_parity_config
from mycelium_tpu_torch.fea import build_model
from mycelium_tpu_torch.fea.ramp import run_ramp
from mycelium_tpu_torch.fea.solve import solve_displacement
from mycelium_tpu_torch.io import export_geometry
from mycelium_tpu_torch.utils.dist import (coordinator_barrier,
                                           is_coordinator, process_count,
                                           process_index)
from tests.torch_support import (coordinator_io_rank, port_config,
                                 run_ranks, scene, shard_ramp_rank,
                                 shard_solve_rank)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSVS = ("stress_record.csv", "active_elements.csv",
        "node_displacements.csv", "force_displacement.csv")


def _tree_cfg(**kw):
    return port_config(archive_parity_config(
        operator="chain", precond="tree", tree_coarse_weight=0.25,
        tree_reg_rel=1e-7, n_steps=6, displacement_max=0.06, **kw))


def test_two_ranks_only_the_coordinator_writes(tmp_path):
    c, e = scene("test_X")
    out = tmp_path / "out"
    out.mkdir()
    ranks = run_ranks(2, coordinator_io_rank, c, e, _tree_cfg(), str(out),
                      tmp_dir=tmp_path)
    assert [bool(r["coordinator"]) for r in ranks] == [True, False]
    for f in ("growth_rank0.npz", "fea_rank0.npz", "csv_rank0/" + CSVS[0]):
        assert (out / f).exists(), f
    for f in ("growth_rank1.npz", "fea_rank1.npz", "csv_rank1"):
        assert not (out / f).exists(), f


def test_two_rank_sharded_solve_and_ramp(tmp_path):
    c, e = scene("test_X")
    cfg = _tree_cfg()
    model = build_model(c, e, cfg, "cpu")
    active = np.ones(model.n_elems, bool)
    ref = solve_displacement(model, torch.as_tensor(active), 0.01, -0.01,
                             torch.zeros((model.n_nodes, 3),
                                         dtype=model.dtype), cfg)
    for got in run_ranks(2, shard_solve_rank, c, e, cfg, active, 0.01,
                         tmp_dir=tmp_path):
        assert got["converged"]
        assert np.linalg.norm(got["x"] - ref.x.numpy()) < 1e-6
        assert abs(int(got["iters"]) - ref.iters) <= 1
    loop = run_ramp(c, e, cfg, device="cpu")
    for got in run_ranks(2, shard_ramp_rank, c, e, cfg, tmp_dir=tmp_path):
        for f in ("disp_record", "stress_record", "force_disp"):
            np.testing.assert_allclose(got[f], getattr(loop, f), rtol=1e-7,
                                       atol=1e-12, err_msg=f)
        np.testing.assert_array_equal(got["active_record"],
                                      loop.active_record)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_cli_distributed_sharded_fea(tmp_path):
    """Two processes under torchrun's variables, gloo on the CPU: the
    sharded ramp's records, written by rank 0 alone, equal the
    one-process ramp's."""
    sc_c, sc_e = scene("test_X")
    d = tmp_path / "mesh"
    export_geometry(str(d), sc_c[sc_e[:, 0]], sc_c[sc_e[:, 1]])
    base = [sys.executable, "-m", "mycelium_tpu_torch.cli"]
    flags = ["fea", str(d), "--device", "cpu", "--fea-steps", "6",
             "--grip", "0.5", "--disp-max", "0.06", "--f64", "--no-plots"]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2")
    procs = [subprocess.Popen(base + ["--distributed"] + flags
                              + ["--sharded", "2"], cwd=ROOT,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            assert p.returncode == 0, out[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    fea_dir = d / "fea_results"
    sharded = tmp_path / "sharded"
    os.rename(fea_dir, sharded)
    one = subprocess.run(base + flags, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT,
                                  OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=300)
    assert one.returncode == 0, one.stderr
    for f in ("active_elements.csv", "force_displacement.csv"):
        assert filecmp.cmp(fea_dir / f, sharded / f, shallow=False), f
    a, b = [np.genfromtxt(x / "node_displacements.csv", delimiter=",",
                          skip_header=1) for x in (fea_dir, sharded)]
    np.testing.assert_allclose(b, a, rtol=1e-7, atol=1e-12)


def test_single_process_guards_are_transparent():
    assert not torch.distributed.is_initialized()
    assert process_index() == 0
    assert process_count() == 1
    assert is_coordinator()
    coordinator_barrier()   # nothing to wait for
