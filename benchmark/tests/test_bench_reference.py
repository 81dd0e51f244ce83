"""The yardstick on the CPU: the frozen mesh generator equals the port's,
the plain reference agrees with the port's CPU path and with itself, the
TF32 control fails the limits the cells hold, and the solve's byte
count is the hand count on a 4-node mesh."""

import dataclasses

import numpy as np
import pytest

from conftest import ROOT
from benchmark.harness.networks import mesh_generator
from benchmark.harness.spec import load_json, bench_path
from benchmark.metrics.solve_bytes import problem_bytes, roofline_pct
from benchmark.reference import pulltest as ref

N = 1500
RAMP_LIMITS = ("pull309k-fracture", "pull309k-ramp")


@pytest.mark.parametrize("n,seed", [(200, 0), (1500, 7), (3000, 2**33 + 1)])
def test_frozen_mesh_equals_the_port(n, seed):
    from mycelium_tpu_torch.meshes import synthetic_mesh
    mine = mesh_generator(ROOT, "synthetic_mesh")(n, seed)
    port = synthetic_mesh(n, seed)
    for a, b in zip(mine, port):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _case(dmax, seed=3):
    from mycelium_tpu_torch.config import hybrid_fea_config
    coords, conn = mesh_generator(ROOT, "synthetic_mesh")(N, seed)
    grip = 0.3 * float(coords[:, 1].max() - coords[:, 1].min())
    cfg = hybrid_fea_config(grip_length=grip, displacement_max=dmax)
    phys = ref.Physics.of(dataclasses.asdict(cfg), grip)
    return coords, conn, cfg, phys


def _records(r):
    return ref.Records(r.stress_record, r.active_record, r.disp_record,
                       r.force_disp)


@pytest.mark.parametrize("dmax", [0.02, 0.06])
def test_reference_agrees_with_the_port_cpu_path(dmax):
    import torch
    from mycelium_tpu_torch.fea.ramp import run_ramp_async
    torch.set_num_threads(1)
    coords, conn, cfg, phys = _case(dmax)
    got = run_ramp_async(coords, conn, cfg, device="cpu")
    mesh = ref.Mesh(coords, conn, phys)
    out = ref.check_ramp(mesh, dmax, _records(got),
                         np.random.default_rng(0), 100)
    assert out["records_off"] == 0
    assert out["steps"] == len(got.force_disp)
    # a float32 solve to rtol 1e-6 on a floppy tree: ~1e-5 of max |u|
    assert out["disp_err"] < 1e-4
    assert out["stress_err"] < 1e-3 and out["force_err"] < 1e-3
    assert out["fracture_margin"] < 1e-3
    if dmax == 0.06:
        assert not got.active_record[-1].all()    # it fractures


def test_reference_judges_itself_exact_and_the_cold_solve():
    import torch
    from mycelium_tpu_torch.fea.model import build_model
    from mycelium_tpu_torch.fea.solve import solve_displacement
    coords, conn, cfg, phys = _case(0.06)
    mesh = ref.Mesh(coords, conn, phys)
    own = ref.check_ramp(mesh, 0.06, ref.ramp(mesh, 0.06),
                         np.random.default_rng(1), 100)
    assert own["records_off"] == 0
    assert max(own[k] for k in ("disp_err", "stress_err", "force_err",
                                "fracture_margin")) == 0.0
    assert own["residual"] < 1e-9
    model = build_model(coords, conn, cfg, "cpu")
    act = torch.ones(model.n_elems, dtype=torch.bool)
    x0 = torch.zeros((model.n_nodes, 3))
    res = solve_displacement(model, act, 0.013, -0.013, x0, cfg)
    unit = mesh.unit_pull(np.ones(len(conn), bool))
    assert ref.solve_error(unit, 0.013, res.x.numpy()) < 1e-5


@pytest.mark.parametrize("cell", RAMP_LIMITS)
def test_tf32_control_fails_the_ramp_limits(cell):
    """The control (the reference in TF32 in the program's place)
    fails a cell's limits; at this size, the card's run is the one at the
    cell's own."""
    lim = load_json(bench_path(ROOT, "limits", cell + ".json"))
    traffic = load_json(bench_path(ROOT, "traffic", _traffic(cell) + ".json"))
    dmax = traffic["displacement_max"]
    coords, conn, _, phys = _case(dmax)
    mesh = ref.Mesh(coords, conn, phys)
    ctl = ref.ramp(ref.Mesh(coords, conn, phys, "tf32"), dmax)
    out = ref.check_ramp(mesh, dmax, ctl, np.random.default_rng(0), 6)
    assert any(out[k] > lim[k] for k in lim)


def test_tf32_control_fails_the_cold_limit():
    lim = load_json(bench_path(ROOT, "limits", "pull22k-cold.json"))
    coords, conn, _, phys = _case(0.02)
    act = np.ones(len(conn), bool)
    unit = ref.Mesh(coords, conn, phys).unit_pull(act)
    ctl = ref.Mesh(coords, conn, phys, "tf32").unit_pull(act)
    assert ref.solve_error(unit, 0.013, ctl * 0.013) > lim["x_err"]


def _traffic(cell):
    spec = load_json(f"{ROOT}/BENCHMARK.json")
    return next(w["traffic"] for w in spec["workloads"] if w["name"] == cell)


@pytest.mark.parametrize("precision", ["float64", "tf32"])
def test_element_operator_keeps_each_element_balanced(precision):
    """The element-wise operator is the assembled matrix in float64, and
    in either precision it gives no force under a rigid translation: the
    control's TF32 rounding keeps each element's balance."""
    coords, conn, _, phys = _case(0.02)
    mesh = ref.Mesh(coords, conn, phys, precision)
    act = np.random.default_rng(5).random(len(conn)) < 0.9
    u = np.random.default_rng(6).standard_normal(coords.shape) * 1e-3
    want = (mesh.stiffness(act) @ u.ravel()).reshape(-1, 3)
    if precision == "float64":
        assert np.abs(mesh.apply(act, u) - want).max() \
            <= 1e-12 * np.abs(want).max()
    shift = np.broadcast_to([0.3, -0.2, 0.1], coords.shape).copy()
    assert not mesh.apply(act, shift).any()


def test_tf32_rounding():
    ulp = 2.0 ** -10
    x = np.array([1.0, 1 + ulp / 2, 1 + 1.5 * ulp, 1 + 0.7 * ulp, -3.14159,
                  1e-3])
    r = ref.to_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0          # a tie goes to even
    assert r[2] == 1 + 2 * ulp                  # and here up, to even
    assert r[3] == 1 + ulp
    assert abs(r[4] + 3.140625) < 1e-12         # 3.14159 → 3 + 144/1024
    assert abs(r[5] - 1e-3) / 1e-3 <= 2 ** -11


def test_solve_bytes_by_hand_on_four_nodes():
    """A 4-node chain (3 elements) in float32: coordinates 4·3·4 = 48,
    connectivity 3·2·4 = 24, active 3, anchored 4, grip masks 2·4 = 8, grip
    displacements 2·4 = 8, x0 48, x 48: 191 bytes."""
    assert problem_bytes(4, 3, 4) == 191
    assert problem_bytes(4, 3, 8) == 48 * 2 + 24 + 3 + 4 + 8 + 16 + 96 * 2

    class T:
        def device_s(self, name):
            return 1e-6

        def count(self, name):
            return 1000

    class V:
        kind, trace, n_nodes, n_elems, float_bytes = "cold_solve", T(), 4, \
            3, 4
        peaks = {"hbm_bytes_s": 3.35e12}

    # 1000 solves of 191 B at 3.35 TB/s against 1 us of device time
    assert abs(roofline_pct(V, "cold_solve")
               - 100 * 1000 * 191 / 3.35e12 / 1e-6) < 1e-12
    assert roofline_pct(V, "pull_test") is None
    V.peaks = None
    assert roofline_pct(V, "cold_solve") is None
