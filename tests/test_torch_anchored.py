"""K7, the grip reachability in one launch (``kernels/anchored.py``), and
the route of ``fea/ramp.py::refresh_anchored``: CUDA tensors launch K7 for
every model, CPU tensors take the plain fixpoint ``tree_anchored`` for
every model, a forest with no levels included.

On the card K7 is held to ``anchored_mask_host`` (scipy) and to the plain
``tree_anchored`` element for element, and a 309k-DOF pull test's records
to the plain path's bit for bit. Those tests skip without a card. The file
imports no jax, so it runs on a machine with PyTorch for CUDA and no jax:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_anchored.py
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mycelium_tpu_torch.config import hybrid_fea_config
from mycelium_tpu_torch.fea import build_model, ramp, run_ramp_async
from mycelium_tpu_torch.fea.ramp import anchored_mask_host, refresh_anchored
from mycelium_tpu_torch.fea.tree_factor import tree_anchored
from mycelium_tpu_torch.kernels import (AnchoredLaunch, launch_counts,
                                        reset_launch_counts)
from mycelium_tpu_torch.meshes import synthetic_mesh
from mycelium_tpu_torch.utils import profiling
# imported by its own name (pytest puts tests/ on sys.path): a machine
# with an unrelated installed package named "tests" shadows tests.*
from torch_support import (cuda_device, emulate_anchored,  # noqa: F401
                           grip_for, random_forest_mesh)

RECORDS = ("stress_record", "active_record", "disp_record", "force_disp")


def _config(coords, displacement_max=0.02):
    """The benchmark's 309k configuration's grips (0.3 of the y extent)
    on any mesh."""
    ext = float(coords[:, 1].max() - coords[:, 1].min())
    return hybrid_fea_config(grip_length=0.3 * ext,
                             displacement_max=displacement_max)


_NETWORKS = {}


def _network(size: str, device, mesh_seed: int = 0):
    """(coords, conn, model) of the 22k- or 309k-DOF network of
    ``mesh_seed`` on ``device`` (the 309k one with the benchmark's grips),
    built once a process."""
    key = (size, str(device), mesh_seed)
    if key not in _NETWORKS:
        n = {"22k": 7375, "309k": 103000}[size]
        coords, conn = synthetic_mesh(n, seed=mesh_seed)
        cfg = _config(coords) if size == "309k" else hybrid_fea_config()
        _NETWORKS[key] = (coords, conn,
                          build_model(coords, conn, cfg, device))
    return _NETWORKS[key]


def _masks(model, conn):
    """(label, active mask) of the card comparison: intact, all inactive,
    30 drawn masks with 1-50% of the elements inactive, and the top grip
    cut off (every element with an end in it inactive)."""
    rng = np.random.default_rng(19)
    yield "intact", np.ones(model.n_elems, bool)
    yield "none active", np.zeros(model.n_elems, bool)
    for k, frac in enumerate(np.linspace(0.01, 0.5, 30)):
        yield f"drawn {k} ({frac:.2f})", rng.random(model.n_elems) >= frac
    top = model.top_nodes.cpu().numpy()
    yield "top grip cut off", ~(top[conn[:, 0]] | top[conn[:, 1]])


@pytest.mark.parametrize("size", ["22k", "309k"])
def test_k7_equals_host_and_plain(cuda_device, size):  # noqa: F811
    _, conn, m = _network(size, cuda_device)
    conn = np.asarray(conn, np.int64)
    grip = (m.top_nodes | m.bot_nodes).cpu().numpy()
    islands = 0
    for label, act_np in _masks(m, conn):
        act = torch.as_tensor(act_np, device=cuda_device)
        before = launch_counts()["anchored"]
        k = refresh_anchored(m, act)
        assert launch_counts()["anchored"] == before + 1, label
        host = anchored_mask_host(conn, act_np, grip)
        plain = tree_anchored(m.tree, m, act)
        np.testing.assert_array_equal(k.cpu().numpy(), host, err_msg=label)
        np.testing.assert_array_equal(plain.cpu().numpy(), host,
                                      err_msg=label)
        assert torch.equal(m.anchored_launch.mask(act), k), label
        islands += int((~host).sum())
    assert islands > 0, "no mask cut a node off the grips"


@pytest.mark.parametrize("mesh_seed", [0, 1])
def test_pulltest_records_bit_equal_to_plain(cuda_device, mesh_seed,  # noqa: F811
                                             monkeypatch):
    """A 309k-DOF 0.06 mm pull test (the fracture cell's) on K7 and on the
    plain ``tree_anchored``: the same records, bit for bit."""
    coords, conn, m = _network("309k", cuda_device, mesh_seed)
    cfg = _config(coords, displacement_max=0.06)
    reset_launch_counts()
    k7 = run_ramp_async(coords, conn, cfg, model=m)
    act = k7.active_record
    prev = np.vstack([np.ones((1, act.shape[1]), bool), act[:-1]])
    changed = int((act != prev).any(axis=1).sum())
    assert changed >= 1, "nothing fractured"
    # one launch a refresh: the start and each step that fractured
    assert launch_counts()["anchored"] == 1 + changed

    def plain(model, active):
        return tree_anchored(model.tree, model, active)

    monkeypatch.setattr(ramp, "refresh_anchored", plain)
    reset_launch_counts()
    ref = run_ramp_async(coords, conn, cfg, model=m)
    assert launch_counts()["anchored"] == 0
    for f in RECORDS:
        np.testing.assert_array_equal(getattr(k7, f), getattr(ref, f),
                                      err_msg=f)


def test_refresh_is_one_trip_on_the_card(cuda_device):  # noqa: F811
    """Under the profiler a refresh on the card is one ``fea.refresh.trip``
    (the launch) and reads nothing back: no ``fea.sync.trip``."""
    coords, conn, m = _network("309k", cuda_device)
    cfg = _config(coords, displacement_max=0.06)
    run_ramp_async(coords, conn, cfg, model=m)
    profiling.reset_readings()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        run_ramp_async(coords, conn, cfg, model=m)
    got = profiling.readings()
    profiling.reset_readings()
    assert got["fea.refresh"]["count"] > 1
    assert got["fea.refresh.trip"]["count"] == got["fea.refresh"]["count"]
    assert "fea.sync.trip" not in got


def test_anchored_launch_rejects_bad_tensors(cuda_device):  # noqa: F811
    _, _, m = _network("22k", cuda_device)
    act = torch.ones(m.n_elems, dtype=torch.bool, device=cuda_device)
    for bad in (act.float(), act[:-1], act.cpu(),
                torch.ones(2 * m.n_elems, dtype=torch.bool,
                           device=cuda_device)[::2]):
        with pytest.raises(ValueError):
            m.anchored_launch.mask(bad)


@pytest.mark.parametrize("mesh", ["synthetic", "random_forest"])
def test_k7_phases_emulated_equal_host(mesh):
    """K7's order of work, its threads interleaved at random on the CPU
    (``torch_support.emulate_anchored``), gives scipy's mask: intact, no
    element active, drawn masks and the top grip cut off."""
    if mesh == "synthetic":
        coords, conn = synthetic_mesh(600)
    else:
        coords, conn = random_forest_mesh(600, 12, seed=3)
    conn = np.asarray(conn, np.int64)
    m = build_model(coords, conn, hybrid_fea_config(
        grip_length=grip_for(coords)), "cpu")
    grip = (m.top_nodes | m.bot_nodes).numpy()
    top = m.top_nodes.numpy()
    rng = np.random.default_rng(7)
    masks = [np.ones(m.n_elems, bool), np.zeros(m.n_elems, bool),
             ~(top[conn[:, 0]] | top[conn[:, 1]])]
    masks += [rng.random(m.n_elems) >= f for f in (0.02, 0.1, 0.3, 0.5)]
    for seed, act in enumerate(masks):
        np.testing.assert_array_equal(emulate_anchored(conn, act, grip, seed),
                                      anchored_mask_host(conn, act, grip))


@pytest.mark.parametrize("mesh", ["synthetic", "random_forest",
                                  "level-less"])
def test_refresh_on_cpu_takes_the_plain_path(mesh):
    """CPU tensors keep the plain fixpoint ``tree_anchored``: more than
    one trip a refresh on a drawn mask, each with its flag read, and no
    launch of K7; the mask is scipy's. The level-less case has its grips
    over the whole extent, so no node is free and the forest has no
    levels: there the fixpoint is the plain neighbour sweep, and its first
    trip finds every node anchored."""
    if mesh == "random_forest":
        coords, conn = random_forest_mesh(600, 12, seed=3)
    else:
        coords, conn = synthetic_mesh(300 if mesh == "level-less" else 3000)
    level_less = mesh == "level-less"
    cfg = hybrid_fea_config(
        grip_length=grip_for(coords, 1.0 if level_less else 0.15))
    m = build_model(coords, conn, cfg, "cpu")
    assert (m.tree_fast is None) == level_less
    assert (m.tree.meta.level_steps == ()) == level_less
    grip = (m.top_nodes | m.bot_nodes).numpy()
    act_np = np.random.default_rng(5).random(m.n_elems) >= 0.05
    reset_launch_counts()
    profiling.reset_readings()
    with profile(activities=[ProfilerActivity.CPU]):
        got = refresh_anchored(m, torch.as_tensor(act_np))
    reg = profiling.readings()
    profiling.reset_readings()
    assert launch_counts()["anchored"] == 0
    assert reg["fea.refresh"]["count"] == 1
    trips = reg["fea.refresh.trip"]["count"]
    assert trips == 1 if level_less else trips > 1
    assert reg["fea.sync.trip"]["count"] == trips
    host = anchored_mask_host(np.asarray(conn, np.int64), act_np, grip)
    np.testing.assert_array_equal(got.numpy(), host)


def test_every_model_carries_k7_and_cpu_tensors_are_refused():
    """Every model is built with K7's launch, unbound; the kernel has no
    CPU mode, so the launch refuses a CPU model's tensors (the refresh
    never hands them to it)."""
    coords, conn = synthetic_mesh(600)
    m = build_model(coords, conn, hybrid_fea_config(
        grip_length=grip_for(coords)), "cpu")
    assert isinstance(m.anchored_launch, AnchoredLaunch)
    assert m.anchored_launch.io_bytes() == 17 * m.n_elems + 2 * m.n_nodes
    with pytest.raises(ValueError, match="CUDA"):
        m.anchored_launch.mask(torch.ones(m.n_elems, dtype=torch.bool))
