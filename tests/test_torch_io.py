"""The port's own copies of what it once took from the JAX package:
configurations, scenes, the synthetic mesh, the CSV readers and writers
and the native mesh-IO library. Each is held to the JAX package's: equal
fields, equal arrays, byte-equal files on the same inputs."""

import dataclasses
import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest

import bench
from mycelium_tpu import config as jconfig
from mycelium_tpu import scenes as jscenes
from mycelium_tpu.bench.growth_scale import PRESETS as JPRESETS
from mycelium_tpu.io import readers as jreaders
from mycelium_tpu.io import writers as jwriters
from mycelium_tpu_torch import config, meshes, scenes
from mycelium_tpu_torch.io import readers, writers
from mycelium_tpu_torch.native import meshio_native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _defaults(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["GrowthConfig", "FeaConfig"])
def test_config_fields_and_defaults_equal(name, tmp_path):
    ours, ref = getattr(config, name), getattr(jconfig, name)
    assert _defaults(ours) == _defaults(ref)
    cfg = ours()
    config.save_config(cfg, str(tmp_path / "port.json"))
    jconfig.save_config(ref(), str(tmp_path / "ref.json"))
    assert filecmp.cmp(tmp_path / "port.json", tmp_path / "ref.json",
                       shallow=False)
    assert config.load_config(str(tmp_path / "ref.json")) == cfg
    assert jconfig.load_config(str(tmp_path / "port.json")) == ref()


def test_presets_equal_the_reference(tmp_path):
    assert sorted(config.GROWTH_PRESETS) == sorted(JPRESETS)
    for k, cfg in config.GROWTH_PRESETS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(JPRESETS[k]), k
    assert dataclasses.asdict(config.growth_3d_config(seed=3)) == \
        dataclasses.asdict(jconfig.growth_3d_config(seed=3))
    config.save_run_configs(str(tmp_path / "p"), config.GrowthConfig(),
                            config.hybrid_fea_config())
    jconfig.save_run_configs(
        str(tmp_path / "r"), jconfig.GrowthConfig(),
        jconfig.FeaConfig(**dataclasses.asdict(config.hybrid_fea_config())))
    for f in ("growth_config.json", "fea_config.json"):
        assert filecmp.cmp(tmp_path / "p" / f, tmp_path / "r" / f,
                           shallow=False), f


@pytest.mark.parametrize("overrides", [{}, dict(n_steps=40, rtol=1e-6),
                                       dict(dtype="float64")])
def test_tuned_preset_equals_the_reference(overrides):
    """The CLI's default solver preset: the reference's tuned_fea_config
    (on the CPU it sets no use_pallas, which the port does not read)."""
    assert dataclasses.asdict(config.tuned_fea_config(**overrides)) == \
        dataclasses.asdict(jconfig.tuned_fea_config(**overrides))


@pytest.mark.parametrize("three_d", [False, True])
def test_petri_dish_equals_the_reference(three_d):
    kw = dict(inoculum_nx=4, inoculum_ny=3, dish_size=7.0)
    cfg = config.growth_3d_config(**kw) if three_d else \
        config.GrowthConfig(**kw)
    ours = scenes.petri_dish(cfg)
    ref = jscenes.petri_dish(jconfig.GrowthConfig(**dataclasses.asdict(cfg)))
    assert ours._fields == ref._fields
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(scenes.inoculum_grid(3, 5, 0.25, 0.1),
                                  jscenes.inoculum_grid(3, 5, 0.25, 0.1))


def test_scenes_equal_the_reference():
    assert scenes.ARCHIVE_SCENE_CONFIGS == jscenes.ARCHIVE_SCENE_CONFIGS
    assert sorted(scenes.SCENES) == sorted(jscenes.SCENES)
    for k in scenes.SCENES:
        a, b = scenes.SCENES[k](), jscenes.SCENES[k]()
        assert a.name == b.name
        np.testing.assert_array_equal(a.coords, b.coords)
        np.testing.assert_array_equal(a.conn, b.conn)
        assert a.conn.dtype == b.conn.dtype


@pytest.mark.parametrize("n", [300, 7375])
def test_synthetic_mesh_equals_bench(n):
    c, e = meshes.synthetic_mesh(n)
    rc, re_ = bench.synthetic_mesh(n)
    np.testing.assert_array_equal(c, rc)
    np.testing.assert_array_equal(e, re_)
    assert e.dtype == re_.dtype


def _segments(seed=0, n=400):
    """Segment endpoints with shared joints (chains) and exact duplicates,
    at coordinates whose 6-decimal rounding matters."""
    rng = np.random.default_rng(seed)
    pts = np.cumsum(rng.normal(0, 0.05, (n + 1, 3)), axis=0)
    pts[:, 2] = 0.0
    starts, ends = pts[:-1].copy(), pts[1:].copy()
    starts[::7] = ends[::5][:len(starts[::7])] + 4e-7
    return starts, ends


def _same_tree(a, b):
    """The regular files of two directories are the same names and
    byte-equal."""
    files = sorted(f for f in os.listdir(a)
                   if os.path.isfile(os.path.join(a, f)))
    assert files and files == sorted(
        f for f in os.listdir(b) if os.path.isfile(os.path.join(b, f)))
    for f in files:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                           shallow=False), f


@pytest.mark.parametrize("variant", ["python", "cpp"])
def test_growth_csvs_byte_equal(variant, tmp_path):
    rng = np.random.default_rng(1)
    history = [dict(hyphae=int(rng.integers(50, 900)),
                    segments=int(rng.integers(50, 9000)),
                    active_tips=int(rng.integers(0, 500)),
                    passive_tips=int(rng.integers(0, 9000)),
                    anastomosed=int(rng.integers(0, 90)),
                    branches=int(rng.integers(0, 900)),
                    total_length_mm=float(rng.uniform(1, 500)), step=t)
               for t in range(12)]
    starts, ends = _segments()
    inten = rng.uniform(0, 1e-7, len(starts))
    for tag, w in (("port", writers), ("ref", jwriters)):
        d = str(tmp_path / tag)
        w.write_growth_stats(d, history, variant=variant)
        w.export_geometry(d, starts, ends)
        w.write_snapshot_csv(os.path.join(d, "snap"), 3, starts, ends, inten)
    for sub in ("", "snap"):
        _same_tree(tmp_path / "port" / sub, tmp_path / "ref" / sub)


@pytest.mark.parametrize("variant", ["python", "cpp"])
def test_fea_csvs_byte_equal(variant, tmp_path):
    rng = np.random.default_rng(2)
    n_rec, n_el, n_nodes = 7, 23, 19
    stress = rng.normal(0, 30, (n_rec, n_el))
    active = rng.random((n_rec, n_el)) > 0.2
    disp = rng.normal(0, 1e-3, (n_rec, 3 * n_nodes))
    fd = np.stack([np.linspace(0, 0.02, n_rec), rng.normal(0, 1, n_rec)], 1)
    times = rng.uniform(0, 1, n_rec).tolist()
    for tag, w in (("port", writers), ("ref", jwriters)):
        d = str(tmp_path / tag)
        w.write_fea_records(d, stress, active, disp, fd, variant=variant)
        w.write_runtime(d, 12.3456789)
        w.write_solve_runtimes(d, times)
    _same_tree(tmp_path / "port", tmp_path / "ref")


def test_dedup_and_reader_equal_the_reference(tmp_path, monkeypatch):
    """dedup_nodes through the native library and through the numpy
    fallback equal the reference's; read_mesh_dir skips out-of-range
    elements as the reference's reader does."""
    starts, ends = _segments(3)
    ref = jwriters.dedup_nodes(starts, ends)
    for native in (True, False):
        if not native:
            monkeypatch.setattr(meshio_native, "dedup_nodes",
                                lambda *a, **k: None)
        nodes, conn = writers.dedup_nodes(starts, ends)
        np.testing.assert_array_equal(nodes, ref[0])
        np.testing.assert_array_equal(conn, ref[1])
    writers.export_geometry(str(tmp_path), starts, ends)
    with open(tmp_path / "elements.csv", "a") as f:
        f.write("999,0,100000\n1000,-1,2\n")
    for a, b in zip(readers.read_mesh_dir(str(tmp_path)),
                    jreaders.read_mesh_dir(str(tmp_path))):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_native_source_is_the_reference_copy():
    """The same code as native/meshio.cpp below the header comment."""
    def code(path):
        with open(path) as f:
            lines = f.read().splitlines()
        return lines[next(i for i, s in enumerate(lines)
                          if not s.startswith("//")):]

    assert code(meshio_native.SRC) == code(
        os.path.join(ROOT, "native", "meshio.cpp"))


def test_native_build_is_atomic_under_concurrent_processes(tmp_path):
    """Four processes build into one fresh directory at once: one
    compiles, the others wait on the lock; every one gets the same
    complete library and no temporary file is left behind."""
    code = ("import sys, ctypes\n"
            "from mycelium_tpu_torch.native import meshio_native as m\n"
            "p = m.build(sys.argv[1])\n"
            "ctypes.CDLL(p).meshio_dedup_nodes\n"
            "print(p)\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    path = paths.pop()
    assert path == meshio_native.library_path(str(tmp_path))
    left = os.listdir(os.path.dirname(path))
    assert sorted(left) == sorted([os.path.basename(path),
                                   os.path.basename(path) + ".lock"])


def test_native_build_failure_warns_with_the_fallback(monkeypatch):
    def fail(*a, **k):
        raise subprocess.CalledProcessError(1, "g++")

    monkeypatch.setattr(meshio_native, "build", fail)
    monkeypatch.setattr(meshio_native, "_tried", False)
    monkeypatch.setattr(meshio_native, "_lib", None)
    with pytest.warns(RuntimeWarning, match="numpy"):
        assert not meshio_native.available()
    assert meshio_native.dedup_nodes(np.zeros((2, 3))) is None
