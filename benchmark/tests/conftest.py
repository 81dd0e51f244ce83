"""Fixtures of the benchmark's CPU tests.

    python -m pytest benchmark/tests -q -p no:cacheprovider

Tests marked ``card`` need a CUDA card and skip without one; on the card
machine the same command runs them. ``small_root`` is a copy of the
benchmark's data files (BENCHMARK.json and ``benchmark/``) with every
network cut to 1,500 nodes, or grown on a small dish, and grips 0.3 of the
y extent, so that a whole run of a cell fits a test on the CPU; the
harness's code is the repo's."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SMALL_NODES = 1500
# a grown network of ~500 segments: 4 sites on a 2 mm dish, 40 steps; the
# 3D variant's tolerance (5e-3 mm) so that tips fuse every few steps; in
# float64, since the cell's growth limits are set at the demo dish's states
# (on this dish float32 leaves other rounding in the nutrient's drain)
SMALL_GROWTH = dict(dish_size=2.0, substrate_width=2.0, inoculum_nx=2,
                    inoculum_ny=2, omega0=5e-6 * 4 / 25, t_steps=40,
                    anastomosis_tol=5e-3, max_segments=1 << 12,
                    max_hyphae=1 << 11, dtype="float64")


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def copy_benchmark(dst: str, nodes: int = SMALL_NODES) -> str:
    """BENCHMARK.json and the benchmark's files under ``dst``, every
    configuration's network cut to ``nodes`` nodes, or grown as
    ``SMALL_GROWTH``."""
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for c in spec["configs"]:
        path = os.path.join(dst, c["file"])
        cfg = json.load(open(path))
        if "mesh" in cfg:
            cfg["mesh"]["n_target_nodes"] = nodes
        else:
            cfg["growth"].update(SMALL_GROWTH)
        cfg["fea"]["grip_length"] = {"y_extent_fraction": 0.3}
        json.dump(cfg, open(path, "w"))
    json.dump(spec, open(os.path.join(dst, "BENCHMARK.json"), "w"))
    return dst


@pytest.fixture
def small_root(tmp_path):
    return copy_benchmark(str(tmp_path))


def run_small(root: str, cell: str, seed: int = 2**33 + 5,
              seconds: float = 1.0, traced: bool = False):
    """One run of ``cell`` of ``root`` on the CPU (the plain versions of
    the kernels), past the harness's look for a card."""
    import time
    import torch
    from benchmark.harness.cell import run_cell
    torch.set_num_threads(1)
    return run_cell(root, cell, seed, seconds, traced, torch.device("cpu"),
                    time.perf_counter())
