"""What the benchmark loads: a run (the harness, every traffic driver,
every metric reader, the reference, and a whole run of a cell on the CPU)
holds no module whose top-level name is ``jax``, ``jaxlib``, ``flax`` or
``mycelium_tpu`` (names compared whole: ``mycelium_tpu_torch`` is the
program), and the reference loads nothing of the port either. Each is
checked in a fresh interpreter."""

import ast
import glob
import os
import subprocess
import sys

from conftest import ROOT

RUN = r"""
import glob, os, sys, time, tempfile
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, os.path.join(sys.argv[1], "benchmark", "tests"))
import torch
torch.set_num_threads(1)
from benchmark.harness.spec import kind_module, load_spec, metric_reader
spec = load_spec(sys.argv[1])
for m in spec["end_to_end"] + spec["per_layer"]:
    metric_reader(sys.argv[1], m["name"])
for k in glob.glob(os.path.join(sys.argv[1], "benchmark", "kinds", "*.py")):
    kind_module(sys.argv[1], os.path.basename(k)[:-3])
import benchmark.run as run
from conftest import copy_benchmark, run_small
with tempfile.TemporaryDirectory() as d:
    out = run_small(copy_benchmark(d, 600), sys.argv[2], seconds=0.2)
assert out.result["correct"], out.result
print(run.forbidden_modules())
sys.exit(1 if run.forbidden_modules() else 0)
"""

REF = r"""
import sys
sys.path.insert(0, sys.argv[1])
import benchmark.reference.pulltest
bad = sorted({m.split(".")[0] for m in sys.modules}
             & {"jax", "jaxlib", "flax", "mycelium_tpu",
                "mycelium_tpu_torch", "torch"})
print(bad)
sys.exit(1 if bad else 0)
"""


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_a_run_loads_nothing_of_jax():
    for cell in ("pull22k-cold", "pull309k-fracture"):
        out = subprocess.run([sys.executable, "-c", RUN, ROOT, cell],
                             cwd=ROOT, env=_env(), capture_output=True,
                             text=True, timeout=600)
        assert out.returncode == 0, out.stdout + out.stderr


def test_the_reference_loads_nothing_of_the_port():
    out = subprocess.run([sys.executable, "-c", REF, ROOT], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_the_reference_imports_only_numpy_and_scipy():
    allowed = {"__future__", "typing", "numpy", "scipy"}
    for path in glob.glob(os.path.join(ROOT, "benchmark", "reference",
                                       "*.py")):
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in allowed, (path, n)
