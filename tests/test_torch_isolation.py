"""The port stands alone: importing every module of ``mycelium_tpu_torch``
(its CLI included) and ``chip_smoke`` loads neither jax, nor the JAX
package (``mycelium_tpu``), nor the root ``bench.py``, nor matplotlib,
which the plots load only when they draw. Checked in a fresh interpreter,
since this test process has imported all four. The plots module, a copy
of the JAX package's, imports only numpy, matplotlib and the standard
library."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = """
import importlib, pkgutil, sys
import mycelium_tpu_torch as p
names = [m.name for m in pkgutil.walk_packages(p.__path__,
                                               'mycelium_tpu_torch.')]
for n in names:
    importlib.import_module(n)
assert {'mycelium_tpu_torch.bench.growth_scale',
        'mycelium_tpu_torch.bench.coupled', 'mycelium_tpu_torch.cli',
        'mycelium_tpu_torch.viz.plots',
        'mycelium_tpu_torch.growth.shard'} <= set(names)
import chip_smoke
chip_smoke.run
bad = sorted(k for k in sys.modules
             if k.split('.')[0] in ('jax', 'jaxlib', 'mycelium_tpu', 'bench',
                                    'matplotlib', 'mpl_toolkits'))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 27 else 0)
"""


def test_port_and_chip_smoke_import_nothing_of_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", CODE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_plots_import_only_numpy_matplotlib_and_the_standard_library():
    path = os.path.join(ROOT, "mycelium_tpu_torch", "viz", "plots.py")
    tree = ast.parse(open(path).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "a relative import"
            roots.add(node.module.split(".")[0])
    assert roots <= {"__future__", "os", "typing", "importlib", "numpy",
                     "matplotlib", "mpl_toolkits"}, roots
    assert "matplotlib" in roots and "mycelium_tpu" not in roots
