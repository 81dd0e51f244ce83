"""The port stands alone: importing every module of ``mycelium_tpu_torch``
and ``chip_smoke`` loads neither jax, nor the JAX package
(``mycelium_tpu``), nor the root ``bench.py``. Checked in a fresh
interpreter, since this test process has imported all three."""

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
        'mycelium_tpu_torch.bench.coupled'} <= set(names)
import chip_smoke
chip_smoke.run
bad = sorted(k for k in sys.modules
             if k.split('.')[0] in ('jax', 'jaxlib', 'mycelium_tpu', 'bench'))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 27 else 0)
"""


def test_port_and_chip_smoke_import_nothing_of_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", CODE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
