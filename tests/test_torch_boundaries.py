"""The port's import boundary: no jax, jaxlib or triton, and no CUDA
library built or loaded at import (its card-side boundary, kernels or a
raise on CUDA tensors, is tested in test_torch_kernels.py)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_package_imports_no_jax_or_triton():
    """Every module imports without jax, jaxlib or triton, and importing
    builds and loads no CUDA library."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mycelium_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'mycelium_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'triton'))\n"
        "from mycelium_tpu_torch.kernels import build\n"
        "built = build.library.cache_info().currsize\n"
        "print(len(names), bad, built)\n"
        "sys.exit(1 if bad or built or len(names) < 15 else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
