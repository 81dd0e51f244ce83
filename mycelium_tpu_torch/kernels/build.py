"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface and loaded with ``ctypes``: no PyTorch
headers, so the build takes seconds. It happens at first use, never at
import, into ``kernels/build/<hash>/``, keyed by a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused.

``-fmad=false`` keeps products from being contracted into fused
multiply-adds: the kernels then round like their plain PyTorch versions,
which is what lets the card-side comparisons use tight tolerances.

Each wrapper counts its launches here; a run reads the counts to show
that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-fmad=false", "-shared",
                           "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_SIGNATURES = {
    # u, free, cact, jact, cn, ckax, ckbd, jn, jkax, jkbd, ja, jb, jp,
    # jptr, jent, out, n, reg, bc, stream
    "chain_matvec_f32": [_P] * 12 + [_I64, _P, _P, _P, _I64,
                                     ctypes.c_float, ctypes.c_int, _P],
    # D, B, rhs, al, be, dinv, xc, work, S, steps, stream
    "pcr_factor_f32": [_P] * 8 + [_I64, ctypes.c_int, _P],
    # al, be, dinv, r, u, S, steps, stream
    "pcr_apply_f32": [_P] * 5 + [_I64, ctypes.c_int, _P],
    "pcr_apply_max_steps": [],
}

_launches = {"chain_matvec": 0, "pcr_factor": 0, "pcr_apply": 0}


def count_launch(name: str) -> None:
    _launches[name] += 1


def launch_counts() -> dict:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def _sources() -> list:
    return sorted(os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, h.hexdigest()[:16],
                        "libmycelium_kernels.so")


def build() -> tuple:
    """Compile the library if it is not built yet. Returns (path,
    seconds spent compiling, 0.0 when it was already built)."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc()] + NVCC_FLAGS + ["-o", tmp] + [
        s for s in _sources() if s.endswith(".cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path, time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    path, _ = build()
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_handle(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
