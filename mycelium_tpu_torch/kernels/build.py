"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface and loaded with ``ctypes``: no PyTorch
headers, so the build takes seconds. It happens at first use, never at
import, into ``kernels/build/<hash>/``, keyed by a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused.

K5 (``chain_cg.cu``) and K6 (``tree_cg.cu``) synchronise their grids with
cooperative groups' ``grid.sync()`` and are launched with
``cudaLaunchCooperativeKernel``; since
CUDA 11 that needs no relocatable device code (``-rdc``), so every source
takes the same flags.

``-fmad=false`` keeps products from being contracted into fused
multiply-adds: the kernels then round like their plain PyTorch versions,
which is what lets the card-side comparisons use tight tolerances.

Each wrapper counts its launches here; a run reads the counts to show
that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import fcntl
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
# The compile-time constants of tree_cg.cu, defined here so that the
# wrapper's shared-memory size and the kernel cannot disagree.
# TREE_CG_WINDOW: slots of a path-aligned window of K6. One block holds the
# window's whole factorization state in shared memory, 45 planes twice over
# (360 B a slot): 256 slots are 92 KB, so two blocks fit one SM of an H100
# (227 KB), and a round is one slot a thread of the 256-thread block. The
# default longest path (``tree_max_path_len`` 128) fits twice.
# TREE_CG_CHUNK: central slots a block takes per halo window of the apply on
# a level with a longer path, which keeps global rounds (the halo of
# 2^rounds - 1 slots on both sides is recomputed by every block).
TREE_CG_WINDOW = 256
TREE_CG_CHUNK = 256
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-fmad=false",
                           "-Xcompiler", "-fPIC",
                           f"-DTREE_CG_CHUNK={TREE_CG_CHUNK}",
                           f"-DTREE_CG_WINDOW={TREE_CG_WINDOW}"]
LINK_FLAGS = ARCH_FLAGS + ["-shared"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_SIGNATURES = {
    # ptrs, n_ptrs (the enum Ptr of chain_matvec.cu), n, reg, u, out, bc,
    # stream
    "chain_matvec_f32": [ctypes.POINTER(_P), ctypes.c_int, _I64,
                         ctypes.c_float, _P, _P, ctypes.c_int, _P],
    # D, B, corner, al, be, dinv, xc, work, win_start, win_len, n_win, S,
    # steps, stream
    "pcr_factor_f32": [_P] * 10 + [ctypes.c_int, _I64, ctypes.c_int, _P],
    # al, be, dinv, r, u, S, steps, stream
    "pcr_apply_f32": [_P] * 5 + [_I64, ctypes.c_int, _P],
    "pcr_apply_max_steps": [],
    # backward, al, be, dinv, win_start, win_len, n_win, att_ptr, att_ent,
    # first_path, last_path, att_tgt, ab, rp, rs, u, us, nv, s0, S, S_tot,
    # steps, stream
    "pcr_sweep_f32": [ctypes.c_int] + [_P] * 5 + [ctypes.c_int] + [_P] * 7
    + [_I64, _P, _I64, _P, _I64, _I64, _I64, ctypes.c_int, _P],
    # vals, vals' strides (k, term), ptr, ent, shift, init, init's strides
    # (k, segment), out, n, K, long_segments, stream
    "ordered_sum_f32": [_P, _I64, _I64, _P, _P, ctypes.c_int, _P, _I64,
                        _I64, _P, _I64, ctypes.c_int, ctypes.c_int, _P],
    "ordered_sum_f64": [_P, _I64, _I64, _P, _P, ctypes.c_int, _P, _I64,
                        _I64, _P, _I64, ctypes.c_int, ctypes.c_int, _P],
    # tip_slot, tip_cell, tip_order, tip_start, tip_count, start, end,
    # gids, ggeo, gcount, ov_slot, ov_start, ov_count, d2, tt, id, H, cap,
    # g, n_slots, gz, window, stream
    "anast_scan_f32": [_P] * 16 + [_I64] + [ctypes.c_int] * 6 + [_P],
    # ptrs, n_ptrs, ints, n_ints (the enums Ptr and Int of chain_cg.cu),
    # active, anchored, x0, x, stats, dy_top, dy_bot, rtol, reg, max_iter,
    # setup_only, stream
    "chain_cg_f32": [ctypes.POINTER(_P), ctypes.c_int,
                     ctypes.POINTER(_I64), ctypes.c_int] + [_P] * 5
    + [ctypes.c_float] * 4 + [ctypes.c_int, ctypes.c_int, _P],
    # blocks per SM (out), SMs (out)
    "chain_cg_grid_blocks": [ctypes.POINTER(ctypes.c_int),
                             ctypes.POINTER(ctypes.c_int)],
    # ptrs, n_ptrs, ints, n_ints (the enums Ptr and Int of tree_cg.cu),
    # active, free, x0, x, stats, dy_top, dy_bot, rtol, reg, reg_pc,
    # stall_accept, max_iter, stream
    "tree_cg_f32": [ctypes.POINTER(_P), ctypes.c_int,
                    ctypes.POINTER(_I64), ctypes.c_int] + [_P] * 5
    + [ctypes.c_float] * 6 + [ctypes.c_int, _P],
    # ptrs, n_ptrs, ints, n_ints, active, free, x0, dy_top, dy_bot, reg_pc,
    # stream
    "tree_cg_setup_f32": [ctypes.POINTER(_P), ctypes.c_int,
                          ctypes.POINTER(_I64), ctypes.c_int] + [_P] * 3
    + [ctypes.c_float] * 3 + [_P],
    # dynamic shared memory bytes, blocks per SM (out), SMs (out)
    "tree_cg_grid_blocks": [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                            ctypes.POINTER(ctypes.c_int)],
    # grid blocks, barriers, out (one int on the device), stream
    "tree_cg_barrier_probe": [ctypes.c_int, ctypes.c_int, _P, _P],
}

_launches = {"chain_matvec": 0, "pcr_factor": 0, "pcr_apply": 0,
             "anast_scan": 0, "chain_cg": 0, "tree_cg": 0,
             "ordered_sum": 0}


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, h.hexdigest()[:16],
                        "libmycelium_kernels.so")


def _run_all(cmds: list) -> None:
    """Run the commands at once; raise with the first failure's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(c)}\n{out}")


def build() -> tuple:
    """Compile the library if it is not built yet: one nvcc per source,
    all started together, then one link. Under a file lock, into a
    temporary name that is renamed into place, so concurrent processes
    never load a partial library. Returns (path, seconds spent
    compiling, 0.0 when it was already built)."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return path, 0.0
        nvcc, pid = _nvcc(), os.getpid()
        t0 = time.perf_counter()
        srcs = [s for s in _sources() if s.endswith(".cu")]
        objs = [f"{path}.{os.path.basename(s)}.{pid}.o" for s in srcs]
        tmp = f"{path}.{pid}.tmp"
        try:
            _run_all([[nvcc] + NVCC_FLAGS + ["-c", s, "-o", o]
                      for s, o in zip(srcs, objs)])
            _run_all([[nvcc] + LINK_FLAGS + ["-o", tmp] + objs])
            os.replace(tmp, path)
        finally:
            for f in objs + [tmp]:
                if os.path.exists(f):
                    os.remove(f)
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
    """The current stream's handle of CUDA tensor ``t``'s device
    (``raw_stream``: no ``torch.cuda.Stream`` object a launch)."""
    return raw_stream(t.device.index)


def raw_stream(device_index: int) -> int:
    """The current stream's handle of a device by its index, without
    building a ``torch.cuda.Stream`` object: what a bound launch calls on
    every launch."""
    import torch
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device_index)
    return torch.cuda.current_stream(device_index).cuda_stream
