"""K4's call time on a grown state, on the card.

    python -m mycelium_tpu_torch.profile_anast [--preset xlarge]
        [--steps 150] [--voxel-size V] [--three-d] [--reps 50]
        [--rounds 5]
    python -m mycelium_tpu_torch.profile_anast --registers

Grows the preset (``--three-d``: the reference 3D configuration at 2^16
segment slots) for ``--steps`` steps on the card, builds the scan's
tables as the next step's query builds them, and times K4 on them:
``--rounds`` readings, each the mean of ``--reps`` back-to-back calls
between two CUDA events. Prints one JSON object with the card's name,
the layout and the readings (milliseconds a call).

The script reads the package it is run from and asks nothing of the
widened layouts beyond what it needs, so the same file copied into an
older checkout of the port (whose ``check_layout`` returns the face
width alone and whose K4 takes the 2D corner window only) times that
checkout's K4 on the same state: that is how two versions are compared
on one card in one run, in turns.

``--registers`` compiles the checkout's ``csrc/anast_scan.cu`` alone with
the library's flags and ``-Xptxas -v`` and prints, a JSON object, each
kernel form's registers and spill bytes as ptxas reports them (nvcc
only, no card needed).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import tempfile

import torch

from .config import GROWTH_PRESETS
from .growth import neighbors, run_growth
from .kernels import anast_scan


def scan_args(st, cfg) -> tuple:
    """K4's arguments for a state, as ``detect_anastomosis`` builds them
    (``check_layout`` gives the face width alone in checkouts without the
    wider layouts)."""
    layout = neighbors.check_layout(cfg)
    g = layout if isinstance(layout, int) else layout.g
    extra = () if isinstance(layout, int) else (layout.gz, layout.window)
    grid, _ = neighbors.grid_insert_finalized(st.grid, st, cfg)
    tb = neighbors.tip_tables(st, cfg)
    return (st.tip, tb.scan_cell, st.start, st.end, grid.ids, grid.geo,
            grid.count, cfg.max_per_cell, tb.ov_slot, tb.ov_start,
            tb.ov_count, g, st.capacity, tb.tips) + extra


def registers() -> dict:
    """Kernel (mangled name) -> {registers, spill_stores, spill_loads}
    of ``csrc/anast_scan.cu`` compiled with the library's flags."""
    from .kernels import build
    src = os.path.join(os.path.dirname(os.path.abspath(build.__file__)),
                       "csrc", "anast_scan.cu")
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [build._nvcc()] + build.NVCC_FLAGS + ["-Xptxas", "-v", "-c", src, "-o",
                                         os.path.join(tmp, "a.o")],
            capture_output=True, text=True, check=True, timeout=600)
    forms, name = {}, None
    for line in (out.stdout + out.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            forms.setdefault(name, {}).update(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            forms.setdefault(name, {})["registers"] = int(m.group(1))
    return forms


def call_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="xlarge",
                    choices=sorted(GROWTH_PRESETS))
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--voxel-size", type=float, default=None)
    ap.add_argument("--three-d", action="store_true")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--registers", action="store_true",
                    help="print each kernel form's registers and spills")
    args = ap.parse_args(argv)
    if args.registers:
        print(json.dumps(registers()))
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("profile_anast: needs a CUDA card")
    if args.three_d:
        from .config import growth_3d_config
        cfg = growth_3d_config(max_segments=1 << 16, max_hyphae=1 << 15)
    else:
        cfg = GROWTH_PRESETS[args.preset]
    cfg = dataclasses.replace(cfg, t_steps=args.steps)
    if args.voxel_size is not None:
        cfg = dataclasses.replace(cfg, voxel_size=args.voxel_size)
    st, _, hist = run_growth(cfg, device="cuda")
    kargs = scan_args(st, cfg)
    readings = [call_ms(lambda: anast_scan(*kargs), args.reps)
                for _ in range(args.rounds)]
    print(json.dumps(dict(
        card=torch.cuda.get_device_name(0),
        config="3d" if args.three_d else args.preset, steps=args.steps,
        voxel_size=cfg.voxel_size, layout=list(kargs[14:]) or [1, 4],
        segments=hist[-1]["segments"],
        tips=int((kargs[1] >= 0).sum()), call_ms=readings)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
