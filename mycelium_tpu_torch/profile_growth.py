"""Where a growth step's time goes on the card.

    python -m mycelium_tpu_torch.profile_growth [--preset xlarge]
        [--warm 100] [--steps 5] [--out DIR]

Grows ``--warm`` steps of the preset, then measures ``--steps`` more in
four passes, each from the same state:

1. step wall milliseconds, the card synchronised only at the end;
2. per operator of the step (translocate, grow, anastomosis, uptake,
   walls), wall milliseconds with the card synchronised around each one;
3. the host syncs per step that PyTorch itself reports
   (``torch.cuda.set_sync_debug_mode``), by source line, beside the
   port's own count (``StepSyncs``);
4. a ``torch.profiler`` trace (after one profiled warm-up step): device
   time and device operations per step, the largest kernels; the busy
   share is that device time over pass 1's step time.

Prints one JSON object; with ``--out`` it also writes the Chrome trace
there. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import warnings

import torch

from .config import GROWTH_PRESETS
from .growth.neighbors import detect_anastomosis
from .growth.ops import enforce_walls, grow, translocate, uptake
from .growth.state import init_state
from .growth.draws import TorchDraws
from .growth.step import StepSyncs, growth_step
from .scenes import petri_dish
from .utils.profiling import device_ops


def _sync():
    torch.cuda.synchronize()


def step_ms(st, ea, cfg, draws, steps):
    """Wall ms per step, synchronised once at the end."""
    H, dtype = cfg.max_hyphae, st.sub.dtype
    walls = ea.wall_center.shape[0] > 0
    _sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        st = growth_step(st, ea, cfg, draws.step(H, dtype, walls))
    _sync()
    return (time.perf_counter() - t0) * 1e3 / steps


def per_op_ms(st, ea, cfg, draws, steps):
    """Wall ms per operator, synchronised around each."""
    H, dtype = cfg.max_hyphae, st.sub.dtype
    walls = ea.wall_center.shape[0] > 0
    ops = {"translocate": 0.0, "grow": 0.0, "anastomosis": 0.0,
           "uptake": 0.0, "walls": 0.0}
    for _ in range(steps):
        d = draws.step(H, dtype, walls)
        for name, fn in (("translocate", lambda s: translocate(s, cfg)),
                         ("grow", lambda s: grow(s, cfg, d)),
                         ("anastomosis", lambda s: detect_anastomosis(s, cfg)),
                         ("uptake", lambda s: uptake(s, ea, cfg)),
                         ("walls", lambda s: enforce_walls(s, ea, cfg, d))):
            _sync()
            t0 = time.perf_counter()
            st = fn(st)
            _sync()
            ops[name] += (time.perf_counter() - t0) * 1e3
    return {k: v / steps for k, v in ops.items()}, st


def syncs_per_step(st, ea, cfg, draws, steps):
    """(PyTorch's count of synchronising calls, the port's own count),
    per step, and PyTorch's count by source line."""
    H, dtype = cfg.max_hyphae, st.sub.dtype
    walls = ea.wall_center.shape[0] > 0
    own = StepSyncs()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(steps):
                st = growth_step(st, ea, cfg, draws.step(H, dtype, walls),
                                 syncs=own)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{os.path.relpath(w.filename)}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1 / steps
    return sum(sites.values()), own.per_step, sites


def profile(st, ea, cfg, draws, steps, out_dir, wall_ms):
    from torch.profiler import ProfilerActivity, schedule
    from torch.profiler import profile as tprofile
    H, dtype = cfg.max_hyphae, st.sub.dtype
    walls = ea.wall_center.shape[0] > 0
    _sync()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  schedule=schedule(wait=0, warmup=1, active=steps,
                                    repeat=1)) as prof:
        for _ in range(steps + 1):
            st = growth_step(st, ea, cfg, draws.step(H, dtype, walls))
            _sync()
            prof.step()
    kernels = device_ops(prof)
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, "growth_trace.json"))
    return dict(device_busy_ms=busy_ms / steps,
                busy_share=busy_ms / steps / wall_ms,
                device_ops_per_step=len(kernels) / steps,
                top_kernels_ms_per_step=[(k[:80], v / steps) for k, v in top])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="xlarge",
                    choices=sorted(GROWTH_PRESETS))
    ap.add_argument("--warm", type=int, default=100)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_growth: needs a CUDA card")
    cfg = dataclasses.replace(GROWTH_PRESETS[args.preset],
                              t_steps=args.warm + args.steps)
    draws = TorchDraws(cfg.seed, "cuda")
    st, ea = init_state(cfg, petri_dish(cfg), device="cuda", draws=draws)
    H, dtype = cfg.max_hyphae, st.sub.dtype
    walls = ea.wall_center.shape[0] > 0
    for _ in range(args.warm):
        st = growth_step(st, ea, cfg, draws.step(H, dtype, walls))
    _sync()
    growth_step(st, ea, cfg, draws.step(H, dtype, walls))   # warm caches
    wall_ms = step_ms(st, ea, cfg, draws, args.steps)
    ops, _ = per_op_ms(st, ea, cfg, draws, args.steps)
    torch_syncs, own_syncs, sites = syncs_per_step(st, ea, cfg, draws,
                                                   args.steps)
    prof = profile(st, ea, cfg, draws, args.steps, args.out, wall_ms)
    print(json.dumps(dict(
        card=torch.cuda.get_device_name(0), preset=args.preset,
        after_steps=args.warm, steps=args.steps, segments=st.n_seg,
        hyphae=st.n_hyp, step_ms=wall_ms, op_ms_synchronised=ops,
        host_syncs_per_step=dict(torch_reported=torch_syncs,
                                 port_counted=own_syncs, by_line=sites),
        **prof)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
