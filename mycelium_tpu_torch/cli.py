"""Command line of the port (counterpart of ``mycelium_tpu.cli fea``):

  python -m mycelium_tpu_torch.cli fea <results_dir> [--fea-steps N]
      [--grip G] [--disp-max D] [--device cuda|cpu]

Reads ``<results_dir>/nodes.csv`` and ``elements.csv``, runs the pull-test
ramp with the hybrid preset and writes ``<results_dir>/fea_results/``
through the reference's CSV writers. Without ``--device`` the run needs a
CUDA card and stops if there is none; ``--device cpu`` runs the plain
PyTorch versions of the kernels on the host.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def cmd_fea(args) -> str:
    import torch

    from mycelium_tpu.config import save_run_configs
    from mycelium_tpu.io import read_mesh_dir, write_fea_records
    from mycelium_tpu.io.writers import write_runtime, write_solve_runtimes

    from .config import hybrid_fea_config
    from .fea import run_ramp

    device = args.device
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: this command runs the FEA "
                             "ramp on the GPU; pass --device cpu to run the "
                             "plain PyTorch path on the host instead")
        device = "cuda"

    t0 = time.time()
    coords, conn = read_mesh_dir(args.results_dir)
    overrides = {}
    if args.fea_steps is not None:
        overrides["n_steps"] = args.fea_steps
    if args.grip is not None:
        overrides["grip_length"] = args.grip
    if args.disp_max is not None:
        overrides["displacement_max"] = args.disp_max
    cfg = hybrid_fea_config(**overrides)
    print(f"FEA on {args.results_dir}: {coords.shape[0]} nodes, "
          f"{conn.shape[0]} elements, device {device}")
    res = run_ramp(coords, conn, cfg, device=device)
    fea_dir = os.path.join(args.results_dir, "fea_results")
    write_fea_records(fea_dir, res.stress_record, res.active_record,
                      res.disp_record, res.force_disp)
    write_solve_runtimes(fea_dir, res.solve_seconds)
    write_runtime(fea_dir, time.time() - t0)
    save_run_configs(args.results_dir, fea=cfg)
    print(f"{res.force_disp.shape[0]} steps, peak force "
          f"{res.force_disp[:, 1].max():.6g} -> {fea_dir}")
    return fea_dir


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mycelium_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)
    fea = sub.add_parser("fea", help="pull-test ramp on a results dir")
    fea.add_argument("results_dir")
    fea.add_argument("--fea-steps", type=int, default=None)
    fea.add_argument("--grip", type=float, default=None)
    fea.add_argument("--disp-max", type=float, default=None)
    fea.add_argument("--device", choices=("cuda", "cpu"), default=None)
    args = ap.parse_args(argv)
    if args.cmd == "fea":
        cmd_fea(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
