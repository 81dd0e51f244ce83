"""Command line of the port (counterpart of ``mycelium_tpu.cli``):

  python -m mycelium_tpu_torch.cli [--distributed] grow [--out results]
      [--dir D] [--steps N] [--seed S] [--capacity C] [--preset P]
      [--three-d] [--snapshots none|csv|png] [--checkpoint-every K]
      [--resume FILE] [--no-summary-plot]
      [--csv-variant python|cpp] [--verbose] [--device cuda|cpu]
  python -m mycelium_tpu_torch.cli [--distributed] fea <results_dir>
      [--fea-steps N] [--grip G] [--disp-max D] [--preset fast|reference]
      [--f64] [--scan] [--sharded [N]] [--fea-checkpoint-every K]
      [--fea-resume FILE] [--trace DIR] [--no-plots]
      [--csv-variant python|cpp] [--verbose] [--device cuda|cpu]
  python -m mycelium_tpu_torch.cli pipeline [grow options] [fea options]
      (the growth preset is --growth-preset there)
  python -m mycelium_tpu_torch.cli sweep <results_dir> [--trials N] [--f64]
      [--verbose] [--device cuda|cpu]
  python -m mycelium_tpu_torch.cli plot-snapshots <results_dir>
  python -m mycelium_tpu_torch.cli plot-fea <results_dir>

``grow`` writes ``mycelium_growth_stats.csv``, ``nodes.csv``/``elements.csv``
(and per-step snapshots) into ``<out>/sim_<timestamp>`` or ``--dir``;
``--three-d`` grows the reference's 3D configuration (``growth_3d_config``:
six inoculum sites in a dish with z-walls) in place of a 2D preset;
``fea`` reads a results directory's mesh and writes ``fea_results/``, with
the solver preset ``fast`` (``tuned_fea_config``: chain operator, tree
preconditioner with the coarse correction) or ``reference``
(``FeaConfig()``: ELL operator, block-Jacobi); ``pipeline`` runs grow,
then fea on the directory it wrote (the reference's run_all.slurm flow);
``--scan`` runs the ramp with device-resident records (``run_ramp_scan``,
cut at full fracture) and writes the same files;
``sweep`` times the 3 solvers x 5 preconditioners over the ramp of a
results directory's mesh and writes ``runtime_results.csv`` and its
``_meta.json``. The CSVs are the JAX package's contracts. Without
``--device`` a command needs a CUDA card and stops if
there is none; ``--device cpu`` runs the plain PyTorch versions of the
kernels on the host.

Checkpoints: ``grow --checkpoint-every K`` saves
``<dir>/growth_checkpoint.npz`` every K steps and ``--resume FILE`` goes
on from one; ``fea --fea-checkpoint-every K`` saves
``<results_dir>/fea_checkpoint.npz`` every K ramp steps (the loop
drivers) and ``--fea-resume FILE`` goes on from one (a file the JAX
package wrote too). ``--sharded [N]`` runs every solve of the ramp
domain-decomposed over the ranks of the process group (``--distributed``:
one process a rank as ``torchrun`` starts them, NCCL on cards, gloo with
``--device cpu``; without it a group of this process alone); N, if given,
must be the group's size. Only rank 0 writes files. ``--trace DIR``
writes a ``torch.profiler`` Chrome trace of the ramp into DIR.

Plots, as the JAX CLI draws them (``viz/plots.py``), by rank 0:
``grow`` writes ``mycelium_growth_summary.png`` unless
``--no-summary-plot``, and with ``--snapshots png`` a
``snapshots/petri_step_NNNN.png`` a step in place of the CSVs; ``fea``
writes ``fea_results/force_displacement.png`` and a
``fea_results/fea_step_NNN.png`` a recorded step unless ``--no-plots``;
``plot-snapshots`` renders a results directory's snapshot CSVs and
``plot-fea`` its FEA records. A command that will plot stops before any
work where matplotlib is not installed; a machine without it passes
``--no-plots --no-summary-plot`` (and no ``--snapshots png``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import os
import sys
import time


def _device(args) -> str:
    import torch
    device = getattr(args, "device", None)    # the plot commands have none
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: this command runs on the GPU; "
                             "pass --device cpu to run the plain PyTorch "
                             "path on the host instead")
        return "cuda"
    return device


def _check_plots(args) -> None:
    """Stop before any work where the command will plot and matplotlib is
    missing."""
    plots = args.cmd in ("plot-snapshots", "plot-fea") or (
        args.cmd in ("grow", "pipeline")
        and (not args.no_summary_plot or args.snapshots == "png")) or (
        args.cmd in ("fea", "pipeline") and not args.no_plots)
    if plots:
        from .viz import require_matplotlib
        require_matplotlib("--no-plots --no-summary-plot (and no "
                           "--snapshots png)")


def _run_device(args):
    """The command's device: this rank's card (``cuda:LOCAL_RANK``), or
    the CPU."""
    from .utils.dist import rank_device
    return rank_device(_device(args))


def cmd_grow(args) -> str:
    from .config import GROWTH_PRESETS, growth_3d_config, save_run_configs
    from .growth import run_growth
    from .growth.export import export_state_geometry, write_state_snapshot
    from .io import write_growth_stats
    from .utils.dist import is_coordinator

    device = _run_device(args)
    if args.three_d and args.growth_preset != "demo":
        raise SystemExit("--three-d grows the reference's 3D configuration; "
                         "the growth presets are 2D")
    cfg = growth_3d_config() if args.three_d \
        else GROWTH_PRESETS[args.growth_preset]
    overrides = {}
    if args.steps is not None:
        overrides["t_steps"] = args.steps
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.capacity is not None:
        overrides["max_segments"] = args.capacity
        overrides["max_hyphae"] = max(args.capacity // 2, 1024)
    cfg = dataclasses.replace(cfg, **overrides)

    out_dir = args.dir or os.path.join(
        args.out, datetime.datetime.now().strftime("sim_%Y%m%d_%H%M%S"))
    writer = is_coordinator()
    if writer:
        os.makedirs(out_dir, exist_ok=True)
    on_step = None
    snapshot_dir = os.path.join(out_dir, "snapshots")
    if args.snapshots == "csv" and writer:
        def on_step(t, st):
            write_state_snapshot(st, snapshot_dir, t)
    elif args.snapshots == "png" and writer:
        import numpy as np

        from .growth import segments_to_host
        from .viz import plot_mycelium

        def on_step(t, st):
            starts, ends, sub, _, _ = segments_to_host(st)
            inten = sub * np.linalg.norm(ends - starts, axis=1)
            plot_mycelium(starts, ends, inten, t,
                          os.path.join(snapshot_dir,
                                       f"petri_step_{t:04d}.png"),
                          dish_size=cfg.dish_size, three_d=cfg.three_d,
                          height=cfg.height)

    initial_state = draws = None
    if args.resume:
        from .io.checkpoint import load_growth_state
        initial_state, draws = load_growth_state(args.resume, cfg, device)
        if draws is None:
            raise SystemExit(f"{args.resume} holds a JAX PRNG key, not a "
                             "draw state: the port cannot go on with that "
                             "key's stream")
        print(f"resuming from {args.resume} at step {initial_state.step}")
    ckpt_path = os.path.join(out_dir, "growth_checkpoint.npz") \
        if args.checkpoint_every else None

    print(f"growing: {cfg.t_steps} steps on {device} -> {out_dir}")
    st, _, history = run_growth(cfg, device=device, draws=draws,
                                on_step=on_step, verbose=args.verbose,
                                initial_state=initial_state,
                                checkpoint_path=ckpt_path,
                                checkpoint_every=args.checkpoint_every)
    if writer:
        write_growth_stats(out_dir, history, variant=args.csv_variant)
        export_state_geometry(st, out_dir)
        save_run_configs(out_dir, growth=cfg)
        if not args.no_summary_plot:
            from .viz import plot_growth_summary
            plot_growth_summary(history, out_dir)
    final = history[-1]
    print(f"done: {final['hyphae']} hyphae, {final['segments']} segments, "
          f"{final['total_length_mm']:.1f} mm")
    return out_dir


def cmd_fea(args) -> str:
    from .config import FeaConfig, save_run_configs, tuned_fea_config
    from .fea import run_ramp, run_ramp_scan, truncate_after_fracture
    from .io import (read_mesh_dir, write_fea_records, write_runtime,
                     write_solve_runtimes)
    from .utils.dist import initialize_single, is_coordinator, process_count

    device = _run_device(args)
    if args.sharded is not None:
        import torch.distributed as dist
        if not dist.is_initialized():
            initialize_single(device)
        if args.sharded != -1 and args.sharded != process_count():
            raise SystemExit(f"--sharded {args.sharded}: the process group "
                             f"has {process_count()} ranks")
    t0 = time.time()
    coords, conn = read_mesh_dir(args.results_dir)
    overrides = {}
    if args.fea_steps is not None:
        overrides["n_steps"] = args.fea_steps
    if args.grip is not None:
        overrides["grip_length"] = args.grip
    if args.disp_max is not None:
        overrides["displacement_max"] = args.disp_max
    if args.f64:
        overrides["dtype"] = "float64"
    cfg = (tuned_fea_config(**overrides) if args.preset == "fast"
           else FeaConfig(**overrides))
    print(f"FEA on {args.results_dir}: {coords.shape[0]} nodes, "
          f"{conn.shape[0]} elements, device {device}")
    ckpt = dict(checkpoint_path=os.path.join(args.results_dir,
                                             "fea_checkpoint.npz")
                if args.fea_checkpoint_every else None,
                checkpoint_every=args.fea_checkpoint_every,
                resume_from=args.fea_resume)
    traced = contextlib.nullcontext()
    if args.trace and is_coordinator():
        from .utils.profiling import trace
        traced = trace(args.trace)
    with traced:
        if args.sharded is not None:
            from .fea import run_ramp_sharded
            res = run_ramp_sharded(coords, conn, cfg, device=device, **ckpt)
        elif args.scan:
            res = truncate_after_fracture(
                run_ramp_scan(coords, conn, cfg, device=device))
        else:
            res = run_ramp(coords, conn, cfg, device=device, **ckpt)
    if args.trace and is_coordinator():
        print(f"trace -> {args.trace}")
    fea_dir = os.path.join(args.results_dir, "fea_results")
    if is_coordinator():
        write_fea_records(fea_dir, res.stress_record, res.active_record,
                          res.disp_record, res.force_disp,
                          variant=args.csv_variant)
        write_solve_runtimes(fea_dir, res.solve_seconds)
        write_runtime(fea_dir, time.time() - t0)
        save_run_configs(args.results_dir, fea=cfg)
        if not args.no_plots:
            _plot_fea(coords, conn, res.stress_record, res.active_record,
                      res.force_disp, fea_dir, res.disp_record)
    if args.verbose:
        for i, (d, force) in enumerate(res.force_disp):
            print(f"step {i}: displacement {d:.6g} mm, force {force:.6g} N, "
                  f"active {int(res.active_record[i].sum())}")
    print(f"{res.force_disp.shape[0]} steps, peak force "
          f"{res.force_disp[:, 1].max():.6g} -> {fea_dir}")
    return fea_dir


def _plot_fea(coords, conn, stress, active, force_disp, fea_dir,
              disp=None) -> int:
    """force_displacement.png and a fea_step_NNN.png a recorded step (on
    the displaced network where ``disp`` is given, as after ``fea``; on
    the mesh as read, as ``plot-fea`` draws it). Returns the steps."""
    from .viz import plot_force_displacement, plot_network
    plot_force_displacement(force_disp,
                            os.path.join(fea_dir, "force_displacement.png"))
    for step in range(stress.shape[0]):
        xy = coords if disp is None else coords + disp[step].reshape(-1, 3)
        plot_network(xy, conn, stress[step], active[step],
                     os.path.join(fea_dir, f"fea_step_{step:03d}.png"), step)
    return stress.shape[0]


def cmd_pipeline(args) -> str:
    from .utils.dist import coordinator_barrier
    args.results_dir = cmd_grow(args)
    coordinator_barrier("mesh")     # rank 0 wrote the mesh the ranks read
    return cmd_fea(args)


def cmd_sweep(args) -> str:
    from .bench import run_solver_sweep
    from .config import FeaConfig
    from .io import read_mesh_dir
    from .utils.dist import is_coordinator

    device = _run_device(args)
    coords, conn = read_mesh_dir(args.results_dir)
    cfg = FeaConfig(dtype="float64" if args.f64 else "float32")
    out_csv = os.path.join(args.results_dir, "runtime_results.csv")
    rows = run_solver_sweep(coords, conn, cfg, trials=args.trials,
                            out_csv=out_csv if is_coordinator() else None,
                            verbose=args.verbose, device=device)
    print(f"{len(rows)} timings -> {out_csv}")
    return out_csv


def cmd_plot_snapshots(args) -> int:
    """Every snapshots/step_*.csv of a results directory to a PNG beside
    it."""
    import glob

    from .viz import plot_snapshot_csv
    snaps = sorted(glob.glob(os.path.join(args.results_dir, "snapshots",
                                          "step_*.csv")))
    for csv in snaps:
        plot_snapshot_csv(csv, csv.replace(".csv", ".png"))
    print(f"rendered {len(snaps)} snapshots")
    return len(snaps)


def cmd_plot_fea(args) -> int:
    """A results directory's FEA records (``fea_results/``) drawn on its
    mesh."""
    from .io import read_fea_records, read_mesh_dir
    coords, conn = read_mesh_dir(args.results_dir)
    fea_dir = os.path.join(args.results_dir, "fea_results")
    stress, active, force_disp = read_fea_records(fea_dir, conn.shape[0])
    n = _plot_fea(coords, conn, stress, active, force_disp, fea_dir)
    print(f"rendered {n} FEA frames")
    return n


def build_parser() -> argparse.ArgumentParser:
    from .config import GROWTH_PRESETS
    ap = argparse.ArgumentParser(
        prog="mycelium_tpu_torch.cli", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--distributed", action="store_true",
                    help="join the process group torchrun describes "
                         "(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, "
                         "LOCAL_RANK) before any tensor is made: NCCL on "
                         "cards, gloo with --device cpu; rank 0 writes the "
                         "files")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(g):
        g.add_argument("--device", choices=("cuda", "cpu"), default=None)
        g.add_argument("--csv-variant", choices=("python", "cpp"),
                       default="python")

    def grow_args(g, preset_flag):
        g.add_argument("--out", default="results")
        g.add_argument("--dir", default=None,
                       help="exact output dir (overrides --out/sim_<ts>)")
        g.add_argument("--steps", type=int, default=None)
        g.add_argument("--seed", type=int, default=None)
        g.add_argument("--capacity", type=int, default=None)
        g.add_argument(preset_flag, dest="growth_preset",
                       choices=sorted(GROWTH_PRESETS), default="demo",
                       help="growth preset")
        g.add_argument("--three-d", action="store_true",
                       help="grow the reference's 3D configuration")
        g.add_argument("--snapshots", choices=("none", "csv", "png"),
                       default="csv")
        g.add_argument("--checkpoint-every", type=int, default=0,
                       help="save growth_checkpoint.npz every K steps")
        g.add_argument("--resume", default=None, metavar="FILE",
                       help="resume growth from a growth checkpoint")
        g.add_argument("--no-summary-plot", action="store_true",
                       help="write no mycelium_growth_summary.png")
        g.add_argument("--verbose", action="store_true")

    def fea_args(g):
        g.add_argument("--fea-steps", type=int, default=None)
        g.add_argument("--grip", type=float, default=None)
        g.add_argument("--disp-max", type=float, default=None)
        g.add_argument("--f64", action="store_true")
        g.add_argument("--scan", action="store_true",
                       help="run the ramp with device-resident records, "
                            "fetched once at the end")
        g.add_argument("--preset", choices=("fast", "reference"),
                       default="fast",
                       help="solver preset: 'fast' = chain operator + tree "
                            "preconditioner with the coarse correction; "
                            "'reference' = FeaConfig defaults (ELL + "
                            "block-Jacobi)")
        g.add_argument("--sharded", type=int, nargs="?", const=-1,
                       default=None, metavar="N",
                       help="domain-decompose every solve over the ranks "
                            "of the process group (N: its size, checked)")
        g.add_argument("--fea-checkpoint-every", type=int, default=0,
                       help="save fea_checkpoint.npz every K ramp steps "
                            "(loop drivers)")
        g.add_argument("--fea-resume", default=None, metavar="FILE",
                       help="resume the ramp from a ramp checkpoint")
        g.add_argument("--trace", default=None, metavar="DIR",
                       help="write a torch.profiler Chrome trace of the "
                            "ramp into DIR")
        g.add_argument("--no-plots", action="store_true",
                       help="write no force_displacement.png and no "
                            "fea_step_NNN.png")

    g = sub.add_parser("grow", help="run the growth simulation")
    grow_args(g, "--preset")
    common(g)
    g.set_defaults(fn=cmd_grow)
    f = sub.add_parser("fea", help="pull-test ramp on a results dir")
    f.add_argument("results_dir")
    fea_args(f)
    f.add_argument("--verbose", action="store_true",
                   help="print each recorded step's displacement, force "
                        "and active elements")
    common(f)
    f.set_defaults(fn=cmd_fea)
    p = sub.add_parser("pipeline", help="grow, then fea on its output")
    grow_args(p, "--growth-preset")
    fea_args(p)
    common(p)
    p.set_defaults(fn=cmd_pipeline)
    w = sub.add_parser("sweep", help="solver x preconditioner timing sweep")
    w.add_argument("results_dir")
    w.add_argument("--trials", type=int, default=5)
    w.add_argument("--f64", action="store_true")
    w.add_argument("--verbose", action="store_true")
    w.add_argument("--device", choices=("cuda", "cpu"), default=None)
    w.set_defaults(fn=cmd_sweep)
    ps = sub.add_parser("plot-snapshots", help="render snapshot CSVs to PNG")
    ps.add_argument("results_dir")
    ps.set_defaults(fn=cmd_plot_snapshots)
    pf = sub.add_parser("plot-fea", help="render FEA records to PNG")
    pf.add_argument("results_dir")
    pf.set_defaults(fn=cmd_plot_fea)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _check_plots(args)
    if args.distributed:
        from .utils.dist import initialize_distributed
        initialize_distributed(device=_device(args))
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
