"""A dry run of sharded growth and the sharded solve over n ranks (the
port's ``__graft_entry__.py::dryrun_multichip``):

    python -m mycelium_tpu_torch.dryrun N

spawns N ranks joined over a ``file://`` store in a temporary directory
(no port is opened): NCCL, one card a rank, where the machine has N cards,
gloo on the CPU otherwise.

- Growth: one step of the JAX dry run's configuration (64·N segment and
  32·N hypha slots, 2x2 inoculum sites of 2 hyphae, 8 segments a grid
  cell) with the segment slots split over the N ranks
  (``growth/shard.py``); rank 0 takes the same step on one device, and
  every field must be equal bit for bit.
- FEA: every rank solves ``meshes.synthetic_mesh(64)`` domain-decomposed
  over the N ranks, and rank 0 solves it again over a group of itself
  alone; the two must agree to a relative max error of 1e-3.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

TOLERANCE = 1e-3


def _rank(rank: int, n: int, store: str, device_type: str) -> None:
    import torch.distributed as dist

    from .config import FeaConfig
    from .fea import build_model
    from .fea.shard import sharded_cg_solver
    from .meshes import synthetic_mesh
    from .utils.dist import initialize_distributed

    torch.set_num_threads(1)
    device = initialize_distributed(
        f"file://{store}", n, rank,
        device=f"cuda:{rank}" if device_type == "cuda" else "cpu")
    try:
        _growth_half(rank, n, device)
        coords, conn = synthetic_mesh(64)
        cfg = FeaConfig(dtype="float32", rtol=1e-5, grip_length=0.1)
        model = build_model(coords, conn, cfg, device)
        active = torch.ones(model.n_elems, dtype=torch.bool, device=device)
        x0 = torch.zeros((model.n_nodes, 3), dtype=model.dtype,
                         device=device)
        res = sharded_cg_solver(model, cfg)(active, 0.01, -0.01, x0)
        if not res.converged:
            raise AssertionError(f"rank {rank}: the sharded CG did not "
                                 "converge")
        alone = dist.new_group([0])
        if rank == 0:
            res1 = sharded_cg_solver(model, cfg, alone)(active, 0.01,
                                                        -0.01, x0)
            if not res1.converged:
                raise AssertionError("the one-rank CG did not converge")
            xn, x1 = res.x.cpu().numpy(), res1.x.cpu().numpy()
            err = float(np.abs(xn - x1).max()) \
                / max(float(np.abs(x1).max()), 1e-30)
            if not err <= TOLERANCE:
                raise AssertionError(f"the {n}-rank solve is {err:.2e} off "
                                     "the one-rank solve")
            print(f"dryrun_multichip OK on {n} ranks "
                  f"({dist.get_backend()}): solve {res.iters} CG "
                  f"iterations, |r| = {res.resnorm:.2e}, {res1.iters} on "
                  f"one rank, relative max error {err:.2e}", flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _growth_half(rank: int, n: int, device) -> None:
    from .config import GrowthConfig
    from .growth import run_growth
    from .growth.shard import SlotBlocks, gathered, run_growth_sharded

    cfg = GrowthConfig(t_steps=1, max_segments=64 * n, max_hyphae=32 * n,
                       h0_per_point=2, inoculum_nx=2, inoculum_ny=2,
                       max_per_cell=8)
    st_l, _, _ = run_growth_sharded(cfg, device=device)
    st_n = gathered(st_l, SlotBlocks(cfg.max_segments))
    if rank == 0:
        st_1, _, _ = run_growth(cfg, device=device)
        if st_n.n_seg != st_1.n_seg or st_n.n_seg <= 8:
            raise AssertionError(f"the {n}-rank step made {st_n.n_seg} "
                                 f"segments, one device {st_1.n_seg}")
        for f in ("start", "end", "theta", "phi", "sub", "state", "prev",
                  "hypha", "tip", "env_e", "overflow"):
            if not torch.equal(getattr(st_n, f), getattr(st_1, f)):
                raise AssertionError(f"sharded growth field {f} differs "
                                     "from one device's")
        print(f"growth: one step on {n} ranks equals one device's in every "
              f"field ({st_n.n_seg} segments)", flush=True)


def dryrun_multichip(n: int) -> None:
    """Spawn ``n`` ranks and run the check (raises if a rank fails)."""
    device_type = "cuda" if torch.cuda.device_count() >= n else "cpu"
    store = os.path.join(tempfile.mkdtemp(prefix="myc_dryrun_"), "store")
    torch.multiprocessing.spawn(_rank, args=(n, store, device_type),
                                nprocs=n, join=True)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
