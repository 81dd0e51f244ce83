"""The two readings a cell's limits are set from, at the cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] \
        [--side control|program] [--drawn]

``--side control`` (the default) puts the reference in TF32
(``reference/pulltest.py``, ``precision="tf32"``) in the program's place:
it produces what the timed path produces (a pull test of each network, or
the sampled cold solves at displacements drawn from the seed), judged as
a run judges the program. It needs no card. The configuration states
float32, the program runs with TF32 off (PyTorch's default; K6 has no
tensor-core path) and has no lower-precision path of its own, so TF32 is
the nearest precision below (see the reference's docstring for what is
rounded).

``--side program`` runs the program on the card through the cell's own
kind (``benchmark/kinds/``): set-up, ``units`` units (two rounds of the
networks by default) and the comparison, with no window: the sound
readings.

``--drawn`` makes network i of n at seed seed·n + i, where the mix names
fixed networks (``mesh_seeds``), so that readings over many seeds cover
many networks.

For each seed it prints one JSON line: the numbers the comparison reads,
each beside the cell's limit. The benchmark's own runs run neither side.
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def drawn(cell):
    """The cell with its networks drawn from the seed."""
    return cell._replace(traffic={k: v for k, v in cell.traffic.items()
                                  if k != "mesh_seeds"})


def networks(cell, seed: int):
    from benchmark.harness.networks import (fea_fields, mesh_generator,
                                            network_seeds)
    from benchmark.reference import pulltest as ref
    mesh = dict(cell.config["mesh"])
    gen = mesh_generator(cell.root, mesh.pop("generator"))
    for s in network_seeds(cell.traffic, seed):
        coords, conn = gen(seed=s, **mesh)
        fields = fea_fields(cell.config, coords)
        yield coords, conn, ref.Physics.of(fields, fields["grip_length"])


def control(cell, seed: int) -> dict:
    from benchmark.reference import pulltest as ref
    t = cell.traffic
    if t["kind"] == "pull_test":
        dmax = float(t["displacement_max"])
        rng = np.random.default_rng([seed, 2])
        worst = {}
        for coords, conn, phys in networks(cell, seed):
            got = ref.ramp(ref.Mesh(coords, conn, phys, "tf32"), dmax)
            out = ref.check_ramp(ref.Mesh(coords, conn, phys), dmax, got,
                                 rng, int(t["check"]["extra_segments"]))
            for k, v in out.items():
                worst[k] = max(v, worst.get(k, v))
        return worst
    rng = np.random.default_rng([seed, 1])
    nets = list(networks(cell, seed))
    worst = 0.0
    for j, (coords, conn, phys) in enumerate(nets):
        act = np.ones(len(conn), bool)
        unit = ref.Mesh(coords, conn, phys).unit_pull(act)
        low = ref.Mesh(coords, conn, phys, "tf32").unit_pull(act)
        n = int(t["check"]["solves"]) // len(nets)
        for dy in t["dy_max"] * (1.0 - rng.random(n)):
            worst = max(worst, ref.solve_error(unit, dy, low * dy))
    return {"x_err": worst}


def program(cell, seed: int, units: int, device) -> dict:
    """The program's readings: the cell's kind as a run calls it, with
    ``units`` units in place of the window."""
    from benchmark.harness.spec import kind_module
    kind = kind_module(cell.root, cell.traffic["kind"])
    st = kind.setup(cell, seed, device, False)
    for i in range(units):
        kind.unit(st, i)
    kind.finish(st)
    return kind.check(st)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--side", choices=("control", "program"),
                    default="control")
    ap.add_argument("--drawn", action="store_true")
    ap.add_argument("--units", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.harness.spec import load_cell
    cell = load_cell(ROOT, args.workload)
    if args.drawn:
        cell = drawn(cell)
    for seed in args.seeds:
        if args.side == "control":
            got = control(cell, seed)
        else:
            import torch
            n = args.units or 2 * int(cell.traffic["networks"])
            got = program(cell, seed, n, torch.device("cuda", 0))
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "side": args.side, "drawn": args.drawn,
                          "numbers": got, "limits": cell.limits,
                          "fails": sorted(k for k, v in cell.limits.items()
                                          if got[k] > v)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
