"""The two readings the pipeline cell's limits are set from, at the cell's
own size (the method of ``control.py``).

    python3 benchmark/pipeline_control.py --workload <cell> \
        --seeds <n> [<n> ...] [--drawn] [--units <k>]

For each seed, on the card: the cell's driver (``kinds/pipeline.py``) runs
its set-up, ``units`` pipelines (one a growth seed by default) and its
comparison with the reference, with no window: the program's (sound)
readings. Then the control on the same program states: the reference in
TF32 (``reference/growth.py``, ``precision="tf32"``; each product's
operands rounded, sums in float64) put in the program's place for each of
4 + 2 growth steps a judged seed (the first, the last and 4 drawn with the
seed), judged as a run judges the program; and the pull-test reference in
TF32 (``reference/pulltest.py``) on the program's grown network, judged by
``check_ramp``. The configuration states float32, the program runs with
TF32 off and has no lower-precision path of its own, so TF32 is the
nearest precision below. The control's export is the reference's dedup
(``mesh_off`` 0).

``--drawn`` grows seed·n + i for i < n in place of the mix's seeds, so
that readings over many seeds cover many networks.

One JSON line a seed: both sides' numbers, each beside the cell's limit.
The benchmark's own runs run neither side.
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control(st, seed: int) -> dict:
    """The control's numbers on the growth seeds the run judged."""
    from benchmark.kinds.pipeline import merge_worst, replay
    from benchmark.reference import growth as gref
    from benchmark.reference import pulltest as ref
    g = st.cell.config["growth"]
    t_steps = int(g["t_steps"])
    rng = np.random.default_rng([seed, 5])
    worst = {"mesh_off": 0}
    for j, gseed in enumerate(st.seeds):
        if not st.sample[j].items:
            continue
        steps = {0, t_steps - 1} | set(rng.choice(
            range(1, t_steps - 1), st.steps - 2, replace=False).tolist())
        taken, _, _ = replay(st, gseed, steps, False)
        for t in sorted(steps):
            before, draws, _ = taken[t]
            merge_worst(worst, gref.judge(
                before, draws, gref.step(before, draws, g, "tf32"), g))
        coords, conn, fields, _ = st.sample[j].items[0]
        phys = ref.Physics.of(fields, fields["grip_length"])
        low = ref.ramp(ref.Mesh(coords, conn, phys, "tf32"), st.dmax)
        merge_worst(worst, ref.check_ramp(ref.Mesh(coords, conn, phys),
                                          st.dmax, low, rng, st.extra))
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--drawn", action="store_true")
    ap.add_argument("--units", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from benchmark.harness.spec import kind_module, load_cell
    cell = load_cell(ROOT, args.workload)
    kind = kind_module(ROOT, cell.traffic["kind"])
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        c = cell
        if args.drawn:
            n = len(cell.traffic["growth_seeds"])
            c = cell._replace(traffic=dict(cell.traffic, growth_seeds=[
                seed * n + i for i in range(n)]))
        st = kind.setup(c, seed, device, False)
        for i in range(args.units or len(st.seeds)):
            kind.unit(st, i)
        kind.finish(st)
        sides = {"program": kind.check(st), "control": control(st, seed)}
        print(json.dumps({
            "workload": c.name, "seed": seed, "drawn": args.drawn,
            "growth_seeds": st.seeds, "limits": c.limits,
            **{side: {k: float(v) for k, v in got.items()}
               for side, got in sides.items()},
            "fails": {side: sorted(k for k, v in c.limits.items()
                                   if got[k] > v)
                      for side, got in sides.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
