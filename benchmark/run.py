"""Run one cell of ``BENCHMARK.json`` once on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checked``: each
number the comparison with the reference read, beside its limit. The same
numbers are the last lines of standard error.

It measures ``mycelium_tpu_torch`` on the first card. Without a card, with
fewer cards than the cell asks for, or with the JAX package or JAX loaded
once the window has closed, it prints no result and exits with 2. The
kernels build into the program's own directory inside the checkout (the
first run of a checkout compiles them).
"""

import time

T0 = time.perf_counter()     # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# whole top-level module names the run must not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "mycelium_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return 2


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, ROOT)
    from benchmark.harness.cell import run_cell
    from benchmark.harness.spec import load_cell
    import torch
    chips = load_cell(ROOT, args.workload).chips
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark measures the card only")
    if torch.cuda.device_count() < chips:
        return fail(f"the cell asks for {chips} cards, "
                    f"{torch.cuda.device_count()} found")
    out = run_cell(ROOT, args.workload, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda", 0), T0)
    bad = forbidden_modules()
    if bad:
        return fail(f"the run loaded {bad}")
    for line in out.notes:
        print(line, file=sys.stderr)
    for name, value, limit, ok in out.checked:
        print(f"check {name} {value!r} limit {limit!r} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out.result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
