"""On the card: each cell's command runs to a correct result with its
metrics, untraced and traced (short windows). Skips without a card."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_on_the_card(cuda_device, cell, trace):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res
    assert res["device"]["platform"] == "gpu"
    group = SPEC["per_layer"] if trace else SPEC["end_to_end"]
    want = {m["name"] for m in group
            if "workloads" not in m or cell in m["workloads"]}
    assert set(res["metrics"]) == want
