"""``utils/profiling.py``: ``trace`` writes one Chrome trace with events
(on the CPU here; the card test in test_torch_kernels.py holds the CLI's
trace to naming a kernel), and ``StepTimer`` writes the JAX package's
``solve_runtime.txt`` byte for byte."""

import filecmp
import json

import torch

from mycelium_tpu.utils.profiling import StepTimer as JStepTimer
from mycelium_tpu_torch.utils.profiling import TRACE_FILE, StepTimer, trace


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "t")) as d:
        assert d == str(tmp_path / "t")
        (torch.arange(1000.0) * 2).sum()
    events = json.loads((tmp_path / "t" / TRACE_FILE).read_text())
    names = {e.get("name", "") for e in events["traceEvents"]}
    assert any("aten::" in n for n in names), sorted(names)[:10]


def test_step_timer_writes_the_jax_contract(tmp_path):
    ours, ref = StepTimer(), JStepTimer()
    for _ in range(3):
        with ours.step():
            pass
    ref.seconds = list(ours.seconds)
    assert len(ours.seconds) == 3 and min(ours.seconds) >= 0.0
    ours.write(str(tmp_path / "port" / "solve_runtime.txt"))
    ref.write(str(tmp_path / "jax"))
    assert filecmp.cmp(tmp_path / "port" / "solve_runtime.txt",
                       tmp_path / "jax" / "solve_runtime.txt",
                       shallow=False)
