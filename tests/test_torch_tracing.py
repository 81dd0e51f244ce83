"""The program's spans and counters (``utils/profiling.py``: ``span``,
``count``, ``readings``) in a pull test: ``run_ramp_async`` on a CPU model
of a small synthetic network pulled far enough to fracture.

- With no profiler the registry stays empty, and the records are bit-equal
  with and without one.
- Under ``torch.profiler``: the refresh counts 1 plus the steps whose
  active set changed, its trips at least the refreshes and as many as
  their flag reads; a solve, a flag read and a record write a step; the
  counter of iterations sums the steps' iterations.
- Each span lies in the profiler's own events as often as the registry
  counts it (the host span ``fea.sync.stats`` in the registry alone), and
  no child's host time exceeds its parent's.
- ``device_ops`` leaves the spans out of a profiled solve's operations.
- ``utils.profiling.trace`` (the CLI's ``--trace``) writes the spans into
  its ``trace.json``."""

import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mycelium_tpu_torch.config import hybrid_fea_config
from mycelium_tpu_torch.fea import build_model, run_ramp_async
from mycelium_tpu_torch.fea.solve import solve_displacement
from mycelium_tpu_torch.meshes import synthetic_mesh
from mycelium_tpu_torch.utils import profiling
import tests.torch_support  # noqa: F401  (one torch thread a worker)

RECORDS = ("stress_record", "active_record", "disp_record", "force_disp",
           "cg_iters")
SYNC_EVERY = 4
HOST_SPANS = ("fea.sync.stats",)     # in the registry, not in the trace
# parent span -> its direct children, which do not overlap one another
CHILDREN = {
    "fea.ramp": ("fea.solve", "fea.post_solve", "fea.refresh",
                 "fea.records.fetch", "fea.sync.flag", "fea.sync.status"),
    # the CPU's post-solve writes the step's record rows
    "fea.post_solve": ("fea.records.write",),
    "fea.refresh": ("fea.refresh.trip",),
    "fea.refresh.trip": ("fea.sync.trip",),
    "fea.solve": ("fea.sync.stats",),
}


@pytest.fixture(scope="module")
def pull():
    """(configuration, untraced result, traced result, untraced readings,
    traced readings, profiler events by name) of one pull test to 0.06 mm
    in 10 steps."""
    coords, conn = synthetic_mesh(1500, seed=0)
    ext = float(coords[:, 1].max() - coords[:, 1].min())
    cfg = hybrid_fea_config(n_steps=10, displacement_max=0.06,
                            grip_length=0.3 * ext)
    model = build_model(coords, conn, cfg, "cpu")
    profiling.reset_readings()
    plain = run_ramp_async(coords, conn, cfg, model=model,
                           sync_every=SYNC_EVERY)
    untraced = profiling.readings()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = run_ramp_async(coords, conn, cfg, model=model,
                                sync_every=SYNC_EVERY)
    got = profiling.readings()
    profiling.reset_readings()
    events = Counter(e.name for e in prof.events()
                     if e.name.startswith("fea."))
    return cfg, plain, traced, untraced, got, events


def test_no_profiler_no_readings(pull):
    _, _, _, untraced, _, _ = pull
    assert untraced == {}
    with profiling.span("fea.x"):
        profiling.count("fea.y", 3)
    assert profiling.readings() == {}


def test_records_bit_equal_with_and_without_profiler(pull):
    _, plain, traced, _, _, _ = pull
    for f in RECORDS:
        np.testing.assert_array_equal(getattr(plain, f), getattr(traced, f))


def test_readings_count_the_pull_test(pull):
    cfg, _, res, _, got, _ = pull
    act = res.active_record
    steps = len(act)
    assert steps == cfg.n_steps and act[-1].any(), "pulled to full fracture"
    prev = np.vstack([np.ones((1, act.shape[1]), bool), act[:-1]])
    changed = int((act != prev).any(axis=1).sum())
    assert changed >= 1, "nothing fractured"
    assert got["fea.ramp"]["count"] == 1
    assert got["fea.refresh"]["count"] == 1 + changed
    trips = got["fea.refresh.trip"]["count"]
    assert trips >= got["fea.refresh"]["count"]
    assert trips == got["fea.sync.trip"]["count"]
    for name in ("fea.solve", "fea.post_solve", "fea.sync.flag",
                 "fea.records.write", "fea.sync.stats"):
        assert got[name]["count"] == steps, name
    assert got["fea.sync.status"]["count"] == -(-steps // SYNC_EVERY)
    assert got["fea.records.fetch"]["count"] == 1
    assert got["fea.cg_iters"] == int(res.cg_iters.sum())


def test_spans_lie_in_the_profiler_trace(pull):
    _, _, _, _, got, events = pull
    spans = {n: v["count"] for n, v in got.items()
             if isinstance(v, dict) and n not in HOST_SPANS}
    assert events == Counter(spans)
    assert all(got[n]["count"] for n in HOST_SPANS)


def test_device_ops_leave_out_the_spans():
    coords, conn = synthetic_mesh(600, seed=1)
    cfg = hybrid_fea_config()
    model = build_model(coords, conn, cfg, "cpu")
    active = torch.ones(model.n_elems, dtype=torch.bool)
    x0 = torch.zeros((model.n_nodes, 3), dtype=model.dtype)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solve_displacement(model, active, 0.01, -0.01, x0, cfg)
    profiling.reset_readings()
    cpu = torch.autograd.DeviceType.CPU
    assert "fea.solve" in {e.name for e in prof.events()}
    ops = profiling.device_ops(prof, cpu)
    assert ops and not [e.name for e in ops if e.name.startswith("fea.")]


@pytest.mark.parametrize("parent", sorted(CHILDREN))
def test_children_within_parent(pull, parent):
    got = pull[4]
    inner = sum(got[c]["host_s"] for c in CHILDREN[parent])
    assert 0 < inner <= got[parent]["host_s"]


def test_trace_writes_the_spans(tmp_path):
    coords, conn = synthetic_mesh(600, seed=1)
    ext = float(coords[:, 1].max() - coords[:, 1].min())
    cfg = hybrid_fea_config(n_steps=4, grip_length=0.3 * ext)
    model = build_model(coords, conn, cfg, "cpu")
    with profiling.trace(str(tmp_path)):
        run_ramp_async(coords, conn, cfg, model=model)
    profiling.reset_readings()
    text = (tmp_path / profiling.TRACE_FILE).read_text()
    names = {e.get("name") for e in json.loads(text)["traceEvents"]}
    assert {"fea.ramp", "fea.refresh", "fea.solve"} <= names
