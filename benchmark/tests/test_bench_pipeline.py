"""The pipeline cell on the CPU:

- the plain growth reference (``reference/growth.py``) against the port's
  ``growth_step`` in float64, step by step on a small dish whose run
  branches, fuses and hits the walls: every step judged at rounding;
- one run of the cell at a small growth (``conftest.SMALL_GROWTH``) through
  the harness, past its look for a card, reads correct;
- faults planted in the timed path each read not correct, by the number
  that must catch them: a growth step that returns its state unchanged,
  branching skipped and one anastomosis a step dropped (``growth_off``),
  half of a step's new segments given the mean substrate of the others
  (``growth_sub_err``), one exported node moved (``mesh_off``); the pull
  test's faults are ``test_bench_faults.py``'s;
- the byte count of K4's roofline by hand on a small state."""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import SMALL_GROWTH, run_small
from benchmark.kinds.pipeline import host_draws, host_state
from benchmark.metrics.anast_bytes import step_bytes
from benchmark.reference import growth as gref

CELL = "pipeline-demo"
DISH = dict(SMALL_GROWTH, dish_size=1.2, substrate_width=1.2, inoculum_nx=3,
            inoculum_ny=3, dist_inoculum=0.3, omega0=5e-6 * 9 / 25,
            t_steps=30)


def test_reference_step_equals_the_port_in_float64():
    from mycelium_tpu_torch.config import GrowthConfig
    from mycelium_tpu_torch.growth import step as gstep
    torch.set_num_threads(1)
    cfg = GrowthConfig(**dict(DISH, dtype="float64"))
    g = dataclasses.asdict(cfg)
    real = gstep.growth_step
    seen = {"branches": 0, "snaps": 0, "at_walls": 0}
    worst = {}

    def step(s, env, c, draws, *args, **kwargs):
        before = host_state(s)
        d = host_draws(draws, s.tip.shape[0])
        out = real(s, env, c, draws, *args, **kwargs)
        after = host_state(out)
        for k, v in gref.judge(before, d, after, g).items():
            worst[k] = max(v, worst.get(k, v))
        seen["branches"] += after.n_hyp - before.n_hyp
        seen["snaps"] += int(np.sum((after.state == gref.ANASTOMOSED)
                                    & (before.state != gref.ANASTOMOSED)))
        ends = after.end[after.state != gref.EMPTY]
        seen["at_walls"] += int(np.sum(np.abs(ends[:, :2]).max(axis=1)
                                       > cfg.dish_size / 2 - 1e-6))
        return out

    gstep.growth_step = step
    try:
        gstep.run_growth(cfg, seed=7, device="cpu")
    finally:
        gstep.growth_step = real
    assert min(seen.values()) > 0, seen
    assert worst["growth_pos_err"] < 1e-12
    assert worst["growth_sub_err"] < 1e-12
    assert worst["growth_env_err"] < 1e-12
    assert worst["growth_off"] == 0 and worst["growth_margin"] == 0


def test_pipeline_run_is_correct(small_root):
    out = run_small(small_root, CELL, seconds=1.0)
    res = out.result
    assert res["correct"], res
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"pipeline_s", "setup_s"}
    assert {"growth_pos_err", "growth_off", "mesh_off",
            "residual"} <= set(res["checked"])


def _unchanged_step(monkeypatch):
    """A growth step that returns its state unchanged."""
    from mycelium_tpu_torch.growth import step as gstep
    monkeypatch.setattr(gstep, "growth_step", lambda st, *args, **kwargs:
                        st.replace(step=st.step + 1))


def _half_the_tips(monkeypatch):
    """Half of a step's new segments left out: each takes the mean
    substrate of the other half's."""
    from mycelium_tpu_torch.growth import step as gstep
    real = gstep.grow

    def grow(st, *args, **kwargs):
        out = real(st, *args, **kwargs)
        a, n = st.n_seg, (out.n_seg - st.n_seg) // 2
        if n:
            sub = out.sub.clone()
            sub[a + n:out.n_seg] = sub[a:a + n].mean()
            out = out.replace(sub=sub)
        return out

    monkeypatch.setattr(gstep, "grow", grow)


def _skip_branching(monkeypatch):
    from mycelium_tpu_torch.growth import step as gstep
    real = gstep.grow

    def grow(st, cfg, draws, *args, **kwargs):
        return real(st, cfg, draws._replace(branch=torch.ones_like(
            draws.branch)), *args, **kwargs)

    monkeypatch.setattr(gstep, "grow", grow)


def _drop_anastomosis(monkeypatch):
    """The lowest hypha's snap of each step undone."""
    from mycelium_tpu_torch.growth import step as gstep
    real = gstep.detect_anastomosis

    def detect(st, cfg, *args, **kwargs):
        out = real(st, cfg, *args, **kwargs)
        t = st.tip.clamp(min=0).long()
        snapped = torch.nonzero((out.state[t] == gref.ANASTOMOSED)
                                & (st.state[t] != gref.ANASTOMOSED))
        if len(snapped):
            s = t[snapped[0, 0]]
            end, state = out.end.clone(), out.state.clone()
            end[s], state[s] = st.end[s], st.state[s]
            out = out.replace(end=end, state=state)
        return out

    monkeypatch.setattr(gstep, "detect_anastomosis", detect)


def _move_node(monkeypatch):
    from mycelium_tpu_torch.growth import export as gexp
    real = gexp.state_mesh

    def state_mesh(st):
        coords, conn = real(st)
        coords = coords.copy()
        coords[len(coords) // 2, 0] += 1e-3
        return coords, conn

    monkeypatch.setattr(gexp, "state_mesh", state_mesh)


FAULTS = {"step_unchanged": (_unchanged_step, "growth_off"),
          "half_the_tips": (_half_the_tips, "growth_sub_err"),
          "branching_skipped": (_skip_branching, "growth_off"),
          "anastomosis_dropped": (_drop_anastomosis, "growth_off"),
          "node_moved": (_move_node, "mesh_off")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_reads_not_correct(small_root, monkeypatch, fault):
    plant, number = FAULTS[fault]
    plant(monkeypatch)
    res = run_small(small_root, CELL, seconds=1.0).result
    assert res["correct"] is False, res
    got = res["checked"][number]
    assert got["value"] > got["limit"], res["checked"]


def test_anast_bytes_by_hand():
    g = {"dish_size": 1.0, "voxel_size": 0.1}
    start = np.array([[0.0, 0.0, 0], [0.02, 0.0, 0], [0.5, 0.5, 0],
                      [0.01, 0.01, 0]])
    end = np.array([[0.02, 0.0, 0], [0.04, 0.0, 0], [0.52, 0.5, 0],
                    [0.2, 0.2, 0]])
    state = np.array([2, 1, 1, 0])
    tip = np.array([1, 2, -1])
    # both tips active; the window of the tip at (0.04, 0) holds segments
    # 0 and 1, that of the tip at (0.52, 0.5) segment 2; slot 3 is empty
    assert step_bytes(start, end, state, tip, 3, 4, g, 4) \
        == 2 * (3 * 4 + 3 * 4) + 3 * 6 * 4
    assert step_bytes(start, end, np.array([2, 2, 2, 0]), tip, 3, 4, g,
                      4) == 0
