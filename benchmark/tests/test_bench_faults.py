"""Whole runs of each cell on the CPU at 1,500 nodes, past the harness's
look for a card: a sound run reads correct, and a run whose timed path is
broken underneath reads not correct, once for each fault the cell can
have:

- ``unchanged``: a solve that returns its state unchanged (x = x0);
- ``half``: half of a batch left out and the mean taken over the rest: a
  solve's second half of nodes given the mean displacement of the first;
- ``altered``: an answer altered where it is produced: the node of the
  largest displacement moved by that displacement again.

No cell spans chips, so none has an exchange between chips to leave out.
"""

import dataclasses
import json
import os

import pytest
import torch

from conftest import ROOT, run_small

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
KIND = {}
for _w in SPEC["workloads"]:
    _t = json.load(open(os.path.join(ROOT, "benchmark", "traffic",
                                     _w["traffic"] + ".json")))
    KIND[_w["name"]] = _t["kind"]
CASES = [(c, f) for c in KIND for f in ("unchanged", "half", "altered")]


def _unchanged(x, x0):
    return x0.clone()


def _half(x, x0):
    x = x.clone()
    n = x.shape[0] // 2
    x[n:] = x[:n].mean(dim=0)
    return x


def _altered(x, x0):
    x = x.clone()
    i = int(x.abs().amax(dim=1).argmax())
    x[i] *= 2
    return x


def _break(monkeypatch, fault: str) -> None:
    """The program's solve, as the ramp and the cold driver call it, with
    its answer broken by ``fault``."""
    from mycelium_tpu_torch.fea import ramp, solve
    real_solve = solve.solve_displacement
    change = {"unchanged": _unchanged, "half": _half,
              "altered": _altered}[fault]

    def broken(model, active, dy_top, dy_bot, x0, cfg, anchored=None,
               **kw):
        res = real_solve(model, active, dy_top, dy_bot, x0, cfg, anchored,
                         **kw)
        return dataclasses.replace(res, x=change(res.x, x0))

    monkeypatch.setattr(ramp, "solve_displacement", broken)
    monkeypatch.setattr(solve, "solve_displacement", broken)


@pytest.mark.parametrize("cell", sorted(KIND))
def test_sound_run_is_correct(small_root, cell):
    out = run_small(small_root, cell).result
    assert out["correct"], out
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checked"


@pytest.mark.parametrize("cell,fault", CASES)
def test_broken_timed_path_reads_not_correct(small_root, monkeypatch, cell,
                                             fault):
    torch.manual_seed(0)
    _break(monkeypatch, fault)
    out = run_small(small_root, cell).result
    assert out["correct"] is False, out
