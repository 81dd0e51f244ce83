"""Checkpoint and resume (port of ``mycelium_tpu/io/checkpoint.py``): plain
``np.savez_compressed`` files, written by the coordinator only
(``utils/dist.py``).

- growth: every array field of ``GrowthState`` under the JAX package's
  names (``grid`` is a cache and is not saved), the host counts
  ``n_seg``, ``n_hyp`` and ``step`` as 0-d int32 arrays, and, in place of the
  JAX package's ``key``, the draw source's state: the ``torch.Generator``
  state of its ``TorchDraws`` (``draw_state``, uint8) and its device type
  (``draw_device``). A CUDA generator cannot go on from a CPU state, so a
  file resumes on the device type that wrote it;
- the ramp: ``step``, ``active``, ``u_prev`` and the records as
  ``rec_stress``, ``rec_active``, ``rec_disp``, ``rec_fd``,
  ``rec_solve_secs``, ``rec_iters``, the JAX package's names, so a file
  written by either package resumes in the other.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..growth.draws import TorchDraws
from ..growth.state import GrowthState, ensure_grid
from ..utils.dist import is_coordinator

GROWTH_FIELDS = tuple(f.name for f in dataclasses.fields(GrowthState)
                      if f.name != "grid")
HOST_INTS = ("n_seg", "n_hyp", "step")


def _write(path: str, payload: dict) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **payload)
    return path


def save_growth_state(path: str, st: GrowthState,
                      draws: TorchDraws) -> str:
    """Save ``st`` and the state of its run's draw source (coordinator
    only)."""
    if not is_coordinator():
        return path
    payload = {k: np.asarray(getattr(st, k), np.int32) if k in HOST_INTS
               else getattr(st, k).cpu().numpy() for k in GROWTH_FIELDS}
    payload["draw_state"] = draws.gen.get_state().numpy()
    payload["draw_device"] = np.asarray(draws.device.type)
    return _write(path, payload)


def load_growth_state(path: str, cfg, device
                      ) -> Tuple[GrowthState, Optional[TorchDraws]]:
    """(state on ``device`` with an empty anastomosis grid, the draw
    source in its saved state). A file the JAX package wrote holds a PRNG
    key in place of a draw state: its draw source is None, and the caller
    passes one that replays that key."""
    data = np.load(path)
    missing = set(GROWTH_FIELDS) - set(data.files)
    if missing:
        raise ValueError(f"checkpoint missing fields: {sorted(missing)}")
    device = torch.device(device)
    vals = {k: int(data[k]) if k in HOST_INTS
            else torch.as_tensor(data[k], device=device)
            for k in GROWTH_FIELDS}
    st = ensure_grid(GrowthState(**vals), cfg)
    if "draw_state" not in data.files:
        return st, None
    saved = str(data["draw_device"])
    if saved != device.type:
        raise ValueError(f"{path}: its draw state is a {saved} generator's "
                         f"and cannot continue on {device.type}; resume on "
                         f"{saved}")
    draws = TorchDraws(0, device)
    draws.gen.set_state(torch.as_tensor(data["draw_state"]))
    return st, draws


def save_ramp_state(path: str, step: int, active, u_prev,
                    records: Optional[dict] = None) -> str:
    """Save the ramp's position (the next step), its active mask, the last
    displacement and the records so far (coordinator only); ``active`` and
    ``u_prev`` are host copies."""
    if not is_coordinator():
        return path
    payload = {"step": np.asarray(step), "active": np.asarray(active),
               "u_prev": np.asarray(u_prev)}
    for k, v in (records or {}).items():
        payload[f"rec_{k}"] = np.asarray(v)
    return _write(path, payload)


def load_ramp_state(path: str) -> Tuple[int, np.ndarray, np.ndarray, dict]:
    """(next step, active mask, last displacement, records by name)."""
    data = np.load(path)
    records = {k[4:]: data[k] for k in data.files if k.startswith("rec_")}
    return int(data["step"]), data["active"], data["u_prev"], records
