"""The least bytes one anastomosis scan (K4's work) must move, whatever
implements it, from the state it scans: each active tip's end read once
and its answer (squared distance, parameter, segment id: three words)
written once, and each candidate segment read once (its start and end).
The candidates are the live segments whose midpoint lies in a cell of an
active tip's window: the 2x2 grid columns around the grid corner nearest
the tip, cells of ``voxel_size``, a face of ceil(dish/voxel) + 4 cells with
positions outside it clipped to its border (the growth configuration's
layout). A segment in several tips' windows counts once; what a kernel
reads again does not count."""

import numpy as np

ACTIVE, EMPTY = 1, 0


def _face(g: dict) -> int:
    return int(np.ceil(g["dish_size"] / g["voxel_size"])) + 4


def _column(p, g: dict, corner: bool):
    """Clipped grid column of each (n, 3) position: its own cell, or the
    cell whose lower corner lies nearest."""
    n = _face(g)
    c = np.floor(np.asarray(p, np.float64)[:, :2] / g["voxel_size"]
                 + (0.5 if corner else 0.0)).astype(np.int64)
    c = np.clip(c + n // 2, 0, n - 1)
    return c[:, 0], c[:, 1]


def step_bytes(start, end, state, tip, n_hyp: int, n_seg: int, g: dict,
               float_bytes: int) -> int:
    """The bytes of one scan of a 2D state (``start``/``end`` (N, 3),
    ``state`` (N,), ``tip`` (H,))."""
    tip = np.asarray(tip)[:n_hyp]
    tip = tip[tip >= 0]
    tip = tip[np.asarray(state)[tip] == ACTIVE]
    if not len(tip):
        return 0
    n = _face(g)
    tx, ty = _column(np.asarray(end)[tip], g, corner=True)
    window = np.zeros((n, n), bool)
    for dx in (-1, 0):
        for dy in (-1, 0):
            x, y = tx + dx, ty + dy
            ok = (x >= 0) & (y >= 0)
            window[x[ok], y[ok]] = True
    live = np.nonzero(np.asarray(state)[:n_seg] != EMPTY)[0]
    mid = (np.asarray(start, np.float64)[live]
           + np.asarray(end, np.float64)[live]) * 0.5
    sx, sy = _column(mid, g, corner=False)
    candidates = int(window[sx, sy].sum())
    return len(tip) * (3 * float_bytes + 3 * 4) \
        + candidates * 6 * float_bytes
