"""Anastomosis detection (port of ``mycelium_tpu/growth/neighbors.py``).

An active tip whose endpoint comes within ``anastomosis_tol`` of another
segment snaps to the closest point of the nearest such segment and
becomes 'S' (reference C9, src/mycelium_sim_2D.py:507-542). Candidates are
found through a dense cell grid over the dish: M = g·g·gz cells, cell
(cx·g + cy)·gz + cz (gz = 1 in 2D).

The port runs one layout for every configuration, the JAX package's
``grid_incremental`` one (the JAX package's tests hold it bit-equal to its
full per-step rebucket):

- finalized segments (a hypha has extended past them; their geometry never
  changes again) live in the persistent append-only ``SegGrid``, stored
  cell-major: entry k of cell m at m·C + k, holding what the distance scan
  reads (start a, direction ab = end - start, 1/|ab|^2);
- the mutable tip segments form a per-step overlay, bucketed over the H
  hypha rows by midpoint cell (cell-sorted slot ids with per-cell offsets;
  their geometry is read by slot from the state);
- each active tip is bucketed by a cell of the tip table, and a tip scans
  a window of xy columns around it, each column's whole z extent (the
  JAX package folds z into the candidate axis). Where the reach
  (h0 + tol)/2 + tol of a tip is at most voxel/2, the tip's cell is its
  nearest grid corner in xy (its own z cell) and the window the 2x2
  columns around that corner (``window`` 4); otherwise the tip's own cell
  and the 3x3 columns around it (``window`` 9);
- K4 (``kernels/anast.py``) scans, per tip, those columns x 2 sources.

The JAX package's per-step rebucket and its TPU knobs (``anast_kernel``,
``MYC_ANAST_KERNEL``) are layout choices for the TPU and are not read.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import GrowthConfig
from ..kernels.anast import anast_scan
from .ops import scatter_drop
from .state import ACTIVE, ANASTOMOSED, GrowthState, const, fma, sqrt

EPS_LEN = 1e-12


def grid_dims(cfg: GrowthConfig):
    """Static grid extents (g, gz): the dish plus a margin for tips that
    leak through a wall; out-of-range coordinates clip into the border
    cells."""
    g = int(np.ceil(cfg.dish_size / cfg.voxel_size)) + 4
    if cfg.three_d:
        gz = int(np.ceil((cfg.height + 2 * cfg.wall_thickness)
                         / cfg.voxel_size)) + 3
    else:
        gz = 1
    return g, gz


class Layout(NamedTuple):
    """The grid of a configuration: face width g, z cells gz, and the
    tip window (4: the 2x2 columns around the tip's nearest corner; 9:
    the 3x3 columns around its own cell)."""
    g: int
    gz: int
    window: int


def check_layout(cfg: GrowthConfig) -> Layout:
    """The layout of a configuration: the corner window where a tip's
    reach (h0 + tol)/2 + tol is at most voxel/2 (JAX neighbors.py:
    462-464), else the 9-cell window."""
    reach = (cfg.h0 + cfg.anastomosis_tol) * 0.5 + cfg.anastomosis_tol
    g, gz = grid_dims(cfg)
    return Layout(g, gz, 4 if reach <= cfg.voxel_size * 0.5 else 9)


def cell_coords(p, cfg: GrowthConfig):
    """(..., 3) positions -> clipped integer cell coords (cx, cy, cz)."""
    g, gz = grid_dims(cfg)
    c = torch.floor(p / cfg.voxel_size).to(torch.int32)
    cx = torch.clamp(c[..., 0] + g // 2, 0, g - 1)
    cy = torch.clamp(c[..., 1] + g // 2, 0, g - 1)
    cz = torch.clamp(c[..., 2] + gz // 2, 0, gz - 1)
    return cx, cy, cz


def cell_id(p, cfg: GrowthConfig):
    g, gz = grid_dims(cfg)
    cx, cy, cz = cell_coords(p, cfg)
    return (cx * g + cy) * gz + cz


def corner_cell(p, cfg: GrowthConfig):
    """The cell of the corner window: in xy the cell whose lower corner is
    nearest to p (the tip's 2x2 window is this column and its (-1, -1),
    (-1, 0), (0, -1) neighbours), in z p's own cell (JAX neighbors.py:
    465-470)."""
    g, gz = grid_dims(cfg)
    c = torch.floor(p / cfg.voxel_size + 0.5).to(torch.int32)
    cx = torch.clamp(c[..., 0] + g // 2, 0, g - 1)
    cy = torch.clamp(c[..., 1] + g // 2, 0, g - 1)
    cz = cell_coords(p, cfg)[2]
    return (cx * g + cy) * gz + cz


class Buckets(NamedTuple):
    order: torch.Tensor    # (n,) stable sort of the items by cell
    start: torch.Tensor    # (n_cells,) int32 first sorted position per cell
    count: torch.Tensor    # (n_cells,) int32 items per cell, capped at cap
    rank: torch.Tensor     # (n,) int64 each item's rank within its cell
    dropped: torch.Tensor  # () bool: some cell held more than cap items


def _bucket(cell, n_cells: int, cap: int) -> Buckets:
    """Bucket items by cell (``n_cells`` for items that take no part), in
    a stable sort: items of one cell keep their input order, as
    ``jnp.argsort`` keeps them in the JAX package's ``_bucket``. Items of
    rank >= cap are absent from the buckets and flagged."""
    key = cell.long()
    order = torch.argsort(key, stable=True)
    # counted by index_add_, not bincount: bincount sizes its output from
    # the data and so waits for the device
    cnt = torch.zeros(n_cells + 1, dtype=torch.int64,
                      device=key.device).index_add_(0, key,
                                                    torch.ones_like(key))
    start = torch.cumsum(cnt, 0) - cnt
    rank = torch.empty_like(key)
    rank[order] = torch.arange(key.shape[0], device=key.device) \
        - start[key[order]]
    cnt = cnt[:n_cells]
    return Buckets(order=order, start=start[:n_cells].to(torch.int32),
                   count=cnt.clamp(max=cap).to(torch.int32), rank=rank,
                   dropped=(cnt > cap).any())


class SegGrid(NamedTuple):
    """Persistent append-only candidate grid of finalized segments,
    cell-major: entry k of cell m at m·C + k (C = max_per_cell)."""
    ids: torch.Tensor    # (M·C,) int32 segment slots; sentinel N
    geo: torch.Tensor    # (M·C, 8) a (3), ab (3), 1/|ab|^2 (0 if
                         # degenerate), 0 (pads a row to 32 bytes)
    count: torch.Tensor  # (M,) int32 per-cell occupancy (<= C)
    n_seen: int          # slots already scanned for finalization


def empty_grid(cfg: GrowthConfig, capacity: int, dtype, device) -> SegGrid:
    g, gz = grid_dims(cfg)
    M, C = g * g * gz, cfg.max_per_cell
    return SegGrid(
        ids=torch.full((M * C,), capacity, dtype=torch.int32, device=device),
        geo=torch.zeros((M * C, 8), dtype=dtype, device=device),
        count=torch.zeros((M,), dtype=torch.int32, device=device),
        n_seen=0)


def inverse_sq_length(ab):
    """1/|ab|^2 of (..., 3) directions, 0 below 1e-12: the squares summed
    left to right, contracted as XLA's CPU backend contracts them."""
    ab2 = fma(ab[..., 2], ab[..., 2], fma(ab[..., 0], ab[..., 0],
                                          ab[..., 1] * ab[..., 1]))
    eps = const(EPS_LEN, ab)
    return torch.where(ab2 < eps, torch.zeros_like(ab2),
                       1.0 / torch.maximum(ab2, eps))


def grid_insert_finalized(grid: SegGrid, st: GrowthState,
                          cfg: GrowthConfig):
    """Insert every segment finalized since the grid last looked.

    The extension window [n_seen, n_seg) of ``st.prev`` is exactly the set
    of parents finalized since then (branch children carry prev = -1; a
    hypha extends at most once per step). Batches of
    ``cfg.grid_update_cap`` rows; a fresh grid over a carried-across state
    inserts its whole backlog the same way. Within a cell, new entries
    take ranks after the cell's standing count, in slot order of the
    window. Returns (grid', dropped) with ``dropped`` flagging per-cell
    capacity overflow."""
    N = st.capacity
    g, gz = grid_dims(cfg)
    M, C = g * g * gz, cfg.max_per_cell
    U = int(cfg.grid_update_cap)
    dev = st.device
    ids, geo, count = grid.ids, grid.geo, grid.count
    dropped = torch.zeros((), dtype=torch.bool, device=dev)
    sgeo = torch.cat([torch.cat([st.start, st.end], dim=1),
                      st.start.new_zeros((1, 6))])
    for base in range(grid.n_seen, st.n_seg, U):   # host bounds: no sync
        rows = st.prev[base:min(base + U, st.n_seg)].long()
        valid = rows >= 0
        slot = torch.where(valid, rows, torch.full_like(rows, N))
        gs = sgeo[slot]
        mid = (gs[:, 0:3] + gs[:, 3:6]) * 0.5
        key = torch.where(valid, cell_id(mid, cfg).long(),
                          torch.full_like(rows, M))
        rank = count.long()[key.clamp(max=M - 1)] + _bucket(key, M, C).rank
        ok = valid & (rank < C)
        dropped = dropped | (valid & (rank >= C)).any()
        tgt = torch.where(ok, key * C + rank, torch.full_like(rank, M * C))
        ab = gs[:, 3:6] - gs[:, 0:3]
        vals = torch.cat([gs[:, 0:3], ab, inverse_sq_length(ab)[:, None],
                          torch.zeros_like(ab[:, :1])], dim=1)
        ids = scatter_drop(ids, tgt, slot.to(torch.int32))
        geo = scatter_drop(geo, tgt, vals)
        count = count.index_add(0, torch.where(ok, key, 0 * key),
                                ok.to(torch.int32))
    return SegGrid(ids=ids, geo=geo, count=count,
                   n_seen=max(grid.n_seen, st.n_seg)), dropped


class TipTables(NamedTuple):
    """The per-step tables of the anastomosis query (``tip_tables``)."""
    ov_slot: torch.Tensor    # (H,) int32 tip-segment slots sorted by cell
    ov_start: torch.Tensor   # (M,) int32 each cell's first overlay entry
    ov_count: torch.Tensor   # (M,) int32
    scan_cell: torch.Tensor  # (H,) int32 the tip's cell in the table, -1
    tips: tuple              # the tip table by cell: (order (H,),
                             # start (M,), count (M,)) int32 and the most
                             # tips a cell (max_tips_per_cell), what K4
                             # reads
    dropped: torch.Tensor    # () bool: a cell's capacity overflowed


def tip_tables(st: GrowthState, cfg: GrowthConfig) -> TipTables:
    """Per step, over the H hypha rows: the tip-segment overlay (slot ids
    sorted by midpoint cell with per-cell offsets and counts), each active
    tip's cell in the tip table (its corner cell for the corner window,
    its own cell for the 9-cell window; -1 for a hypha that is not in it:
    no active tip, or rank >= max_tips_per_cell in its cell), and that
    table bucketed by cell."""
    H = st.tip.shape[0]
    g, gz, window = check_layout(cfg)
    M = g * g * gz
    dev = st.device
    t = st.tip.clamp(min=0).long()
    seg_ok = (torch.arange(H, device=dev) < st.n_hyp) & (st.tip >= 0)
    tip_ok = seg_ok & (st.state[t] == ACTIVE)
    tip_start, tip_end = st.start[t], st.end[t]
    never = torch.full((H,), M, dtype=torch.int64, device=dev)
    ov = _bucket(torch.where(seg_ok, cell_id((tip_start + tip_end) * 0.5,
                                             cfg).long(), never),
                 M, cfg.max_per_cell)
    bucket = corner_cell if window == 4 else cell_id
    tip_cell = torch.where(tip_ok, bucket(tip_end, cfg).long(), never)
    tb = _bucket(tip_cell, M, cfg.max_tips_per_cell)
    in_tbl = (tip_cell < M) & (tb.rank < cfg.max_tips_per_cell)
    scan_cell = torch.where(in_tbl, tip_cell, torch.full_like(tip_cell, -1))
    return TipTables(
        ov_slot=t[ov.order].to(torch.int32), ov_start=ov.start,
        ov_count=ov.count, scan_cell=scan_cell.to(torch.int32),
        tips=(tb.order.to(torch.int32), tb.start, tb.count,
              cfg.max_tips_per_cell),
        dropped=ov.dropped | tb.dropped)


def detect_anastomosis(st: GrowthState, cfg: GrowthConfig, scan=anast_scan,
                       out: GrowthState | None = None,
                       put=scatter_drop) -> GrowthState:
    """Snap active tips onto nearby segments: insert the newly finalized
    segments into the persistent grid, build the per-step tables, run the
    distance scan (K4; ``scan`` swaps in K4's plain version for the
    kernel-against-plain trajectory checks only), then snap every tip
    whose nearest candidate lies within tolerance to that candidate's
    closest point. Cell-capacity overflow (dropped candidates) raises the
    state's overflow flag. ``st`` is what is read; the snaps go into
    ``out``'s slot arrays (default ``st``'s) through ``put``, as in
    ``ops.grow``."""
    g, gz, window = check_layout(cfg)
    N = st.capacity
    grid, ins_dropped = grid_insert_finalized(st.grid, st, cfg)
    tb = tip_tables(st, cfg)
    scan_cell = tb.scan_cell
    d2, tt, wid = scan(st.tip, scan_cell, st.start, st.end, grid.ids,
                       grid.geo, grid.count, cfg.max_per_cell, tb.ov_slot,
                       tb.ov_start, tb.ov_count, g, N, tb.tips, gz, window)

    # the winner's closest point, recomputed per hypha from its slot
    w = wid.long().clamp(max=N)
    a = torch.cat([st.start, st.start.new_zeros((1, 3))])[w]
    b = torch.cat([st.end, st.end.new_zeros((1, 3))])[w]
    proj = fma(tt[:, None], b - a, a)
    tol = const(cfg.anastomosis_tol, d2)
    snap = (scan_cell >= 0) & (sqrt(d2) <= tol)
    idx = torch.where(snap, st.tip.long(), torch.full_like(w, N))
    out = st if out is None else out
    return out.replace(
        end=put(out.end, idx, proj),
        state=put(out.state, idx, torch.full_like(idx, ANASTOMOSED)),
        grid=grid,
        overflow=st.overflow | ins_dropped | tb.dropped)
