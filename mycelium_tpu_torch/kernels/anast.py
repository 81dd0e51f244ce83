"""K4: the anastomosis distance scan (CUDA kernel + plain PyTorch version).

Replaces ``mycelium_tpu/growth/pallas_anast.py::_scan_kernel`` and, for
the layouts that kernel does not take (gz > 1, the 9-cell window), the
JAX package's XLA scan. The source note in ``csrc/anast_scan.cu`` says
what bounds it and how.

The grid has M = g·g·gz cells, cell m = (cx·g + cy)·gz + cz. For each
hypha h with ``tip_cell[h] >= 0`` (its active tip is in the tip table,
in cell m), with p the tip's end ``end[tip_slot[h]]``: visit the xy
columns (cx+dx, cy+dy) of the window in order, for ``window`` 4 the
offsets ``OFFS`` (m's xy is then the tip's nearest corner), for 9 the
offsets ``OFFS9`` (m's xy is the tip's own cell), columns outside the
face holding nothing; in each column first the persistent grid's
entries, then the tip overlay's; within a source the candidates of the
column's gz cells in the position order rank·gz + cz (the JAX package's
slot-major planes, neighbors.py:450-459). Skip a candidate whose id is
the tip's own slot or >= N; keep the candidate with the strictly
smallest squared distance in that visiting order

    ap = p - a;  tt = clip((ap·ab)·r, 0, 1);  e = ap - tt·ab;  d² = e·e

(r = 1/|ab|², 0 for a degenerate segment). Returns (d², tt, id) per hypha:
(inf, 0, N) for a hypha outside the table or without a candidate. The
grid's (a, ab, r) are stored per entry; an overlay candidate's are
computed from ``start``/``end`` by slot. The kernel works by cell: it
takes the tip table bucketed by cell (``tips``: the hyphae sorted by
cell, each cell's first position and count, and the most tips a cell),
which the plain version does not read.

The nesting (offsets outermost, then source, then position) and the
arithmetic are the JAX package's XLA scan (neighbors.py:585-620), and the
products and sums are fused where XLA's CPU backend fuses them: ap·ab and
e·e as fma(x2, y2, fma(x0, y0, x1·y1)), e as fma(-tt, ab, ap). The kernel
writes those fused multiply-adds out (``__fmaf_rn``, with no other
contraction) and the plain version computes them exactly (``_fma``), so
the two agree bit for bit, and with the Pallas kernel in interpret mode
(2D, corner window). The Pallas kernel rolls its windows into a sentinel
halo: the same zeros outside the face as here; the XLA path's
``jnp.roll`` wraps around instead, which differs only for a tip in the
first or last row or column of the face.
"""

from __future__ import annotations

import torch

from . import build

OFFS = ((-1, -1), (-1, 0), (0, -1), (0, 0))
OFFS9 = tuple((dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1))


def window_offsets(window: int):
    """The xy offsets of a tip's window, in visiting order."""
    if window not in (4, 9):
        raise ValueError(f"anast_scan: window must be 4 or 9, got {window}")
    return OFFS if window == 4 else OFFS9
_ROWS_PER_CHUNK = 1 << 22     # bound on (rows x candidates) per plain pass


def _fma(a, b, c):
    """a·b + c rounded once. float32: the product is exact in float64, the
    sum is rounded to odd in float64 (TwoSum error, then the odd
    neighbour) and then to float32, which makes the second rounding exact
    (Boldo and Melquiond, 2008) on any device. float64: ``addcmul``, a
    fused multiply-add on the CPU."""
    if a.dtype != torch.float32:
        return torch.addcmul(c, a, b)
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    inf = torch.full_like(s, float("inf"))
    s = torch.where((err != 0) & even,
                    torch.nextafter(s, torch.where(err > 0, inf, -inf)), s)
    return s.float()


def _dist(p, a, ab, r):
    """(d², tt) of points p against segments (a, ab, r); (..., 3) each."""
    ap = p - a
    apab = _fma(ap[..., 2], ab[..., 2], _fma(ap[..., 0], ab[..., 0],
                                             ap[..., 1] * ab[..., 1]))
    tt = torch.clamp(apab * r, 0.0, 1.0)
    e = _fma(-tt[..., None], ab, ap)
    d2 = _fma(e[..., 2], e[..., 2], _fma(e[..., 0], e[..., 0],
                                         e[..., 1] * e[..., 1]))
    return d2, tt


def _inv_sq_length(ab):
    ab2 = _fma(ab[..., 2], ab[..., 2], _fma(ab[..., 0], ab[..., 0],
                                            ab[..., 1] * ab[..., 1]))
    eps = torch.as_tensor(1e-12, dtype=ab.dtype, device=ab.device)
    return torch.where(ab2 < eps, torch.zeros_like(ab2),
                       1.0 / torch.maximum(ab2, eps))


def anast_scan_plain(tip_slot, tip_cell, start, end, grid_ids, grid_geo,
                     grid_count, cap: int, ov_slot, ov_start, ov_count,
                     g: int, n_slots: int, tips=None, gz: int = 1,
                     window: int = 4):
    """The plain PyTorch version, any device: per (offset, source), all
    of a column's candidates at once in position order; the first
    smallest within the pass, then a strict-< merge in visiting order (the
    sequential scan's answer). ``tips`` is not read."""
    H = tip_slot.shape[0]
    dev, dtype = start.device, start.dtype
    N = n_slots
    d2_out = torch.full((H,), float("inf"), dtype=dtype, device=dev)
    tt_out = torch.zeros((H,), dtype=dtype, device=dev)
    id_out = torch.full((H,), N, dtype=torch.int32, device=dev)
    rows = torch.nonzero(tip_cell >= 0).flatten()
    if rows.numel() == 0:
        return d2_out, tt_out, id_out
    offs = window_offsets(window)
    start_p = torch.cat([start, start.new_zeros((1, 3))])
    end_p = torch.cat([end, end.new_zeros((1, 3))])
    n_ov = ov_slot.shape[0]
    ov_slot_p = torch.cat([ov_slot, ov_slot.new_full((1,), N)])
    # per xy column, its gz cells' counts and first entries
    col_grid = grid_count.long().reshape(g * g, gz)
    col_ov = ov_count.long().reshape(g * g, gz)
    col_ov_start = ov_start.long().reshape(g * g, gz)
    kmax = int(max(int(grid_count.max()), int(ov_count.max()), 1))
    step = max(1, _ROWS_PER_CHUNK // (kmax * gz))
    for r0 in range(0, rows.numel(), step):
        h = rows[r0:r0 + step]
        slot = tip_slot[h].long()
        col = tip_cell[h].long() // gz
        p = end[slot]
        cx, cy = col // g, col % g
        best = torch.full((h.numel(),), float("inf"), dtype=dtype,
                          device=dev)
        btt = torch.zeros_like(best)
        bid = torch.full((h.numel(),), N, dtype=torch.int64, device=dev)
        for dx, dy in offs:
            x, y = cx + dx, cy + dy
            inb = (x >= 0) & (y >= 0) & (x < g) & (y < g)
            c = torch.where(inb, x * g + y, 0 * x)
            for src in ("grid", "overlay"):
                n = (col_grid if src == "grid" else col_ov)[c]   # (h, gz)
                n = torch.where(inb[:, None], n, 0 * n)
                K = int(n.max())
                if K == 0:
                    continue
                # position k = rank·gz + cz
                k = torch.arange(K * gz, device=dev)
                rank, cz = k // gz, k % gz
                valid = rank[None, :] < n[:, cz]
                cell = c[:, None] * gz + cz[None, :]
                if src == "grid":
                    e = cell * cap + rank[None, :]
                    e = torch.where(valid, e, 0 * e)
                    cid = grid_ids[e].long()
                    geo = grid_geo[e]
                    a, ab, r = geo[..., 0:3], geo[..., 3:6], geo[..., 6]
                else:
                    e = (col_ov_start[c][:, cz] + rank[None, :]) \
                        .clamp(max=n_ov)
                    e = torch.where(valid, e, torch.full_like(e, n_ov))
                    cid = ov_slot_p[e].long()
                    cs = cid.clamp(max=N)
                    a = start_p[cs]
                    ab = end_p[cs] - a
                    r = _inv_sq_length(ab)
                d2, tt = _dist(p[:, None, :], a, ab, r)
                use = valid & (cid != slot[:, None]) & (cid < N)
                d2 = torch.where(use, d2, torch.full_like(d2, float("inf")))
                dmin = d2.amin(dim=1)
                first = torch.argmax((d2 == dmin[:, None]).to(torch.uint8),
                                     dim=1)[:, None]
                better = dmin < best
                best = torch.where(better, dmin, best)
                btt = torch.where(better, tt.gather(1, first)[:, 0], btt)
                bid = torch.where(better, cid.gather(1, first)[:, 0], bid)
        d2_out[h] = best
        tt_out[h] = btt
        id_out[h] = bid.to(torch.int32)
    return d2_out, tt_out, id_out


def _check(name, t, shape, dtype):
    if t.device.type != "cuda" or t.dtype != dtype or \
            tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"anast_scan: {name} must be a contiguous {dtype} CUDA tensor "
            f"of shape {tuple(shape)}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def anast_scan(tip_slot, tip_cell, start, end, grid_ids, grid_geo,
               grid_count, cap: int, ov_slot, ov_start, ov_count, g: int,
               n_slots: int, tips=None, gz: int = 1, window: int = 4):
    """The scan: the CUDA kernel for CUDA tensors (float32 only, raises
    otherwise; ``tips`` = (order (H,), start (M,), count (M,)) int32, the
    tip table by cell, and the most tips it holds a cell, any number
    (``neighbors.tip_tables``: max_tips_per_cell); above 32 the kernel's
    form that takes a cell's tips in groups of 32), the plain version for
    CPU tensors. ``gz`` and ``window`` are the layout's
    (``neighbors.check_layout``)."""
    window_offsets(window)
    if start.device.type == "cpu":
        return anast_scan_plain(tip_slot, tip_cell, start, end, grid_ids,
                                grid_geo, grid_count, cap, ov_slot,
                                ov_start, ov_count, g, n_slots, gz=gz,
                                window=window)
    if tips is None:
        raise ValueError("anast_scan: the kernel needs the tip table by "
                         "cell (tips = (order, start, count, most tips a "
                         "cell))")
    H, N, M = tip_slot.shape[0], n_slots, g * g * gz
    if max(H, M * cap, 3 * N, 2 * window * cap * gz) >= 2 ** 31:
        raise ValueError("anast_scan: the kernel indexes with 32 bits: H, "
                         "g²·gz·cap and 3·n_slots must stay below 2^31")
    f32, i32 = torch.float32, torch.int32
    order, tstart, tcount, per_cell = tips
    for name, t, shape, dt in (
            ("tip_slot", tip_slot, (H,), i32), ("tip_cell", tip_cell, (H,), i32),
            ("tips.order", order, (H,), i32),
            ("tips.start", tstart, (M,), i32),
            ("tips.count", tcount, (M,), i32),
            ("start", start, (N, 3), f32), ("end", end, (N, 3), f32),
            ("grid_ids", grid_ids, (M * cap,), i32),
            ("grid_geo", grid_geo, (M * cap, 8), f32),
            ("grid_count", grid_count, (M,), i32),
            ("ov_slot", ov_slot, ov_slot.shape[:1], i32),
            ("ov_start", ov_start, (M,), i32),
            ("ov_count", ov_count, (M,), i32)):
        _check(name, t, shape, dt)
    d2 = torch.empty((H,), dtype=f32, device=start.device)
    tt = torch.empty_like(d2)
    ids = torch.empty((H,), dtype=i32, device=start.device)
    lib = build.library()
    rc = lib.anast_scan_f32(
        tip_slot.data_ptr(), tip_cell.data_ptr(), order.data_ptr(),
        tstart.data_ptr(), tcount.data_ptr(), start.data_ptr(),
        end.data_ptr(), grid_ids.data_ptr(), grid_geo.data_ptr(),
        grid_count.data_ptr(), ov_slot.data_ptr(), ov_start.data_ptr(),
        ov_count.data_ptr(), d2.data_ptr(), tt.data_ptr(), ids.data_ptr(),
        H, int(cap), int(g), N, int(gz), int(window), int(per_cell),
        build.stream_handle(start))
    build.check(rc, "anast_scan_f32")
    build.count_launch("anast_scan")
    return d2, tt, ids
