"""K4: the anastomosis distance scan (CUDA kernel + plain PyTorch version).

Replaces ``mycelium_tpu/growth/pallas_anast.py::_scan_kernel``. The source
note in ``csrc/anast_scan.cu`` says what bounds it and how.

For each hypha h with ``tip_cell[h] >= 0`` (its active tip is in the tip
table; the cell is its tip's corner cell cx·g + cy), with p the tip's end
``end[tip_slot[h]]``: visit the cells (cx+dr, cy+dc) for (dr, dc) in
(-1,-1), (-1,0), (0,-1), (0,0) (cells outside the face hold nothing), in
each first the persistent grid's entries, then the tip overlay's, each in
ascending rank; skip a candidate whose id is the tip's own slot or >= N;
keep the candidate with the strictly smallest squared distance

    ap = p - a;  tt = clip((ap·ab)·r, 0, 1);  e = ap - tt·ab;  d² = e·e

(r = 1/|ab|², 0 for a degenerate segment). Returns (d², tt, id) per hypha:
(inf, 0, N) for a hypha outside the table or without a candidate. The
grid's (a, ab, r) are stored per entry; an overlay candidate's are
computed from ``start``/``end`` by slot. The kernel works by corner cell:
it takes the tip table bucketed by corner cell (``tips``: the hyphae
sorted by cell, each cell's first position and count), which the plain
version does not read.

The nesting (offsets outermost, then source, then rank) and the
arithmetic are the JAX package's XLA scan (neighbors.py:585-620), and the
products and sums are fused where XLA's CPU backend fuses them: ap·ab and
e·e as fma(x2, y2, fma(x0, y0, x1·y1)), e as fma(-tt, ab, ap). The kernel
writes those fused multiply-adds out (``__fmaf_rn``, with no other
contraction) and the plain version computes them exactly (``_fma``), so
the two agree bit for bit, and with the Pallas kernel in interpret mode.
The Pallas kernel rolls its windows into a sentinel halo: the same zeros
outside the face as here; the XLA path's ``jnp.roll`` wraps around
instead, which differs only for a tip at row or column 0.
"""

from __future__ import annotations

import torch

from . import build

OFFS = ((-1, -1), (-1, 0), (0, -1), (0, 0))
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
                     g: int, n_slots: int, tips=None):
    """The plain PyTorch version, any device: per (offset, source), all
    of a cell's candidates at once; the first smallest within the pass,
    then a strict-< merge in visiting order (the sequential scan's
    answer). ``tips`` is not read."""
    H = tip_slot.shape[0]
    dev, dtype = start.device, start.dtype
    N = n_slots
    d2_out = torch.full((H,), float("inf"), dtype=dtype, device=dev)
    tt_out = torch.zeros((H,), dtype=dtype, device=dev)
    id_out = torch.full((H,), N, dtype=torch.int32, device=dev)
    rows = torch.nonzero(tip_cell >= 0).flatten()
    if rows.numel() == 0:
        return d2_out, tt_out, id_out
    start_p = torch.cat([start, start.new_zeros((1, 3))])
    end_p = torch.cat([end, end.new_zeros((1, 3))])
    n_ov = ov_slot.shape[0]
    ov_slot_p = torch.cat([ov_slot, ov_slot.new_full((1,), N)])
    kmax = int(max(int(grid_count.max()), int(ov_count.max()), 1))
    step = max(1, _ROWS_PER_CHUNK // kmax)
    for r0 in range(0, rows.numel(), step):
        h = rows[r0:r0 + step]
        slot = tip_slot[h].long()
        cell = tip_cell[h].long()
        p = end[slot]
        cx, cy = cell // g, cell % g
        best = torch.full((h.numel(),), float("inf"), dtype=dtype,
                          device=dev)
        btt = torch.zeros_like(best)
        bid = torch.full((h.numel(),), N, dtype=torch.int64, device=dev)
        for dr, dc in OFFS:
            x, y = cx + dr, cy + dc
            inb = (x >= 0) & (y >= 0)
            c = torch.where(inb, x * g + y, 0 * x)
            for src in ("grid", "overlay"):
                if src == "grid":
                    n = torch.where(inb, grid_count[c].long(), 0 * c)
                    K = int(n.max())
                    if K == 0:
                        continue
                    k = torch.arange(K, device=dev)
                    e = c[:, None] * cap + k[None, :]
                    cid = grid_ids[e].long()
                    geo = grid_geo[e]
                    a, ab, r = geo[..., 0:3], geo[..., 3:6], geo[..., 6]
                else:
                    n = torch.where(inb, ov_count[c].long(), 0 * c)
                    K = int(n.max())
                    if K == 0:
                        continue
                    k = torch.arange(K, device=dev)
                    e = (ov_start[c].long()[:, None] + k[None, :]) \
                        .clamp(max=n_ov)
                    cid = ov_slot_p[e].long()
                    cs = cid.clamp(max=N)
                    a = start_p[cs]
                    ab = end_p[cs] - a
                    r = _inv_sq_length(ab)
                d2, tt = _dist(p[:, None, :], a, ab, r)
                use = (k[None, :] < n[:, None]) & (cid != slot[:, None]) \
                    & (cid < N)
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
               n_slots: int, tips=None):
    """The scan: the CUDA kernel for CUDA tensors (float32 only, raises
    otherwise; ``tips`` = (order (H,), start (M,), count (M,)) int32, the
    tip table by corner cell, at most 32 a cell: ``neighbors.tip_tables``),
    the plain version for CPU tensors."""
    if start.device.type == "cpu":
        return anast_scan_plain(tip_slot, tip_cell, start, end, grid_ids,
                                grid_geo, grid_count, cap, ov_slot,
                                ov_start, ov_count, g, n_slots)
    if tips is None:
        raise ValueError("anast_scan: the kernel needs the tip table by "
                         "corner cell (tips = (order, start, count))")
    H, N, M = tip_slot.shape[0], n_slots, g * g
    if max(H, M * cap, 3 * N) >= 2 ** 31:
        raise ValueError("anast_scan: the kernel indexes with 32 bits: H, "
                         "g²·cap and 3·n_slots must stay below 2^31")
    f32, i32 = torch.float32, torch.int32
    order, tstart, tcount = tips
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
        H, int(cap), int(g), N, build.stream_handle(start))
    build.check(rc, "anast_scan_f32")
    build.count_launch("anast_scan")
    return d2, tt, ids
