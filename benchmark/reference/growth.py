"""One step of the hyphal growth model in float64, and the export's node
dedup, written from the upstream ``src/mycelium_sim_2D.py``
(YiKwanwoo2/mycelium-fea-project; SURVEY.md §2.4-2.5) with NumPy only.

Per step, in the upstream demo loop's order (``:667-673``):

- translocate (``:275-310``): each segment with a predecessor exchanges
  D·dt·(I_prev − I)/((L + L_prev)/2) with it, the amount clamped so that
  neither leaves [0, M_cap] (tested in the upstream's elif order); all
  exchanges read the substrate before the step, are added at once, and the
  result is clamped to [0, M_cap] once.
- grow and branch (``:388-460``): a hypha whose last segment is active and
  holds I·L >= c_g·h0 spends c_g·h0, turns that segment passive and appends
  an active one of length h0 at its end, the direction perturbed by
  (u − 1/2)·lambda; with a branch uniform below p_branch and 2·c_g·h0 in
  hand it spends twice and also starts a new hypha there. Each new segment
  gets half the tip's concentration after the cost (substrate is not
  conserved, as upstream). New segments take the slots after the occupied
  ones, extensions first, each group in hypha order; new hyphae take the
  next ids in the same order; a segment or hypha past the capacity is not
  made.
- anastomosis (``:507-542``): an active tip whose end lies within tol of
  another segment snaps to the closest point of that segment and becomes
  'S'.
- uptake (``:315-338``): for each substrate cuboid, the segments whose end
  lies in it (1e-12 of slack), in slot order, take
  max(min(dt·mu·E·I, M_cap − I, E), 0) from its nutrient E until E is
  spent.
- walls (``:340-383``): the last segment of every hypha whose end lies in a
  wall cuboid is turned along the wall's face (the face of largest overlap)
  at its length, up to 3 sweeps, and becomes active.

Departures from upstream, each the port's documented semantics:

- anastomosis snaps to the nearest segment within tol, not the first one
  its dict-based hash yields, and every tip is tested against the segments
  as grown this step, before any snap (upstream snaps tip by tip);
- uptake stops once E is at most 1e-18 mol, not at 0;
- the random numbers are the program's own draws (uniforms for the branch
  test and the two perturbations, normals for the walls' degenerate cases),
  handed to both sides; upstream draws from ``random``.

``precision="tf32"`` is the control: each product's operands rounded to
TF32 (float32's exponent, 10 bits of mantissa), sums kept in float64.

``judge`` holds a program's step to this one. A decision is a comparison
with a threshold: a tip's I·L against the cost (grow) and twice it
(branch), the branch uniform against p_branch, a tip's distance to its
nearest segment against tol, which segment is nearest, and a tip's end
inside a wall at each sweep. Its margin is how far from the threshold the
reference's quantity lies, over the threshold's scale. Where the program
took a decision otherwise within the band that rounding at the
configuration's precision explains (``band``), the reference takes the
program's; everything else is the reference's own, and a decision taken
otherwise beyond the band shows as segments that differ.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from scipy.spatial import cKDTree

EMPTY, ACTIVE, PASSIVE, ANASTOMOSED = 0, 1, 2, 3
SLACK = 1e-12          # a cuboid's point test
SMALL = 1e-12          # degenerate lengths
E_FLOOR = 1e-18        # mol: uptake stops at or below


def to_tf32(a) -> np.ndarray:
    """``a`` rounded to the nearest TF32 value (ties to even), as
    float64."""
    b = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    b = ((b + 0xFFF + ((b >> 13) & 1)) >> 13) << 13
    return b.astype(np.uint32).view(np.float32).astype(np.float64)


ROUND = {"float64": lambda a: np.asarray(a, np.float64), "tf32": to_tf32}


class State(NamedTuple):
    """The program's state layout, segment slots and hypha rows, its
    numbers as float64 arrays."""
    start: np.ndarray      # (N, 3)
    end: np.ndarray        # (N, 3)
    theta: np.ndarray      # (N,)
    phi: np.ndarray        # (N,)
    sub: np.ndarray        # (N,) internal substrate I, mol/mm
    state: np.ndarray      # (N,) EMPTY / ACTIVE / PASSIVE / ANASTOMOSED
    prev: np.ndarray       # (N,) predecessor slot, -1 none
    hypha: np.ndarray      # (N,) owning hypha, -1 none
    tip: np.ndarray        # (H,) last segment of each hypha, -1 none
    n_seg: int
    n_hyp: int
    env_e: np.ndarray      # (S,) nutrient left in each substrate cuboid


class Draws(NamedTuple):
    branch: np.ndarray     # (H,) uniforms
    ext: np.ndarray        # (H,) uniforms, the extension's perturbation
    child: np.ndarray      # (H,) uniforms, the branch's perturbation
    wall_rnd: np.ndarray   # (3, H, 3) normals: a degenerate direction
    wall_tan: np.ndarray   # (3, H, 3) normals: a degenerate slide


class Dish(NamedTuple):
    sub_center: np.ndarray
    sub_size: np.ndarray
    sub_mu: np.ndarray
    wall_center: np.ndarray
    wall_size: np.ndarray


def dish(g: dict) -> Dish:
    """The upstream 2D demo dish (``mycelium_sim_2D.py:634-654``): one
    substrate cuboid over the dish, 4 side walls."""
    if g["three_d"]:
        raise ValueError("the growth reference is 2D")
    ds, wt, h = g["dish_size"], g["wall_thickness"], g["height"]
    walls_c = np.array([[0, ds / 2 + wt / 2, 0], [0, -ds / 2 - wt / 2, 0],
                        [ds / 2 + wt / 2, 0, 0], [-ds / 2 - wt / 2, 0, 0]],
                       np.float64)
    walls_s = np.array([[ds, wt, wt], [ds, wt, wt], [wt, ds, wt],
                        [wt, ds, wt]], np.float64)
    return Dish(np.zeros((1, 3)), np.array([[ds, g["substrate_width"], h]]),
                np.array([g["substrate_mu"]], np.float64), walls_c, walls_s)


def _inside(center, size, p):
    return np.all(np.abs(p - center) <= 0.5 * size + SLACK, axis=-1)


def _depth(center, size, p):
    """How far p lies inside the cuboid (negative: outside), by its
    nearest face."""
    return np.min(0.5 * size + SLACK - np.abs(p - center), axis=-1)


def _norm(v):
    return np.sqrt(np.sum(v * v, axis=-1))


class Margins:
    """The decisions the program took otherwise: those within ``band`` of
    their threshold are taken (``take``), the largest margin of those
    kept."""

    def __init__(self, band: float):
        self.band, self.worst = band, 0.0

    def take(self, margin) -> np.ndarray:
        m = np.asarray(margin, np.float64)
        ok = m <= self.band
        if ok.any():
            self.worst = max(self.worst, float(m[ok].max()))
        return ok


def band(g: dict) -> float:
    """The widest margin rounding at the configuration's precision
    explains: 2^10 units of its last place (float32: 6.1e-5). A decision
    quantity is a few operations on the state's numbers, and the
    threshold's constants are themselves rounded, so a sound step's
    margins are a few units; TF32's unit is 2^13 of float32's."""
    return 2.0 ** 10 * float(np.finfo(g["dtype"]).eps) / 2


class _Grown(NamedTuple):
    s: State               # after translocation and growth
    scanned: np.ndarray    # (H,) bool: the hypha's tip is an active tip


def translocate(s: State, g: dict, rnd) -> np.ndarray:
    n = s.n_seg
    sub = s.sub.astype(np.float64)
    prev = s.prev[:n].astype(np.int64)
    ln = _norm(s.end[:n] - s.start[:n])
    valid = (prev >= 0) & (s.state[:n] != EMPTY)
    p = np.maximum(prev, 0)
    sc, sp = sub[:n], sub[p]
    denom = (ln + ln[p]) / 2.0
    ok = valid & (denom > 0)
    delta = rnd(g["dt"] * g["diffusion"]) * rnd(sp - sc) \
        / np.where(denom > 0, denom, 1.0)
    new_s, new_p = sc + delta, sp - delta
    m_cap = g["m_cap"]
    adj = np.where(new_s < 0, -sc, np.where(
        new_s > m_cap, m_cap - sc, np.where(
            new_p < 0, sp, np.where(new_p > m_cap, m_cap - sp, delta))))
    adj = np.where(ok, adj, 0.0)
    out = sub.copy()
    out[:n] = sc + adj
    np.add.at(out, p, -adj)
    return np.clip(out, 0.0, m_cap)


def grow(s: State, sub: np.ndarray, d: Draws, g: dict, rnd,
         grew=None, branched=None, margins: Margins | None = None):
    """Growth and branching after translocation (``sub``). ``grew`` and
    ``branched`` (H,) are the program's decisions: where they differ from
    this one's within the band of ``margins``, they are taken."""
    n_cap, h_cap = s.start.shape[0], s.tip.shape[0]
    hyp = np.arange(h_cap)
    valid = (hyp < s.n_hyp) & (s.tip >= 0)
    t = np.maximum(s.tip, 0).astype(np.int64)
    tip_start, tip_end = s.start[t].astype(np.float64), \
        s.end[t].astype(np.float64)
    tip_state = np.where(valid, s.state[t], EMPTY)
    length = _norm(tip_end - tip_start)
    avail = rnd(sub[t]) * rnd(length)
    cost = g["c_g"] * g["h0"]
    active = tip_state == ACTIVE
    can = active & (avail >= cost)
    if grew is not None:
        off = active & (can != grew)
        take = off & margins.take(np.where(off, np.abs(avail - cost) / cost,
                                           np.inf))
        can = np.where(take, grew, can)
    u = d.branch.astype(np.float64)
    conds = np.stack([u < g["p_branch"], avail >= 2 * cost])
    gaps = np.stack([np.abs(u - g["p_branch"]) / g["p_branch"],
                     np.abs(avail - 2 * cost) / (2 * cost)])
    br = can & conds.all(axis=0)
    if branched is not None:
        off = can & (br != branched)
        # True -> False: the nearest condition; False -> True: every
        # condition that failed
        flip = np.where(br, gaps.min(axis=0),
                        np.where(conds, 0.0, gaps).max(axis=0))
        take = off & margins.take(np.where(off, flip, np.inf))
        br = np.where(take, branched, br)
    ci, bi = can.astype(np.int64), br.astype(np.int64)
    ext_slot = s.n_seg + np.cumsum(ci) - ci
    child_slot = s.n_seg + ci.sum() + np.cumsum(bi) - bi
    child_hyp = s.n_hyp + np.cumsum(bi) - bi
    vext = can & (ext_slot < n_cap)
    vchild = br & (child_slot < n_cap) & (child_hyp < h_cap)
    total = np.where(br, 2 * cost, cost)
    tip_sub = np.maximum(avail - total, 0.0) / np.where(length > 0, length,
                                                        1.0)
    lam = rnd(g["lambda_angle"])
    tip_phi = s.phi[t].astype(np.float64)
    ph_e = rnd(d.ext.astype(np.float64) - 0.5) * lam + tip_phi
    ph_c = rnd(d.child.astype(np.float64) - 0.5) * lam + tip_phi
    h0 = rnd(g["h0"])

    def end_at(ph):
        dirv = np.stack([np.cos(ph), np.sin(ph), np.zeros_like(ph)], axis=1)
        return rnd(dirv) * h0 + tip_end

    out = {k: getattr(s, k).astype(np.float64 if k in
                                   ("start", "end", "theta", "phi") else
                                   getattr(s, k).dtype, copy=True)
           for k in ("start", "end", "theta", "phi", "state", "prev",
                     "hypha", "tip")}
    out["sub"] = sub.copy()
    for mask, slot, ph, end, parent, owner in (
            (vext, ext_slot, ph_e, end_at(ph_e), s.tip, hyp),
            (vchild, child_slot, ph_c, end_at(ph_c),
             np.full(h_cap, -1), child_hyp)):
        i = slot[mask]
        out["start"][i] = tip_end[mask]
        out["end"][i] = end[mask]
        out["theta"][i] = np.pi / 2
        out["phi"][i] = ph[mask]
        out["sub"][i] = 0.5 * tip_sub[mask]
        out["state"][i] = ACTIVE
        out["prev"][i] = parent[mask]
        out["hypha"][i] = owner[mask]
    out["sub"][t[vext]] = tip_sub[vext]
    out["state"][t[vext]] = PASSIVE
    out["tip"][vext] = ext_slot[vext]
    out["tip"][child_hyp[vchild]] = child_slot[vchild]
    # the counts of what was decided, capped at the capacities
    grown = s._replace(n_seg=min(s.n_seg + int(ci.sum() + bi.sum()), n_cap),
                       n_hyp=min(s.n_hyp + int(bi.sum()), h_cap), **out)
    hv = (hyp < grown.n_hyp) & (grown.tip >= 0)
    scanned = hv & (grown.state[np.maximum(grown.tip, 0)] == ACTIVE)
    return _Grown(grown, scanned)


class Nearest(NamedTuple):
    """A scanned tip's nearest and second-nearest segments: distance,
    parameter along the segment, slot (N where none)."""
    d: np.ndarray          # (H, 2)
    t: np.ndarray          # (H, 2)
    j: np.ndarray          # (H, 2)


def nearest(gr: _Grown, g: dict, rnd) -> Nearest:
    """Each scanned tip's end against every other live segment within
    2·tol of it (found by midpoint: a segment within 2·tol of the tip has
    its midpoint within 2·tol and half the longest segment); the rest lie
    farther than any decision looks."""
    s = gr.s
    n_cap, h_cap = s.start.shape[0], s.tip.shape[0]
    d = np.full((h_cap, 2), np.inf)
    tt = np.zeros((h_cap, 2))
    jj = np.full((h_cap, 2), n_cap, np.int64)
    cand = np.nonzero(s.state[:s.n_seg] != EMPTY)[0]
    rows = np.nonzero(gr.scanned)[0]
    if not len(rows) or not len(cand):
        return Nearest(d, tt, jj)
    a = s.start[cand]
    ab = s.end[cand] - a
    reach = 2 * g["anastomosis_tol"] + 0.5 * float(_norm(ab).max())
    near = cKDTree(a + 0.5 * ab).query_ball_point(s.end[s.tip[rows]],
                                                  reach * (1 + 1e-9))
    hi = np.repeat(np.arange(len(rows)), [len(x) for x in near])
    ci = np.fromiter((c for x in near for c in x), np.int64, len(hi))
    other = cand[ci] != s.tip[rows[hi]]       # not the tip itself
    hi, ci = hi[other], ci[other]
    if not len(ci):
        return Nearest(d, tt, jj)
    p = s.end[s.tip[rows[hi]]]
    seg, ap = rnd(ab[ci]), p - a[ci]
    ab2 = np.sum(seg * seg, axis=1)
    r = np.where(ab2 < SMALL, 0.0, 1.0 / np.maximum(ab2, SMALL))
    t = np.clip(np.sum(rnd(ap) * seg, axis=1) * r, 0.0, 1.0)
    e = ap - rnd(t)[:, None] * seg
    dist = np.sqrt(np.sum(rnd(e) * rnd(e), axis=1))
    order = np.lexsort((dist, hi))
    hi, dist, t, j = hi[order], dist[order], t[order], cand[ci[order]]
    first = np.ones(len(hi), bool)
    first[1:] = hi[1:] != hi[:-1]
    rank = np.arange(len(hi)) - np.maximum.accumulate(
        np.where(first, np.arange(len(hi)), 0))
    keep = rank < 2
    h, k = rows[hi[keep]], rank[keep]
    d[h, k], tt[h, k], jj[h, k] = dist[keep], t[keep], j[keep]
    return Nearest(d, tt, jj)


def uptake(sub, env_e, end, state, n_seg: int, dsh: Dish, g: dict, rnd):
    """The sequential drain, segment by segment in slot order."""
    sub, env_e = sub.copy(), np.asarray(env_e, np.float64).copy()
    m_cap, rate = g["m_cap"], g["dt"]
    for c in range(len(dsh.sub_center)):
        inside = _inside(dsh.sub_center[c], dsh.sub_size[c], end[:n_seg]) \
            & (state[:n_seg] != EMPTY)
        a = rnd(rate * dsh.sub_mu[c])
        e = float(env_e[c])
        for i in np.nonzero(inside)[0]:
            if not e > E_FLOOR:
                break
            si = sub[i]
            th = max(min(float(a * rnd(e) * rnd(si)), m_cap - si, e), 0.0)
            e -= th
            sub[i] = si + th
        env_e[c] = e
    return sub, env_e


def walls(end, start, hv, flip, dsh: Dish, d: Draws, rnd):
    """The 3 sweeps over every hypha's last segment (rows of ``start`` /
    ``end``, valid where ``hv``); ``flip`` (H,) names a sweep whose
    inside test is taken the other way (-1: none). Returns (end, touched,
    the margin of each sweep's test, over h0 later)."""
    end = end.copy()
    h_cap = len(end)
    length = _norm(end - start)
    touched = np.zeros(h_cap, bool)
    margin = np.zeros((h_cap, 3))
    nw = len(dsh.wall_center)
    for it in range(3):
        depth = np.stack([_depth(dsh.wall_center[w], dsh.wall_size[w], end)
                          for w in range(nw)], axis=1)
        inside = depth >= 0
        pen = inside.any(axis=1)
        margin[:, it] = np.where(pen, np.where(inside, depth, 0).max(axis=1),
                                 (-depth).min(axis=1))
        first = np.where(pen, np.argmax(inside, axis=1),
                         np.argmin(-depth, axis=1))
        pen = np.where(flip == it, ~pen, pen) & hv
        c = dsh.wall_center[first]
        delta = end - c
        face = np.argmax(np.abs(delta) - dsh.wall_size[first] / 2.0, axis=1)
        normal = np.zeros((h_cap, 3))
        normal[np.arange(h_cap), face] = np.sign(delta[np.arange(h_cap),
                                                       face])
        dv = end - start
        dv = np.where((_norm(dv) < SMALL)[:, None], d.wall_rnd[it], dv)
        dv = dv / _norm(dv)[:, None]
        dot = np.sum(rnd(dv) * normal, axis=1)
        slide = dv - rnd(dot)[:, None] * normal
        tan = d.wall_tan[it] * (1.0 - np.abs(normal))
        slide = np.where((_norm(slide) < SMALL)[:, None], tan, slide)
        slide = slide / _norm(slide)[:, None]
        new = rnd(slide) * rnd(length)[:, None] + start
        end = np.where(pen[:, None], new, end)
        touched |= pen
    return end, touched, margin


def _tail(gr: _Grown, nb: Nearest, snap, flip, dsh: Dish, d: Draws, g: dict,
          rnd, cache: dict):
    """Anastomosis by ``snap`` (H,): the candidate taken (0 nearest, 1
    second, -1 none), uptake, the walls with ``flip``. Returns (state,
    wall margins (H, 3) over h0)."""
    s = gr.s
    h_cap = s.tip.shape[0]
    t = np.maximum(s.tip, 0)
    end, state = s.end.copy(), s.state.copy()
    rows = np.nonzero(snap >= 0)[0]
    if len(rows):
        k = snap[rows]
        j = nb.j[rows, k]
        a = s.start[j]
        proj = rnd(nb.t[rows, k])[:, None] * rnd(s.end[j] - a) + a
        end[t[rows]] = proj
        state[t[rows]] = ANASTOMOSED
    key = snap.tobytes()
    if key not in cache:
        cache[key] = uptake(s.sub, s.env_e, end, state, s.n_seg, dsh, g, rnd)
    sub, env_e = cache[key]
    hv = (np.arange(h_cap) < s.n_hyp) & (s.tip >= 0)
    new_end, touched, margin = walls(end[t], s.start[t], hv, flip, dsh, d,
                                     rnd)
    dv = new_end - s.start[t]
    dn = np.maximum(_norm(dv), 1e-30)
    theta = np.arccos(np.clip(dv[:, 2] / dn, -1.0, 1.0))
    phi = np.arctan2(dv[:, 1], dv[:, 0])
    i = t[touched]
    out = dict(end=end, state=state, theta=s.theta.copy(), phi=s.phi.copy())
    out["end"][i] = new_end[touched]
    out["theta"][i] = theta[touched]
    out["phi"][i] = phi[touched]
    out["state"][i] = ACTIVE
    return s._replace(sub=sub, env_e=env_e, **out), margin / g["h0"]


def _program_growth(s: State, prog: State):
    """The program's grow and branch decisions, read off its state after
    the step: a hypha grew where its last segment moved to a new slot;
    its new hyphae, in order, started at the ends of the hyphae that grew
    and branched, in order. Returns (grew, branched, unmatched)."""
    h_cap = s.tip.shape[0]
    hv = (np.arange(h_cap) < s.n_hyp) & (s.tip >= 0)
    grew = hv & (prog.tip != s.tip)
    branched = np.zeros(h_cap, bool)
    tip_end = s.end[np.maximum(s.tip, 0)]
    parents = iter(np.nonzero(grew)[0])
    unmatched = 0
    for c in range(s.n_hyp, min(prog.n_hyp, h_cap)):
        slot = prog.tip[c]
        at = prog.start[slot] if 0 <= slot < len(prog.start) else None
        for h in parents:
            if at is not None and np.array_equal(tip_end[h], at):
                branched[h] = True
                break
        else:
            unmatched += 1
    return grew, branched, unmatched


def step(s: State, d: Draws, g: dict, precision: str = "float64") -> State:
    """The step, every decision this reference's own."""
    rnd = ROUND[precision]
    dsh = dish(g)
    gr = grow(s, translocate(s, g, rnd), d, g, rnd)
    nb = nearest(gr, g, rnd)
    snap = np.where(gr.scanned & (nb.d[:, 0] <= g["anastomosis_tol"]), 0, -1)
    flip = np.full(s.tip.shape[0], -1)
    return _tail(gr, nb, snap, flip, dsh, d, g, rnd, {})[0]


def _tip_gap(ref: State, prog: State, h0: float) -> np.ndarray:
    """(H,) how far each hypha's last segment lies from the program's:
    its end over h0, plus 1 where its state differs."""
    t = np.maximum(ref.tip, 0)
    far = np.abs(ref.end[t] - prog.end[t]).max(axis=1) / h0
    return far + (ref.state[t] != prog.state[t])


def judge(before: State, d: Draws, after: State, g: dict) -> dict:
    """The program's step from ``before`` with draws ``d`` to ``after``,
    against this reference's from the same state and draws:

    - ``growth_pos_err``: max |x − x_ref| over h0 of every live segment's
      start and end, and of its angles (radians, modulo a turn: the
      displacement of the next segment's end over h0);
    - ``growth_sub_err``: max |I − I_ref| over max |I_ref|;
    - ``growth_env_err``: max |E − E_ref| over the most nutrient a cuboid
      held before the step;
    - ``growth_off``: slots whose state, hypha or predecessor differ,
      hyphae whose last segment differs, and a differing count of
      segments or hyphae or a new hypha not traced to its parent, after
      the decisions the program took otherwise within ``band`` are taken;
    - ``growth_margin``: the largest margin of those (see the module's
      docstring).
    """
    rnd = ROUND["float64"]
    dsh = dish(g)
    h0, h_cap = g["h0"], before.tip.shape[0]
    margins = Margins(band(g))
    grew, branched, unmatched = _program_growth(before, after)
    gr = grow(before, translocate(before, g, rnd), d, g, rnd, grew, branched,
              margins)
    nb = nearest(gr, g, rnd)
    tol = g["anastomosis_tol"]
    snap = np.where(gr.scanned & (nb.d[:, 0] <= tol), 0, -1)
    flip = np.full(h_cap, -1)
    cache = {}
    ref, wall_m = _tail(gr, nb, snap, flip, dsh, d, g, rnd, cache)
    # each hypha's last segment: the single decision within the band,
    # taken otherwise, that brings it nearest to the program's, where one
    # does
    gap = _tip_gap(ref, after, h0)
    best, best_m = gap, np.full(h_cap, np.inf)
    toggled = np.where(gr.scanned & np.isfinite(nb.d[:, 0]),
                       np.where(snap >= 0, -1, 0), snap)
    second = np.where((snap == 0) & (nb.d[:, 1] <= tol), 1, snap)
    runner_up = np.subtract(nb.d[:, 1], nb.d[:, 0], out=np.full(h_cap, np.inf),
                            where=np.isfinite(nb.d[:, 1]))
    variants = [(toggled, flip, np.abs(nb.d[:, 0] - tol) / tol),
                (second, flip, runner_up / tol)]
    for it in range(3):
        variants.append((snap, np.full(h_cap, it), wall_m[:, it]))
    choice_snap, choice_flip = snap.copy(), flip.copy()
    for v_snap, v_flip, v_m in variants:
        changed = (v_snap != snap) | (v_flip != flip)
        if not changed.any():
            continue
        alt = _tail(gr, nb, v_snap, v_flip, dsh, d, g, rnd, cache)[0]
        g_alt = _tip_gap(alt, after, h0)
        take = changed & (g_alt < best) & (v_m <= margins.band)
        best = np.where(take, g_alt, best)
        best_m = np.where(take, v_m, best_m)
        choice_snap = np.where(take, v_snap, choice_snap)
        choice_flip = np.where(take, v_flip, choice_flip)
    margins.take(best_m)
    if (choice_snap != snap).any() or (choice_flip != flip).any():
        ref = _tail(gr, nb, choice_snap, choice_flip, dsh, d, g, rnd,
                    cache)[0]
    return compare(ref, after, before, g, margins.worst, unmatched)


def compare(ref: State, prog: State, before: State, g: dict,
            margin: float = 0.0, unmatched: int = 0) -> dict:
    h0 = g["h0"]
    live = (ref.state != EMPTY) | (prog.state != EMPTY)
    pos = 0.0
    for k, scale in (("start", h0), ("end", h0), ("theta", 1.0),
                     ("phi", 1.0)):
        diff = np.asarray(getattr(prog, k), np.float64) - getattr(ref, k)
        if diff.ndim == 2:
            diff = np.abs(diff).max(axis=1)
        else:       # an angle: the same direction a turn apart is equal
            diff = np.abs((diff + np.pi) % (2 * np.pi) - np.pi)
        pos = max(pos, float(np.max(diff[live], initial=0.0)) / scale)
    sub_err = float(np.abs(np.asarray(prog.sub, np.float64) - ref.sub).max()
                    / max(float(np.abs(ref.sub).max()), 1e-300))
    e0 = max(float(np.max(before.env_e, initial=0.0)), 1e-300)
    env_err = float(np.abs(np.asarray(prog.env_e, np.float64)
                           - ref.env_e).max(initial=0.0) / e0)
    off = int(np.sum(ref.state != prog.state) + np.sum(ref.hypha != prog.hypha)
              + np.sum(ref.prev != prog.prev) + np.sum(ref.tip != prog.tip)
              + (ref.n_seg != prog.n_seg) + (ref.n_hyp != prog.n_hyp)
              + unmatched)
    return {"growth_pos_err": pos, "growth_sub_err": sub_err,
            "growth_env_err": env_err, "growth_off": off,
            "growth_margin": margin}


def mesh(start, end, state, hypha, decimals: int = 6):
    """The export (``mycelium_sim_2D.py:693-728``): live segments in hypha
    order, chain (slot) order within a hypha; their (start, end) points in
    that order, nodes first seen first, points equal after rounding to
    ``decimals`` one node. Returns (coords (n, 3), conn (e, 2))."""
    idx = np.nonzero(np.asarray(state) != EMPTY)[0]
    idx = idx[np.lexsort((idx, np.asarray(hypha)[idx]))]
    pts = np.empty((2 * len(idx), 3))
    pts[0::2] = np.asarray(start, np.float64)[idx]
    pts[1::2] = np.asarray(end, np.float64)[idx]
    _, first, inverse = np.unique(np.round(pts, decimals), axis=0,
                                  return_index=True, return_inverse=True)
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first))
    return pts[np.sort(first)], rank[inverse.reshape(-1)].reshape(-1, 2)


def mesh_off(coords, conn, ref_coords, ref_conn) -> int:
    """Nodes and elements of the program's mesh that differ from the
    reference's (a differing count counts its difference and every
    entry)."""
    coords, conn = np.asarray(coords, np.float64), np.asarray(conn)
    if coords.shape != ref_coords.shape or conn.shape != ref_conn.shape:
        return abs(len(coords) - len(ref_coords)) \
            + abs(len(conn) - len(ref_conn)) + len(ref_coords) + len(ref_conn)
    return int(np.sum(np.any(coords != ref_coords, axis=1))
               + np.sum(np.any(conn != ref_conn, axis=1)))
