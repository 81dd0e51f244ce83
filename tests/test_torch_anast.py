"""Anastomosis: the port's detect_anastomosis against the JAX package's,
and K4's plain version (kernels/anast.py) against the reference's Pallas
scan kernel in interpret mode, per hypha.

The port's scan visits candidates in the XLA path's order and computes
each distance with the fused multiply-adds XLA's CPU backend uses, so
(d², tt, id) are bit-equal to the Pallas kernel's on identical inputs
(tolerance 0) wherever no two distinct candidates sit at bitwise-equal
distance (the Pallas kernel nests the window offsets the other way,
pallas_anast.py:28-35); and the snapped ends and states equal the
reference's. Cells outside the face hold nothing, as in the Pallas
kernel's sentinel halo (the XLA path's roll wraps around instead).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mycelium_tpu.config import GrowthConfig as JGrowthConfig
from mycelium_tpu.growth import neighbors as jnb
from mycelium_tpu.growth import ops as jops
from mycelium_tpu.growth.pallas_anast import anast_scan_kernel
from mycelium_tpu.growth.state import ANASTOMOSED, PASSIVE, ACTIVE
from mycelium_tpu.growth.step import run_growth as jrun_growth
from mycelium_tpu_torch.config import GrowthConfig
from mycelium_tpu_torch.convert import (growth_state_from_jax,
                                        jax_growth_arrays)
from mycelium_tpu_torch.growth import neighbors as tnb
from mycelium_tpu_torch.growth.state import ensure_grid, init_state
from mycelium_tpu_torch.kernels.anast import (_dist, _inv_sq_length,
                                              anast_scan, anast_scan_plain)
from tests.torch_support import (JaxDraws, emulate_anast_by_cell,
                                 scan_args, tie_state)

_GROWN = {}


def grown_25():
    """A 25-step float32 state of the reference's demo configuration with
    the persistent grid (tests/test_growth_ops.py:539-561 grows it), taken
    on through the next step's translocate and grow, so the anastomosis
    query sees fresh tips."""
    if "st" not in _GROWN:
        jcfg = JGrowthConfig(t_steps=25, grid_incremental=True)
        st, _, hist = jrun_growth(jcfg)
        assert hist[-1]["segments"] > 1000
        key, k_grow = jax.random.split(st.key)
        st = jax.jit(jops.translocate, static_argnums=1)(
            st._replace(key=key), jcfg)
        st = jax.jit(jops.grow, static_argnums=1)(st, jcfg, k_grow)
        _GROWN["st"] = (GrowthConfig(**dataclasses.asdict(jcfg)), jcfg, st)
    return _GROWN["st"]


def _jax_detect(jst, jcfg, mode, monkeypatch):
    monkeypatch.setenv("MYC_ANAST_KERNEL", mode)
    return jax.jit(lambda s: jnb.detect_anastomosis(s, jcfg))(jst)


@pytest.mark.parametrize("mode", ["off", "interpret"])
def test_detect_anastomosis_matches_reference(mode, monkeypatch):
    cfg, jcfg, jst = grown_25()
    out_j = _jax_detect(jst, jcfg, mode, monkeypatch)
    st = growth_state_from_jax(jax_growth_arrays(jst), cfg, "cpu")
    out_t = tnb.detect_anastomosis(st, cfg)
    np.testing.assert_array_equal(out_t.end.numpy(), np.asarray(out_j.end))
    np.testing.assert_array_equal(out_t.state.numpy(),
                                  np.asarray(out_j.state))
    assert bool(out_t.overflow) == bool(out_j.overflow)
    assert int((out_t.state == ANASTOMOSED).sum()) \
        > int((st.state == ANASTOMOSED).sum())
    # the grid after this step's insert, array-equal after the layout change
    ref = growth_state_from_jax(jax_growth_arrays(out_j), cfg, "cpu").grid
    for f in ("ids", "geo", "count"):
        np.testing.assert_array_equal(getattr(out_t.grid, f).numpy(),
                                      getattr(ref, f).numpy())


def scan_inputs(st, cfg):
    """The scan's arguments for a port state, as detect_anastomosis builds
    them, plus the rank of each hypha in its corner cell."""
    g = tnb.check_layout(cfg).g
    grid, _ = tnb.grid_insert_finalized(st.grid, st, cfg)
    tb = tnb.tip_tables(st, cfg)
    scan_cell = tb.scan_cell
    H, M = st.tip.shape[0], g * g
    t = st.tip.clamp(min=0).long()
    rank = tnb._bucket(torch.where(scan_cell >= 0, scan_cell.long(),
                                   torch.full((H,), M)), M, H).rank
    args = (st.tip, scan_cell, st.start, st.end, grid.ids, grid.geo,
            grid.count, cfg.max_per_cell, tb.ov_slot, tb.ov_start,
            tb.ov_count, g, st.capacity, tb.tips)
    return args, rank, t


def pallas_per_hypha(args, rank, t, cfg):
    """The reference's Pallas kernel (interpret mode) on the same inputs,
    laid out as its planes (rank, cx, cy), read back per hypha."""
    (tip, scan_cell, start, end, gids, ggeo, gcount, C, ov_slot, ov_start,
     ov_count, g, N, _) = args
    M, Ct = g * g, cfg.max_tips_per_cell
    inb = (scan_cell >= 0).numpy()
    h = np.nonzero(inb)[0]
    cell = scan_cell.long().numpy()[h]
    rk = rank.numpy()[h]
    tslot = np.full((Ct, M), N, np.int32)
    tslot[rk, cell] = tip.numpy()[h]
    tend = np.zeros((3, Ct, M), np.float32)
    tend[:, rk, cell] = end.numpy()[t.numpy()[h]].T
    tipcnt = np.bincount(cell, minlength=M).astype(np.int32)

    def planes(x):                       # (M, C, ...) -> (C, g, g, ...)
        return np.moveaxis(x, 1, 0).reshape((C, g, g) + x.shape[2:])

    geo = planes(ggeo.numpy().reshape(M, C, 8))
    grid_src = ([geo[..., k] for k in range(3)],
                [geo[..., 3 + k] for k in range(3)], geo[..., 6],
                planes(gids.numpy().reshape(M, C)))
    oid = np.full((M, C), N, np.int64)
    ost, ocnt = ov_start.numpy(), ov_count.numpy()
    for m in np.nonzero(ocnt)[0]:
        oid[m, :ocnt[m]] = ov_slot.numpy()[ost[m]:ost[m] + ocnt[m]]
    ids_t = torch.as_tensor(oid).clamp(max=N)
    a = torch.cat([start, start.new_zeros((1, 3))])[ids_t]
    ab = torch.cat([end, end.new_zeros((1, 3))])[ids_t] - a
    r = _inv_sq_length(ab)
    ov_src = ([planes(a[..., k].numpy()) for k in range(3)],
              [planes(ab[..., k].numpy()) for k in range(3)],
              planes(r.numpy()), planes(oid.astype(np.int32)))
    j = jnp.asarray
    d2, tt, ids = anast_scan_kernel(
        [j(x.reshape(Ct, g, g)) for x in tend], j(tslot.reshape(Ct, g, g)),
        [([j(x) for x in s[0]], [j(x) for x in s[1]], j(s[2]), j(s[3]))
         for s in (grid_src, ov_src)],
        j(tipcnt.reshape(g, g)),
        [j(gcount.numpy().reshape(g, g)), j(ocnt.reshape(g, g))], N, g,
        interpret=True)
    flat = (rk, cell // g, cell % g)
    return h, np.asarray(d2)[flat], np.asarray(tt)[flat], \
        np.asarray(ids)[flat]


def assert_scan_matches_pallas(st, cfg, min_hits=1, max_ties=None):
    args, rank, t = scan_inputs(st, cfg)
    h, d2, tt, ids = pallas_per_hypha(args, rank, t, cfg)
    pd2, ptt, pid = anast_scan_plain(*args)
    assert len(h) > 0 and int((pid.numpy()[h] < st.capacity).sum()) \
        >= min_hits
    np.testing.assert_array_equal(pd2.numpy()[h], d2)
    # (tt, id) bit-equal except where two distinct candidates tie at
    # bitwise-equal d² (a tip at the joint of a chain: the end of one
    # segment is the start of the next) and the two nestings pick
    # different ones; then the Pallas kernel's pick must be a candidate at
    # the same d² by the port's own arithmetic
    tie = pid.numpy()[h] != ids
    assert tie.sum() <= (max(2, len(h) // 100) if max_ties is None
                         else max_ties), int(tie.sum())
    np.testing.assert_array_equal(ptt.numpy()[h][~tie], tt[~tie])
    if tie.any():
        start, end = args[2], args[3]
        alt = torch.as_tensor(ids[tie]).long()
        p = end[args[0][torch.as_tensor(h[tie])].long()]
        a = start[alt]
        ab = end[alt] - a
        d2_alt, tt_alt = _dist(p, a, ab, _inv_sq_length(ab))
        np.testing.assert_array_equal(d2_alt.numpy(), d2[tie])
        np.testing.assert_array_equal(tt_alt.numpy(), tt[tie])
    # hyphae outside the tip table: no candidate
    out = np.setdiff1d(np.arange(st.tip.shape[0]), h)
    assert np.isinf(pd2.numpy()[out]).all()
    assert (pid.numpy()[out] == st.capacity).all()
    # the wrapper takes the plain version for CPU tensors
    for x, y in zip(anast_scan(*args), (pd2, ptt, pid)):
        assert torch.equal(x, y)
    return pd2, pid, h


def test_plain_scan_matches_pallas_on_grown_state():
    cfg, _, jst = grown_25()
    st = growth_state_from_jax(jax_growth_arrays(jst), cfg, "cpu")
    assert_scan_matches_pallas(st, cfg, min_hits=100)


def _fixture_state(cfg, segs, tips):
    """A port state holding the given segments: ``segs`` rows of
    (start, end, state, hypha, prev); ``tips`` the tip slot per hypha.
    The grid is empty, so the scan inserts the finalized backlog."""
    st, _ = init_state(cfg, device="cpu", draws=JaxDraws(cfg.seed))
    N, H = cfg.max_segments, cfg.max_hyphae
    start = torch.zeros((N, 3))
    end = torch.zeros((N, 3))
    state = torch.zeros(N, dtype=torch.int8)
    prev = torch.full((N,), -1, dtype=torch.int32)
    hypha = torch.full((N,), -1, dtype=torch.int32)
    for i, (a, b, s, hy, pv) in enumerate(segs):
        start[i], end[i] = torch.tensor(a), torch.tensor(b)
        state[i], hypha[i], prev[i] = s, hy, pv
    tip = torch.full((H,), -1, dtype=torch.int32)
    tip[:len(tips)] = torch.tensor(tips, dtype=torch.int32)
    return ensure_grid(st.replace(
        start=start, end=end, state=state, prev=prev, hypha=hypha, tip=tip,
        n_seg=len(segs), n_hyp=len(tips), grid=None), cfg)


def test_plain_scan_matches_pallas_across_band_boundary():
    """The reference's band-boundary fixture (tests/test_growth_ops.py:
    564-623): a tip whose corner cell is row 48, the first row of the
    Pallas kernel's second band, with its only candidate in row 47."""
    cfg = GrowthConfig(max_segments=64, max_hyphae=8, h0_per_point=2,
                       inoculum_nx=2, inoculum_ny=2)
    st = _fixture_state(cfg, [
        ([2.049, 0.0, 0.0], [2.0990, 0.0, 0.0], ACTIVE, 0, -1),
        ([2.0995, -0.025, 0.0], [2.0995, 0.025, 0.0], PASSIVE, 1, -1),
        ([2.0995, 0.025, 0.0], [2.0995, 0.075, 0.0], PASSIVE, 1, 1),
    ], tips=[0, 2])
    d2, ids, _ = assert_scan_matches_pallas(st, cfg)
    assert int(ids[0]) == 1 and float(d2[0]) < 1e-6
    out = tnb.detect_anastomosis(st, cfg)
    assert int(out.state[0]) == ANASTOMOSED
    assert abs(float(out.end[0, 0]) - 2.0995) < 1e-6
    assert abs(float(out.end[0, 1])) < 1e-6


def test_plain_scan_at_face_edge_reads_zeros():
    """Tips whose corner cell lies in row 0 and column 0 (tips that leaked
    past the walls): the (-1, ·) and (·, -1) cells are off the face and
    hold nothing, as in the Pallas kernel; the XLA path's roll would wrap
    them to row/column g-1, where a far segment sits here. One tip has a
    candidate in its own edge cell, the other none."""
    cfg = GrowthConfig(max_segments=64, max_hyphae=8, h0_per_point=2,
                       inoculum_nx=2, inoculum_ny=2)
    g = tnb.grid_dims(cfg)[0]
    far = 0.1 * (g // 2) - 0.03                 # a point of row/col g-1
    edge = -0.1 * (g // 2) + 0.01               # a point of row/col 0
    st = _fixture_state(cfg, [
        # hypha 0: active tip ending in corner cell (0, y)
        ([edge - 0.05, 0.3, 0.0], [edge, 0.3, 0.0], ACTIVE, 0, -1),
        # hypha 1: finalized segment in row 0 next to it, and its child
        ([edge + 0.0004, 0.27, 0.0], [edge + 0.0004, 0.32, 0.0],
         PASSIVE, 1, -1),
        ([edge + 0.0004, 0.32, 0.0], [edge + 0.0004, 0.37, 0.0],
         PASSIVE, 1, 1),
        # hypha 2: active tip ending in corner cell (x, 0)
        ([0.7, edge - 0.05, 0.0], [0.7, edge, 0.0], ACTIVE, 2, -1),
        # hypha 3: finalized segment at the far edge, in the row / column
        # a wrap-around window would read, and its child
        ([0.68, far, 0.0], [0.72, far, 0.0], PASSIVE, 3, -1),
        ([0.72, far, 0.0], [0.76, far, 0.0], PASSIVE, 3, 4),
        ([far, 0.28, 0.0], [far, 0.32, 0.0], PASSIVE, 4, -1),
        ([far, 0.32, 0.0], [far, 0.36, 0.0], PASSIVE, 4, 6),
    ], tips=[0, 2, 3, 5, 7])
    corner = tnb.corner_cell(st.end[[0, 3]], cfg).numpy()
    assert corner[0] // g == 0 and corner[1] % g == 0
    d2, ids, _ = assert_scan_matches_pallas(st, cfg)
    assert int(ids[0]) == 1 and float(d2[0]) < 1e-6
    assert np.isinf(float(d2[2])) and int(ids[2]) == cfg.max_segments


def test_cell_order_matches_plain_on_grown_state():
    """K4's order of work (by corner cell, the least (d², position) over
    the window's candidates laid end to end in visiting order), emulated
    on the CPU, gives the plain version's sequential strict-< answer bit
    for bit on the grown demo state."""
    cfg, _, jst = grown_25()
    st = growth_state_from_jax(jax_growth_arrays(jst), cfg, "cpu")
    args = scan_args(st, cfg)
    for a, b in zip(emulate_anast_by_cell(args), anast_scan_plain(*args)):
        assert torch.equal(a, b)


def test_cell_order_matches_plain_and_pallas_on_tie_state():
    """The tie-heavy state (duplicated segments, lattice points at bitwise
    equal distances): ties between candidates in different cells, in the
    grid and the overlay of one cell, and at different ranks of one run.
    The emulation of K4's order equals the plain version bit for bit;
    against the Pallas kernel, which nests the window the other way, d²
    is bit-equal for every tip and a differing pick is a candidate at the
    same d²."""
    cfg, st = tie_state()
    args = scan_args(st, cfg)
    ties = {}
    for a, b in zip(emulate_anast_by_cell(args, ties),
                    anast_scan_plain(*args)):
        assert torch.equal(a, b)
    assert all(ties.get(k, 0) >= 5 for k in ("cell", "source", "rank")), \
        ties
    assert_scan_matches_pallas(st, cfg, min_hits=100, max_ties=len(st.tip))


def _jax_state_of(st, jcfg):
    """The JAX package's GrowthState holding a port state's segments and
    tips, with an empty persistent grid (the scan inserts the backlog)."""
    from mycelium_tpu.growth import state as jstate
    jst, _ = jstate.init_state(jcfg)
    j = lambda t: jnp.asarray(t.numpy())               # noqa: E731
    return jstate.ensure_grid(jst._replace(
        start=j(st.start), end=j(st.end), state=j(st.state),
        prev=j(st.prev), hypha=j(st.hypha), tip=j(st.tip),
        n_seg=jnp.asarray(st.n_seg, jnp.int32),
        n_hyp=jnp.asarray(st.n_hyp, jnp.int32), grid=None), jcfg)


def test_tie_state_matches_jax_xla_scan(monkeypatch):
    """The JAX package's XLA scan (``detect_anastomosis`` with the Pallas
    kernel off), whose visiting order the plain version reproduces, on the
    tie-heavy state, with the widest tolerance its 2x2 corner window
    allows ((h0 + tol)/2 + tol <= voxel/2), so every tip within a lattice
    step of a candidate snaps. The snapped ends and states equal the
    port's, which snaps each such tip to the plain version's (id, tt) pick;
    many of those tips have a rival candidate at the same d² whose
    projection lies elsewhere, so another pick would show in the ends."""
    cfg, st = tie_state()
    # the JAX package's grid strategy, which the port always runs
    cfg = dataclasses.replace(cfg, anastomosis_tol=0.016,
                              grid_incremental=True)
    assert (cfg.h0 + 0.016) / 2 + 0.016 <= cfg.voxel_size / 2
    jcfg = JGrowthConfig(**dataclasses.asdict(cfg))
    out_j = _jax_detect(_jax_state_of(st, jcfg), jcfg, "off", monkeypatch)
    out_t = tnb.detect_anastomosis(st, cfg)
    np.testing.assert_array_equal(out_t.end.numpy(), np.asarray(out_j.end))
    np.testing.assert_array_equal(out_t.state.numpy(),
                                  np.asarray(out_j.state))
    assert bool(out_t.overflow) == bool(out_j.overflow)
    # the plain version's picks behind the port's snaps, and their rivals
    args = scan_args(st, cfg)
    d2, tt, ids = anast_scan_plain(*args)
    h = torch.nonzero(args[1] >= 0).flatten()
    snapped = h[torch.sqrt(d2[h]) <= cfg.anastomosis_tol]
    t = st.tip[snapped].long()
    assert len(snapped) >= 100
    assert bool((out_t.state[t] == ANASTOMOSED).all())
    n = st.n_seg
    a, ab = st.start[:n], st.end[:n] - st.start[:n]
    p = st.end[t][:, None, :]
    dd, tp = _dist(p, a[None], ab[None], _inv_sq_length(ab)[None])
    dd[torch.arange(len(t)), t] = torch.inf          # a tip's own segment
    best = dd == d2[snapped][:, None]
    assert bool(best.any(1).all())
    proj = a[None] + tp[..., None] * ab[None]
    rivals = sum(int(len(torch.unique(proj[i][best[i]], dim=0)) > 1)
                 for i in range(len(t)))
    assert rivals >= 10, rivals
