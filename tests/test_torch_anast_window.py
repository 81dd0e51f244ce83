"""The anastomosis scan's wider layouts: the 9-cell window (a tip's reach
(h0 + tol)/2 + tol above voxel/2) and 3D grids (gz > 1), which the JAX
package runs through its XLA grid scan (``grid_incremental=True``; its
Pallas kernel takes the 2D corner window only).

- The 2D growth trajectory at voxel_size 0.05 (reach 0.0265 > 0.025, so
  the 9-cell window) against the JAX package's, every step, with the
  reference's draws replayed (float64: integer fields equal, float fields
  within 1e-10 of each field's largest magnitude, as
  tests/test_torch_growth.py holds 2D).
- K4's plain version against the XLA scan on three states: a grown 3D
  state, a grown 9-cell state and the 3D tie-heavy state
  (``torch_support.tie_state_3d``); the snapped ends and states equal
  (tolerance 0). The XLA scan's ``jnp.roll`` wraps at the face's edges
  where K4 reads empty cells, so no tip of these states may lie in the
  first or last row or column of the face.
- On the tie-heavy state, tips with candidates at bitwise-equal d² in
  different z cells of one column: the position order rank·gz + cz picks
  what the XLA scan picks, and a z-major order would not.
- K4's order of work (by cell, the least (d², key) over runs loaded cell
  by cell), emulated on the CPU, equals the plain version bit for bit on
  every layout.
- A 2D trajectory whose tip table holds more than 32 tips in a cell (K4
  takes them in groups of 32) against the JAX package's, every step.
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
from mycelium_tpu.growth import state as jstate
from mycelium_tpu.growth.step import run_growth as jrun_growth
from mycelium_tpu_torch.config import GrowthConfig, growth_3d_config
from mycelium_tpu_torch.convert import (growth_state_from_jax,
                                        jax_growth_arrays)
from mycelium_tpu_torch.growth import neighbors as tnb
from mycelium_tpu_torch.growth import run_growth
from mycelium_tpu_torch.growth.state import ANASTOMOSED
from mycelium_tpu_torch.kernels.anast import (_dist, _inv_sq_length,
                                              anast_scan, anast_scan_plain)
from tests.torch_support import (JaxDraws, emulate_anast_by_cell,
                                 scan_args, tie_state_3d)

INT_FIELDS = ("state", "prev", "hypha", "tip")
FLOAT_FIELDS = ("start", "end", "theta", "phi", "sub", "env_e")
STEPS = 40
CFG9 = GrowthConfig(t_steps=STEPS, max_segments=1 << 12, max_hyphae=1 << 11,
                    dtype="float64", dish_size=3.0, substrate_width=3.0,
                    voxel_size=0.05)
TOL_TIE = 0.016     # the widest tolerance of the 2x2 corner window


def _fields(st):
    out = {f: np.array(np.asarray(getattr(st, f)))
           for f in INT_FIELDS + FLOAT_FIELDS}
    out["n_seg"] = int(np.asarray(st.n_seg))
    out["n_hyp"] = int(np.asarray(st.n_hyp))
    out["overflow"] = bool(np.asarray(st.overflow))
    return out


_CACHE = {}


def trajectories9():
    if "runs" not in _CACHE:
        jcfg = JGrowthConfig(**dataclasses.asdict(
            dataclasses.replace(CFG9, grid_incremental=True)))
        ref, port = [], []
        _, _, jhist = jrun_growth(
            jcfg, on_step=lambda t, st: ref.append(_fields(st)))
        _, _, hist = run_growth(CFG9, device="cpu", draws=JaxDraws(CFG9.seed),
                                on_step=lambda t, s: port.append(_fields(s)))
        _CACHE["runs"] = (ref, port, jhist, hist)
    return _CACHE["runs"]


def test_layouts():
    """The window follows the reach bound; 3D grids have gz > 1."""
    assert tnb.check_layout(GrowthConfig()) == (54, 1, 4)
    assert tnb.check_layout(CFG9) == (64, 1, 9)
    assert tnb.check_layout(GrowthConfig(voxel_size=0.05)) == (104, 1, 9)
    assert tnb.check_layout(growth_3d_config()) == (54, 5, 4)
    assert tnb.check_layout(growth_3d_config(voxel_size=0.05)) == (104, 7, 9)
    # K4 takes a cell's tips in groups of 32: any count a cell is a layout
    assert tnb.check_layout(GrowthConfig(max_tips_per_cell=33)) == (54, 1, 4)
    assert tnb.check_layout(GrowthConfig(max_tips_per_cell=48)) == (54, 1, 4)


# More than 32 tips in one cell of the tip table: 40 hyphae from one
# inoculum point, whose tips stay within one corner cell of 0.3 mm for the
# first two steps (branching cut to 0.1, so that the table of 48 holds
# them all and nothing is dropped).
CFG_P11 = GrowthConfig(t_steps=2, dtype="float64", h0_per_point=40,
                       p_branch=0.1, inoculum_nx=1, inoculum_ny=1,
                       voxel_size=0.3, max_tips_per_cell=48, max_per_cell=256,
                       dish_size=3.0, substrate_width=3.0,
                       max_segments=1 << 11, max_hyphae=1 << 10)


def test_more_than_32_tips_a_cell_match_reference_every_step():
    """P11: the port grows a configuration whose tip table holds more than
    32 tips in one cell (the plain scan; K4 takes them in groups of 32 on
    the card) step by step as the JAX package does, integer fields equal
    and float fields within 1e-10 of each field's largest magnitude."""
    from mycelium_tpu_torch.growth.state import init_state
    from mycelium_tpu_torch.growth.step import growth_step
    cfg = CFG_P11
    most = []

    def scan(*args):
        most.append(int(args[13][2].max()))       # the table's fullest cell
        return anast_scan_plain(*args)

    draws = JaxDraws(cfg.seed)
    st, ea = init_state(cfg, device="cpu", draws=draws)
    port = []
    for _ in range(cfg.t_steps):
        st = growth_step(st, ea, cfg, draws.step(cfg.max_hyphae,
                                                 torch.float64, True, False),
                         scan=scan)
        port.append(_fields(st))
    ref = []
    jcfg = JGrowthConfig(**dataclasses.asdict(
        dataclasses.replace(cfg, grid_incremental=True)))
    jrun_growth(jcfg, on_step=lambda t, s: ref.append(_fields(s)))
    assert len(ref) == len(port) == cfg.t_steps
    assert min(most) > 32, most
    snapped = []
    for t, (j, s) in enumerate(zip(ref, port)):
        for f in INT_FIELDS + ("n_seg", "n_hyp", "overflow"):
            np.testing.assert_array_equal(s[f], j[f],
                                          err_msg=f"step {t} field {f}")
        for f in FLOAT_FIELDS:
            scale = max(np.abs(j[f]).max(), 1e-300)
            err = np.abs(s[f] - j[f]).max()
            assert err <= 1e-10 * scale, (t, f, err / scale)
        assert not s["overflow"]
        snapped.append(int((s["state"] == ANASTOMOSED).sum()))
    # tips snap in each step, so the scan's winners decide the trajectory
    assert 0 < snapped[0] < snapped[1], snapped


def test_9cell_run_growth_matches_reference_every_step():
    ref, port, _, _ = trajectories9()
    assert len(ref) == len(port) == STEPS
    for t, (j, s) in enumerate(zip(ref, port)):
        for f in INT_FIELDS + ("n_seg", "n_hyp", "overflow"):
            np.testing.assert_array_equal(s[f], j[f],
                                          err_msg=f"step {t} field {f}")
        for f in FLOAT_FIELDS:
            scale = max(np.abs(j[f]).max(), 1e-300)
            err = np.abs(s[f] - j[f]).max()
            assert err <= 1e-10 * scale, (t, f, err / scale)
    final = ref[-1]
    assert (final["state"] == ANASTOMOSED).sum() >= 1, "no snap"
    assert final["n_seg"] > 1000 and not final["overflow"]


def test_9cell_run_growth_history_matches_reference():
    _, _, jhist, hist = trajectories9()
    for t, (a, b) in enumerate(zip(hist, jhist)):
        for k in a:
            if k == "total_length_mm":
                assert abs(a[k] - b[k]) <= 1e-10 * abs(b[k]), (t, k)
            else:
                assert a[k] == b[k], (t, k, a[k], b[k])


def _grown(jcfg):
    """A float32 state of ``jcfg`` grown by the JAX package with its
    persistent grid, taken on through the next step's translocate and
    grow, so that the anastomosis query sees fresh tips."""
    st, _, _ = jrun_growth(jcfg)
    key, k_grow = jax.random.split(st.key)
    st = jax.jit(jops.translocate, static_argnums=1)(st._replace(key=key),
                                                      jcfg)
    return jax.jit(jops.grow, static_argnums=1)(st, jcfg, k_grow)


def _jax_state_of(st, jcfg):
    """The JAX package's state holding a port state's segments and tips,
    with an empty persistent grid (the scan inserts the backlog)."""
    jst, _ = jstate.init_state(jcfg)
    j = lambda t: jnp.asarray(t.numpy())               # noqa: E731
    return jstate.ensure_grid(jst._replace(
        start=j(st.start), end=j(st.end), state=j(st.state),
        prev=j(st.prev), hypha=j(st.hypha), tip=j(st.tip),
        n_seg=jnp.asarray(st.n_seg, jnp.int32),
        n_hyp=jnp.asarray(st.n_hyp, jnp.int32), grid=None), jcfg)


def state(name):
    """(port cfg, JAX cfg, port state, JAX state) of one of the three
    states."""
    if name not in _CACHE:
        if name == "tie3d":
            cfg, st = tie_state_3d()
            cfg = dataclasses.replace(cfg, anastomosis_tol=TOL_TIE,
                                      grid_incremental=True)
            jcfg = JGrowthConfig(**dataclasses.asdict(cfg))
            jst = _jax_state_of(st, jcfg)
        else:
            cfg = (growth_3d_config(t_steps=25) if name == "grown3d" else
                   GrowthConfig(t_steps=30, voxel_size=0.05))
            cfg = dataclasses.replace(cfg, grid_incremental=True)
            jcfg = JGrowthConfig(**dataclasses.asdict(cfg))
            jst = _grown(jcfg)
            st = growth_state_from_jax(jax_growth_arrays(jst), cfg, "cpu")
        _CACHE[name] = (cfg, jcfg, st, jst)
    return _CACHE[name]


STATES = ["grown3d", "grown9", "tie3d"]


@pytest.mark.parametrize("name", STATES)
def test_plain_scan_snaps_as_the_xla_scan(name, monkeypatch):
    cfg, jcfg, st, jst = state(name)
    monkeypatch.setenv("MYC_ANAST_KERNEL", "off")
    out_j = jax.jit(lambda s: jnb.detect_anastomosis(s, jcfg))(jst)
    out_t = tnb.detect_anastomosis(st, cfg)
    # no tip on the face's edge, where the XLA scan's roll wraps around
    g, gz, window = tnb.check_layout(cfg)
    args = scan_args(st, cfg)
    col = args[1][args[1] >= 0].long() // gz
    assert int((args[1] >= 0).sum()) >= 100
    for c in (col // g, col % g):
        assert int(c.min()) > 0 and int(c.max()) < g - 1
    assert (gz, window) == {"grown3d": (5, 4), "grown9": (1, 9),
                            "tie3d": (5, 4)}[name]
    np.testing.assert_array_equal(out_t.end.numpy(), np.asarray(out_j.end))
    np.testing.assert_array_equal(out_t.state.numpy(),
                                  np.asarray(out_j.state))
    assert bool(out_t.overflow) == bool(out_j.overflow) is False
    assert int((out_t.state == ANASTOMOSED).sum()) \
        > int((st.state == ANASTOMOSED).sum())


@pytest.mark.parametrize("name", STATES + ["grown3d9"])
def test_cell_order_matches_plain(name):
    """K4's order of work, emulated, equals the plain scan bit for bit;
    the wrapper takes the plain version for CPU tensors."""
    if name == "grown3d9":
        cfg = growth_3d_config(t_steps=20, voxel_size=0.05)
        st, _, _ = run_growth(cfg, device="cpu")
    else:
        cfg, _, st, _ = state(name)
    args = scan_args(st, cfg)
    plain = anast_scan_plain(*args)
    assert int((plain[2] < st.capacity).sum()) >= 100
    for a, b, c in zip(emulate_anast_by_cell(args), plain,
                       anast_scan(*args)):
        assert torch.equal(a, b) and torch.equal(b, c)


def test_tie_state_3d_takes_rank_major_positions():
    """On the 3D tie-heavy state many tips have their least d² at
    candidates in different z cells of one column. The plain scan's
    position order, rank·gz + cz, is the XLA scan's (the snaps above are
    equal); ordering a column z cell first (z-major) picks another
    candidate for some tips, with another projection, so the snaps would
    differ."""
    cfg, _, st, _ = state("tie3d")
    args = scan_args(st, cfg)
    ties = {}
    d2, tt, ids = emulate_anast_by_cell(args, ties)
    assert ties.get("z", 0) >= 20, ties
    zd2, ztt, zids = emulate_anast_by_cell(args, z_major=True)
    assert torch.equal(zd2, d2)
    snapped = torch.sqrt(d2) <= cfg.anastomosis_tol
    moved = snapped & (zids != ids)
    h = torch.nonzero(moved).flatten()
    assert len(h) >= 5, len(h)
    p = st.end[st.tip[h].long()]

    def proj(i, t):
        a = st.start[i.long()]
        return a + t[:, None] * (st.end[i.long()] - a)

    assert int((proj(ids[h], tt[h]) != proj(zids[h], ztt[h])).any(1).sum()) \
        >= 5
    # both picks are at the tip's least distance by the scan's arithmetic
    for i in (ids[h], zids[h]):
        a = st.start[i.long()]
        ab = st.end[i.long()] - a
        dd, _ = _dist(p, a, ab, _inv_sq_length(ab))
        assert torch.equal(dd, d2[h])
