"""Growth operators (port of ``mycelium_tpu/growth/ops.py``): substrate
translocation, tip growth and branching, cuboid uptake, wall enforcement.

Each is a masked update over the fixed-capacity state, with the reference
semantics and the deviations documented in the JAX module: translocation
applies all deltas at once and clamps once; uptake drains E through the
segments in slot order with an epsilon floor (``UPTAKE_E_FLOOR``).

Differences in form, not in result:
- The operators work on the occupied prefix [0, n_seg) of the slot arrays
  (``n_seg`` is a host integer, read once per step by ``grow``).
  ``translocate`` takes that prefix in one pass: the JAX package's 2^16-row
  chunks, and with them the unclamped last-chunk start of fault C2
  (mycelium_tpu/growth/ops.py:72-113), do not exist here.
- JAX's ``mode="drop"`` scatters pad the target by one row that takes the
  dropped writes and is sliced off (``scatter_drop``).
- ``uptake`` keeps the regime loop of the JAX ``while_loop``: one host
  sync per iteration for its condition.
"""

from __future__ import annotations

import torch

from ..config import GrowthConfig
from .draws import StepDraws
from .state import (ACTIVE, EMPTY, PASSIVE, EnvArrays, GrowthState, const,
                    direction_from_angles, fma, norm3, norm3_fused,
                    perturb)

UPTAKE_E_FLOOR = 1e-18  # mol; negligible vs the 5e-6 Omega0 budget


def scatter_drop(arr, idx, vals):
    """``arr[idx] = vals`` out of place, dropping the rows whose index is
    ``len(arr)`` (JAX's ``.at[idx].set(vals, mode="drop")``). Kept indices
    must be distinct."""
    n = arr.shape[0]
    out = torch.cat([arr, arr.new_zeros((1,) + tuple(arr.shape[1:]))])
    out.index_copy_(0, idx.long(), vals.to(arr.dtype))
    return out[:n]


def _at(x, i):
    """x[i] for a 0-dim index tensor, as a 0-dim tensor, without reading
    the index back to the host."""
    return x.index_select(0, i.reshape(1))[0]


def translocate(st: GrowthState, cfg: GrowthConfig) -> GrowthState:
    """Diffusive exchange between predecessor and successor segments,
    clamped so both stay in [0, M_cap] (mycelium_sim_2D.py:275-310). The
    clamp adjusts the transferred delta itself, testing bounds in the
    reference's elif order. One pass over the occupied prefix: every read
    uses the original sub, each slot receives at most one +delta (itself)
    and one -delta (its unique extension child), then one clamp."""
    n = st.n_seg
    prev = st.prev[:n].long()
    sub_c = st.sub[:n]
    L = norm3(st.end[:n] - st.start[:n])
    valid = (prev >= 0) & (st.state[:n] != EMPTY)
    p = prev.clamp(min=0)
    adj, ok = exchange(sub_c, sub_c[p], L, L[p], valid, cfg)
    acc = st.sub.clone()
    acc[:n] = sub_c + adj
    acc.index_add_(0, p, torch.where(ok, -adj, torch.zeros_like(adj)))
    return st.replace(sub=acc.clamp(0.0, cfg.m_cap))


def exchange(sub_c, sub_p, L, lp, valid, cfg: GrowthConfig):
    """``translocate``'s transfer between each slot (substrate ``sub_c``,
    length ``L``) and its parent (``sub_p``, ``lp``): (adj, ok), the
    clamped amount the slot gains and its parent loses (0 where not
    ``ok``), and where the exchange applies."""
    m_cap = const(cfg.m_cap, sub_c)
    scale = const(cfg.dt * cfg.diffusion, sub_c)
    denom = (L + lp) / 2.0
    ok = valid & (denom > 0)
    denom_safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    delta = scale * (sub_p - sub_c) / denom_safe
    new_s = sub_c + delta
    new_p = sub_p - delta
    # the reference's elif chain (order matters)
    adj = torch.where(
        new_s < 0, -sub_c,
        torch.where(new_s > m_cap, m_cap - sub_c,
                    torch.where(new_p < 0, sub_p,
                                torch.where(new_p > m_cap, m_cap - sub_p,
                                            delta))))
    return torch.where(ok, adj, torch.zeros_like(adj)), ok


def grow(st: GrowthState, cfg: GrowthConfig, draws: StepDraws,
         out: GrowthState | None = None, put=scatter_drop) -> GrowthState:
    """Apical extension and branching (mycelium_sim_2D.py:388-460).

    Per active tip with enough substrate (I·L >= c_g·h0): spend the growth
    cost, turn the tip passive, and append a new active segment continuing
    in a perturbed direction; with probability p_branch (and 2x the cost
    available) also spawn a branch child as a new hypha. Both new segments
    receive half the parent's post-cost concentration (substrate is not
    conserved here, faithfully to the reference). Extensions take the
    slots [n_seg, n_seg + n_ext), children the ones after. Reads the new
    counts back to the host: one sync.

    ``st`` is what is read. The slot arrays written are ``out``'s (default
    ``st``'s), through ``put(array, slots, values)`` (default
    ``scatter_drop``): the sharded step reads the gathered slots and
    writes its rank's block (``growth/shard.py``)."""
    N, H = st.capacity, st.tip.shape[0]
    dev = st.device
    i32 = torch.int32
    hyp_ids = torch.arange(H, dtype=i32, device=dev)
    tip_slot = st.tip
    hyp_valid = (hyp_ids < st.n_hyp) & (tip_slot >= 0)
    t = tip_slot.clamp(min=0).long()
    tip_start = st.start[t]
    tip_end = st.end[t]
    tip_theta = st.theta[t]
    tip_phi = st.phi[t]
    tip_sub = st.sub[t]
    tip_state = torch.where(hyp_valid, st.state[t],
                            torch.zeros_like(st.state[t]))
    L_tip = norm3_fused(tip_end - tip_start)
    avail = tip_sub * L_tip
    cost = const(cfg.c_g * cfg.h0, avail)
    cost2 = const(2 * (cfg.c_g * cfg.h0), avail)
    can_grow = (tip_state == ACTIVE) & (avail >= cost)
    do_branch = can_grow & (draws.branch < const(cfg.p_branch, avail)) \
        & (avail >= cost2)

    ext_off = torch.cumsum(can_grow.to(i32), 0, dtype=i32) - can_grow.to(i32)
    child_off = torch.cumsum(do_branch.to(i32), 0, dtype=i32) \
        - do_branch.to(i32)
    n_new = torch.stack([can_grow.sum(), do_branch.sum()])
    n_ext_t = n_new[0].to(i32)
    ext_slot = st.n_seg + ext_off
    child_slot = st.n_seg + n_ext_t + child_off
    child_hyp = st.n_hyp + child_off
    valid_ext = can_grow & (ext_slot < N)
    valid_child = do_branch & (child_slot < N) & (child_hyp < H)

    total_cost = torch.where(do_branch, cost2, cost)
    L_safe = torch.where(L_tip > 0, L_tip, torch.ones_like(L_tip))
    tip_sub_new = torch.clamp(avail - total_cost, min=0.0) / L_safe
    child_sub = 0.5 * tip_sub_new

    # new directions: 2D perturbs phi and pins theta to pi/2, 3D perturbs
    # both (one stream of uniforms for extensions, one for children)
    ph_e = perturb(draws.ext, tip_phi, cfg)
    ph_c = perturb(draws.child, tip_phi, cfg)
    if cfg.three_d:
        th_e = perturb(draws.ext_theta, tip_theta, cfg)
        th_c = perturb(draws.child_theta, tip_theta, cfg)
    else:
        th_e = th_c = torch.full_like(ph_e, torch.pi / 2)
    h0 = const(cfg.h0, avail)
    end_e = fma(direction_from_angles(th_e, ph_e, cfg.three_d), h0, tip_end)
    end_c = fma(direction_from_angles(th_c, ph_c, cfg.three_d), h0, tip_end)

    drop = torch.full_like(t, N)
    ext_idx = torch.where(valid_ext, ext_slot.long(), drop)
    child_idx = torch.where(valid_child, child_slot.long(), drop)
    tip_idx = torch.where(valid_ext, t, drop)
    new_idx = torch.cat([ext_idx, child_idx])
    both = torch.cat

    out = st if out is None else out
    start = put(out.start, new_idx, both([tip_end, tip_end]))
    end = put(out.end, new_idx, both([end_e, end_c]))
    theta = put(out.theta, new_idx, both([th_e, th_c]))
    phi = put(out.phi, new_idx, both([ph_e, ph_c]))
    sub = put(out.sub, both([tip_idx, new_idx]),
              both([tip_sub_new, child_sub, child_sub]))
    state = put(
        out.state, both([tip_idx, new_idx]),
        both([torch.full_like(t, PASSIVE), torch.full_like(new_idx, ACTIVE)]))
    prev = put(out.prev, new_idx,
               both([tip_slot, torch.full_like(tip_slot, -1)]))
    hypha = put(out.hypha, new_idx, both([hyp_ids, child_hyp]))
    tip = torch.where(valid_ext, ext_slot, st.tip)
    tip = scatter_drop(tip, torch.where(valid_child,
                                        (st.n_hyp + child_off).long(),
                                        torch.full_like(t, H)), child_slot)

    n_ext, n_child = n_new.tolist()          # the step's count sync
    overflow = (st.n_seg + n_ext + n_child > N) or (st.n_hyp + n_child > H)
    return out.replace(
        start=start, end=end, theta=theta, phi=phi, sub=sub, state=state,
        prev=prev, hypha=hypha, tip=tip,
        n_seg=min(st.n_seg + n_ext + n_child, N),
        n_hyp=min(st.n_hyp + n_child, H),
        overflow=st.overflow | overflow)


def _contains(center, size, p, eps=1e-12):
    """Axis-aligned cuboid point test with the reference's 1e-12 slack
    (mycelium_sim_2D.py:163-166). center/size: (3,), p: (...,3)."""
    lo = center - 0.5 * size - eps
    hi = center + 0.5 * size + eps
    return ((p >= lo) & (p <= hi)).all(dim=-1)


def uptake_loop(st: GrowthState, env: EnvArrays,
                cfg: GrowthConfig) -> GrowthState:
    """Literal sequential drain, one slot at a time (the reference's exact
    traversal, mycelium_sim_2D.py:315-338): the oracle of ``uptake``,
    for tests only (one host sync per slot)."""
    m_cap = const(cfg.m_cap, st.sub)
    floor = const(UPTAKE_E_FLOOR, st.sub)
    sub = st.sub.clone()
    env_e = st.env_e.clone()
    for c in range(env.sub_center.shape[0]):
        mu = env.sub_mu[c]
        in_c = _contains(env.sub_center[c], env.sub_size[c], st.end) & \
            (st.state != EMPTY)
        e = env_e[c]
        for i in range(st.n_seg):
            if not bool(e > floor):
                break
            si = sub[i]
            theta = cfg.dt * mu * e * si
            theta = torch.clamp(torch.minimum(theta, torch.minimum(
                m_cap - si, e)), min=0.0)
            theta = torch.where(in_c[i], theta, torch.zeros_like(theta))
            e = e - theta
            sub[i] = si + theta
        env_e[c] = e
    return st.replace(sub=sub, env_e=env_e)


def uptake(st: GrowthState, env: EnvArrays, cfg: GrowthConfig,
           syncs=None) -> GrowthState:
    """Run-parallel sequential drain (same semantics as ``uptake_loop``).

    Per segment the drain is one of three affine maps of E: A (no clamp,
    E -> (1 - dt·mu·s)·E), B (cap clamp, E -> E - (m_cap - s)), C
    (exhaustion). Each loop iteration commits one maximal A-run (a masked
    cumprod), then one maximal B-run (a masked cumsum), then, only if
    neither advanced, one scalar element; the loop runs a handful of
    times, not once per segment. Segments already at m_cap are exact
    no-ops and are excluded up front. The loop condition is read on the
    host once per iteration (``syncs.reads`` counts them when given)."""
    dtype = st.sub.dtype
    dev = st.device
    n = st.n_seg
    m_cap = const(cfg.m_cap, st.sub)
    floor = const(UPTAKE_E_FLOOR, st.sub)
    zero = const(0.0, st.sub)
    one = const(1.0, st.sub)
    idx = torch.arange(n, device=dev)
    sub = st.sub.clone()
    env_e = st.env_e.clone()
    for c in range(env.sub_center.shape[0]):
        mu = env.sub_mu[c]
        s = sub[:n]
        elig = _contains(env.sub_center[c], env.sub_size[c], st.end[:n]) \
            & (st.state[:n] != EMPTY) & (s < m_cap)
        pos = torch.zeros((), dtype=torch.int64, device=dev)
        e = env_e[c]
        while True:
            if syncs is not None:
                syncs.reads += 1
            if not bool((pos < n) & (e > floor)):
                break
            live = (idx >= pos) & elig
            a = torch.where(live, cfg.dt * mu * s, zero)
            cap = torch.clamp(m_cap - s, min=0.0)

            # regime-A run: E_i = e * prod_{j<i}(1 - a_j)
            f = torch.where(live, 1.0 - a, one)
            cp = torch.cumprod(f, 0)
            p_excl = torch.cat([one.reshape(1), cp[:-1]])
            e_a = e * p_excl
            th_a = a * e_a
            viol = live & ((a >= 1.0) | (th_a > cap) | (e_a <= floor))
            v1 = torch.where(viol.any(), torch.argmax(viol.to(torch.uint8)),
                             n)
            commit_a = live & (idx < v1)
            s = s + torch.where(commit_a, th_a, zero)
            e1 = e * torch.where(v1 < n, _at(p_excl, v1.clamp(max=n - 1)),
                                 cp[-1])

            # regime-B run from v1: theta_i = cap_i (saturation)
            live_b = (idx >= v1) & elig
            cap_b = torch.where(live_b, cap, zero)
            s_excl = torch.cat([zero.reshape(1), torch.cumsum(cap_b, 0)[:-1]])
            e_b = e1 - s_excl
            ok_b = e1 > floor
            bind = live_b & ok_b & (cap <= a * e_b) & (cap <= e_b) \
                & (e_b > floor)
            stop = live_b & ~bind
            w = torch.where(stop.any(), torch.argmax(stop.to(torch.uint8)),
                            n)
            commit_b = live_b & bind & (idx < w)
            s = torch.where(commit_b, m_cap, s)
            e2 = e1 - torch.where(commit_b, cap_b, zero).sum()

            # scalar fallback: one stuck element at w == pos
            stuck = (w == pos) & (w < n) & ok_b & (e2 > floor)
            wc = w.clamp(max=n - 1)
            sw = _at(s, wc)
            aw = cfg.dt * mu * sw
            th_w = torch.clamp(torch.minimum(aw * e2, torch.minimum(
                torch.clamp(m_cap - sw, min=0.0), e2)), min=0.0)
            th_w = torch.where(stuck & _at(elig, wc), th_w, zero)
            s = s.index_add(0, wc.reshape(1),
                            torch.where(stuck, th_w, zero).reshape(1))
            e = e2 - th_w
            pos = torch.where(stuck, w + 1, torch.maximum(w, v1))
        sub[:n] = s
        env_e[c] = e
    return st.replace(sub=sub, env_e=env_e)


def enforce_walls(st: GrowthState, env: EnvArrays, cfg: GrowthConfig,
                  draws: StepDraws, out: GrowthState | None = None,
                  put=scatter_drop) -> GrowthState:
    """Project tips penetrating impenetrable cuboids tangentially along the
    wall face, up to 3 sweeps for corners (mycelium_sim_2D.py:340-383).
    Applies to the last segment of every hypha regardless of state and
    reactivates projected tips ('A'), both faithful reference quirks. The
    sweeps' random fallback directions come from ``draws.wall_rnd`` /
    ``draws.wall_tan``. ``out`` and ``put`` as in ``grow``."""
    H, N = st.tip.shape[0], st.capacity
    W = env.wall_center.shape[0]
    out = st if out is None else out
    if W == 0:
        return out
    dev = st.device
    hyp_valid = (torch.arange(H, device=dev) < st.n_hyp) & (st.tip >= 0)
    t = st.tip.clamp(min=0).long()
    start = st.start[t]
    end = st.end[t]
    length = norm3_fused(end - start)
    touched = torch.zeros((H,), dtype=torch.bool, device=dev)
    small = const(1e-12, start)

    for it in range(3):                       # reference max_iter=3
        inside = torch.stack([_contains(env.wall_center[w], env.wall_size[w],
                                        end) for w in range(W)], dim=1)
        pen = inside.any(dim=1) & hyp_valid
        w_first = torch.argmax(inside.to(torch.uint8), dim=1)
        c = env.wall_center[w_first]
        half = env.wall_size[w_first] / 2.0
        delta = end - c
        overlap = delta.abs() - half
        face = torch.argmax(overlap, dim=1)
        ohf = torch.nn.functional.one_hot(face, 3).to(start.dtype)
        normal = ohf * torch.sign(
            (delta * ohf).sum(dim=1, keepdim=True))
        d = end - start
        dn = norm3_fused(d)[:, None]
        d = torch.where(dn < small, draws.wall_rnd[it], d)
        d = d / norm3_fused(d)[:, None]
        dot = fma(d[:, 2], normal[:, 2], fma(d[:, 1], normal[:, 1],
                                             d[:, 0] * normal[:, 0]))
        slide = fma(-dot[:, None], normal, d)
        sn = norm3_fused(slide)[:, None]
        tan = draws.wall_tan[it] * (1.0 - normal.abs())
        slide = torch.where(sn < small, tan, slide)
        slide = slide / norm3_fused(slide)[:, None]
        new_end = fma(slide, length[:, None], start)
        end = torch.where(pen[:, None], new_end, end)
        touched = touched | pen

    dirv = end - start
    dn = torch.clamp(norm3_fused(dirv), min=1e-30)
    new_theta = torch.arccos(torch.clamp(dirv[:, 2] / dn, -1.0, 1.0))
    new_phi = torch.atan2(dirv[:, 1], dirv[:, 0])

    idx = torch.where(touched, t, torch.full_like(t, N))
    return out.replace(
        end=put(out.end, idx, end),
        theta=put(out.theta, idx, new_theta),
        phi=put(out.phi, idx, new_phi),
        state=put(out.state, idx, torch.full_like(idx, ACTIVE)))
