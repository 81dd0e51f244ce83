"""Growth over the ranks of a process group: the counterpart of the JAX
package's GSPMD growth (``growth_step`` with the segment-slot arrays placed
``P("shard")`` and everything else ``P()``, tests/test_shard.py:219-260),
one process a rank, ``torch.distributed`` in place of GSPMD.

Placement. The arrays whose leading axis is the segment capacity N
(start, end, theta, phi, sub, state, prev, hypha) live in rank blocks:
rank r holds slots [r·B, (r + 1)·B), B = ceil(N / ranks); where N does not
divide by the rank count, the last block is padded with empty slots that
no operator reads or writes. The hypha rows (tip), the persistent
anastomosis grid, the environment, the nutrient E and the host counts
are replicated: every rank holds and computes the same.

Exchange. Every read across slots is an ``all_gather_into_tensor`` of the
ranks' blocks into the full array (sliced back to N rows); every write
lands only in the rank's own block:

- ``translocate`` computes each slot of the block from its parent's length
  and substrate (gathered), and adds the parents' shares, gathered with
  their targets, into the block in slot order;
- ``grow``, the anastomosis snaps and the walls work per hypha: they read
  the tips' slots from the gathered arrays and write the appends at n_seg
  + rank (and the tips' own slots) into the block that holds each;
- ``grid_insert_finalized`` and K4 read the gathered start, end, state and
  prev: every rank inserts the same finalized segments into its copy of
  the grid and runs K4 on the same tip table against it, one launch a
  step;
- ``uptake``'s cumulative products and sums run over the gathered
  substrate, ends and states;
- the step's stats sum the gathered per-slot terms.

Bit-equality. Every sum adds its terms in the single-device order: the
terms are gathered and summed in one fixed order, never as partial sums by
rank. The draws are the single-device draws (``growth/draws.py``), taken
the same on every rank, and the host counts come out of the same gathered
numbers on every rank. So a run on any number of ranks equals
``run_growth`` on one device in every field, bit for bit (the JAX package
allows itself rtol 1e-4 on sub and env_e because GSPMD reassociates).

The JAX CLI has no sharded growth (``--distributed grow`` replicates it),
so neither has the port's.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..config import GrowthConfig
from ..devices import DEFAULT_DEVICE, resolve
from ..fea.shard import _collective
from ..scenes import Environment, petri_dish
from .draws import TorchDraws
from .neighbors import detect_anastomosis
from .ops import enforce_walls, exchange, grow, scatter_drop, uptake
from .state import EMPTY, EnvArrays, GrowthState, init_state, norm3
from .step import StepSyncs, alive_lengths, history_rows, stats_vector

# the slot arrays and the fill of a slot no hypha holds
SLOT_FIELDS = {"start": 0.0, "end": 0.0, "theta": 0.0, "phi": 0.0,
               "sub": 0.0, "state": EMPTY, "prev": -1, "hypha": -1}


class SlotBlocks:
    """The segment slots' split over the ranks of ``group``: this rank's
    block is slots [lo, lo + B) of the capacity N padded to ranks·B."""

    def __init__(self, capacity: int, group=None):
        if not dist.is_initialized():
            raise RuntimeError("sharded growth needs a process group "
                               "(utils.dist.initialize_distributed or "
                               "initialize_single)")
        self.group = group
        self.ranks = dist.get_world_size(group)
        self.N = capacity
        self.B = -(-capacity // self.ranks)
        self.lo = dist.get_rank(group) * self.B

    def local(self, x, fill=0):
        """This rank's block of a full (N, ...) array."""
        pad = self.ranks * self.B - self.N
        if pad:
            x = torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])
        return x[self.lo:self.lo + self.B].clone()

    def gather(self, x_l):
        """The full (N, ...) array from the ranks' (B, ...) blocks."""
        out = x_l.new_empty((self.ranks * self.B,) + tuple(x_l.shape[1:]))
        _collective(dist.all_gather_into_tensor, out, x_l.contiguous(),
                    group=self.group)
        return out[:self.N]

    def put(self, arr_l, idx, vals):
        """``scatter_drop`` of slot writes into this rank's block: the
        writes to other ranks' slots (and the dropped ones, idx >= N) are
        dropped here."""
        hi = min(self.lo + self.B, self.N)
        mine = (idx >= self.lo) & (idx < hi)
        return scatter_drop(arr_l, torch.where(mine, idx - self.lo,
                                               torch.full_like(idx, self.B)),
                            vals)


def shard_state(st: GrowthState, blocks: SlotBlocks) -> GrowthState:
    """This rank's state: its blocks of the slot arrays, the rest as is."""
    return st.replace(**{f: blocks.local(getattr(st, f), fill)
                         for f, fill in SLOT_FIELDS.items()})


def gathered(st_l: GrowthState, blocks: SlotBlocks,
             fields=tuple(SLOT_FIELDS)) -> GrowthState:
    """The state with ``fields`` gathered to full slot arrays (the others
    stay the rank's blocks): what an operator that reads across slots
    reads."""
    return st_l.replace(**{f: blocks.gather(getattr(st_l, f))
                           for f in fields})


def translocate_sharded(st_l: GrowthState, cfg: GrowthConfig,
                        blocks: SlotBlocks) -> GrowthState:
    """``ops.translocate`` on this rank's block: each slot's exchange with
    its parent from the gathered lengths and substrate; the parents'
    shares (-delta at the parent, at most one nonzero a slot: its unique
    extension child) gathered with their targets and added into the block
    in slot order, as the single device's ``index_add_``."""
    n, lo, B = st_l.n_seg, blocks.lo, blocks.B
    nl = max(0, min(n - lo, B))          # the block's rows below n_seg
    L_l = norm3(st_l.end - st_l.start)
    L = blocks.gather(L_l)
    sub = blocks.gather(st_l.sub)
    prev = st_l.prev[:nl].long()
    sub_c = st_l.sub[:nl]
    valid = (prev >= 0) & (st_l.state[:nl] != EMPTY)
    p = prev.clamp(min=0)
    adj, ok = exchange(sub_c, sub[p], L_l[:nl], L[p], valid, cfg)
    acc = st_l.sub.clone()
    acc[:nl] = sub_c + adj
    share = torch.zeros_like(st_l.sub)
    share[:nl] = torch.where(ok, -adj, torch.zeros_like(adj))
    target = torch.full((B,), -1, dtype=torch.int64, device=acc.device)
    target[:nl] = p
    share, target = blocks.gather(share)[:n], blocks.gather(target)[:n]
    mine = (target >= lo) & (target < lo + B)
    acc.index_add_(0, target[mine] - lo, share[mine])
    return st_l.replace(sub=acc.clamp(0.0, cfg.m_cap))


def sharded_growth_step(st_l: GrowthState, env: EnvArrays,
                        cfg: GrowthConfig, draws, blocks: SlotBlocks,
                        syncs: Optional[StepSyncs] = None) -> GrowthState:
    """One growth step (``step.growth_step``'s operators in its order) on
    this rank's block of the slots."""
    put = blocks.put
    st_l = translocate_sharded(st_l, cfg, blocks)
    st_l = grow(gathered(st_l, blocks, ("start", "end", "theta", "phi",
                                        "sub", "state")),
                cfg, draws, out=st_l, put=put)
    st_l = detect_anastomosis(
        gathered(st_l, blocks, ("start", "end", "state", "prev")), cfg,
        out=st_l, put=put)
    up = uptake(gathered(st_l, blocks, ("sub", "end", "state")), env, cfg,
                syncs)
    st_l = st_l.replace(sub=blocks.local(up.sub), env_e=up.env_e)
    st_l = enforce_walls(gathered(st_l, blocks, ("start", "end")), env, cfg,
                         draws, out=st_l, put=put)
    if syncs is not None:
        syncs.steps += 1
        syncs.reads += 1                      # grow's count read
    return st_l.replace(step=st_l.step + 1)


def summarize_sharded(st_l: GrowthState, blocks: SlotBlocks) -> torch.Tensor:
    """``step.summarize_device`` of the whole state: the per-slot terms
    gathered and summed over all N slots at once, as on one device."""
    return stats_vector(blocks.gather(st_l.state),
                        blocks.gather(alive_lengths(st_l)))


def run_growth_sharded(cfg: GrowthConfig, env: Environment | None = None,
                       seed: int | None = None, device=DEFAULT_DEVICE,
                       draws=None, group=None,
                       on_step: Optional[Callable] = None,
                       syncs: Optional[StepSyncs] = None):
    """``step.run_growth`` with the slots split over the ranks of ``group``
    (default: the whole process group); every rank calls it with the same
    arguments. Returns (this rank's state, env arrays, history): the
    history is ``run_growth``'s, on every rank; ``gathered(state,
    SlotBlocks(cfg.max_segments, group))`` is the whole state."""
    device = resolve(device)
    if env is None:
        env = petri_dish(cfg)
    if draws is None:
        draws = TorchDraws(cfg.seed if seed is None else seed, device)
    st, ea = init_state(cfg, env, device=device, draws=draws)
    blocks = SlotBlocks(st.capacity, group)
    st_l = shard_state(st, blocks)
    del st
    walls = ea.wall_center.shape[0] > 0
    device_stats, hyphae = [], []
    for t in range(cfg.t_steps):
        st_l = sharded_growth_step(
            st_l, ea, cfg, draws.step(cfg.max_hyphae, st_l.sub.dtype, walls,
                                      cfg.three_d), blocks, syncs)
        device_stats.append(summarize_sharded(st_l, blocks))
        hyphae.append(st_l.n_hyp)
        if on_step is not None:
            on_step(t, st_l)
    return st_l, ea, history_rows(device_stats, hyphae, cfg)
