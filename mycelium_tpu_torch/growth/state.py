"""Fixed-capacity growth state (port of ``mycelium_tpu/growth/state.py``).

Segments live in pre-allocated slots, assigned in creation order; within a
hypha slot order is chain order (each extension takes a fresh higher slot),
which export.py uses to rebuild the reference's per-hypha traversal order.
Segment states are int8: 0 empty slot, 1 'A' (active tip), 2 'P'
(passive), 3 'S' (anastomosed).

The counts ``n_seg``/``n_hyp`` and the step are host integers: the port
reads them once per step (``ops.grow``) and uses them to bound the work of
the other operators. ``overflow`` stays on the device. The random numbers
are not part of the state: each step takes them from a draw source
(``draws.py``).

Arithmetic follows the JAX package under ``jit`` on the CPU op for op,
including the fused multiply-adds that XLA's CPU backend contracts a
product and a sum into (``fma`` below): that is what lets the tests hold
float32 results bit-equal to the reference's.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import GrowthConfig
from ..devices import DEFAULT_DEVICE, resolve
from ..scenes import Environment, petri_dish

EMPTY, ACTIVE, PASSIVE, ANASTOMOSED = 0, 1, 2, 3
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _host(np_fn, t):
    return torch.from_numpy(np_fn(t.numpy()))


def sqrt(x):
    """Correctly rounded square root. On the host it is numpy's: torch's
    vectorized CPU sqrt is not correctly rounded, XLA's is."""
    return _host(np.sqrt, x) if x.device.type == "cpu" else torch.sqrt(x)


def cos(x):
    """cos; float64 on the host through numpy (the C library's, which
    XLA's CPU backend also computes; torch's differs in the last bit)."""
    if x.device.type == "cpu" and x.dtype == torch.float64:
        return _host(np.cos, x)
    return torch.cos(x)


def sin(x):
    """sin; float64 on the host through numpy, as ``cos``."""
    if x.device.type == "cpu" and x.dtype == torch.float64:
        return _host(np.sin, x)
    return torch.sin(x)


@functools.lru_cache(maxsize=None)
def _const(x: float, dtype, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=device)


def const(x, like) -> torch.Tensor:
    """The number x as a 0-dim tensor of ``like``'s type and device, made
    once per (value, type, device) and shared: a fresh one would copy
    from the host each step, and on the card that copy waits for the
    device. Never written to."""
    return _const(float(x), like.dtype, like.device)


def fma(a, b, c):
    """a·b + c. ``torch.addcmul`` rounds once on the CPU, as XLA's CPU
    backend does where it contracts a product into a sum. On the card the
    rounding is CUDA PyTorch's; runs there are held to the same run
    through the plain scan, not to XLA's bits."""
    return torch.addcmul(c, a, b)


def norm3(v):
    """Row norms of (..., 3), sqrt((x0² + x1²) + x2²), as XLA computes the
    slot-wide segment lengths (no contraction there)."""
    return sqrt((v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])
                + v[..., 2] * v[..., 2])


def norm3_fused(v):
    """Row norms of (..., 3) as XLA computes them on rows gathered per
    hypha (grow, walls): the squares accumulated left to right into
    fused multiply-adds. Which form XLA's CPU backend takes depends on how
    it fuses the surrounding ops; each call site follows the reference
    (the tests hold them bit-equal)."""
    return sqrt(fma(v[..., 2], v[..., 2],
                    fma(v[..., 1], v[..., 1], v[..., 0] * v[..., 0])))


class EnvArrays(NamedTuple):
    """Static environment geometry on the device (the nutrient E lives in
    the state)."""
    sub_center: torch.Tensor   # (S,3)
    sub_size: torch.Tensor     # (S,3)
    sub_mu: torch.Tensor       # (S,)
    wall_center: torch.Tensor  # (W,3)
    wall_size: torch.Tensor    # (W,3)
    inoculum: torch.Tensor     # (P,3)


@dataclasses.dataclass
class GrowthState:
    start: torch.Tensor     # (N,3)
    end: torch.Tensor       # (N,3)
    theta: torch.Tensor     # (N,) polar angle
    phi: torch.Tensor       # (N,) azimuth
    sub: torch.Tensor       # (N,) internal substrate I [mol/mm]
    state: torch.Tensor     # (N,) int8 segment state
    prev: torch.Tensor      # (N,) int32 predecessor slot (-1 = none)
    hypha: torch.Tensor     # (N,) int32 owning hypha id
    tip: torch.Tensor       # (H,) int32 tip slot per hypha (-1 = unused)
    n_seg: int              # segments allocated
    n_hyp: int              # hyphae allocated
    env_e: torch.Tensor     # (S,) nutrient remaining per substrate cuboid
    step: int
    overflow: torch.Tensor  # () bool: capacity exhausted at some point
    grid: Optional[object] = None   # neighbors.SegGrid, the persistent
                                    # anastomosis grid (a cache of the
                                    # arrays above)

    @property
    def capacity(self) -> int:
        return self.start.shape[0]

    @property
    def device(self) -> torch.device:
        return self.start.device

    def alive(self) -> torch.Tensor:
        return self.state != EMPTY

    def length(self) -> torch.Tensor:
        return norm3(self.end - self.start)

    def replace(self, **changes) -> "GrowthState":
        return dataclasses.replace(self, **changes)


def state_env_arrays(env: Environment, cfg: GrowthConfig,
                     device) -> EnvArrays:
    dtype = DTYPES[cfg.dtype]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)

    return EnvArrays(sub_center=t(env.substrate_center),
                     sub_size=t(env.substrate_size),
                     sub_mu=t(env.substrate_mu),
                     wall_center=t(env.wall_center).reshape(-1, 3),
                     wall_size=t(env.wall_size).reshape(-1, 3),
                     inoculum=t(env.inoculum))


def direction_from_angles(theta, phi, three_d: bool):
    """2D: (cos phi, sin phi, 0), theta pinned to pi/2
    (mycelium_sim_2D.py:95-99). 3D: (sin theta cos phi, sin theta sin
    phi, cos theta) (mycelium_sim.py:60-63)."""
    if three_d:
        st = sin(theta)
        return torch.stack([st * cos(phi), st * sin(phi), cos(theta)],
                           dim=-1)
    return torch.stack([cos(phi), sin(phi), torch.zeros_like(phi)], dim=-1)


def perturb(u, angle, cfg: GrowthConfig):
    """Uniform angular noise in [-lam/2, lam/2) on one angle, from
    uniforms ``u`` in [0, 1): phi in 2D (mycelium_sim_2D.py:101-109),
    theta and phi each from their own uniforms in 3D (mycelium_sim.py:
    65-69)."""
    return fma(u - 0.5, const(cfg.lambda_angle, u), angle)


def init_state(cfg: GrowthConfig, env: Environment | None = None,
               seed: int | None = None, device=DEFAULT_DEVICE,
               draws=None) -> tuple[GrowthState, EnvArrays]:
    """Seed the inoculum: each site spawns h0_per_point hyphae of one
    segment each with a random initial direction; the substrate budget
    Omega0 is split evenly over sites, then over hyphae
    (mycelium_sim_2D.py:247-270). ``draws`` is the run's draw source
    (default ``draws.TorchDraws`` seeded from ``seed`` or cfg.seed)."""
    from .draws import TorchDraws
    device = resolve(device)
    if env is None:
        env = petri_dish(cfg)
    if draws is None:
        draws = TorchDraws(cfg.seed if seed is None else seed, device)
    ea = state_env_arrays(env, cfg, device)
    dtype = DTYPES[cfg.dtype]
    N, H = cfg.max_segments, cfg.max_hyphae
    P = ea.inoculum.shape[0]
    n0 = P * cfg.h0_per_point
    if n0 > N or n0 > H:
        raise ValueError("capacity too small for inoculum")

    d0 = draws.init(n0, dtype)
    theta0 = d0.theta * math.pi
    phi0 = d0.phi * (2 * math.pi)
    starts0 = torch.repeat_interleave(ea.inoculum, cfg.h0_per_point, dim=0)
    # init_state runs eagerly in the JAX package: no contraction here
    ends0 = starts0 + direction_from_angles(theta0, phi0, cfg.three_d) \
        * cfg.h0
    per_seg = (cfg.omega0 / P) / cfg.h0_per_point

    def pad(x, fill, n=N):
        out = torch.full((n,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                         device=device)
        out[:x.shape[0]] = x
        return out

    i32 = torch.int32
    st = GrowthState(
        start=pad(starts0, 0.0),
        end=pad(ends0, 0.0),
        theta=pad(theta0, 0.0),
        phi=pad(phi0, 0.0),
        sub=pad(torch.full((n0,), per_seg / cfg.h0, dtype=dtype,
                           device=device), 0.0),
        state=pad(torch.full((n0,), ACTIVE, dtype=torch.int8,
                             device=device), EMPTY),
        prev=torch.full((N,), -1, dtype=i32, device=device),
        hypha=pad(torch.arange(n0, dtype=i32, device=device), -1),
        tip=pad(torch.arange(n0, dtype=i32, device=device), -1, H),
        n_seg=n0, n_hyp=n0,
        env_e=torch.as_tensor(np.asarray(env.substrate_e0, np.float64),
                              dtype=dtype, device=device),
        step=0,
        overflow=torch.zeros((), dtype=torch.bool, device=device),
    )
    return ensure_grid(st, cfg), ea


def ensure_grid(st: GrowthState, cfg: GrowthConfig) -> GrowthState:
    """Attach an empty persistent anastomosis grid when the state carries
    none (a fresh init, a state carried across from the JAX package). The
    next detect_anastomosis inserts the whole backlog."""
    if st.grid is not None:
        return st
    from .neighbors import empty_grid
    return st.replace(grid=empty_grid(cfg, st.capacity, st.start.dtype,
                                      st.device))
