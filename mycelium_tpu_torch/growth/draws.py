"""The growth model's random numbers, drawn up front per step.

The JAX package threads a PRNG key through the state and splits it inside
the ops. The port takes an explicit ``torch.Generator`` instead: each step
draws every random number it needs at once, into tensors of fixed shapes,
and the ops do the arithmetic around them. Where they come from:

- ``InitDraws`` (init_state, mycelium_tpu/growth/state.py:132-134):
  uniforms for theta0 and phi0, (n0,) each (theta0 is read in 3D only);
- ``StepDraws`` (growth_step): the branch uniforms (H,) (ops.py:159), the
  extension and child phi uniforms (H,) each (state.py:99-112 via
  ops.py:184-188), in 3D also the extension and child theta uniforms
  (H,) each (``perturb_direction`` draws theta first, then phi), and,
  only when the dish has walls, three sweeps of wall normals
  ``wall_rnd`` and ``wall_tan``, (3, H, 3) each (ops.py:464-488).

A draw source is any object with ``init(n0, dtype)`` and
``step(H, dtype, walls, three_d=False)``; the tests replay the JAX
package's key chain through one, so the port and the reference see the
same numbers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class InitDraws(NamedTuple):
    theta: torch.Tensor    # (n0,) uniforms in [0, 1)
    phi: torch.Tensor      # (n0,) uniforms in [0, 1)


class StepDraws(NamedTuple):
    branch: torch.Tensor                # (H,) uniforms
    ext: torch.Tensor                   # (H,) uniforms, extension phi
    child: torch.Tensor                 # (H,) uniforms, branch child phi
    wall_rnd: Optional[torch.Tensor]    # (3, H, 3) normals, None: no walls
    wall_tan: Optional[torch.Tensor]    # (3, H, 3) normals, None: no walls
    ext_theta: Optional[torch.Tensor] = None     # (H,) uniforms, 3D only
    child_theta: Optional[torch.Tensor] = None   # (H,) uniforms, 3D only


class TorchDraws:
    """The default draw source: one ``torch.Generator`` on the run's
    device, seeded once."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(self.device).manual_seed(int(seed))

    def _u(self, shape, dtype):
        return torch.rand(shape, generator=self.gen, dtype=dtype,
                          device=self.device)

    def _n(self, shape, dtype):
        return torch.randn(shape, generator=self.gen, dtype=dtype,
                           device=self.device)

    def init(self, n0: int, dtype) -> InitDraws:
        return InitDraws(theta=self._u((n0,), dtype),
                         phi=self._u((n0,), dtype))

    def step(self, H: int, dtype, walls: bool,
             three_d: bool = False) -> StepDraws:
        u = self._u((5 if three_d else 3, H), dtype)
        rnd = self._n((3, H, 3), dtype) if walls else None
        tan = self._n((3, H, 3), dtype) if walls else None
        return StepDraws(branch=u[0], ext=u[1], child=u[2], wall_rnd=rnd,
                         wall_tan=tan,
                         ext_theta=u[3] if three_d else None,
                         child_theta=u[4] if three_d else None)
