"""K8: a ramp step's post-solve and its record rows in one launch (CUDA
kernel, ``csrc/post_solve.cu``, whose source note says what bounds it and
how), and its plain PyTorch version.

For the solved displacement ``u`` and the step's active mask it writes the
elements' stress and new active mask, a copy of ``u``, the status row
(``status_row``: converged, active after, iterations, force) in float64 and
the flag ``changed`` (an element fractured) into a ``PostRows``: on the card
the record keeper's own rows, so no further launch writes them. The force is
the top grip's y-reaction, taken from the element forces at the top grip's
element ends in float64, in the fixed order of ``fixed_order_sum``, with
no atomics: reruns give the same bits.

It replaces no TPU kernel: the JAX package's ``post_solve`` is plain jnp.
``fea/ramp.py::post_solve`` launches it for CUDA tensors; on CPU tensors it
keeps its plain arithmetic (the whole operator's reactions summed over the
top grip), whose force ``post_solve_plain`` matches to rounding and whose
stress and mask it matches bit for bit. ``post_solve_plain`` is the
kernel's oracle: on CPU copies of the same inputs it gives K8's bits. It
takes the stress, the mask and the force's terms from ``fea/elements.py``,
whose dot products K8 adds in the same order (``dot3``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import build

THREADS = 256
WARPS = THREADS // 32
# the columns of a step's status row (float64): the solve converged (1 or
# 0), the elements active after the step, the solve's iterations, the top
# grip's y-reaction. K8 writes them in this order; the record keepers
# (fea/ramp.py) read them by these names.
CONVERGED, ACTIVE, ITERS, FORCE = range(4)


class PostRows(NamedTuple):
    """What one step's post-solve writes."""
    stress: torch.Tensor     # (E,) the model's dtype
    active: torch.Tensor     # (E,) bool, the mask after the step
    disp: torch.Tensor       # (3N,) the model's dtype, u node-major
    status: torch.Tensor     # (4,) float64, ``status_row``
    changed: torch.Tensor    # () bool: an element fractured


def status_row(converged, n_active, iters, force):
    """A step's status row, float64 in the columns ``CONVERGED`` to
    ``FORCE``, on the device of the tensors ``n_active`` (a count) and
    ``force``; ``converged`` and ``iters`` are the host's values."""
    f64 = torch.float64
    return torch.stack([force.new_tensor(float(converged), dtype=f64),
                        n_active.to(f64),
                        force.new_tensor(float(iters), dtype=f64),
                        force.to(f64)])


def _block_totals(vals):
    """Each block's total of the (..., B, 256) values in the order of
    ``grid_reduce.cuh::block_sums``: a warp's 32 lanes by shuffle-down
    halving, then its 8 warps one after another from 0.0."""
    x = vals.reshape(vals.shape[:-1] + (WARPS, 32))
    for o in (16, 8, 4, 2, 1):
        x = x[..., :o] + x[..., o:2 * o]
    s = torch.zeros(x.shape[:-2], dtype=x.dtype, device=x.device)
    for w in range(WARPS):
        s = s + x[..., w, 0]
    return s


def fixed_order_sum(terms):
    """The sums of K8 over the last dimension of ``terms`` (float64, (...,
    E)): a thread a term, ceil(E / 256) blocks (at least one), each
    block's total (``_block_totals``), then thread t adds blocks t, t + 256,
    ... in order from 0.0 and the one block's total of those is the sum."""
    terms = terms.to(torch.float64)
    e = terms.shape[-1]
    blocks = max(1, -(-e // THREADS))
    pad = torch.zeros(terms.shape[:-1] + (blocks * THREADS - e,),
                      dtype=terms.dtype, device=terms.device)
    part = _block_totals(torch.cat([terms, pad], -1).reshape(
        terms.shape[:-1] + (blocks, THREADS)))
    rounds = -(-blocks // THREADS)
    pad = torch.zeros(part.shape[:-1] + (rounds * THREADS - blocks,),
                      dtype=part.dtype, device=part.device)
    part = torch.cat([part, pad], -1).reshape(
        part.shape[:-1] + (rounds, THREADS))
    lanes = torch.zeros(part.shape[:-2] + (THREADS,), dtype=part.dtype,
                        device=part.device)
    for r in range(rounds):
        lanes = lanes + part[..., r, :]
    return _block_totals(lanes)


def post_solve_plain(u, conn, geom, top_nodes, active, e_mod: float,
                     max_strain: float, converged, iters) -> PostRows:
    """What K8 writes, on any device, in fresh tensors: the stress and the
    mask of ``element_strain``, and the force's terms, the y-components of
    ``element_forces`` at the top grip's element ends, in float64, summed
    with the counts in the order of ``fixed_order_sum``."""
    # fea imports this module: take its element functions at the call
    from ..fea.elements import element_forces, element_strain
    strain = element_strain(u, conn, geom)
    stress = torch.where(active, e_mod * strain, 0.0)
    active_new = active & (strain.abs() <= max_strain)
    fy = element_forces(u, conn, geom, active)[:, 1].to(torch.float64)
    zero = torch.zeros_like(fy)
    c = torch.where(top_nodes[conn[:, 0]], zero + fy, zero)
    c = torch.where(top_nodes[conn[:, 1]], c - fy, c)
    fractured = (active & ~active_new).to(torch.float64)
    force, n_active, n_fractured = fixed_order_sum(torch.stack(
        [c, active_new.to(torch.float64), fractured]))
    return PostRows(stress, active_new, u.reshape(-1).clone(),
                    status_row(converged, n_active, iters, force),
                    n_fractured > 0)


class PostSolveLaunch:
    """K8 bound to one model: made with the model (``fea/model.py::
    with_kernels``); at its first launch it validates the model's
    connectivity, geometry and top grip, allocates the scratch (a float64
    partial of each of the three sums a block, and the counter that finds
    the last block) and sizes the grid, ceil(E / 256) blocks.

    The kernel has no CPU mode: ``rows`` and ``launch`` take the model's
    card only and raise on others (``fea/ramp.py::post_solve`` keeps its
    plain arithmetic for CPU tensors)."""

    def __init__(self, conn, geom, top_nodes):
        self.conn, self.geom, self.top_nodes = conn, geom, top_nodes
        self.n = top_nodes.shape[0]
        self.n_elems = conn.shape[0]
        self.device = conn.device
        self.dtype = geom.n.dtype
        self._bound = False

    def _bind(self) -> None:
        """Validate once, allocate once."""
        dev, dt, e = self.device, self.dtype, self.n_elems
        if dev.type != "cuda":
            raise ValueError(f"post_solve: the model's tensors are on {dev}; "
                             "the kernel takes CUDA tensors only")
        fn = {torch.float32: "post_solve_f32",
              torch.float64: "post_solve_f64"}.get(dt)
        if fn is None:
            raise ValueError(f"post_solve: the kernel takes float32 or "
                             f"float64 models, not {dt}")
        for name, t, shape, dtype in (
                ("conn", self.conn, (e, 2), torch.int64),
                ("geom.n", self.geom.n, (e, 3), dt),
                ("geom.length", self.geom.length, (e,), dt),
                ("geom.k_ax", self.geom.k_ax, (e,), dt),
                ("geom.k_bd", self.geom.k_bd, (e,), dt),
                ("top_nodes", self.top_nodes, (self.n,), torch.bool)):
            build.check_tensor("post_solve", name, t, shape, dtype, dev)
        self._index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        self.grid = max(1, -(-e // THREADS))
        self.partial = torch.empty(3 * self.grid, dtype=torch.float64,
                                   device=dev)
        self.done = torch.zeros((), dtype=torch.int32, device=dev)
        self._fn = getattr(build.library(), fn)
        self._bound = True

    def io_bytes(self) -> int:
        """Bytes one step must move whatever the kernel's design, each
        input read once and each output written once: the connectivity,
        the geometry (direction, length, k_ax, k_bd), the active mask, u
        and the top grip; the stress, the new mask, the disp row, the
        status row and the flag."""
        item = self.geom.n.element_size()
        per_elem = 16 + 6 * item + 1 + item + 1
        per_node = 3 * item + 1 + 3 * item
        return per_elem * self.n_elems + per_node * self.n + 4 * 8 + 1

    def rows(self) -> PostRows:
        """Fresh rows on the model's card, for a caller with none of its
        own."""
        dev, dt = self.device, self.dtype
        return PostRows(
            torch.empty(self.n_elems, dtype=dt, device=dev),
            torch.empty(self.n_elems, dtype=torch.bool, device=dev),
            torch.empty(3 * self.n, dtype=dt, device=dev),
            torch.empty(4, dtype=torch.float64, device=dev),
            torch.empty((), dtype=torch.bool, device=dev))

    def launch(self, u, active, rows: PostRows, e_mod: float,
               max_strain: float, converged, iters) -> PostRows:
        """Write the step of ``u`` (N, 3) under ``active`` (E,) bool into
        ``rows``, one launch on the current stream; raises on a tensor the
        kernel does not take or a launch the card refuses."""
        if not self._bound:
            self._bind()
        dev, dt, e = self.device, self.dtype, self.n_elems
        for name, t, shape, dtype in (
                ("u", u, (self.n, 3), dt),
                ("active", active, (e,), torch.bool),
                ("rows.stress", rows.stress, (e,), dt),
                ("rows.active", rows.active, (e,), torch.bool),
                ("rows.disp", rows.disp, (3 * self.n,), dt),
                ("rows.status", rows.status, (4,), torch.float64),
                ("rows.changed", rows.changed, (), torch.bool)):
            build.check_tensor("post_solve", name, t, shape, dtype, dev)
        g = self.geom
        rc = self._fn(
            u.data_ptr(), self.conn.data_ptr(), g.n.data_ptr(),
            g.length.data_ptr(), g.k_ax.data_ptr(), g.k_bd.data_ptr(),
            self.top_nodes.data_ptr(), active.data_ptr(),
            rows.stress.data_ptr(), rows.active.data_ptr(),
            rows.disp.data_ptr(), rows.status.data_ptr(),
            rows.changed.data_ptr(), self.partial.data_ptr(),
            self.done.data_ptr(), float(e_mod), float(max_strain),
            float(converged), float(iters), self.n, e, self.grid,
            build.raw_stream(self._index))
        if rc != 0:
            build.check(rc, "post_solve")
        build.count_launch("post_solve")
        return rows
