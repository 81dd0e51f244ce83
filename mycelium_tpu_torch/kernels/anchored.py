"""K7: grip reachability, the nodes joined to a grip through active
elements, in one cooperative launch (CUDA kernel, ``csrc/anchored.cu``,
whose source note says what bounds it and how).

It replaces no TPU kernel: the JAX package computes the mask in plain jnp
(``mycelium_tpu/fea/tree_jax.py::tree_anchored``). Its plain versions stay
where they are, unchanged: ``fea/tree_factor.py::tree_anchored`` (the
fixpoint accelerated by the forest, the plain neighbour sweep on a forest
with no levels), which ``fea/ramp.py::refresh_anchored`` runs on CPU
tensors, and ``fea/ramp.py::anchored_mask_host`` (scipy's connected
components), the oracle the card-side checks hold the kernel to.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .tree_cg import THREADS, grid_rule


@functools.cache
def resident_blocks(device_index: int) -> tuple:
    """(blocks per SM, SMs) of the kernel on a card, from the occupancy
    calculator: the cooperative grid may hold at most their product."""
    per, sms = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = build.library().anchored_grid_blocks(ctypes.byref(per),
                                                  ctypes.byref(sms))
    build.check(rc, "anchored_grid_blocks")
    return per.value, sms.value


def _check(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype or \
            tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"anchored: {name} must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


class AnchoredLaunch:
    """K7 bound to one model: made with the model (``fea/model.py::
    with_kernels``); at its first launch it validates the model's
    connectivity and grips, computes the grip mask ``top | bot`` once,
    allocates the scratch (``parent`` int32 and ``flag`` uint8, a node
    each) and sizes the grid. ``mask`` passes only the active mask and
    returns a fresh (N,) bool tensor.

    The kernel has no CPU mode: ``mask`` takes CUDA tensors only and
    raises on others (``fea/ramp.py::refresh_anchored`` sends CPU tensors
    to the plain versions)."""

    def __init__(self, conn, top_nodes, bot_nodes):
        self.conn, self.top_nodes, self.bot_nodes = conn, top_nodes, bot_nodes
        self.n = top_nodes.shape[0]
        self.n_elems = conn.shape[0]
        self.device = conn.device
        self._bound = False

    def _bind(self) -> None:
        """Validate once, allocate once."""
        dev = self.device
        if dev.type != "cuda":
            raise ValueError(f"anchored: the model's tensors are on {dev}; "
                             "the kernel takes CUDA tensors only")
        _check("conn", self.conn, (self.n_elems, 2), torch.int64, dev)
        _check("top_nodes", self.top_nodes, (self.n,), torch.bool, dev)
        _check("bot_nodes", self.bot_nodes, (self.n,), torch.bool, dev)
        index = self._index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        self.grip = (self.top_nodes | self.bot_nodes).contiguous()
        self.parent = torch.empty(self.n, dtype=torch.int32, device=dev)
        self.flag = torch.empty(self.n, dtype=torch.uint8, device=dev)
        per_sm, sms = resident_blocks(index)
        self.grid = grid_rule(self.n, per_sm, sms)
        self._lib = build.library()
        self._bound = True

    def io_bytes(self) -> int:
        """Bytes one refresh must move whatever the kernel's design: the
        connectivity, the active mask and the grip mask read once, the
        result written once."""
        return 16 * self.n_elems + self.n_elems + 2 * self.n

    def mask(self, active):
        """The grip reachability of ``active`` (E,) bool: a fresh (N,) bool
        tensor on the model's card, one launch; raises on a tensor the
        kernel does not take or a launch the card refuses."""
        if not self._bound:
            self._bind()
        _check("active", active, (self.n_elems,), torch.bool, self.device)
        out = torch.empty(self.n, dtype=torch.bool, device=self.device)
        rc = self._lib.anchored_mask(
            self.conn.data_ptr(), active.data_ptr(), self.grip.data_ptr(),
            self.parent.data_ptr(), self.flag.data_ptr(), out.data_ptr(),
            self.n, self.n_elems, self.grid, build.raw_stream(self._index))
        if rc != 0:
            build.check(rc, "anchored_mask")
        build.count_launch("anchored")
        return out
