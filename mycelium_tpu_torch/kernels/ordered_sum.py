"""Segment sums in one fixed order (CUDA kernel + plain PyTorch version).

The sums of the PyTorch routes whose terms collide on a target (the chain
diagonal's jump terms, the coarse Galerkin entries, the hybrid's Schur
corrections and forward right-hand sides) go through here, so the card
adds every target's terms in the order the CPU does and the two give the
same bits. The kernel (``csrc/ordered_sum.cu``) is not one of the six TPU
kernels: it takes the place of ``index_add_``, whose float atomics on the
card add colliding terms in an order that changes from run to run. It
gives a thread to a sum where segments are short and, where the caller
says they are long (``long_segments``: the coarse blocks, tens of terms on
average), a block to a segment, its terms staged in shared memory.

    out[:, s] = init[:, s] + vals[:, ent[j] >> shift] + ...
                for j = ptr[s], ..., ptr[s + 1] - 1, one after another

``vals`` (K, T) and ``init`` (K, n) may be strided views; ``ptr`` (n + 1,)
may be a slice of a larger CSR (its entries index ``ent`` directly);
``ent`` None means entry j is term j. The plain version is a sequential
``index_add_`` over the terms listed in CSR order, which on the CPU adds
them in that order: the definition of the sum.
"""

from __future__ import annotations

import torch

from . import build


def ordered_sum_plain(vals, ptr, ent, n: int, init=None, shift: int = 0):
    """The plain version: one ``index_add_`` in CSR order. Sequential, and
    so the kernel's order, on the CPU only (atomics on the card)."""
    ptr = ptr.long()
    j0, j1 = int(ptr[0]), int(ptr[n])
    idx = torch.arange(j0, j1, device=vals.device) if ent is None \
        else ent[j0:j1].long() >> shift
    seg = torch.repeat_interleave(torch.arange(n, device=vals.device),
                                  ptr[1:n + 1] - ptr[:n])
    out = vals.new_zeros((vals.shape[0], n)) if init is None \
        else init.clone()
    return out.index_add_(1, seg, vals.index_select(1, idx)).contiguous()


def ordered_sum(vals, ptr, ent, n: int, init=None, shift: int = 0,
                long_segments: bool = False):
    """The kernel for CUDA tensors (float32 or float64, int32 ``ptr`` and
    ``ent``, raises otherwise), the plain version for CPU tensors. Returns
    a contiguous (K, n) tensor. ``long_segments`` chooses a block a
    segment (for segments of tens of terms or more, as the coarse blocks')
    over a thread a sum (a few terms, as the node jump, attachment and
    dense-tail CSRs'); both add in the same order."""
    if vals.device.type == "cpu":
        return ordered_sum_plain(vals, ptr, ent, n, init, shift)
    K = vals.shape[0]
    fn = {torch.float32: "ordered_sum_f32",
          torch.float64: "ordered_sum_f64"}.get(vals.dtype)
    bad = [name for name, t, ok in (
        ("vals", vals, vals.dim() == 2),
        ("ptr", ptr, ptr.dtype == torch.int32 and ptr.is_contiguous()
         and ptr.shape == (n + 1,)),
        ("ent", ent, ent is None or (ent.dtype == torch.int32
                                     and ent.is_contiguous())),
        ("init", init, init is None or (init.dtype == vals.dtype
                                        and init.shape == (K, n))))
        if t is not None and (t.device != vals.device or not ok)]
    if fn is None or bad:
        raise ValueError(f"ordered_sum: {bad or ['vals dtype']} not as the "
                         "kernel takes them (float32/float64 vals (K, T); "
                         "int32 contiguous ptr (n + 1,) and ent; init (K, n) "
                         "of vals' dtype; all on one CUDA device)")
    out = torch.empty((K, n), dtype=vals.dtype, device=vals.device)
    is_k, is_s = init.stride() if init is not None else (0, 0)
    rc = getattr(build.library(), fn)(
        vals.data_ptr(), vals.stride(0), vals.stride(1), ptr.data_ptr(),
        ent.data_ptr() if ent is not None else None, int(shift),
        init.data_ptr() if init is not None else None, is_k, is_s,
        out.data_ptr(), n, K, int(long_segments),
        build.stream_handle(vals))
    build.check(rc, fn)
    build.count_launch("ordered_sum")
    return out
