"""Where the port runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

import dataclasses

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device=DEFAULT_DEVICE) -> torch.device:
    """``torch.device(device)``; a CUDA device without a card raises
    instead of moving the run to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device='cpu' (--device cpu) to run the plain PyTorch path on "
            "the host instead")
    return dev


def moved(obj, device):
    """A copy of ``obj`` with every tensor in it on ``device``: tensors,
    dataclasses of tensors (the plans and tables) and tuples or lists of
    them; anything else is returned as it is."""
    if torch.is_tensor(obj):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: moved(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)})
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(moved(x, device) for x in obj)
    return obj
