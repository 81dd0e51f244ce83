"""A run's networks and the program's configuration for each, from a
cell's files: shared by the traffic drivers in ``benchmark/kinds/``."""

from __future__ import annotations

import time
from typing import NamedTuple

from .spec import bench_path, load_module


class Network(NamedTuple):
    coords: object        # (N, 3) float64
    conn: object          # (E, 2) int32
    fields: dict          # every FeaConfig field, grips resolved
    cfg: object           # the program's FeaConfig
    model: object         # the program's model, built in set-up


def mesh_generator(root: str, name: str):
    return getattr(load_module(bench_path(root, "traffic", "meshgen.py"),
                               "bench_meshgen"), name)


def fea_fields(config: dict, coords, **overrides) -> dict:
    """The configuration's ``fea`` fields for a network; a grip length
    given as ``{"y_extent_fraction": f}`` is f times the network's y
    extent."""
    fields = dict(config["fea"])
    grip = fields["grip_length"]
    if isinstance(grip, dict):
        ext = float(coords[:, 1].max() - coords[:, 1].min())
        fields["grip_length"] = grip["y_extent_fraction"] * ext
    fields.update(overrides)
    return fields


def network_seeds(traffic: dict, seed: int) -> list:
    """The generator's seed of each network of a run, in the run's order.
    A mix that names ``mesh_seeds`` runs those networks in every run, in
    an order drawn from the run's seed: its work depends on how each
    network fractures, so every run does the same work. Otherwise network
    i of n is the mesh at seed seed·n + i."""
    fixed = traffic.get("mesh_seeds")
    if fixed is not None:
        import numpy as np
        order = np.random.default_rng([seed, 3]).permutation(len(fixed))
        return [int(fixed[i]) for i in order]
    n = int(traffic["networks"])
    return [seed * n + i for i in range(n)]


def build_networks(cell, seed: int, device, **overrides) -> tuple:
    """(the run's networks, host seconds of each ``build_model``, host
    seconds of each mesh's generation), the networks at
    ``network_seeds``."""
    import torch
    from mycelium_tpu_torch.config import FeaConfig
    from mycelium_tpu_torch.fea.model import build_model
    mesh = dict(cell.config["mesh"])
    gen = mesh_generator(cell.root, mesh.pop("generator"))
    nets, build_s, mesh_s = [], [], []
    for s in network_seeds(cell.traffic, seed):
        t0 = time.perf_counter()
        coords, conn = gen(seed=s, **mesh)
        mesh_s.append(time.perf_counter() - t0)
        fields = fea_fields(cell.config, coords, **overrides)
        cfg = FeaConfig(**fields)
        t0 = time.perf_counter()
        model = build_model(coords, conn, cfg, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        build_s.append(time.perf_counter() - t0)
        nets.append(Network(coords, conn, fields, cfg, model))
    return nets, build_s, mesh_s


def release(nets: list) -> list:
    """The networks without their models (the program's state), so that
    the reference runs with the card's memory given back."""
    import torch
    out = [n._replace(model=None) for n in nets]
    nets.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


class Reservoir:
    """A uniform sample of ``k`` items of a stream, drawn with ``rnd``
    (reservoir sampling): ``offer()``, called once an item, says which
    slot of ``items`` the item takes, or None."""

    def __init__(self, k: int, rnd):
        self.k, self.rnd, self.seen = k, rnd, 0
        self.items = []

    def offer(self):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(None)
            return len(self.items) - 1
        j = self.rnd.randrange(self.seen)
        return j if j < self.k else None

