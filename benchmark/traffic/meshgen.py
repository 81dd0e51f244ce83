"""The networks of the pull-test cells: a frozen copy of
``mycelium_tpu_torch/meshes.py::synthetic_mesh`` (itself the root
``bench.py``'s fallback mesh), kept here so that the inputs stay the same
whatever a later change does to the program. The benchmark makes each
network from the run's seed and hands the same arrays to the program and
to the reference."""

from __future__ import annotations

import numpy as np


def synthetic_mesh(n_target_nodes: int, seed: int = 0,
                   mean_chain: int = 64):
    """Synthetic mycelium-like network: random-walk hyphae (chains of
    0.05 mm segments) that branch off existing nodes, the real workload's
    mostly-chain topology. Steps that would leave the square of side
    0.05·sqrt(n) bounce (length-preserving), so every element has the
    growth step's length."""
    rng = np.random.default_rng(seed)
    h0 = 0.05
    extent = h0 * np.sqrt(n_target_nodes)   # keep density roughly constant
    coords = [np.zeros(3)]
    conn = []
    while len(coords) < n_target_nodes:
        start = int(rng.integers(0, len(coords)))
        length = max(int(rng.geometric(1.0 / mean_chain)), 4)
        phi = rng.uniform(0, 2 * np.pi)
        pos = coords[start].copy()
        prev = start
        for _ in range(length):
            if len(coords) >= n_target_nodes:
                break
            phi += rng.uniform(-0.26, 0.26)
            step = np.array([np.cos(phi), np.sin(phi), 0.0]) * h0
            for ax in range(2):
                if abs(pos[ax] + step[ax]) > extent / 2:
                    step[ax] = -step[ax]
            phi = np.arctan2(step[1], step[0])
            pos = pos + step
            coords.append(pos)
            conn.append([prev, len(coords) - 1])
            prev = len(coords) - 1
    return np.asarray(coords), np.asarray(conn, np.int32)
