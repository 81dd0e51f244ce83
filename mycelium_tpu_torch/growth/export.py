"""Geometry export (port of ``mycelium_tpu/growth/export.py``): growth
state -> nodes.csv/elements.csv, deduplicated on the host (growth and the
pull test meet at the CSV mesh contract, as in the reference). Segments
come out in the reference's traversal order: hyphae in creation order,
chain order within each hypha, i.e. a stable sort by (hypha id, slot).
"""

from __future__ import annotations

import numpy as np

from ..io.writers import dedup_nodes, export_geometry, write_snapshot_csv
from ..utils import profiling
from .state import EMPTY, GrowthState


def segments_to_host(st: GrowthState):
    """Alive segments as numpy (starts, ends, sub, state, hypha), in the
    reference's per-hypha traversal order."""
    start, end, sub, state, hypha = (
        x.cpu().numpy() for x in (st.start, st.end, st.sub, st.state,
                                  st.hypha))
    idx = np.nonzero(state != EMPTY)[0]
    idx = idx[np.lexsort((idx, hypha[idx]))]
    return (np.asarray(start[idx], np.float64),
            np.asarray(end[idx], np.float64),
            np.asarray(sub[idx], np.float64),
            state[idx], hypha[idx])


def export_state_geometry(st: GrowthState, out_dir: str) -> str:
    starts, ends, _, _, _ = segments_to_host(st)
    return export_geometry(out_dir, starts, ends)


def state_mesh(st: GrowthState):
    """(coords, conn) of the deduplicated network, for ``build_model``
    without the CSV round trip. Under a profiler it is the span
    ``growth.export`` (``utils.profiling``)."""
    with profiling.span("growth.export"):
        starts, ends, _, _, _ = segments_to_host(st)
        return dedup_nodes(starts, ends)


def write_state_snapshot(st: GrowthState, snapshot_dir: str,
                         step: int) -> str:
    """Per-step snapshot of the C++ contract (x1,y1,x2,y2,intensity with
    intensity = I*L, mycelium_sim_2D.cpp:463-475)."""
    starts, ends, sub, _, _ = segments_to_host(st)
    length = np.linalg.norm(ends - starts, axis=1)
    return write_snapshot_csv(snapshot_dir, step, starts, ends, sub * length)
