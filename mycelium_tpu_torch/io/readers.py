"""Mesh readers of the port (a copy of ``mycelium_tpu/io/readers.py``):
``nodes.csv`` (node_id,x,y,z) and ``elements.csv`` (elem_id,n1,n2), with
elements that reference out-of-range nodes skipped like the reference's
C++ reader (src/fea_petsc.cpp:241). The native CSV parser is used when its
library builds; numpy is the fallback. ``read_fea_records`` is the port's
own: it reads back what ``write_fea_records`` wrote (either variant) with
numpy, where the JAX CLI's ``plot-fea`` reads it with pandas."""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from ..native import meshio_native


def _read_csv_numeric(path: str) -> np.ndarray:
    """Parse a simple numeric CSV with a header row into a float64 array."""
    arr = meshio_native.read_csv(path)
    if arr is not None:
        return arr
    return np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2,
                      dtype=np.float64)


def read_mesh(nodes_path: str, elems_path: str
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Load (coords (n,3) float64, conn (e,2) int32) from the CSV contract."""
    nodes = _read_csv_numeric(nodes_path)
    elems = _read_csv_numeric(elems_path)
    if nodes.size == 0:
        raise ValueError(f"empty nodes file: {nodes_path}")
    n_nodes = nodes.shape[0]
    coords = np.ascontiguousarray(nodes[:, 1:4], dtype=np.float64)
    if elems.size == 0:
        conn = np.zeros((0, 2), dtype=np.int32)
    else:
        conn = elems[:, 1:3].astype(np.int64)
        ok = ((conn >= 0) & (conn < n_nodes)).all(axis=1)
        conn = conn[ok].astype(np.int32)
    return coords, conn


def read_mesh_dir(results_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load a mesh from a results/sim_* style directory."""
    return read_mesh(os.path.join(results_dir, "nodes.csv"),
                     os.path.join(results_dir, "elements.csv"))


def read_fea_records(fea_dir: str, n_elems: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(stress (S, n_elems) float64, active (S, n_elems) bool, force_disp
    (S, 2) float64) from ``fea_dir``'s stress_record.csv,
    active_elements.csv and force_displacement.csv: a row a recorded
    step, the first ``n_elems`` columns of each (the step column after
    them is not read); actives as True/False or 1/0."""
    def rows(name, dtype):
        return np.loadtxt(os.path.join(fea_dir, name), delimiter=",",
                          skiprows=1, ndmin=2, dtype=dtype)
    stress = rows("stress_record.csv", np.float64)[:, :n_elems]
    flags = rows("active_elements.csv", str)[:, :n_elems]
    active = (flags == "True") | (flags == "1")
    return stress, active, rows("force_displacement.csv", np.float64)
