"""Matplotlib renders of the port (a copy of ``mycelium_tpu/viz/plots.py``,
which renders the reference figures, component C27): the same figures,
sizes, dpi, colour maps, limits and titles.

- Growth network: LineCollection colored by I*L on viridis, normalized to
  the per-frame max (reference plot_mycelium, src/mycelium_sim_2D.py:547-607
  and the snapshot plotter src/plot_snapshots.py:11-38).
- FEA network: active elements colored by stress/MAX_STRESS on plasma
  (reference plot_network, src/fea_solver.py:137-181 and
  src/plot_fea_results.py:24-52).
- Growth summary: 3-panel time series (src/mycelium_sim_2D.py:730-756).
- Force-displacement curve (src/fea_solver.py:319-327).

Matplotlib is imported lazily (``_mpl``), so importing the port never
loads it, and a machine without it runs everything but these functions;
all entry points accept plain numpy arrays. ``require_matplotlib`` is the
check a command that will plot makes before it starts any work.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def require_matplotlib(flags: str) -> None:
    """Raise, naming the package and the options that turn plotting off
    (``flags``), where matplotlib is not installed."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        raise RuntimeError(f"plotting needs the matplotlib package, which "
                           f"is not installed: install it, or pass "
                           f"{flags}") from None


def _mpl():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    from matplotlib.collections import LineCollection
    from matplotlib.colors import Normalize
    return plt, LineCollection, Normalize


def plot_mycelium(starts, ends, intensity, step: int, out_path: str,
                  inoculum: Optional[np.ndarray] = None,
                  dish_size: float = 5.0, title: Optional[str] = None,
                  three_d: bool = False, height: float = 0.1):
    """Growth frame: segments colored by I*L / max(I*L) on viridis.

    With ``three_d``, renders on a 3D axes in the reference 3D variant's
    style (top-down view, z-axis hidden, flat box aspect — reference
    src/mycelium_sim.py:507-559); otherwise a flat 2D LineCollection
    (src/mycelium_sim_2D.py:547-607).
    """
    plt, LineCollection, Normalize = _mpl()
    max_val = float(np.max(intensity)) if len(starts) else 1.0
    if max_val < 1e-12:
        max_val = 1.0
    if three_d:
        from mpl_toolkits.mplot3d.art3d import Line3DCollection
        fig = plt.figure(figsize=(7, 7))
        ax = fig.add_subplot(111, projection="3d")
        if len(starts):
            segs = np.stack([starts[:, :3], ends[:, :3]], axis=1)
            lc = Line3DCollection(segs, cmap="viridis",
                                  array=np.asarray(intensity) / max_val,
                                  norm=Normalize(vmin=0, vmax=1),
                                  linewidths=1.3)
            ax.add_collection3d(lc)
        if inoculum is not None:
            ax.scatter(inoculum[:, 0], inoculum[:, 1], inoculum[:, 2],
                       color="red", s=30, label="inoculum")
            ax.legend()
        ax.set_zticks([])
        ax.view_init(elev=90, azim=-90)       # top-down XY view
        ax.set_box_aspect([1, 1, 0.1])
        ax.grid(False)
        ax.set_xlim(-dish_size / 2, dish_size / 2)
        ax.set_ylim(-dish_size / 2, dish_size / 2)
        ax.set_zlim(0.0, max(height, 1e-3))
    else:
        fig, ax = plt.subplots(figsize=(7, 7))
        if len(starts):
            segs = np.stack([starts[:, :2], ends[:, :2]], axis=1)
            lc = LineCollection(segs, cmap="viridis",
                                array=np.asarray(intensity) / max_val,
                                norm=Normalize(vmin=0, vmax=1),
                                linewidths=1.2)
            ax.add_collection(lc)
        if inoculum is not None:
            ax.scatter(inoculum[:, 0], inoculum[:, 1], color="red", s=30)
        ax.set_aspect("equal")
        ax.set_xlim(-dish_size / 2, dish_size / 2)
        ax.set_ylim(-dish_size / 2, dish_size / 2)
    ax.set_title(title or f"Step {step}")
    ax.set_xlabel("X [mm]")
    ax.set_ylabel("Y [mm]")
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_network(coords, conn, stress, active, out_path: str, step: int,
                 max_stress: float = 45.0,
                 xlim=(-1.7, 1.7), ylim=(-0.2, 3.2)):
    """FEA frame: active elements colored by stress/max_stress on plasma."""
    plt, LineCollection, Normalize = _mpl()
    active = np.asarray(active, bool)
    xy = np.asarray(coords)[:, :2]
    segs = np.stack([xy[conn[active, 0]], xy[conn[active, 1]]], axis=1)
    colors = np.asarray(stress)[active] / max_stress
    fig, ax = plt.subplots(figsize=(6, 6))
    if len(segs):
        lc = LineCollection(segs, cmap="plasma", array=colors,
                            norm=Normalize(vmin=0, vmax=1), linewidths=1.2)
        ax.add_collection(lc)
    ax.set_xlim(*xlim)
    ax.set_ylim(*ylim)
    ax.set_aspect("equal")
    ax.set_title(f"Step {step + 1} - Active: {int(active.sum())}")
    ax.set_xlabel("x [mm]")
    ax.set_ylabel("y [mm]")
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def plot_growth_summary(history, out_dir: str):
    """3-panel time series: total length / branches+merges / tip counts."""
    plt, _, _ = _mpl()
    steps = [h["step"] for h in history]
    fig, axes = plt.subplots(3, 1, figsize=(8, 9), sharex=True)
    for ax in axes:
        ax.spines["right"].set_visible(False)
        ax.spines["top"].set_visible(False)
    axes[0].plot(steps, [h["total_length_mm"] for h in history],
                 label="Total Hyphal Length")
    axes[0].set_ylabel("Length [mm]")
    axes[0].legend()
    axes[1].plot(steps, [h["branches"] for h in history], label="Branches")
    axes[1].plot(steps, [h["anastomosed"] for h in history],
                 label="Merges (Anastomoses)")
    axes[1].set_ylabel("Count")
    axes[1].legend()
    axes[2].plot(steps, [h["active_tips"] for h in history],
                 label="Active Tips")
    axes[2].plot(steps, [h["passive_tips"] for h in history],
                 label="Passive Tips")
    axes[2].set_ylabel("Tips")
    axes[2].set_xlabel("Simulation Step")
    axes[2].legend()
    fig.tight_layout()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "mycelium_growth_summary.png")
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def plot_force_displacement(force_disp, out_path: str):
    plt, _, _ = _mpl()
    fd = np.asarray(force_disp)
    fig = plt.figure(figsize=(6, 4))
    plt.plot(fd[:, 0], fd[:, 1], marker="o")
    plt.xlabel("Total Displacement (mm)")
    plt.ylabel("Reaction Force (N)")
    plt.title("Force–Displacement Curve")
    plt.grid(True)
    plt.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def plot_snapshot_csv(csv_path: str, out_png: str, dish_size: float = 5.0):
    """Render a C++-contract snapshot CSV (x1,y1,x2,y2,intensity) — the
    reference's standalone src/plot_snapshots.py:11-38."""
    data = np.loadtxt(csv_path, delimiter=",", skiprows=1, ndmin=2)
    if data.size == 0:
        data = np.zeros((0, 5))
    starts = np.concatenate([data[:, 0:2], np.zeros((len(data), 1))], axis=1)
    ends = np.concatenate([data[:, 2:4], np.zeros((len(data), 1))], axis=1)
    step = 0
    base = os.path.basename(csv_path)
    digits = "".join(c for c in base if c.isdigit())
    if digits:
        step = int(digits)
    return plot_mycelium(starts, ends, data[:, 4], step, out_png,
                         dish_size=dish_size)
