"""Plots of the port (``plots.py``); matplotlib is loaded only when one is
drawn."""

from .plots import (plot_force_displacement, plot_growth_summary,
                    plot_mycelium, plot_network, plot_snapshot_csv,
                    require_matplotlib)

__all__ = ["plot_mycelium", "plot_network", "plot_growth_summary",
           "plot_force_displacement", "plot_snapshot_csv",
           "require_matplotlib"]
