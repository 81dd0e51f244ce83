"""The port's CSV contracts: mesh readers and result writers (copies of
``mycelium_tpu/io``'s, byte-identical output)."""

from .readers import read_fea_records, read_mesh, read_mesh_dir
from .writers import (dedup_nodes, export_geometry, write_fea_records,
                      write_growth_stats, write_runtime,
                      write_snapshot_csv, write_solve_runtimes,
                      write_sweep_results)

__all__ = ["read_fea_records", "read_mesh", "read_mesh_dir", "dedup_nodes",
           "export_geometry", "write_fea_records", "write_growth_stats",
           "write_runtime", "write_snapshot_csv", "write_solve_runtimes",
           "write_sweep_results"]
