"""The benchmark of ``mycelium_tpu_torch``, the PyTorch and CUDA port.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line. Everything here is found by name: configurations in
``configs/``, traffic mixes in ``traffic/``, per-layer readers in
``metrics/``, correctness limits in ``limits/``. The plain reference that
decides ``correct`` is ``reference/`` (NumPy and SciPy only)."""
