"""The benchmark of visfs_tpu_torch: one command (``python3 -m
benchmark.run``) runs one cell of BENCHMARK.json once.  Everything that
belongs to one configuration, traffic mix, cell or per-layer metric is a
file of its own (``configs/``, ``traffic/``, ``limits/``, ``metrics/``),
found by the name BENCHMARK.json gives it."""
