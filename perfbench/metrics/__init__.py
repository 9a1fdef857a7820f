"""Per-layer metrics: one reader per file, named as in BENCHMARK.json."""
