"""Per-layer metrics of the benchmark, one reader per file, found by name."""
