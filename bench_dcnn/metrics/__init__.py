"""Per-layer metrics, one reader a file, named as in ``BENCHMARK.json``:
``read(ctx)`` takes the traced window's ``harness.Context`` and returns
the value, or None where the cell gives it nothing to read."""
