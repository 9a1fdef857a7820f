"""Benchmark harness of densityflows_tpu_torch (see README.md)."""
