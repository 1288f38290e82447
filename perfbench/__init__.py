"""Benchmark of gnxraytracer_tpu_torch (see harness.py)."""
