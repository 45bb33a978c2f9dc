"""Workload entry points (slice 1: DiT sampling)."""
