"""Workload entry points: DiT and PixArt-alpha sampling, DeiT evaluation."""
