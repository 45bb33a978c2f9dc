"""Samplers for training input pipelines (port of the JAX package's
``data/samplers.py``).

ra_sampler_indices re-implements the reference's RASampler
(workloads/deit/samplers.py:8-64): repeated augmentation — each of
``num_repeats`` copies of every sample is distributed across processes, and
each epoch keeps ``len(dataset) * selected / num_repeats`` of them.
"""

from __future__ import annotations

import math

import numpy as np


def ra_sampler_indices(n: int, rank: int, world: int, seed: int,
                       num_repeats: int = 3) -> np.ndarray:
    """Shuffled, repeated, sharded indices for one epoch."""
    rng = np.random.RandomState(seed)
    order = rng.permutation(n)
    rep = np.repeat(order, num_repeats)
    num_samples = int(math.ceil(len(rep) / world))
    total = num_samples * world
    rep = np.concatenate([rep, rep[: total - len(rep)]])
    shard = rep[rank:total:world]
    num_selected = int(math.floor(n / 256)) * 256 // world \
        if n >= 256 else num_samples
    return shard[:max(num_selected, 1)]
