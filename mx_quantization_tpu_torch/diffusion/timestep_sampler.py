"""Timestep samplers for diffusion training (port of the JAX package's
``diffusion/timestep_sampler.py``): a uniform sampler and the
importance-weighted loss-second-moment resampler of "Improved Denoising
Diffusion Probabilistic Models" (reference
``workloads/DiT/diffusion/timestep_sampler.py``).

The resampler's state is functional, as in JAX: ``(history (T, H),
counts (T,))`` tensors that the caller passes through its loop; ``update``
returns the new state.  Draws come from the caller's ``torch.Generator``,
on the generator's device.
"""

from __future__ import annotations

from typing import Tuple

import torch


class UniformSampler:
    """t ~ U{0, T-1}; weights = 1 (timestep_sampler.py UniformSampler)."""

    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps

    def sample(self, generator: torch.Generator, batch: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        dev = generator.device
        t = torch.randint(0, self.num_timesteps, (batch,),
                          generator=generator, device=dev)
        return t, torch.ones((batch,), dtype=torch.float32, device=dev)


class LossSecondMomentResampler:
    """Importance-sample timesteps by the running second moment of their
    loss: a history of ``history_per_term`` losses per t; p_t is
    proportional to sqrt(E[L_t^2]) (uniform until every t holds a full
    history), mixed with uniform by ``uniform_prob``."""

    def __init__(self, num_timesteps: int, history_per_term: int = 10,
                 uniform_prob: float = 0.001):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob

    def init_state(self, device="cpu"):
        return (torch.zeros((self.num_timesteps, self.history_per_term),
                            dtype=torch.float32, device=device),
                torch.zeros((self.num_timesteps,), dtype=torch.int32,
                            device=device))

    def weights_from_state(self, state) -> torch.Tensor:
        history, counts = state
        w = torch.sqrt((history ** 2).mean(-1))
        warm = (counts >= self.history_per_term).all()
        w = torch.where(warm, w, torch.ones_like(w))
        w = w / w.sum()
        return (w * (1 - self.uniform_prob)
                + self.uniform_prob / self.num_timesteps)

    def sample(self, generator: torch.Generator, batch: int, state
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(t, importance weights 1 / (T p_t))."""
        p = self.weights_from_state(state)
        t = torch.multinomial(p.to(generator.device), batch,
                              replacement=True, generator=generator)
        t = t.to(p.device)
        return t, 1.0 / (self.num_timesteps * p[t])

    def update(self, state, t: torch.Tensor, losses: torch.Tensor):
        """Record per-sample losses at their timesteps: each loss goes to
        slot ``counts[t] % H`` of its ring buffer and the count is bumped
        (scatter semantics: of equal t in one batch, each writes the slot
        the state held before the call, and each bumps the count)."""
        history, counts = state
        slot = counts[t].long() % self.history_per_term
        history = history.index_put((t, slot),
                                    losses.to(torch.float32))
        counts = counts.index_add(0, t, torch.ones_like(t, dtype=counts.dtype))
        return history, counts
