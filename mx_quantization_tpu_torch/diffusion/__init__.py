"""Diffusion sampling: DDPM and DDIM with respacing (DiT) and
DPM-Solver++(2M) (PixArt-alpha).  The JAX package's exports but its
timestep samplers, which belong to training (ROADMAP.md)."""

from .dpm_solver import DPMSolverMultistep
from .gaussian import (GaussianDiffusion, create_diffusion,
                       linear_beta_schedule, space_timesteps)

__all__ = ["DPMSolverMultistep", "GaussianDiffusion", "create_diffusion",
           "linear_beta_schedule", "space_timesteps"]
