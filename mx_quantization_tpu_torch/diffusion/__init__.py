"""Diffusion sampling: DDPM with respacing (DiT) and DPM-Solver++(2M)
(PixArt-alpha)."""

from .dpm_solver import DPMSolverMultistep
from .gaussian import (GaussianDiffusion, create_diffusion,
                       linear_beta_schedule, space_timesteps)

__all__ = ["DPMSolverMultistep", "GaussianDiffusion", "create_diffusion",
           "linear_beta_schedule", "space_timesteps"]
