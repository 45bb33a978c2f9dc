"""Gaussian diffusion sampling (DDPM with respacing)."""

from .gaussian import (GaussianDiffusion, create_diffusion,
                       linear_beta_schedule, space_timesteps)

__all__ = ["GaussianDiffusion", "create_diffusion", "linear_beta_schedule",
           "space_timesteps"]
