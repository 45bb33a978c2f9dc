"""Diffusion: DDPM and DDIM with respacing (DiT), DPM-Solver++(2M)
(PixArt-alpha), the training losses and the timestep samplers."""

from .dpm_solver import DPMSolverMultistep
from .gaussian import (GaussianDiffusion, create_diffusion,
                       linear_beta_schedule, space_timesteps)
from .timestep_sampler import LossSecondMomentResampler, UniformSampler

__all__ = ["DPMSolverMultistep", "GaussianDiffusion",
           "LossSecondMomentResampler", "UniformSampler", "create_diffusion",
           "linear_beta_schedule", "space_timesteps"]
