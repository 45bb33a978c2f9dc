"""Gaussian diffusion for sampling: the linear beta schedule, timestep
respacing and the ancestral DDPM step (port of the JAX package's
``diffusion/gaussian.py``, sampling part).

Coefficient tables are float64 numpy arrays gathered per step in float32.
The model callable always receives ORIGINAL timesteps (``timestep_map``
maps a respaced index to its original timestep).  The step noise is an
argument, so a caller can replay any noise sequence.
"""

from __future__ import annotations

from typing import Callable, Optional, Set

import numpy as np
import torch


def linear_beta_schedule(num_timesteps: int) -> np.ndarray:
    scale = 1000.0 / num_timesteps
    return np.linspace(scale * 1e-4, scale * 0.02, num_timesteps,
                       dtype=np.float64)


def space_timesteps(num_timesteps: int, section_counts) -> Set[int]:
    """Evenly spaced subset of original timesteps (reference respace.py).

    section_counts: int, "ddimN", or a comma list of per-section counts.
    """
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired:
                    return set(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {desired} ddim steps")
        section_counts = [int(x) for x in section_counts.split(",")]
    elif isinstance(section_counts, int):
        section_counts = [section_counts]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx, all_steps = 0, []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(
                f"cannot divide section of {size} steps into {count}")
        stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            all_steps.append(start_idx + round(cur))
            cur += stride
        start_idx += size
    return set(all_steps)


def _gather(arr: np.ndarray, t: torch.Tensor, ndim: int) -> torch.Tensor:
    out = torch.as_tensor(arr, dtype=torch.float32, device=t.device)[t]
    return out.reshape(out.shape + (1,) * (ndim - 1))


class GaussianDiffusion:
    """Diffusion with precomputed (possibly respaced) coefficient tables."""

    def __init__(self, betas: np.ndarray,
                 use_timesteps: Optional[Set[int]] = None,
                 learn_sigma: bool = True):
        betas = np.asarray(betas, np.float64)
        self.learn_sigma = learn_sigma
        if use_timesteps is not None:
            # respace: recompute betas over the kept timesteps
            alphas_cumprod = np.cumprod(1.0 - betas)
            last = 1.0
            new_betas, tmap = [], []
            for i, ac in enumerate(alphas_cumprod):
                if i in use_timesteps:
                    new_betas.append(1 - ac / last)
                    last = ac
                    tmap.append(i)
            betas = np.array(new_betas, np.float64)
            self.timestep_map = np.array(tmap, np.int64)
        else:
            self.timestep_map = np.arange(len(betas))

        self.betas = betas
        self.num_timesteps = len(betas)
        alphas = 1.0 - betas
        self.alphas_cumprod = np.cumprod(alphas)
        self.alphas_cumprod_prev = np.append(1.0, self.alphas_cumprod[:-1])
        self.sqrt_recip_alphas_cumprod = np.sqrt(1.0 / self.alphas_cumprod)
        self.sqrt_recipm1_alphas_cumprod = np.sqrt(
            1.0 / self.alphas_cumprod - 1)
        self.posterior_variance = (
            betas * (1.0 - self.alphas_cumprod_prev) /
            (1.0 - self.alphas_cumprod))
        self.posterior_log_variance_clipped = np.log(
            np.append(self.posterior_variance[1], self.posterior_variance[1:]))
        self.posterior_mean_coef1 = (
            betas * np.sqrt(self.alphas_cumprod_prev) /
            (1.0 - self.alphas_cumprod))
        self.posterior_mean_coef2 = (
            (1.0 - self.alphas_cumprod_prev) * np.sqrt(alphas) /
            (1.0 - self.alphas_cumprod))

    def model_t(self, t: torch.Tensor) -> torch.Tensor:
        """Map spaced timestep indices to original model timesteps."""
        return torch.as_tensor(self.timestep_map, device=t.device)[t]

    def p_mean_variance(self, model_out, x, t, clip_denoised=False):
        """model_out: (B, 2C or C, ...) -> (mean, log_variance, pred_x0)."""
        nd = x.dim()
        if self.learn_sigma:
            eps, v = model_out.chunk(2, dim=1)
            min_log = _gather(self.posterior_log_variance_clipped, t, nd)
            max_log = _gather(np.log(self.betas), t, nd)
            frac = (v + 1) / 2
            log_var = frac * max_log + (1 - frac) * min_log
        else:
            eps = model_out
            log_var = _gather(self.posterior_log_variance_clipped, t, nd)
        x0 = (_gather(self.sqrt_recip_alphas_cumprod, t, nd) * x -
              _gather(self.sqrt_recipm1_alphas_cumprod, t, nd) * eps)
        if clip_denoised:
            x0 = x0.clamp(-1, 1)
        mean = (_gather(self.posterior_mean_coef1, t, nd) * x0 +
                _gather(self.posterior_mean_coef2, t, nd) * x)
        return mean, log_var, x0

    def p_sample_step(self, model: Callable, x: torch.Tensor, i: int,
                      noise: torch.Tensor, clip_denoised: bool = False,
                      model_kwargs=None) -> torch.Tensor:
        """One ancestral sampling step at spaced index ``i`` with the given
        standard-normal ``noise`` (unused at i == 0)."""
        model_kwargs = model_kwargs or {}
        t = torch.full((x.shape[0],), i, dtype=torch.int64, device=x.device)
        out = model(x, self.model_t(t).to(torch.float32), **model_kwargs)
        mean, log_var, _ = self.p_mean_variance(out, x, t, clip_denoised)
        nonzero = float(i != 0)
        return mean + nonzero * torch.exp(0.5 * log_var) * noise


def create_diffusion(timestep_respacing: Optional[str] = None,
                     diffusion_steps: int = 1000,
                     learn_sigma: bool = True) -> GaussianDiffusion:
    """Reference create_diffusion with the linear schedule."""
    use = (space_timesteps(diffusion_steps, timestep_respacing)
           if timestep_respacing else None)
    return GaussianDiffusion(linear_beta_schedule(diffusion_steps),
                             use_timesteps=use, learn_sigma=learn_sigma)
