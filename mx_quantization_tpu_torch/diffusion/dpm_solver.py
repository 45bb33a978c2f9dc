"""DPM-Solver++ (2M) multistep scheduler for PixArt-style text-to-image
sampling (port of the JAX package's ``diffusion/dpm_solver.py``; the
reference pipeline uses diffusers' DPMSolverMultistepScheduler with 20
steps).

Epsilon prediction, data-prediction (dpmsolver++) formulation, 2nd-order
multistep; scaled-linear betas as in Stable-Diffusion-family models.  The
tables are float64 numpy, as in the JAX package; each step's coefficients
reach the tensors as float32 scalars, and ``expm1(-h)`` is evaluated in
float32 on a float32 argument, which is what the JAX code computes with
64-bit types off.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def _f32(value, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(value), dtype=torch.float32, device=like.device)


class DPMSolverMultistep:
    def __init__(self, num_train_timesteps: int = 1000,
                 beta_start: float = 0.00085, beta_end: float = 0.012,
                 beta_schedule: str = "scaled_linear",
                 solver_order: int = 2):
        if beta_schedule == "scaled_linear":
            betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                                num_train_timesteps, dtype=np.float64) ** 2
        elif beta_schedule == "linear":
            betas = np.linspace(beta_start, beta_end, num_train_timesteps,
                                dtype=np.float64)
        else:
            raise ValueError(beta_schedule)
        self.num_train_timesteps = num_train_timesteps
        alphas_cumprod = np.cumprod(1.0 - betas)
        self.alpha_t = np.sqrt(alphas_cumprod)
        self.sigma_t = np.sqrt(1 - alphas_cumprod)
        self.lambda_t = np.log(self.alpha_t) - np.log(self.sigma_t)
        self.solver_order = solver_order

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        # diffusers-style linspace over [0, T-1], descending
        t = np.linspace(0, self.num_train_timesteps - 1,
                        num_inference_steps + 1).round()[::-1][:-1]
        return t.astype(np.int64)

    def step(self, x: torch.Tensor, eps: torch.Tensor, ts: np.ndarray, i: int,
             prev_x0: Optional[torch.Tensor]):
        """Solver step ``i`` of the schedule ``ts`` from state ``x`` with the
        model's ``eps``; ``prev_x0`` is the last step's data prediction
        (None at the first step).  Returns (next x, this step's x0)."""
        t_idx = int(ts[i])
        x0 = (x - _f32(self.sigma_t[t_idx], x) * eps) / _f32(
            self.alpha_t[t_idx], x)
        s_t = int(ts[i + 1]) if i + 1 < len(ts) else 0
        h = self.lambda_t[s_t] - self.lambda_t[t_idx]
        decay = _f32(self.sigma_t[s_t] / self.sigma_t[t_idx], x)
        coef = _f32(self.alpha_t[s_t], x) * torch.expm1(_f32(-h, x))
        if prev_x0 is None or self.solver_order == 1:
            # DPM-Solver++(1) == DDIM in data space
            d = x0
        else:
            h_prev = self.lambda_t[t_idx] - self.lambda_t[int(ts[i - 1])]
            r = h_prev / h if h != 0 else 1.0
            d = _f32(1 + 1 / (2 * r), x) * x0 - _f32(1 / (2 * r), x) * prev_x0
        return decay * x - coef * d, x0

    def sample(self, model: Callable, x: torch.Tensor,
               num_inference_steps: int = 20, model_kwargs=None,
               guidance_scale: float = 0.0, uncond_kwargs=None
               ) -> torch.Tensor:
        """Run DPM-Solver++(2M) from the initial noise ``x``.
        ``model(x, t, **kwargs) -> eps``; with ``guidance_scale`` and
        ``uncond_kwargs`` it runs CFG over two model calls."""
        model_kwargs = model_kwargs or {}
        ts = self.timesteps(num_inference_steps)
        prev_x0 = None
        for i, t_idx in enumerate(ts):
            t = torch.full((x.shape[0],), float(t_idx), dtype=torch.float32,
                           device=x.device)
            eps = model(x, t, **model_kwargs)
            if guidance_scale and uncond_kwargs is not None:
                eps_u = model(x, t, **uncond_kwargs)
                eps = eps_u + guidance_scale * (eps - eps_u)
            x, prev_x0 = self.step(x, eps, ts, i, prev_x0)
        return x
