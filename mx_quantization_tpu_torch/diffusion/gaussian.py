"""Gaussian diffusion: the linear and squaredcos beta schedules, timestep
respacing, the forward process and posterior, the ancestral DDPM and DDIM
steps and loops, and the training losses (port of the JAX package's
``diffusion/gaussian.py``).

Coefficient tables are float64 numpy arrays; each step gathers them in
float32 from a copy that goes onto a device once and stays cached there,
so no step uploads a table (an upload from the host would wait for the
device).  The model callable always receives ORIGINAL timesteps
(``timestep_map`` maps a respaced index to its original timestep).  The
step noise is an argument, so a caller can replay any noise sequence.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Set

import numpy as np
import torch


def linear_beta_schedule(num_timesteps: int) -> np.ndarray:
    scale = 1000.0 / num_timesteps
    return np.linspace(scale * 1e-4, scale * 0.02, num_timesteps,
                       dtype=np.float64)


def squaredcos_beta_schedule(num_timesteps: int) -> np.ndarray:
    def alpha_bar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
    betas = []
    for i in range(num_timesteps):
        t1, t2 = i / num_timesteps, (i + 1) / num_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), 0.999))
    return np.array(betas, dtype=np.float64)


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


# the tables a step gathers, in float32 on the step's device
_TABLES = ("alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
           "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
           "sqrt_recipm1_alphas_cumprod", "posterior_log_variance_clipped",
           "log_betas", "posterior_mean_coef1", "posterior_mean_coef2")


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
        self.sqrt_alphas_cumprod = np.sqrt(self.alphas_cumprod)
        self.sqrt_one_minus_alphas_cumprod = np.sqrt(1 - self.alphas_cumprod)
        self.sqrt_recip_alphas_cumprod = np.sqrt(1.0 / self.alphas_cumprod)
        self.sqrt_recipm1_alphas_cumprod = np.sqrt(
            1.0 / self.alphas_cumprod - 1)
        self.posterior_variance = (
            betas * (1.0 - self.alphas_cumprod_prev) /
            (1.0 - self.alphas_cumprod))
        self.posterior_log_variance_clipped = np.log(
            np.append(self.posterior_variance[1], self.posterior_variance[1:]))
        self.log_betas = np.log(betas)
        self.posterior_mean_coef1 = (
            betas * np.sqrt(self.alphas_cumprod_prev) /
            (1.0 - self.alphas_cumprod))
        self.posterior_mean_coef2 = (
            (1.0 - self.alphas_cumprod_prev) * np.sqrt(alphas) /
            (1.0 - self.alphas_cumprod))
        self._on_device: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    # ------------------------------------------------------------------
    def device_tables(self, device) -> Dict[str, torch.Tensor]:
        """The float32 tables and the int64 ``timestep_map`` on ``device``,
        uploaded together at the first call for that device."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        tabs = self._on_device.get(device)
        if tabs is None:
            tabs = {name: torch.as_tensor(getattr(self, name),
                                          dtype=torch.float32).to(device)
                    for name in _TABLES}
            tabs["timestep_map"] = torch.as_tensor(self.timestep_map).to(
                device)
            self._on_device[device] = tabs
        return tabs

    def _gather(self, name: str, t: torch.Tensor, ndim: int) -> torch.Tensor:
        out = self.device_tables(t.device)[name][t]
        return out.reshape(out.shape + (1,) * (ndim - 1))

    def model_t(self, t: torch.Tensor) -> torch.Tensor:
        """Map spaced timestep indices to original model timesteps."""
        return self.device_tables(t.device)["timestep_map"][t]

    def q_sample(self, x0, t, noise):
        return (self._gather("sqrt_alphas_cumprod", t, x0.dim()) * x0 +
                self._gather("sqrt_one_minus_alphas_cumprod", t, x0.dim())
                * noise)

    def q_posterior_mean(self, x0, xt, t):
        return (self._gather("posterior_mean_coef1", t, xt.dim()) * x0 +
                self._gather("posterior_mean_coef2", t, xt.dim()) * xt)

    def _predict_x0_from_eps(self, xt, t, eps):
        return (self._gather("sqrt_recip_alphas_cumprod", t, xt.dim()) * xt -
                self._gather("sqrt_recipm1_alphas_cumprod", t, xt.dim())
                * eps)

    def p_mean_variance(self, model_out, x, t, clip_denoised=False):
        """model_out: (B, 2C or C, ...) -> (mean, log_variance, pred_x0)."""
        nd = x.dim()
        if self.learn_sigma:
            eps, v = model_out.chunk(2, dim=1)
            min_log = self._gather("posterior_log_variance_clipped", t, nd)
            max_log = self._gather("log_betas", t, nd)
            frac = (v + 1) / 2
            log_var = frac * max_log + (1 - frac) * min_log
        else:
            eps = model_out
            log_var = self._gather("posterior_log_variance_clipped", t, nd)
        x0 = self._predict_x0_from_eps(x, t, eps)
        if clip_denoised:
            x0 = x0.clamp(-1, 1)
        return self.q_posterior_mean(x0, x, t), log_var, x0

    def _model_out(self, model, x, i, model_kwargs):
        t = torch.full((x.shape[0],), i, dtype=torch.int64, device=x.device)
        return model(x, self.model_t(t).to(torch.float32),
                     **(model_kwargs or {})), t

    # ------------------------------------------------------------------
    def p_sample_step(self, model: Callable, x: torch.Tensor, i: int,
                      noise: torch.Tensor, clip_denoised: bool = False,
                      model_kwargs=None) -> torch.Tensor:
        """One ancestral sampling step at spaced index ``i`` with the given
        standard-normal ``noise`` (unused at i == 0)."""
        out, t = self._model_out(model, x, i, model_kwargs)
        mean, log_var, _ = self.p_mean_variance(out, x, t, clip_denoised)
        nonzero = float(i != 0)
        return mean + nonzero * torch.exp(0.5 * log_var) * noise

    def _loop(self, step, shape, generator, noise, step_noise):
        """Run ``step(x, i, noise_i)`` over i = T-1 ... 0 from ``noise``
        (else drawn from ``generator``), each step's noise from
        ``step_noise`` (else drawn) in sampling order."""
        def draw():
            if generator is None:
                raise ValueError("pass a generator, or noise and step_noise")
            return torch.randn(shape, generator=generator,
                               device=generator.device)

        x = draw() if noise is None else noise
        for n, i in enumerate(reversed(range(self.num_timesteps))):
            z = draw() if step_noise is None else step_noise[n]
            x = step(x, i, z.to(x.device))
        return x

    def p_sample_loop(self, model: Callable, shape,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None,
                      step_noise: Optional[Sequence[torch.Tensor]] = None,
                      clip_denoised: bool = False,
                      model_kwargs=None) -> torch.Tensor:
        """Full DDPM loop from the initial ``noise`` (else one draw of
        ``shape`` from ``generator``, on the generator's device), one draw
        per step unless ``step_noise`` gives each step's noise in sampling
        order."""
        with torch.inference_mode():
            return self._loop(
                lambda x, i, z: self.p_sample_step(
                    model, x, i, z, clip_denoised, model_kwargs),
                shape, generator, noise, step_noise)

    # ------------------------------------------------------------------
    def ddim_sample_step(self, model: Callable, x: torch.Tensor, i: int,
                         noise: torch.Tensor, eta: float = 0.0,
                         clip_denoised: bool = False,
                         model_kwargs=None) -> torch.Tensor:
        """One DDIM step at spaced index ``i``; ``noise`` is scaled by
        eta's sigma and unused at i == 0."""
        out, t = self._model_out(model, x, i, model_kwargs)
        _, _, x0 = self.p_mean_variance(out, x, t, clip_denoised)
        nd = x.dim()
        eps = ((self._gather("sqrt_recip_alphas_cumprod", t, nd) * x - x0) /
               self._gather("sqrt_recipm1_alphas_cumprod", t, nd))
        ab = self._gather("alphas_cumprod", t, nd)
        ab_prev = self._gather("alphas_cumprod_prev", t, nd)
        sigma = (eta * torch.sqrt((1 - ab_prev) / (1 - ab)) *
                 torch.sqrt(1 - ab / ab_prev))
        mean = (torch.sqrt(ab_prev) * x0 +
                torch.sqrt(1 - ab_prev - sigma ** 2) * eps)
        nonzero = float(i != 0)
        return mean + nonzero * sigma * noise

    def ddim_sample_loop(self, model: Callable, shape,
                         generator: Optional[torch.Generator] = None,
                         noise: Optional[torch.Tensor] = None,
                         step_noise: Optional[Sequence[torch.Tensor]] = None,
                         eta: float = 0.0, clip_denoised: bool = False,
                         model_kwargs=None) -> torch.Tensor:
        """Full DDIM loop; the noise as in ``p_sample_loop``."""
        with torch.inference_mode():
            return self._loop(
                lambda x, i, z: self.ddim_sample_step(
                    model, x, i, z, eta, clip_denoised, model_kwargs),
                shape, generator, noise, step_noise)


    # ------------------------------------------------------------------
    @staticmethod
    def _discretized_gaussian_log_likelihood(x, means, log_scales):
        """Log-likelihood of a gaussian discretized to the +-1/255 image
        grid (reference diffusion_utils.py:62-88, tanh-approximated normal
        CDF :39-44)."""
        def cdf(v):
            return 0.5 * (1.0 + torch.tanh(
                math.sqrt(2.0 / math.pi) * (v + 0.044715 * v ** 3)))

        centered = x - means
        inv_stdv = torch.exp(-log_scales)
        cdf_plus = cdf(inv_stdv * (centered + 1.0 / 255.0))
        cdf_min = cdf(inv_stdv * (centered - 1.0 / 255.0))
        log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
        log_one_minus = torch.log((1.0 - cdf_min).clamp(min=1e-12))
        log_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
        return torch.where(x < -0.999, log_cdf_plus,
                           torch.where(x > 0.999, log_one_minus, log_delta))

    def training_losses(self, model: Callable, x0: torch.Tensor,
                        t: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        model_kwargs=None,
                        noise: Optional[torch.Tensor] = None
                        ) -> Dict[str, torch.Tensor]:
        """MSE(eps) + VB loss terms per sample (reference :717-784): the VB
        term takes the model's variance with the mean's eps detached, and
        at t == 0 it is the decoder NLL of the discretized gaussian.  The
        noise is ``noise`` if given, else one standard-normal draw of x0's
        shape from ``generator``, on the generator's device."""
        if noise is None:
            if generator is None:
                raise ValueError("pass a generator or noise")
            noise = torch.randn(x0.shape, generator=generator,
                                device=generator.device, dtype=x0.dtype)
        xt = self.q_sample(x0, t, noise)
        out = model(xt, self.model_t(t).to(torch.float32),
                    **(model_kwargs or {}))

        terms = {}
        if self.learn_sigma:
            eps, v = out.chunk(2, dim=1)
            # the vb term with the mean frozen (no gradient through eps)
            frozen = torch.cat([eps.detach(), v], dim=1)
            mean, log_var, _ = self.p_mean_variance(frozen, xt, t)
            true_mean = self.q_posterior_mean(x0, xt, t)
            true_log_var = self._gather("posterior_log_variance_clipped", t,
                                        xt.dim())
            kl = 0.5 * (-1.0 + log_var - true_log_var +
                        torch.exp(true_log_var - log_var) +
                        (true_mean - mean) ** 2 * torch.exp(-log_var))
            axes = tuple(range(1, kl.dim()))
            vb_kl = kl.mean(axes) / math.log(2.0)
            nll = -self._discretized_gaussian_log_likelihood(
                x0, mean, 0.5 * log_var)
            vb_nll = nll.mean(axes) / math.log(2.0)
            terms["vb"] = torch.where(t == 0, vb_nll, vb_kl)
        else:
            eps = out
        terms["mse"] = ((noise - eps) ** 2).mean(tuple(range(1, eps.dim())))
        terms["loss"] = terms["mse"] + terms["vb"] if "vb" in terms \
            else terms["mse"]
        return terms


def create_diffusion(timestep_respacing: Optional[str] = None,
                     noise_schedule: str = "linear",
                     diffusion_steps: int = 1000,
                     learn_sigma: bool = True) -> GaussianDiffusion:
    """Reference create_diffusion (its diffusion/__init__.py:10-46)."""
    if noise_schedule == "linear":
        betas = linear_beta_schedule(diffusion_steps)
    elif noise_schedule == "squaredcos_cap_v2":
        betas = squaredcos_beta_schedule(diffusion_steps)
    else:
        raise ValueError(f"unknown schedule {noise_schedule!r}")
    use = (space_timesteps(diffusion_steps, timestep_respacing)
           if timestep_respacing else None)
    return GaussianDiffusion(betas, use_timesteps=use,
                             learn_sigma=learn_sigma)
