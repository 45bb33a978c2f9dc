"""DiT training (port of the JAX package's ``workloads/dit_train.py``;
reference workloads/DiT/train.py:87-269): AdamW at weight decay 0, the
1000-step linear schedule's MSE + VB loss, and an EMA of the parameters,
on one device.

Quantization-aware training takes specs with ``quantize_backprop=True``:
the forward runs the kernels (K1, K2) where the plan routes to them, and
the backward is the JAX package's custom VJPs (``ops/linear.py``,
``attention.py``).  The trained tensors are the JAX parameter tree's
leaves: every parameter of the ``DiT`` module and its position table
(a leaf of the JAX tree, so JAX's optimizer updates it; the reference
keeps it fixed).  There is no label dropout, as in JAX's ``dit_forward``.

Run a few steps on synthetic latents (unquantized, as the JAX CLI does):
    python -m mx_quantization_tpu_torch.workloads.dit_train --device cpu \
        --model DiT-S/8 --steps 4 --batch 2
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..diffusion.gaussian import GaussianDiffusion, create_diffusion
from ..models.dit import (DiT, DiT_models, DiTConfig, DiTQuantConfig,
                          dit_forward, init_dit)
from ..utils.checkpoint import save_params


def trainable_tensors(model: DiT) -> List[torch.Tensor]:
    """The JAX DiT parameter tree's leaves, made to require grad: the
    module's parameters and the position table."""
    model.requires_grad_(True)
    model.pos_embed.requires_grad_(True)
    return [*model.parameters(), model.pos_embed]


@torch.no_grad()
def update_ema(ema: List[torch.Tensor], params: List[torch.Tensor],
               decay: float = 0.9999) -> None:
    """EMA <- decay * EMA + (1 - decay) * params, in place (reference
    train.py:40-49)."""
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, params, alpha=1 - decay)


def make_train_step(model: DiT, ema: List[torch.Tensor],
                    qcfg: DiTQuantConfig, diffusion: GaussianDiffusion,
                    optimizer: torch.optim.Optimizer) -> Callable:
    """One training step ``step(x0, y, t, noise, weights=None) -> loss``:
    the weighted mean of ``training_losses`` at timesteps ``t`` with
    ``noise``, its gradients, an optimizer step and the EMA update of
    ``ema`` (in ``trainable_tensors`` order).  The model, optimizer and EMA
    change in place; the loss is returned on the device, unsynchronized."""
    params = trainable_tensors(model)

    def model_fn(xt, tt, y):
        return dit_forward(model, xt, tt, y, qcfg)

    def train_step(x0: torch.Tensor, y: torch.Tensor, t: torch.Tensor,
                   noise: torch.Tensor,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        terms = diffusion.training_losses(model_fn, x0, t,
                                          model_kwargs={"y": y}, noise=noise)
        loss = terms["loss"].mean() if weights is None \
            else (terms["loss"] * weights).mean()
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        update_ema(ema, params)
        return loss.detach()

    return train_step


def draw_timesteps_and_noise(generator: torch.Generator, x0: torch.Tensor,
                             num_timesteps: int, timestep_sampler=None):
    """A step's random inputs from ``generator``, on x0's device: t (uniform
    unless ``timestep_sampler`` gives t and importance weights), then the
    standard-normal noise of x0's shape.  -> (t, noise, weights or None)."""
    B = x0.shape[0]
    if timestep_sampler is not None:
        t, weights = timestep_sampler.sample(generator, B)
        weights = weights.to(x0.device)
    else:
        t = torch.randint(0, num_timesteps, (B,), generator=generator,
                          device=generator.device)
        weights = None
    noise = torch.randn(x0.shape, generator=generator,
                        device=generator.device)
    return t.to(x0.device), noise.to(x0.device), weights


def train(cfg: DiTConfig, qcfg: DiTQuantConfig, data_iter, steps: int = 1000,
          lr: float = 1e-4, ckpt_every: int = 0, results_dir: str = "results",
          log_every: int = 100, mesh=None, seed: int = 0, device="cuda",
          model: Optional[DiT] = None):
    """Train on ``data_iter``'s (latents (B, 4, h, w), labels (B,)) batches,
    numpy arrays or tensors, for up to ``steps`` steps.  The model is
    ``init_dit``'s from ``seed`` unless given; timesteps and noise come
    from a generator on the device seeded ``seed + 1``.  Every
    ``ckpt_every`` steps ``{"model": ..., "ema": ...}`` (state dicts) goes
    to ``results_dir/<step>.pkl``.  Returns (model, ema state dict)."""
    if mesh is not None:
        raise NotImplementedError(
            "training over a device mesh is not ported yet (ROADMAP.md "
            "section 1, parallelism)")
    device = resolve_device(device)
    if model is None:
        model = init_dit(cfg, torch.Generator().manual_seed(seed), device)
    params = trainable_tensors(model)
    ema = [p.detach().clone() for p in params]
    optimizer = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=0.0)
    diffusion = create_diffusion(None)  # 1000 linear steps (train.py:112)
    step_fn = make_train_step(model, ema, qcfg, diffusion, optimizer)
    gen = torch.Generator(device=device).manual_seed(seed + 1)

    running, t0 = [], time.time()
    for step, (x0, y) in enumerate(data_iter):
        if step >= steps:
            break
        x0 = torch.as_tensor(x0, dtype=torch.float32).to(device)
        y = torch.as_tensor(y).to(device)
        t, noise, _ = draw_timesteps_and_noise(gen, x0,
                                               diffusion.num_timesteps)
        running.append(step_fn(x0, y, t, noise))
        if log_every and (step + 1) % log_every == 0:
            lv = torch.stack(running).mean().item()
            sps = log_every / (time.time() - t0)
            print(f"step {step + 1}: loss {lv:.4f} ({sps:.2f} steps/s)")
            running, t0 = [], time.time()
        if ckpt_every and (step + 1) % ckpt_every == 0:
            os.makedirs(results_dir, exist_ok=True)
            save_params(os.path.join(results_dir, f"{step + 1:07d}.pkl"),
                        {"model": model.state_dict(),
                         "ema": ema_state_dict(model, ema)})
    return model, ema_state_dict(model, ema)


def ema_state_dict(model: DiT, ema: List[torch.Tensor]) -> dict:
    """The EMA tensors under the model's state-dict names."""
    names = [n for n, _ in model.named_parameters()] + ["pos_embed"]
    return dict(zip(names, ema))


def main(argv=None):
    p = argparse.ArgumentParser("DiT training (smoke-scale)")
    p.add_argument("--model", default="DiT-S/8", choices=sorted(DiT_models))
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = DiT_models[args.model](input_size=args.image_size // 8)
    rng = np.random.RandomState(0)

    def synth():
        while True:
            yield (rng.randn(args.batch, 4, cfg.input_size,
                             cfg.input_size).astype(np.float32),
                   rng.randint(0, cfg.num_classes, args.batch))

    return train(cfg, DiTQuantConfig(), synth(), steps=args.steps,
                 log_every=5, device=args.device)


if __name__ == "__main__":
    main()
