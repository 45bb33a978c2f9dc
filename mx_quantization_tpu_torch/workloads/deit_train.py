"""DeiT training and fine-tuning (port of the JAX package's
``workloads/deit_train.py``; reference workloads/deit/engine.py:19-82 and
main.py:770-834): AdamW with decoupled weight decay, a cosine learning-rate
decay, label-smoothing cross entropy and an EMA of the parameters, on one
device.  Quantization-aware training takes specs with
``quantize_backprop=True``; mixup (``mixup_batch``) is the reference's
timm Mixup for callers that build their own step.

Run a few steps on synthetic images (unquantized, as the JAX CLI does):
    python -m mx_quantization_tpu_torch.workloads.deit_train --device cpu \
        --steps 4 --batch 2
"""

from __future__ import annotations

import argparse
import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.vit import (VIT_CONFIGS, ViT, VitConfig, VitQuantConfig,
                          init_vit, vit_forward)
from .dit_train import update_ema


def label_smoothing_ce(logits: torch.Tensor, labels: torch.Tensor,
                       smoothing: float = 0.1) -> torch.Tensor:
    """Cross entropy against one-hot labels smoothed by ``smoothing``."""
    n = logits.shape[-1]
    target = F.one_hot(labels, n).to(logits.dtype) * (1 - smoothing) \
        + smoothing / n
    return -(target * F.log_softmax(logits, dim=-1)).sum(-1).mean()


def mixup(x: torch.Tensor, y: torch.Tensor, num_classes: int, lam: float,
          perm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mix each image and its one-hot label with the ``perm``-th one by
    ``lam``."""
    y1 = F.one_hot(y, num_classes).to(x.dtype)
    return lam * x + (1 - lam) * x[perm], lam * y1 + (1 - lam) * y1[perm]


def _beta(generator: torch.Generator, a: float, b: float) -> float:
    """One Beta(a, b) draw from the uniforms of a CPU ``generator``
    (Johnk's method: X = U^(1/a), Y = V^(1/b), accepted when X + Y <= 1)."""
    while True:
        u, v = torch.rand(2, generator=generator, dtype=torch.float64)
        x, y = u.item() ** (1 / a), v.item() ** (1 / b)
        if 0 < x + y <= 1:
            return x / (x + y)


def mixup_batch(generator: torch.Generator, x: torch.Tensor, y: torch.Tensor,
                num_classes: int, alpha: float = 0.8
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mixup (reference timm Mixup, engine.py:35-37): lam ~ Beta(alpha,
    alpha) and a permutation of the batch, both from the CPU
    ``generator``."""
    lam = _beta(generator, alpha, alpha)
    perm = torch.randperm(x.shape[0], generator=generator).to(x.device)
    return mixup(x, y, num_classes, lam, perm)


def cosine_decay(lr: float, steps: int, count: int) -> float:
    """``optax.cosine_decay_schedule(lr, steps)`` at ``count``."""
    frac = min(count, steps) / steps
    return lr * 0.5 * (1 + math.cos(math.pi * frac))


def make_train_step(model: ViT, ema: List[torch.Tensor],
                    qcfg: VitQuantConfig, optimizer: torch.optim.Optimizer,
                    lr: float, steps: int, ema_decay: float = 0.99996,
                    label_smoothing: float = 0.1) -> Callable:
    """One step ``step(count, x, y) -> loss``: the learning rate set to the
    cosine schedule at ``count``, the label-smoothed loss's gradients, an
    optimizer step and the EMA update (in ``model.parameters()`` order).
    The loss is returned on the device, unsynchronized."""
    params = list(model.parameters())

    def train_step(count: int, x: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
        for group in optimizer.param_groups:
            group["lr"] = cosine_decay(lr, steps, count)
        loss = label_smoothing_ce(vit_forward(model, x, qcfg), y,
                                  label_smoothing)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        update_ema(ema, params, ema_decay)
        return loss.detach()

    return train_step


def train(cfg: VitConfig, qcfg: VitQuantConfig, data_iter, steps: int = 100,
          lr: float = 5e-4, weight_decay: float = 0.05,
          ema_decay: float = 0.99996, label_smoothing: float = 0.1,
          mesh=None, seed: int = 0, log_every: int = 50, device="cuda",
          model: Optional[ViT] = None):
    """Train on ``data_iter``'s (images (B, 3, H, W), labels (B,)) batches,
    numpy arrays or tensors, for up to ``steps`` steps.  The model is
    ``init_vit``'s from ``seed`` unless given.  Returns (model, EMA state
    dict)."""
    if mesh is not None:
        raise NotImplementedError(
            "training over a device mesh is not ported yet (ROADMAP.md "
            "section 1, parallelism)")
    device = resolve_device(device)
    if model is None:
        model = init_vit(cfg, torch.Generator().manual_seed(seed), device)
    model.requires_grad_(True)
    ema = [p.detach().clone() for p in model.parameters()]
    optimizer = torch.optim.AdamW(model.parameters(), lr=lr,
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=weight_decay)
    step_fn = make_train_step(model, ema, qcfg, optimizer, lr, steps,
                              ema_decay, label_smoothing)
    for step, (x, y) in enumerate(data_iter):
        if step >= steps:
            break
        x = torch.as_tensor(x, dtype=torch.float32).to(device)
        y = torch.as_tensor(y).to(device)
        loss = step_fn(step, x, y)
        if log_every and (step + 1) % log_every == 0:
            print(f"step {step + 1}: loss {loss.item():.4f}")
    names = [n for n, _ in model.named_parameters()]
    return model, dict(zip(names, ema))


def main(argv=None):
    p = argparse.ArgumentParser("DeiT training (smoke-scale)")
    p.add_argument("--model", default="deit_tiny_patch16_224",
                   choices=sorted(VIT_CONFIGS))
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--img-size", type=int, default=32)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cfg = dataclasses.replace(VIT_CONFIGS[args.model], img_size=args.img_size)
    rng = np.random.RandomState(0)

    def synth():
        while True:
            yield (rng.randn(args.batch, 3, cfg.img_size,
                             cfg.img_size).astype(np.float32),
                   rng.randint(0, cfg.num_classes, args.batch))

    return train(cfg, VitQuantConfig(mx_quant=False), synth(),
                 steps=args.steps, log_every=5, device=args.device)


if __name__ == "__main__":
    main()
