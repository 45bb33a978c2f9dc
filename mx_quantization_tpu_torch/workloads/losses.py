"""Training losses for the DeiT workload (port of the JAX package's
``workloads/losses.py``): the reference's DistillationLoss
(workloads/deit/losses.py), a base criterion plus none / soft / hard
distillation against a teacher's logits, weighted by alpha; soft is the KL
at temperature tau.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def soft_kl(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
            tau: float) -> torch.Tensor:
    """KL(teacher || student) at temperature tau, scaled by tau^2 / N."""
    t = torch.softmax(teacher_logits / tau, dim=-1)
    log_s = F.log_softmax(student_logits / tau, dim=-1)
    log_t = F.log_softmax(teacher_logits / tau, dim=-1)
    kl = (t * (log_t - log_s)).sum(-1)
    return kl.mean() * tau * tau


def distillation_loss(base_criterion: Callable, student_outputs, labels,
                      teacher_logits: Optional[torch.Tensor] = None,
                      distillation_type: str = "none", alpha: float = 0.5,
                      tau: float = 1.0) -> torch.Tensor:
    """student_outputs: logits, or (cls_logits, dist_logits) for models with
    a distillation token (reference losses.py forward)."""
    if isinstance(student_outputs, tuple):
        outputs, outputs_kd = student_outputs
    else:
        outputs = outputs_kd = student_outputs
    base = base_criterion(outputs, labels)
    if distillation_type == "none":
        return base
    if teacher_logits is None:
        raise ValueError("distillation requires teacher logits")
    if distillation_type == "soft":
        dist = soft_kl(outputs_kd, teacher_logits, tau)
    elif distillation_type == "hard":
        hard = teacher_logits.argmax(-1)
        logp = F.log_softmax(outputs_kd, dim=-1)
        dist = -logp.gather(-1, hard[:, None]).mean()
    else:
        raise ValueError(distillation_type)
    return base * (1 - alpha) + dist * alpha
