"""Device resolution for the port's entry points.

Entry points default to ``device="cuda"``.  Where no GPU exists they raise
instead of falling back: the CPU runs only when the caller asks for it.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; this entry point runs on the GPU "
            "by default — pass device='cpu' to run the plain PyTorch "
            "versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
