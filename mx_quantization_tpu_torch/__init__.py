"""PyTorch / CUDA port of ``mx_quantization_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; this package keeps its
module layout and names.  It covers DiT-XL/2 MXINT8 top-k sampling (with
its fused opt-ins), PixArt-alpha sampling and DeiT ImageNet evaluation,
each TPU kernel on their paths a hand-written Triton or CUDA C++ kernel
(ROADMAP.md lists the slices).  Entry points run on the card
unless the caller passes ``device="cpu"``; on the CPU every kernel wrapper
uses its plain PyTorch version.
"""

from .device import resolve_device
from .formats import ElemFormat, FormatParams, format_params
from .specs import MxSpecs, finalize_mx_specs

__all__ = ["ElemFormat", "FormatParams", "MxSpecs", "finalize_mx_specs",
           "format_params", "resolve_device"]
