"""PyTorch / CUDA port of ``mx_quantization_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; this package keeps its
module layout and names.  Slice 1 covers the DiT-XL/2 MXINT8 top-k sampling
path: the MX quantize kernel (Triton) in front of every quantized linear and
the fused qkv top-k attention kernel (CUDA C++).  Entry points run on the card
unless the caller passes ``device="cpu"``; on the CPU every kernel wrapper
uses its plain PyTorch version.
"""

from .device import resolve_device
from .formats import ElemFormat, FormatParams, format_params
from .specs import MxSpecs, finalize_mx_specs

__all__ = ["ElemFormat", "FormatParams", "MxSpecs", "finalize_mx_specs",
           "format_params", "resolve_device"]
