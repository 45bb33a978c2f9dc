"""Offline weight pre-quantization (port of the JAX package's
``utils/prequantize.py``).

Every linear weight the quantized forward would MX-quantize along its input
axis is snapped to the MX grid once, and the specs gain
``prequantized_weights=True`` so the forward skips it.  MX quantization is
idempotent, so the result is numerically identical to quantizing on the
fly.  Weights the model consumes unquantized (the DiT block adaLN) are left
alone.  The fused engine snaps with the fast quantizer after the bfloat
round, the emulation engine (``custom_tpu="ref"``) with ``quantize_mx`` at
the specs' shared-exponent method and round, as JAX does.  ``serve_dtype=torch.bfloat16`` stores the snapped weights in bf16
(exact for every int and fp4/6/8 grid) and casts the remaining unquantized
matmul weights to bf16 too (not bit-exact against f32 storage).

The module is updated in place (the weights of DiT-XL/2 are 2.7 GB in f32).
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

import torch
from torch import nn

from ..formats import format_params
from ..ops.fastquant import bf_fast, quantize_mx_fast
from ..ops.mx import quantize_mx
from ..specs import MxSpecs

# weights consumed by quantized `linear(...)` calls
_LINEAR_WEIGHT_RE = re.compile(
    r"(qkv|proj|fc1|fc2|to_q|to_k|to_v|to_out|adaLN|linear)\.weight$")

# matched above but consumed UNquantized (DiT block adaLN; PixArt's
# AdaLayerNormSingle projection and patch-embed conv)
_UNQUANTIZED_RE = re.compile(
    r"(?<!final_layer\.)adaLN\.weight$|adaln_single\.linear\.weight$"
    r"|pos_embed\.proj\.weight$")


def bf16_exact(elem_format) -> bool:
    """True if every MX grid point of the format is exact in bfloat16."""
    return format_params(elem_format).mbits <= 9


def prequantize_weights(model: nn.Module, specs: MxSpecs,
                        serve_dtype: Optional[torch.dtype] = None,
                        ) -> Tuple[nn.Module, MxSpecs]:
    """Snap matching weights to the MX grid in place; returns
    (model, specs with prequantized_weights=True)."""
    fmt = specs.w_elem_format
    if fmt is None:
        raise ValueError("no weight format configured")
    bs, sb = specs.block_size, specs.effective_scale_bits()
    fl = specs.mx_flush_fp32_subnorms
    q_dtype = torch.float32
    if serve_dtype is not None and bf16_exact(fmt):
        q_dtype = serve_dtype

    def snap(x):
        if specs.custom_tpu == "fused":
            return quantize_mx_fast(bf_fast(x, specs), fmt, bs, sb, axis=-1,
                                    out_dtype=q_dtype, flush=fl)
        return quantize_mx(x, sb, fmt, axes=[-1], block_size=bs,
                           shared_exp_method=specs.shared_exp_method,
                           round=specs.round_mx_output or "nearest",
                           flush_fp32_subnorms=fl).to(q_dtype)

    with torch.no_grad():
        for name, prm in model.named_parameters():
            if prm.dim() < 2:
                continue
            if (_LINEAR_WEIGHT_RE.search(name)
                    and not _UNQUANTIZED_RE.search(name)):
                prm.data = snap(prm.data)
            elif serve_dtype is not None and name.endswith(".weight"):
                prm.data = prm.data.to(serve_dtype)
    return model, specs.replace(prequantized_weights=True)
