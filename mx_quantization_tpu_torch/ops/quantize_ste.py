"""Standalone differentiable quantize wrappers (port of the JAX package's
``ops/quantize_ste.py``).

Reference: microxscaling/mx/quantize.py:14-48 — quantize_bfloat applies the
elementwise quantizer on BOTH the forward and backward pass.
"""

from __future__ import annotations

import torch

from .elemwise import quantize_elemwise_op
from .mx import quantize_mx_op


class _QuantizeBfloatGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, specs):
        ctx.specs = specs
        return quantize_elemwise_op(x, specs)

    @staticmethod
    def backward(ctx, g):
        return quantize_elemwise_op(g, ctx.specs.backwards()), None


class _QuantizeMxSte(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, specs, elem_format, axis):
        return quantize_mx_op(x, specs, elem_format=elem_format, axes=[axis])

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def quantize_bfloat_grad(x: torch.Tensor, mx_specs) -> torch.Tensor:
    """Forward AND backward bfloat quantization (reference QuantizeBfloat):
    the gradient is elementwise-quantized by the backward specs."""
    return _QuantizeBfloatGrad.apply(x, mx_specs)


def quantize_mx_ste(x: torch.Tensor, mx_specs, elem_format,
                    axis: int) -> torch.Tensor:
    """MX fake-quant with a straight-through gradient."""
    return _QuantizeMxSte.apply(x, mx_specs, elem_format, axis)
