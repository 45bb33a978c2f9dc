"""MX-quantized ops: float-domain quantizers, the quantized linear."""

from .fastquant import (bf16_round_half_away, bf_fast, quantize_mx_fast,
                        quantize_mx_serving)
from .linear import linear

__all__ = ["bf16_round_half_away", "bf_fast", "linear", "quantize_mx_fast",
           "quantize_mx_serving"]
