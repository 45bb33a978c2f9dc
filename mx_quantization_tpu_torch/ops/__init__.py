"""MX-quantized ops: the emulation engine's quantizers (``bitmath``,
``elemwise``, ``mx``), the fast float-domain quantizers, the exact k-th
largest selection, and the quantized linear, matmul and bmm."""

from .elemwise import (quantize_bfloat, quantize_elemwise,
                       quantize_elemwise_core, quantize_elemwise_op,
                       quantize_fp)
from .fastquant import (bf16_round_half_away, bf_fast, quantize_mx_fast,
                        quantize_mx_serving)
from .linear import bmm, linear, matmul, mx_dot
from .mx import (MxPacked, block_view, mx_decode, mx_encode, quantize_mx,
                 quantize_mx_op, shared_exponents, unblock_view)

__all__ = ["MxPacked", "bf16_round_half_away", "bf_fast", "block_view",
           "bmm", "linear", "matmul", "mx_decode", "mx_dot", "mx_encode",
           "quantize_bfloat", "quantize_elemwise", "quantize_elemwise_core",
           "quantize_elemwise_op", "quantize_fp", "quantize_mx",
           "quantize_mx_fast", "quantize_mx_op", "quantize_mx_serving",
           "shared_exponents", "unblock_view"]
