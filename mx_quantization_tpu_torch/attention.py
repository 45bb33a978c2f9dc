"""Quantized attention with approximated top-k pruning: the fused qkv entry
(port of the JAX package's ``attention.py`` ``TopKAttentionConfig``,
``fused_qkv_eligible`` and ``fused_qkv_topk_attention``; forward only).

The flow is the reference's
  true_scores = MX(q) @ MX(k)^T * scale,  pred = approx(q) @ approx(k)^T,
  attn = softmax over the top-k of pred,  out = MX(attn) @ MX(v),
all inside kernel K2 (``ops/kernels/topk_attention.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .formats import format_params
from .ops.kernels.topk_attention import (MAX_TOKENS,
                                         fused_topk_attention_qkv)


class TopKAttentionConfig(NamedTuple):
    """Attention-pruning configuration (same fields as the JAX package's).

    key_bits: ranking precision of the top-k selection (32 exact f32, 16
    bf16-precision, 8 sign+exponent).  out_dtype: "float32" or "bfloat16"
    output of the kernel.  contract: "exact" keeps the emulation-ordered
    numerics; "serving" selects the relaxed tier (tie-inclusive selection,
    bf16 attention probabilities, no bf16 rounds of the score and PV
    sums)."""
    mx_quant: bool = True
    top_k: bool = True
    k: int = 20
    approx_flag: bool = True
    pred_mode: str = "ex_pred"
    sparse_impl: str = "dense"
    key_bits: int = 32
    out_dtype: str = "float32"
    contract: str = "exact"


# element formats K2 quantizes (every grid point is exact in bf16)
_KERNEL_ELEM_FORMATS = ("int8", "int4", "int2", "fp8_e4m3", "fp8_e5m2",
                        "fp6_e3m2", "fp6_e2m3", "fp4", "fp4_e2m1")
_KERNEL_BFLOATS = (0, 16, 32)


def fused_qkv_eligible(mx_specs, cfg: TopKAttentionConfig, n: int) -> bool:
    """Can self-attention run on the fused qkv entry?  The port's K2 serves
    the ex_pred predictor (or none) and N <= MAX_TOKENS."""
    return (mx_specs is not None and mx_specs.custom_tpu == "fused"
            and cfg.mx_quant and cfg.sparse_impl == "dense"
            and n <= MAX_TOKENS and mx_specs.block_size == 32
            and mx_specs.a_elem_format in _KERNEL_ELEM_FORMATS
            and mx_specs.bfloat in _KERNEL_BFLOATS and mx_specs.fp == 0
            and (cfg.pred_mode == "ex_pred" or not cfg.approx_flag))


def fused_qkv_topk_attention(qkv: torch.Tensor, num_heads: int, scale: float,
                             mx_specs, cfg: TopKAttentionConfig
                             ) -> torch.Tensor:
    """(B, N, 3*H*D) fused-qkv activations -> (B, N, H*D).  A cfg with
    top_k=False (an excluded block or timestep) runs dense MX attention:
    it is normalized to k = N so the kernel takes its masked-softmax
    branch."""
    if not cfg.top_k:
        cfg = cfg._replace(top_k=True, approx_flag=False, k=int(qkv.shape[1]))
    ebits, mbits, emax, max_norm, _ = format_params(mx_specs.a_elem_format)
    return fused_topk_attention_qkv(
        qkv, num_heads, k=cfg.k, scale=scale,
        block_size=mx_specs.block_size,
        scale_bits=mx_specs.effective_scale_bits(), approx=cfg.approx_flag,
        pred_mode=cfg.pred_mode, key_bits=cfg.key_bits,
        out_dtype=getattr(torch, cfg.out_dtype), contract=cfg.contract,
        bfloat=16 if mx_specs.bfloat == 16 else 0,
        flush=mx_specs.mx_flush_fp32_subnorms,
        ebits=ebits, mbits=mbits, emax=emax, max_norm=float(max_norm))
