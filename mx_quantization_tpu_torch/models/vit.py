"""DeiT / Vision Transformer with MX quantization and top-k attention
(port of the JAX package's ``models/vit.py``; trained by
``workloads/deit_train.py``, which turns ``requires_grad`` on).

The parameters live in a ``ViT`` module whose names follow the JAX
parameter tree (``patch_embed.weight``, ``blocks.<i>.attn.qkv.weight``,
``head.weight``, ...); the blocks are an ``nn.ModuleList`` walked by a
Python loop.  ``vit_forward`` takes the quantization plan ``VitQuantConfig``
as an argument, as the JAX one does.

Contracts kept from the reference (its ``apply_quantization_to_deit``):
only the blocks' attention and MLP are quantized; the patch embed (its
sums taken in float64 and rounded once, ``vit_embed``), the LayerNorms and
the head stay unquantized in f32 (TF32 must be off, as it is by default).
The last block never runs top-k and takes ``exclude_block_type`` as its
predictor; ``exclude_blocks`` keep top-k but fall back to
``exclude_block_type``.  The MLP's GELU is the erf form.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..attention import (TopKAttentionConfig, fused_qkv_eligible,
                         fused_qkv_topk_attention, topk_attention)
from ..device import resolve_device
from ..ops.linear import gelu_linear, linear
from ..specs import MxSpecs
from .common import patch_embed
from .dit import Affine


@dataclasses.dataclass(frozen=True)
class VitConfig:
    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    num_classes: int = 1000
    embed_dim: int = 192
    depth: int = 12
    num_heads: int = 3
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    eps: float = 1e-6

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


@dataclasses.dataclass(frozen=True)
class VitQuantConfig:
    """Per-model quantization plan (same fields as the JAX package's).

    ``fuse_gelu`` (serving tier only): the MLP's erf GELU and the fc2 input
    quantize run as kernel K6 where its gate holds (the fc1 output's last
    axis block-aligned, at least 2^16 elements)."""
    mx_specs: Optional[MxSpecs] = None
    mx_quant: bool = False
    top_k: bool = True
    k: int = 20
    approx_flag: bool = True
    pred_mode: str = "ex_pred"
    exclude_blocks: Tuple[int, ...] = ()
    exclude_block_type: str = "ex_pred"
    last_block_no_topk: bool = True   # block depth-1 always dense
    sparse_impl: str = "dense"
    topk_key_bits: int = 32
    contract: str = "exact"
    fuse_gelu: bool = False

    def block_attn_cfg(self, idx: int, depth: int) -> TopKAttentionConfig:
        if not self.mx_quant or self.mx_specs is None:
            return TopKAttentionConfig(mx_quant=False)
        top_k = self.top_k
        pred_mode = self.pred_mode
        if self.last_block_no_topk and idx == depth - 1:
            top_k = False
            pred_mode = self.exclude_block_type
        elif idx in self.exclude_blocks:
            pred_mode = self.exclude_block_type
        return TopKAttentionConfig(
            mx_quant=True, top_k=top_k, k=self.k,
            approx_flag=self.approx_flag, pred_mode=pred_mode,
            sparse_impl=self.sparse_impl, key_bits=self.topk_key_bits,
            contract=self.contract)


# ----------------------------------------------------------------------
class Norm(nn.Module):
    """A LayerNorm's ``weight`` and ``bias``."""

    def __init__(self, dim: int, device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(dim, device=device),
                                 requires_grad=False)


class ViTBlock(nn.Module):
    def __init__(self, cfg: VitConfig, device):
        super().__init__()
        C = cfg.embed_dim
        hidden = int(C * cfg.mlp_ratio)
        self.norm1 = Norm(C, device)
        self.attn = nn.Module()
        self.attn.qkv = Affine(C, 3 * C, device, bias=cfg.qkv_bias)
        self.attn.proj = Affine(C, C, device)
        self.norm2 = Norm(C, device)
        self.mlp = nn.Module()
        self.mlp.fc1 = Affine(C, hidden, device)
        self.mlp.fc2 = Affine(hidden, C, device)


class ViT(nn.Module):
    """DeiT parameters (LayerNorms at 1 and 0, the rest zero); ``init_vit``
    or a loader fills them."""

    def __init__(self, cfg: VitConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        C, p = cfg.embed_dim, cfg.patch_size
        self.patch_embed = Affine(cfg.in_chans, C, device, (p, p))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C, device=device),
                                      requires_grad=False)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.num_patches + 1, C, device=device),
            requires_grad=False)
        self.blocks = nn.ModuleList(ViTBlock(cfg, device)
                                    for _ in range(cfg.depth))
        self.norm = Norm(C, device)
        self.head = Affine(C, cfg.num_classes, device)


def init_vit(cfg: VitConfig, generator: torch.Generator,
             device="cuda") -> ViT:
    """The JAX package's ``init_vit`` distributions: the patch embed and
    every linear uniform in +-1/sqrt(fan_in) (weights and biases), the cls
    token and the position table truncated normal (std 0.02, cut at 2 std),
    the LayerNorms at 1 and 0.  Draws come from the CPU ``generator``, so a
    seed gives the same weights on every device."""
    model = ViT(cfg, device=device)

    def trunc_normal(shape, std=0.02):
        # inverse CDF of the normal restricted to [-2, 2]
        lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
        u = lo + (1 - 2 * lo) * torch.rand(shape, generator=generator,
                                           dtype=torch.float64)
        return (std * math.sqrt(2) * torch.erfinv(2 * u - 1)).float()

    with torch.no_grad():
        for name, prm in model.named_parameters():
            shape = tuple(prm.shape)
            if name in ("cls_token", "pos_embed"):
                val = trunc_normal(shape)
            elif ".norm" in f".{name}":
                continue  # LayerNorms keep 1 and 0
            else:
                owner = model.get_submodule(name.rsplit(".", 1)[0])
                w = owner.weight.shape
                bound = 1.0 / math.sqrt(math.prod(w[1:]))
                val = (torch.rand(shape, generator=generator) * 2 - 1) * bound
            prm.copy_(val)
    return model


# ----------------------------------------------------------------------
def layer_norm(x: torch.Tensor, norm: Norm, eps: float) -> torch.Tensor:
    """Unquantized f32 LayerNorm (the JAX package's ``layer_norm`` with
    ``mx_specs=None``)."""
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * norm.weight + norm.bias


def vit_attention(attn: nn.Module, x: torch.Tensor, cfg: VitConfig,
                  specs: Optional[MxSpecs], attn_cfg: TopKAttentionConfig,
                  orthogonal_matrix=None) -> torch.Tensor:
    """Self-attention (reference QuantizedAttention.forward), routed as the
    JAX package routes: the fused qkv kernel (K2) where JAX's gate takes
    it (N <= 512, every predictor but ELSA: DeiT's ex_pred and two_step),
    else the split q/k/v entry (``topk_attention``: K3 for ELSA, or the
    unquantized attention); ``orthogonal_matrix`` is ELSA's projection."""
    B, N, C = x.shape
    H, D = cfg.num_heads, cfg.head_dim
    mxs = specs if attn_cfg.mx_quant else None
    qkv = linear(x, attn.qkv.weight, attn.qkv.bias, mx_specs=mxs)
    scale = D ** -0.5
    if fused_qkv_eligible(mxs, attn_cfg, N):
        out = fused_qkv_topk_attention(qkv, H, scale, mxs, attn_cfg)
    else:
        q, k, v = (t.contiguous() for t in
                   qkv.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4))
        out, _ = topk_attention(q, k, v, scale, mxs, attn_cfg,
                                orthogonal_matrix=orthogonal_matrix)
        out = out.transpose(1, 2).reshape(B, N, C)
    return linear(out, attn.proj.weight, attn.proj.bias, mx_specs=mxs)


def vit_mlp(mlp: nn.Module, x: torch.Tensor, specs: Optional[MxSpecs],
            contract: str = "exact", fuse_gelu: bool = False) -> torch.Tensor:
    """fc1, the erf GELU and fc2; with ``fuse_gelu`` in the serving tier
    the GELU rides in fc2's input quantize (kernel K6) where its gate
    holds."""
    h = linear(x, mlp.fc1.weight, mlp.fc1.bias, mx_specs=specs)
    return gelu_linear(h, mlp.fc2.weight, mlp.fc2.bias, specs, fuse_gelu,
                       contract, approximate=False)


def vit_block(blk: ViTBlock, attn_cfg: TopKAttentionConfig, x: torch.Tensor,
              cfg: VitConfig, qcfg: VitQuantConfig,
              orthogonal_matrix=None) -> torch.Tensor:
    """One pre-norm block: the unquantized LayerNorms, attention and MLP
    (quantized where ``attn_cfg.mx_quant``) and the residuals, in f32."""
    mxs = qcfg.mx_specs if attn_cfg.mx_quant else None
    h = layer_norm(x, blk.norm1, cfg.eps)
    x = x + vit_attention(blk.attn, h, cfg, qcfg.mx_specs, attn_cfg,
                          orthogonal_matrix)
    h = layer_norm(x, blk.norm2, cfg.eps)
    return x + vit_mlp(blk.mlp, h, mxs, contract=attn_cfg.contract,
                       fuse_gelu=qcfg.fuse_gelu)


def vit_embed(model: ViT, x: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) images -> (B, N + 1, C) tokens: the f32 patch embed, the
    cls token at index 0 and the learned position table.

    The patch embed's sums (3 * 16 * 16 = 768 terms) are taken in float64
    and rounded to f32 once.  An f32 sum's last bits depend on its order
    (cuBLAS's, MKL's, XLA's), and where they meet an MX rounding boundary in
    the first block a grid point moves and the logits move with it; the
    correctly rounded embedding is the same on every device, and it is the
    one that holds the reference torch goldens in every mode
    (tests/test_torch_deit_golden.py)."""
    cfg = model.cfg
    pe = model.patch_embed
    h = patch_embed(x.to(torch.float32), pe.weight, pe.bias, cfg.patch_size,
                    exact_sum=True)
    cls = model.cls_token.expand(x.shape[0], 1, cfg.embed_dim)
    return torch.cat([cls, h], dim=1) + model.pos_embed


def vit_head(model: ViT, h: torch.Tensor) -> torch.Tensor:
    """The final LayerNorm and the head on the cls token, unquantized."""
    h = layer_norm(h, model.norm, model.cfg.eps)
    return linear(h[:, 0], model.head.weight, model.head.bias)


def vit_forward(model: ViT, x: torch.Tensor, qcfg: VitQuantConfig,
                orthogonal_matrix=None) -> torch.Tensor:
    """Full DeiT forward: (B, 3, H, W) images -> (B, num_classes) logits;
    ``orthogonal_matrix``: ELSA's projection."""
    cfg = model.cfg
    h = vit_embed(model, x)
    for i, blk in enumerate(model.blocks):
        h = vit_block(blk, qcfg.block_attn_cfg(i, cfg.depth), h, cfg, qcfg,
                      orthogonal_matrix)
    return vit_head(model, h)


# ----------------------------------------------------------------------
VIT_CONFIGS = {
    "deit_tiny_patch16_224": VitConfig(embed_dim=192, depth=12, num_heads=3),
    "deit_small_patch16_224": VitConfig(embed_dim=384, depth=12, num_heads=6),
    "deit_base_patch16_224": VitConfig(embed_dim=768, depth=12, num_heads=12),
}
