"""PixArt-alpha transformer with MX quantization and top-k self/cross
attention (port of the JAX package's ``models/pixart.py``, forward only).

  * ada_norm_single conditioning: one AdaLayerNormSingle produces a 6-way
    modulation shared by all blocks; each block adds its own learned
    scale_shift_table.
  * per block: self-attention (attn1) with top-k pruning (self_k), cross
    attention (attn2) over the T5 text states with the encoder attention
    mask added as a bias to both the true and the predicted scores, and a
    feed-forward with GELU(tanh).
  * caption projection: linear / GELU(tanh) / linear from T5's 4096
    channels to the inner dim.
  * micro-conditioning (the alpha 1024^2 model, or ``micro_conds=True``):
    sinusoidal-256 embeddings of the resolution (H, W) and of the aspect
    ratio, each through its own two-layer SiLU MLP to inner / 3 channels,
    concatenated and added to the timestep embedding.
  * quantization plan with set_config semantics: exclude_blocks fall back
    to the ``exclude_blocks_type`` predictor; exclude_timesteps disable
    pruning at those sampling steps.

The parameters live in a ``PixArt`` module whose names follow the JAX
parameter tree (``blocks.<i>.attn1.to_q.weight``, ``adaln_single.linear``,
...); the blocks are an ``nn.ModuleList`` walked by a Python loop.  Both
attentions reach ``attention.topk_attention``, that is kernel K3 (K4 at
1024^2, N = 4096); the serving tier's ``fuse_gelu`` opt-in takes kernel
K6.  ELSA's projection reaches the attentions as ``orthogonal_matrix``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..attention import TopKAttentionConfig, topk_attention
from ..device import resolve_device
from ..ops.linear import gelu_linear, linear
from ..specs import MxSpecs
from .common import patch_embed
from .dit import Affine, get_2d_sincos_pos_embed, timestep_embedding


@dataclasses.dataclass(frozen=True)
class PixArtConfig:
    num_attention_heads: int = 16
    attention_head_dim: int = 72
    in_channels: int = 4
    out_channels: int = 8
    num_layers: int = 28
    cross_attention_dim: int = 1152
    sample_size: int = 32          # 256px alpha model (latent 32x32)
    patch_size: int = 2
    caption_channels: int = 4096   # T5-XXL
    norm_eps: float = 1e-6
    # None -> diffusers default (on for sample_size 128, the alpha 1024px
    # model); PixArt-Sigma sets False
    micro_conds: Optional[bool] = None

    @property
    def inner_dim(self):
        return self.num_attention_heads * self.attention_head_dim

    @property
    def num_patches(self):
        return (self.sample_size // self.patch_size) ** 2

    @property
    def use_additional_conditions(self):
        if self.micro_conds is not None:
            return self.micro_conds
        return self.sample_size == 128


@dataclasses.dataclass(frozen=True)
class PixArtQuantConfig:
    """set_config semantics (same fields as the JAX package's).
    ``fuse_gelu`` (off by default) runs the feed-forward's GELU and the fc2
    input quantize as kernel K6, in the serving tier, where the fc1
    output's last axis is block-aligned and holds at least 2^16 elements."""
    mx_specs: Optional[MxSpecs] = None
    mx_quant: bool = False
    self_top_k: bool = False
    self_k: int = 20
    cross_top_k: bool = False
    cross_k: int = 20
    ex_pred: bool = False
    pred_mode: str = "ex_pred"
    exclude_blocks: Tuple[int, ...] = ()
    exclude_blocks_type: str = "ex_pred"
    exclude_timesteps: Tuple[int, ...] = ()
    sparse_impl: str = "dense"
    topk_key_bits: int = 32
    activation_dtype: str = "float32"
    contract: str = "exact"
    fuse_gelu: bool = False

    def _pred_mode(self, idx):
        return (self.exclude_blocks_type if idx in self.exclude_blocks
                else self.pred_mode)

    def _serving_kw(self):
        return dict(key_bits=self.topk_key_bits, contract=self.contract,
                    out_dtype=("bfloat16"
                               if self.activation_dtype == "bfloat16"
                               else "float32"))

    def self_attn_cfg(self, idx, timestep_idx) -> TopKAttentionConfig:
        """Self-attn: excluded block -> top_k off; excluded timestep ->
        dense attention."""
        if not self.mx_quant or self.mx_specs is None:
            return TopKAttentionConfig(mx_quant=False)
        top_k = self.self_top_k and idx not in self.exclude_blocks
        if timestep_idx is not None and timestep_idx in self.exclude_timesteps:
            top_k = False
        return TopKAttentionConfig(
            mx_quant=True, top_k=top_k, k=self.self_k,
            approx_flag=self.ex_pred, pred_mode=self._pred_mode(idx),
            sparse_impl=self.sparse_impl, **self._serving_kw())

    def cross_attn_cfg(self, idx, timestep_idx) -> TopKAttentionConfig:
        """Cross-attn: excluded timestep keeps top-k but switches the
        predictor off (true-score top-k)."""
        if not self.mx_quant or self.mx_specs is None:
            return TopKAttentionConfig(mx_quant=False)
        approx = self.ex_pred and not (
            timestep_idx is not None and
            timestep_idx in self.exclude_timesteps)
        return TopKAttentionConfig(
            mx_quant=True, top_k=self.cross_top_k, k=self.cross_k,
            approx_flag=approx, pred_mode=self._pred_mode(idx),
            sparse_impl=self.sparse_impl, **self._serving_kw())


# ----------------------------------------------------------------------
def _attention_module(d: int, device) -> nn.Module:
    m = nn.Module()
    for name in ("to_q", "to_k", "to_v", "to_out"):
        setattr(m, name, Affine(d, d, device))
    return m


class PixArtBlock(nn.Module):
    def __init__(self, d: int, device):
        super().__init__()
        self.scale_shift_table = nn.Parameter(
            torch.zeros(6, d, device=device), requires_grad=False)
        self.attn1 = _attention_module(d, device)
        self.attn2 = _attention_module(d, device)
        self.ff = nn.Module()
        self.ff.fc1 = Affine(d, 4 * d, device)
        self.ff.fc2 = Affine(4 * d, d, device)


class PixArt(nn.Module):
    """PixArt-alpha parameters, zero-filled; ``init_pixart`` or a loader
    fills them.  The sin/cos position table is computed from the config
    (a buffer outside the state dict, as diffusers computes it too)."""

    def __init__(self, cfg: PixArtConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        d, p = cfg.inner_dim, cfg.patch_size
        self.pos_embed = nn.Module()
        self.pos_embed.proj = Affine(cfg.in_channels, d, device, (p, p))
        self.pos_embed.register_buffer("pe", torch.as_tensor(
            get_2d_sincos_pos_embed(d, cfg.sample_size // p))[None].to(device),
            persistent=False)
        self.adaln_single = nn.Module()
        self.adaln_single.emb_mlp0 = Affine(256, d, device)
        self.adaln_single.emb_mlp2 = Affine(d, d, device)
        self.adaln_single.linear = Affine(d, 6 * d, device)
        if cfg.use_additional_conditions:  # inner / 3 channels each
            sd = d // 3
            self.adaln_single.res_mlp0 = Affine(256, sd, device)
            self.adaln_single.res_mlp2 = Affine(sd, sd, device)
            self.adaln_single.ar_mlp0 = Affine(256, sd, device)
            self.adaln_single.ar_mlp2 = Affine(sd, sd, device)
        self.caption_projection = nn.Module()
        self.caption_projection.linear_1 = Affine(cfg.caption_channels, d,
                                                  device)
        self.caption_projection.linear_2 = Affine(d, d, device)
        self.blocks = nn.ModuleList(PixArtBlock(d, device)
                                    for _ in range(cfg.num_layers))
        self.scale_shift_table = nn.Parameter(
            torch.zeros(2, d, device=device), requires_grad=False)
        self.proj_out = Affine(d, p * p * cfg.out_channels, device)


def init_pixart(cfg: PixArtConfig, generator: torch.Generator,
                device="cuda") -> PixArt:
    """Random weights as the JAX ``init_pixart`` draws them: every linear
    kaiming-uniform (weight and bias within 1/sqrt(fan_in)), the patch
    embed normal(0.02) with a zero bias, the scale-shift tables
    normal / sqrt(inner dim).  Nothing is zero, so no block is the
    identity.  Draws come from the CPU ``generator``, so a seed gives the
    same weights on every device."""
    model = PixArt(cfg, device=device)
    d = cfg.inner_dim

    def uniform(shape, bound):
        return (torch.rand(shape, generator=generator) * 2 - 1) * bound

    with torch.no_grad():
        for name, prm in model.named_parameters():
            shape = tuple(prm.shape)
            if name == "pos_embed.proj.weight":
                val = 0.02 * torch.randn(shape, generator=generator)
            elif name == "pos_embed.proj.bias":
                val = torch.zeros(shape)
            elif name.endswith("scale_shift_table"):
                val = torch.randn(shape, generator=generator) / d ** 0.5
            else:  # a linear's weight (out, in) or bias (out,)
                owner = name.rsplit(".", 1)[0]
                fan_in = model.get_submodule(owner).weight.shape[1]
                val = uniform(shape, 1.0 / math.sqrt(fan_in))
            prm.copy_(val)
    return model


# ----------------------------------------------------------------------
def _ln(x, eps=1e-6):
    xf = x.to(torch.float32)  # norm statistics stay f32 with bf16 activations
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _mha(attn: nn.Module, x: torch.Tensor, kv: torch.Tensor,
         cfg: PixArtConfig, specs, attn_cfg: TopKAttentionConfig,
         bias=None, orthogonal_matrix=None) -> torch.Tensor:
    """Shared self/cross attention: q from x, k and v from kv."""
    B, N, C = x.shape
    H = cfg.num_attention_heads
    D = C // H
    S = kv.shape[1]
    mxs = specs if attn_cfg.mx_quant else None
    q = linear(x, attn.to_q.weight, attn.to_q.bias, mx_specs=mxs)
    k = linear(kv, attn.to_k.weight, attn.to_k.bias, mx_specs=mxs)
    v = linear(kv, attn.to_v.weight, attn.to_v.bias, mx_specs=mxs)
    if attn_cfg.out_dtype == "bfloat16":
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    q = q.reshape(B, N, H, D).transpose(1, 2).contiguous()
    k = k.reshape(B, S, H, D).transpose(1, 2).contiguous()
    v = v.reshape(B, S, H, D).transpose(1, 2).contiguous()
    out, _ = topk_attention(q, k, v, D ** -0.5, mxs, attn_cfg,
                            orthogonal_matrix=orthogonal_matrix, bias=bias)
    out = out.transpose(1, 2).reshape(B, N, C)
    return linear(out, attn.to_out.weight, attn.to_out.bias, mx_specs=mxs)


def pixart_block_apply(blk: PixArtBlock, x: torch.Tensor, ctx: torch.Tensor,
                       t6: torch.Tensor, cfg: PixArtConfig, specs,
                       self_cfg: TopKAttentionConfig,
                       cross_cfg: TopKAttentionConfig, bias=None,
                       act_dtype=torch.float32, fuse_gelu: bool = False,
                       orthogonal_matrix=None) -> torch.Tensor:
    """One transformer block (ada_norm_single): adaLN-single modulation, MX
    self-attention, cross-attention (the bias added to the true and the
    predicted scores inside ``topk_attention``), MX feed-forward with
    GELU(tanh); ``fuse_gelu`` as in ``PixArtQuantConfig``."""
    B = x.shape[0]
    d = cfg.inner_dim
    mxs = specs if self_cfg.mx_quant else None
    mods = (blk.scale_shift_table[None] + t6.reshape(B, 6, d)).to(act_dtype)
    (shift_msa, scale_msa, gate_msa,
     shift_mlp, scale_mlp, gate_mlp) = [mods[:, i][:, None] for i in range(6)]
    h = _ln(x, cfg.norm_eps) * (1 + scale_msa) + shift_msa
    x = x + gate_msa * _mha(blk.attn1, h, h, cfg, specs, self_cfg,
                            orthogonal_matrix=orthogonal_matrix
                            ).to(act_dtype)
    # PixArt: no norm before the cross-attention; ELSA there takes its
    # default projection, as in JAX (non-square ELSA raises in both)
    x = x + _mha(blk.attn2, x, ctx, cfg, specs, cross_cfg,
                 bias=bias).to(act_dtype)
    h = _ln(x, cfg.norm_eps) * (1 + scale_mlp) + shift_mlp
    h = linear(h, blk.ff.fc1.weight, blk.ff.fc1.bias,
               mx_specs=mxs).to(act_dtype)
    # "gelu-approximate"
    h = gelu_linear(h, blk.ff.fc2.weight, blk.ff.fc2.bias, mxs, fuse_gelu,
                    self_cfg.contract).to(act_dtype)
    return x + gate_mlp * h


def pixart_embed(model: PixArt, hidden_states: torch.Tensor,
                 encoder_hidden_states: torch.Tensor, timestep: torch.Tensor,
                 qcfg: PixArtQuantConfig,
                 resolution: Optional[torch.Tensor] = None,
                 aspect_ratio: Optional[torch.Tensor] = None):
    """Patch and position embedding, the adaLN-single conditioning (with the
    micro-conditioning where the config has it) and the caption projection:
    (B, C, H, W) latents, (B, S, caption) T5 states and (B,) timesteps ->
    tokens (B, N, inner) and projected captions (B, S, inner) in the
    activation dtype, the (B, 6 * inner) modulation and the (B, inner)
    conditioning embedding.  ``resolution`` (B, 2) and ``aspect_ratio``
    (B, 1) default to the model's native pixel size 8 * sample_size,
    square, and 1."""
    cfg = model.cfg
    pe = model.pos_embed
    x = patch_embed(hidden_states, pe.proj.weight, pe.proj.bias,
                    cfg.patch_size) + pe.pe

    ada = model.adaln_single
    emb = timestep_embedding(timestep, 256)
    emb = linear(emb, ada.emb_mlp0.weight, ada.emb_mlp0.bias)
    emb = linear(nn.functional.silu(emb), ada.emb_mlp2.weight,
                 ada.emb_mlp2.bias)
    if cfg.use_additional_conditions:
        B, dev = hidden_states.shape[0], hidden_states.device
        if resolution is None:
            resolution = torch.full((B, 2), float(cfg.sample_size * 8),
                                    device=dev)
        if aspect_ratio is None:
            aspect_ratio = torch.ones(B, 1, device=dev)

        def size_emb(v, m0, m2):
            # (B, n) scalars -> sinusoidal-256 each -> MLP -> (B, n * d/3)
            e = timestep_embedding(v.reshape(-1).to(torch.float32), 256)
            e = linear(e, m0.weight, m0.bias)
            e = linear(nn.functional.silu(e), m2.weight, m2.bias)
            return e.reshape(v.shape[0], -1)

        emb = emb + torch.cat(
            [size_emb(resolution, ada.res_mlp0, ada.res_mlp2),
             size_emb(aspect_ratio, ada.ar_mlp0, ada.ar_mlp2)], dim=-1)
    t6 = linear(nn.functional.silu(emb), ada.linear.weight, ada.linear.bias)

    cp = model.caption_projection
    ctx = linear(encoder_hidden_states, cp.linear_1.weight, cp.linear_1.bias)
    ctx = nn.functional.gelu(ctx, approximate="tanh")
    ctx = linear(ctx, cp.linear_2.weight, cp.linear_2.bias)

    act = torch.bfloat16 if qcfg.activation_dtype == "bfloat16" \
        else torch.float32
    return x.to(act), ctx.to(act), t6, emb


def pixart_final_layer(model: PixArt, x: torch.Tensor,
                       emb: torch.Tensor) -> torch.Tensor:
    """Final modulation, the (unquantized) output projection and the
    unpatchify: (B, N, inner) tokens -> (B, out_channels, H, W)."""
    cfg = model.cfg
    shift, scale = (model.scale_shift_table[None] + emb[:, None]).chunk(
        2, dim=1)
    x = _ln(x, 1e-6) * (1 + scale) + shift
    x = linear(x, model.proj_out.weight, model.proj_out.bias)
    B = x.shape[0]
    hw, p, c_out = (cfg.sample_size // cfg.patch_size, cfg.patch_size,
                    cfg.out_channels)
    x = x.reshape(B, hw, hw, p, p, c_out).permute(0, 5, 1, 3, 2, 4)
    return x.reshape(B, c_out, hw * p, hw * p)


def pixart_forward(model: PixArt, hidden_states: torch.Tensor,
                   encoder_hidden_states: torch.Tensor,
                   timestep: torch.Tensor, qcfg: PixArtQuantConfig,
                   encoder_attention_mask: Optional[torch.Tensor] = None,
                   timestep_idx: Optional[int] = None,
                   orthogonal_matrix=None,
                   resolution: Optional[torch.Tensor] = None,
                   aspect_ratio: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """(B, C, H, W) latents + (B, S, caption) T5 states + (B,) timesteps
    -> (B, out_channels, H, W).  encoder_attention_mask: (B, S) of 0/1,
    turned into the additive bias (1 - mask) * -10000 of shape
    (B, 1, 1, S), or an additive bias already.  ``orthogonal_matrix``:
    ELSA's projection; ``resolution`` and ``aspect_ratio``: the
    micro-conditioning's (``pixart_embed``)."""
    cfg = model.cfg
    specs = qcfg.mx_specs if qcfg.mx_quant else None
    bias = encoder_attention_mask
    if bias is not None and bias.dim() == 2:
        bias = ((1 - bias.to(torch.float32)) * -10000.0)[:, None, None, :]
    x, ctx, t6, emb = pixart_embed(model, hidden_states,
                                   encoder_hidden_states, timestep, qcfg,
                                   resolution=resolution,
                                   aspect_ratio=aspect_ratio)
    for i, blk in enumerate(model.blocks):
        x = pixart_block_apply(blk, x, ctx, t6, cfg, specs,
                               qcfg.self_attn_cfg(i, timestep_idx),
                               qcfg.cross_attn_cfg(i, timestep_idx),
                               bias=bias, act_dtype=x.dtype,
                               fuse_gelu=qcfg.fuse_gelu,
                               orthogonal_matrix=orthogonal_matrix)
    return pixart_final_layer(model, x, emb)
