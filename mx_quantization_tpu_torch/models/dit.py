"""DiT (Diffusion Transformer) with MX quantization and top-k attention
(port of the JAX package's ``models/dit.py``, forward only).

The parameters live in a ``DiT`` module whose names follow the JAX
parameter tree (``blocks.<i>.attn.qkv.weight``, ``final_layer.adaLN.bias``,
...); the blocks are an ``nn.ModuleList`` walked by a Python loop.  The
forward functions take the quantization plan ``DiTQuantConfig`` as an
argument, as the JAX ones do, so one set of weights serves every plan.

Contracts kept from the reference: adaLN-Zero blocks; ``exclude_blocks``
turns top-k and prediction off for those blocks (attention stays MX dense);
the block adaLN modulation is unquantized while the final layer's
modulation and projection are quantized; CFG guides the first 3 channels.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..attention import (TopKAttentionConfig, _kernel_elemwise_args,
                         _kernel_format_args, fused_qkv_eligible,
                         fused_qkv_topk_attention, split_t_eligible,
                         topk_attention)
from ..device import resolve_device
from ..ops.fastquant import (bf_fast, fused_eligible, quantize_mx_fast,
                             quantize_mx_serving)
from ..ops.kernels.ln_modulate_quantize import ln_modulate_quantize
from ..ops.kernels.topk_attention import fused_topk_attention_qkv_t
from ..ops.linear import gelu_linear, linear, mm_f32
from ..specs import MxSpecs
from .common import patch_embed


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    input_size: int = 32
    patch_size: int = 2
    in_channels: int = 4
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    learn_sigma: bool = True
    class_dropout_prob: float = 0.1

    @property
    def out_channels(self):
        return self.in_channels * 2 if self.learn_sigma else self.in_channels

    @property
    def num_patches(self):
        return (self.input_size // self.patch_size) ** 2

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class DiTQuantConfig:
    """Quantization plan (same fields as the JAX package's).

    Three opt-ins, each off by default, choose kernels where they apply
    (the gates are the JAX package's):
      * ``fuse_ln_modulate``: every block's two LN + modulate passes and
        the final layer's run as kernel K5 (LN, modulate and the MX
        quantize of the consumer linear's input in one pass), which then
        skips its own quantize.  Applies with MX quantization at bfloat=0
        in both tiers, and at bfloat=16 (the DiT operating point) in the
        serving tier only.
      * ``fuse_gelu``: the MLP's GELU and the fc2 input quantize run as
        kernel K6.  Serving tier only, where the fc1 output's last axis is
        block-aligned and holds at least 2^16 elements.
      * ``qkv_layout="split_t"``: the qkv projection emits q and k
        pre-transposed and attention runs as kernel K7 (K2's math).  Both
        tiers, where N % 128 == 0 and the fused qkv entry's conditions
        hold; the port's K7 takes N <= 256 and the ex_pred predictor (or
        none) and raises beyond them (ROADMAP.md).
    """
    mx_specs: Optional[MxSpecs] = None
    mx_quant: bool = False
    top_k: bool = False
    k: int = 20
    ex_pred: bool = True
    pred_mode: str = "ex_pred"
    exclude_blocks: Tuple[int, ...] = ()
    exclude_timesteps: Tuple[int, ...] = ()
    sparse_impl: str = "dense"
    topk_key_bits: int = 32
    contract: str = "exact"
    activation_dtype: str = "float32"
    fuse_ln_modulate: bool = False
    fuse_gelu: bool = False
    qkv_layout: str = "fused"

    def block_attn_cfg(self, idx: int,
                       timestep_idx: Optional[int]) -> TopKAttentionConfig:
        if not self.mx_quant or self.mx_specs is None:
            return TopKAttentionConfig(mx_quant=False)
        top_k = self.top_k and idx not in self.exclude_blocks
        if timestep_idx is not None and timestep_idx in self.exclude_timesteps:
            top_k = False
        approx = self.ex_pred and idx not in self.exclude_blocks
        return TopKAttentionConfig(
            mx_quant=True, top_k=top_k, k=self.k, approx_flag=approx,
            pred_mode=self.pred_mode, sparse_impl=self.sparse_impl,
            key_bits=self.topk_key_bits, contract=self.contract,
            out_dtype=("bfloat16" if self.activation_dtype == "bfloat16"
                       else "float32"))


# ----------------------------------------------------------------------
def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """Fixed 2-D sin/cos position table (reference models.py:484-530)."""
    def emb_1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0).reshape(
        [2, 1, grid_size, grid_size])
    emb = np.concatenate([emb_1d(embed_dim // 2, grid[0]),
                          emb_1d(embed_dim // 2, grid[1])], axis=1)
    return emb.astype(np.float32)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embedding (reference models.py:45-64)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) *
                      torch.arange(half, dtype=torch.float32,
                                   device=t.device) / half)
    args = t[:, None].to(torch.float32) * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


# ----------------------------------------------------------------------
class Affine(nn.Module):
    """Holds one linear layer's ``weight`` (out, in, ...) and ``bias`` (None
    with ``bias=False``); the product is taken by ``ops.linear.linear``
    with the plan's specs."""

    def __init__(self, in_f: int, out_f: int, device, kernel=(),
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(
            torch.zeros(out_f, in_f, *kernel, device=device),
            requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(out_f, device=device),
                                 requires_grad=False) if bias else None


class DiTBlock(nn.Module):
    def __init__(self, hs: int, hidden: int, device):
        super().__init__()
        self.attn = nn.Module()
        self.attn.qkv = Affine(hs, 3 * hs, device)
        self.attn.proj = Affine(hs, hs, device)
        self.mlp = nn.Module()
        self.mlp.fc1 = Affine(hs, hidden, device)
        self.mlp.fc2 = Affine(hidden, hs, device)
        self.adaLN = Affine(hs, 6 * hs, device)


class DiT(nn.Module):
    """DiT parameters, zero-filled; ``init_dit`` or a loader fills them."""

    def __init__(self, cfg: DiTConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        hs, p = cfg.hidden_size, cfg.patch_size
        self.x_embedder = Affine(cfg.in_channels, hs, device, (p, p))
        self.register_buffer("pos_embed", torch.as_tensor(
            get_2d_sincos_pos_embed(hs, int(cfg.num_patches ** 0.5))
        )[None].to(device))
        self.t_embedder = nn.Module()
        self.t_embedder.mlp0 = Affine(256, hs, device)
        self.t_embedder.mlp2 = Affine(hs, hs, device)
        n_embed = cfg.num_classes + (1 if cfg.class_dropout_prob > 0 else 0)
        self.y_embedder = nn.Module()
        self.y_embedder.table = nn.Parameter(
            torch.zeros(n_embed, hs, device=device), requires_grad=False)
        hidden = int(hs * cfg.mlp_ratio)
        self.blocks = nn.ModuleList(DiTBlock(hs, hidden, device)
                                    for _ in range(cfg.depth))
        self.final_layer = nn.Module()
        self.final_layer.adaLN = Affine(hs, 2 * hs, device)
        self.final_layer.linear = Affine(hs, p * p * cfg.out_channels,
                                         device)


def init_dit(cfg: DiTConfig, generator: torch.Generator, device="cuda",
             randomize_all: bool = False) -> DiT:
    """Reference ``initialize_weights``: xavier-uniform linears with zero
    biases, normal(0.02) timestep MLP and label table, zeroed adaLN
    modulations and final projection.  Those zeros make every block the
    identity; ``randomize_all=True`` draws them too (xavier weights and
    normal(0.02) biases everywhere), so that every kernel's output reaches
    the result.  Draws come from the CPU ``generator``, so a seed gives the
    same weights on every device."""
    model = DiT(cfg, device=device)

    def xavier(shape, fan_in, fan_out):
        lim = math.sqrt(6.0 / (fan_in + fan_out))
        return (torch.rand(shape, generator=generator) * 2 - 1) * lim

    def normal(shape, std=0.02):
        return std * torch.randn(shape, generator=generator)

    zero_init = ("adaLN", "final_layer.linear")
    with torch.no_grad():
        for name, prm in model.named_parameters():
            shape = tuple(prm.shape)
            if name == "y_embedder.table" or name.startswith("t_embedder"):
                keep = randomize_all or name.endswith(("weight", "table"))
                val = normal(shape) if keep else torch.zeros(shape)
            elif name.endswith("weight"):
                fan_in = int(np.prod(shape[1:]))
                if randomize_all or not any(z in name for z in zero_init):
                    val = xavier(shape, fan_in, shape[0])
                else:
                    val = torch.zeros(shape)
            else:  # biases
                val = normal(shape) if randomize_all else torch.zeros(shape)
            prm.copy_(val)
    return model


# ----------------------------------------------------------------------
def _qkv_split_t(x: torch.Tensor, qkv: nn.Module, mxs: MxSpecs, H: int,
                 D: int, x_prequantized: bool):
    """Quantized qkv projection emitting q and k pre-transposed, (2*H*Dp, B,
    N), and v (B, N, H*D): ``linear(x, W_qkv)`` reordered, with the same
    contraction per element and the same bf_fast rounds, the activation
    quantized once (or taken on the grid from K5).  Each head's q and k
    weight rows (and bias) are padded to Dp with zeros on every forward, as
    the JAX package does, so the padded rows of qk_t are zero."""
    bs = mxs.block_size
    sb = mxs.effective_scale_bits()
    fl = mxs.mx_flush_fp32_subnorms
    Dp = -(-max(D, 8) // bs) * bs
    if x_prequantized or mxs.prequantized_activations:
        qx = bf_fast(x, mxs).to(torch.bfloat16)
    else:
        qx = quantize_mx_serving(x, mxs.a_elem_format, bs, sb, axis=-1,
                                 flush=fl, bfloat=mxs.bfloat)
    w, b = qkv.weight, qkv.bias
    if mxs.prequantized_weights:
        qw = w.to(torch.bfloat16)
    else:
        qw = quantize_mx_fast(bf_fast(w, mxs), mxs.w_elem_format, bs, sb,
                              axis=-1, flush=fl)
    B, N, C = x.shape
    qw_qk = nn.functional.pad(qw[:2 * H * D].reshape(2 * H, D, C),
                              (0, 0, 0, Dp - D)).reshape(2 * H * Dp, C)
    # (2*H*Dp, C) . (B*N, C)^T: the product writes q and k pre-transposed
    qk_t = bf_fast(mm_f32(qw_qk, qx.reshape(B * N, C)), mxs).reshape(
        2 * H * Dp, B, N)
    v = bf_fast(mm_f32(qx, qw[2 * H * D:]), mxs)
    if b is not None:
        b_qk = nn.functional.pad(b[:2 * H * D].reshape(2 * H, D),
                                 (0, Dp - D)).reshape(-1)
        qk_t = bf_fast(qk_t + bf_fast(b_qk, mxs)[:, None, None], mxs)
        v = bf_fast(v + bf_fast(b[2 * H * D:], mxs), mxs)
    return qk_t, v, Dp


def dit_attention(attn: nn.Module, x: torch.Tensor, cfg: DiTConfig,
                  specs: Optional[MxSpecs], attn_cfg: TopKAttentionConfig,
                  x_prequantized: bool = False,
                  qkv_layout: str = "fused",
                  orthogonal_matrix=None) -> torch.Tensor:
    """Self-attention, routed as the JAX package routes: with
    ``qkv_layout="split_t"``, where it applies, the split-emission
    projection and kernel K7; else the fused qkv kernel (K2) where it serves
    the config, else the split q/k/v entry (``topk_attention``: K3, or the
    unquantized attention).  ``x_prequantized``: x is already on the MX
    grid (K5's output), so the qkv projection skips its quantize;
    ``orthogonal_matrix``: ELSA's projection."""
    B, N, C = x.shape
    H, D = cfg.num_heads, cfg.head_dim
    mxs = specs if attn_cfg.mx_quant else None
    if qkv_layout == "split_t" and split_t_eligible(mxs, attn_cfg, N):
        qk_t, v, _ = _qkv_split_t(x, attn.qkv, mxs, H, D, x_prequantized)
        if attn_cfg.out_dtype == "bfloat16":
            qk_t, v = qk_t.to(torch.bfloat16), v.to(torch.bfloat16)
        acfg = attn_cfg
        if not acfg.top_k:  # an excluded block: dense, k = N
            acfg = acfg._replace(top_k=True, approx_flag=False, k=N)
        out = fused_topk_attention_qkv_t(
            qk_t, v, H, k=acfg.k, scale=D ** -0.5, n_valid=N,
            block_size=mxs.block_size, scale_bits=mxs.effective_scale_bits(),
            approx=acfg.approx_flag, pred_mode=acfg.pred_mode,
            key_bits=acfg.key_bits, out_dtype=getattr(torch, acfg.out_dtype),
            contract=acfg.contract, **_kernel_elemwise_args(mxs),
            **_kernel_format_args(mxs))
        return linear(out, attn.proj.weight, attn.proj.bias, mx_specs=mxs)
    qkv = linear(x, attn.qkv.weight, attn.qkv.bias,
                 mx_specs=_preq(mxs, x_prequantized))
    if attn_cfg.out_dtype == "bfloat16":
        qkv = qkv.to(torch.bfloat16)  # values already sit on the bf16 grid
    if fused_qkv_eligible(mxs, attn_cfg, N):
        out = fused_qkv_topk_attention(qkv, H, D ** -0.5, mxs, attn_cfg)
    else:
        q, k, v = (t.contiguous() for t in
                   qkv.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4))
        out, _ = topk_attention(q, k, v, D ** -0.5, mxs, attn_cfg,
                                orthogonal_matrix=orthogonal_matrix)
        out = out.transpose(1, 2).reshape(B, N, C)
    return linear(out, attn.proj.weight, attn.proj.bias, mx_specs=mxs)


def _ln(x, eps=1e-6):
    xf = x.to(torch.float32)
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _lnmod_eligible(qcfg: DiTQuantConfig, specs: Optional[MxSpecs],
                    hidden: int) -> bool:
    """Does ``fuse_ln_modulate`` take kernel K5 (JAX ``dit_forward``'s
    gate)?  At bfloat=16 the kernel rounds the modulated result to bf16
    from f32 statistics, a serving-tier relaxation, so it applies there in
    the serving tier only."""
    return (qcfg.fuse_ln_modulate and specs is not None
            and fused_eligible(specs, specs.a_elem_format,
                               specs.w_elem_format)
            and (specs.bfloat == 0
                 or (specs.bfloat == 16 and qcfg.contract == "serving"))
            and hidden % specs.block_size == 0)


def _lnmod(x, shift, scale, specs, fused: bool):
    """LN and adaLN modulate -> (h, on the MX grid?).  ``fused``: kernel K5,
    whose output is the consumer linear's quantized input."""
    if not fused:
        return modulate(_ln(x), shift, scale), False
    return ln_modulate_quantize(
        x, shift, scale, specs.a_elem_format, specs.block_size,
        specs.effective_scale_bits(), flush=specs.mx_flush_fp32_subnorms,
        bfloat=specs.bfloat), True


def _preq(mxs, preq: bool):
    """The consumer linear's specs for an input already on the MX grid."""
    return mxs.replace(prequantized_activations=True) \
        if (preq and mxs is not None) else mxs


def dit_block_step(blk: DiTBlock, attn_cfg: TopKAttentionConfig,
                   x: torch.Tensor, cb: torch.Tensor, *, cfg: DiTConfig,
                   specs: Optional[MxSpecs], act_dtype,
                   fuse_lnmod: bool = False, qkv_layout: str = "fused",
                   fuse_gelu: bool = False,
                   orthogonal_matrix=None) -> torch.Tensor:
    """One DiT block (adaLN-Zero attention + MLP).  ``fuse_lnmod`` is
    ``_lnmod_eligible``'s answer; ``qkv_layout`` and ``fuse_gelu`` are the
    plan's (``DiTQuantConfig``); ``orthogonal_matrix`` ELSA's projection."""
    mxs = specs if attn_cfg.mx_quant else None
    mod = linear(nn.functional.silu(cb), blk.adaLN.weight,
                 blk.adaLN.bias).to(act_dtype)
    (shift_msa, scale_msa, gate_msa,
     shift_mlp, scale_mlp, gate_mlp) = mod.chunk(6, dim=-1)
    fused = fuse_lnmod and attn_cfg.mx_quant
    h, h_preq = _lnmod(x, shift_msa, scale_msa, specs, fused)
    x = x + gate_msa[:, None] * dit_attention(
        blk.attn, h, cfg, specs, attn_cfg, x_prequantized=h_preq,
        qkv_layout=qkv_layout,
        orthogonal_matrix=orthogonal_matrix).to(act_dtype)
    h, h_preq = _lnmod(x, shift_mlp, scale_mlp, specs, fused)
    h = linear(h, blk.mlp.fc1.weight, blk.mlp.fc1.bias,
               mx_specs=_preq(mxs, h_preq)).to(act_dtype)
    h = gelu_linear(h, blk.mlp.fc2.weight, blk.mlp.fc2.bias, mxs, fuse_gelu,
                    attn_cfg.contract).to(act_dtype)
    return x + gate_mlp[:, None] * h


def dit_embed(model: DiT, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor,
              qcfg: DiTQuantConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Patch, position, timestep and class embeddings: (B, C, H, W)
    latents -> (B, N, hidden) tokens in the activation dtype and the
    (B, hidden) f32 conditioning."""
    cfg = model.cfg
    bf16 = qcfg.activation_dtype == "bfloat16"
    pe = model.x_embedder
    h = patch_embed(x, pe.weight, pe.bias, cfg.patch_size, bf16=bf16)
    h = h + model.pos_embed

    te = model.t_embedder
    t_emb = linear(timestep_embedding(t, 256), te.mlp0.weight, te.mlp0.bias)
    t_emb = linear(nn.functional.silu(t_emb), te.mlp2.weight, te.mlp2.bias)
    c = t_emb + model.y_embedder.table[y]
    return h.to(torch.bfloat16 if bf16 else torch.float32), c


def dit_final_layer(model: DiT, h: torch.Tensor, c: torch.Tensor,
                    qcfg: DiTQuantConfig) -> torch.Tensor:
    """adaLN modulate, final linear and unpatchify: (B, N, hidden) tokens
    and the f32 conditioning -> (B, outC, H, W) f32."""
    cfg = model.cfg
    specs = qcfg.mx_specs if qcfg.mx_quant else None
    fl = model.final_layer
    mod = linear(nn.functional.silu(c), fl.adaLN.weight, fl.adaLN.bias,
                 mx_specs=specs)
    shift, scale = mod.to(h.dtype).chunk(2, dim=-1)
    h, preq = _lnmod(h, shift, scale, specs,
                     _lnmod_eligible(qcfg, specs, cfg.hidden_size))
    h = linear(h, fl.linear.weight, fl.linear.bias,
               mx_specs=_preq(specs, preq))
    h = h.to(torch.float32)

    B, c_out, p = h.shape[0], cfg.out_channels, cfg.patch_size
    g = int(h.shape[1] ** 0.5)
    h = h.reshape(B, g, g, p, p, c_out).permute(0, 5, 1, 3, 2, 4)
    return h.reshape(B, c_out, g * p, g * p)


def dit_forward(model: DiT, x: torch.Tensor, t: torch.Tensor,
                y: torch.Tensor, qcfg: DiTQuantConfig,
                timestep_idx: Optional[int] = None,
                orthogonal_matrix=None) -> torch.Tensor:
    """(B, C, H, W) latents + (B,) timesteps + (B,) labels ->
    (B, outC, H, W); ``orthogonal_matrix``: ELSA's projection."""
    specs = qcfg.mx_specs if qcfg.mx_quant else None
    h, c = dit_embed(model, x, t, y, qcfg)
    cb = c.to(h.dtype)
    fuse_lnmod = _lnmod_eligible(qcfg, specs, model.cfg.hidden_size)
    for i, blk in enumerate(model.blocks):
        h = dit_block_step(blk, qcfg.block_attn_cfg(i, timestep_idx), h, cb,
                           cfg=model.cfg, specs=specs, act_dtype=h.dtype,
                           fuse_lnmod=fuse_lnmod, qkv_layout=qcfg.qkv_layout,
                           fuse_gelu=qcfg.fuse_gelu,
                           orthogonal_matrix=orthogonal_matrix)
    return dit_final_layer(model, h, c, qcfg)


def dit_forward_with_cfg(model: DiT, x, t, y, qcfg: DiTQuantConfig,
                         cfg_scale: float,
                         timestep_idx: Optional[int] = None,
                         orthogonal_matrix=None) -> torch.Tensor:
    """CFG forward on the duplicated batch; guidance on the first 3
    channels only (reference models.py:452-476)."""
    half = x[: len(x) // 2]
    out = dit_forward(model, torch.cat([half, half], dim=0), t, y, qcfg,
                      timestep_idx, orthogonal_matrix)
    eps, rest = out[:, :3], out[:, 3:]
    cond_eps, uncond_eps = eps.chunk(2, dim=0)
    half_eps = uncond_eps + cfg_scale * (cond_eps - uncond_eps)
    return torch.cat([torch.cat([half_eps, half_eps], dim=0), rest], dim=1)


# ----------------------------------------------------------------------
def _mk(depth, hidden, patch, heads):
    def factory(input_size=32, **kw):
        return DiTConfig(input_size=input_size, patch_size=patch,
                         hidden_size=hidden, depth=depth, num_heads=heads,
                         **kw)
    return factory


DiT_models = {
    "DiT-XL/2": _mk(28, 1152, 2, 16), "DiT-XL/4": _mk(28, 1152, 4, 16),
    "DiT-XL/8": _mk(28, 1152, 8, 16),
    "DiT-L/2": _mk(24, 1024, 2, 16), "DiT-L/4": _mk(24, 1024, 4, 16),
    "DiT-L/8": _mk(24, 1024, 8, 16),
    "DiT-B/2": _mk(12, 768, 2, 12), "DiT-B/4": _mk(12, 768, 4, 12),
    "DiT-B/8": _mk(12, 768, 8, 12),
    "DiT-S/2": _mk(12, 384, 2, 6), "DiT-S/4": _mk(12, 384, 4, 6),
    "DiT-S/8": _mk(12, 384, 8, 6),
    "DiT-debug": _mk(2, 64, 2, 2),
}
