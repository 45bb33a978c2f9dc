"""T5 v1.1 text encoder (port of the JAX package's ``models/t5.py``,
forward only): PixArt's prompt encoder, run in the same process as the
sampler and optionally MX-quantized (``mx_specs``: every projection goes
through ``ops.linear``, so the activation quantize is kernel K1 on the
card; MXINT8 stands where the reference runs an 8-bit bitsandbytes T5).

Architecture (google/t5-v1_1-*): RMSNorm (no bias, eps 1e-6), one relative
position bias table shared by every layer (bidirectional buckets, 32 of
them up to distance 128), unscaled attention with an f32 score and
``finfo(f32).min`` masking, a gated tanh-GELU FFN (wi_0 through GELU times
wi_1, then wo), the input embedding, a final RMSNorm.  The attention and
FFN products outside the projections are plain ``torch.matmul`` and
elementwise ops, as JAX computes them outside any Pallas kernel.

The bucket table is built on the host in numpy float32 in JAX's operation
order: the bucket truncates an f32 log to an integer, and at the distances
where the log lands on an integer (16, 32, ..., 512) one ulp between two
log implementations would move a bucket.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.linear import linear


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096          # t5-v1_1-xxl
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6


T5_CONFIGS = {
    "t5-v1_1-small": T5Config(d_model=512, d_kv=64, d_ff=1024,
                              num_layers=8, num_heads=6),
    "t5-v1_1-xxl": T5Config(),
}


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * w


def relative_position_bucket(rel_pos: np.ndarray, num_buckets: int = 32,
                             max_distance: int = 128) -> np.ndarray:
    """Bidirectional T5 bucket of each relative position (transformers'
    ``T5Attention._relative_position_bucket``), in numpy float32 with JAX's
    operation order; int32."""
    rel_pos = np.asarray(rel_pos)
    num_buckets //= 2
    ret = (rel_pos > 0).astype(np.int32) * num_buckets
    n = np.abs(rel_pos)
    max_exact = num_buckets // 2
    ratio = n.astype(np.float32) / np.float32(max_exact) + np.float32(1e-6)
    val_large = max_exact + (
        np.log(ratio) / np.float32(np.log(max_distance / max_exact))
        * np.float32(num_buckets - max_exact)).astype(np.int32)
    val_large = np.minimum(val_large, num_buckets - 1)
    return (ret + np.where(n < max_exact, n, val_large)).astype(np.int32)


def _weight(o: int, i: int, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(o, i, device=device), requires_grad=False)


def _ones(d: int, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(d, device=device), requires_grad=False)


class _Attn(nn.Module):
    def __init__(self, d: int, inner: int, device):
        super().__init__()
        self.ln = _ones(d, device)
        self.q, self.k, self.v = (_weight(inner, d, device) for _ in "qkv")
        self.o = _weight(d, inner, device)


class _FF(nn.Module):
    def __init__(self, d: int, ff: int, device):
        super().__init__()
        self.ln = _ones(d, device)
        self.wi_0, self.wi_1 = _weight(ff, d, device), _weight(ff, d, device)
        self.wo = _weight(d, ff, device)


class _Block(nn.Module):
    def __init__(self, cfg: T5Config, device):
        super().__init__()
        self.attn = _Attn(cfg.d_model, cfg.num_heads * cfg.d_kv, device)
        self.ff = _FF(cfg.d_model, cfg.d_ff, device)


class T5Encoder(nn.Module):
    """T5 encoder parameters, named after the JAX tree (``embed``,
    ``rel_bias``, ``blocks.<i>.attn.q``, ``blocks.<i>.ff.wi_0``,
    ``final_ln``); projections are (out, in) and bias-free.  Zero-filled
    (norm weights one); ``init_t5_encoder`` or a loader fills them."""

    def __init__(self, cfg: T5Config, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = _weight(cfg.vocab_size, cfg.d_model, device)
        self.rel_bias = _weight(cfg.relative_attention_num_buckets,
                                cfg.num_heads, device)
        self.blocks = nn.ModuleList(_Block(cfg, device)
                                    for _ in range(cfg.num_layers))
        self.final_ln = _ones(cfg.d_model, device)


def position_bias(model: T5Encoder, L: int,
                  attention_mask: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """The (B or 1, H, L, L) f32 additive attention bias shared by every
    layer: the relative position bias (buckets from the host's table) plus
    ``finfo(f32).min`` at the padded keys."""
    cfg, dev = model.cfg, model.embed.device
    buckets = relative_position_bucket(
        np.arange(L)[None, :] - np.arange(L)[:, None],
        cfg.relative_attention_num_buckets,
        cfg.relative_attention_max_distance)
    idx = torch.from_numpy(buckets.astype(np.int64)).to(dev)
    bias = model.rel_bias[idx].permute(2, 0, 1)[None]   # (1, H, L, L)
    if attention_mask is not None:
        keep = attention_mask.to(dev)[:, None, None, :] > 0
        bias = bias + torch.where(
            keep, torch.zeros((), device=dev),
            torch.full((), torch.finfo(torch.float32).min, device=dev))
    return bias


def t5_block(blk: nn.Module, x: torch.Tensor, bias: torch.Tensor,
             cfg: T5Config, mx_specs=None) -> torch.Tensor:
    """One encoder layer on the (B, L, d_model) residual stream ``x``: each
    of its seven projections quantizes its own input with ``mx_specs`` (q,
    k and v each quantize the same ``h``), as JAX's ``t5_encode`` does."""
    B, L, _ = x.shape
    H, dk, eps = cfg.num_heads, cfg.d_kv, cfg.layer_norm_epsilon

    def lin(h, w):
        return linear(h, w, None, mx_specs=mx_specs)

    def heads(t):
        return t.reshape(B, L, H, dk).transpose(1, 2)

    with torch.inference_mode():
        att = blk.attn
        h = _rms_norm(x, att.ln, eps)
        q, k, v = (heads(lin(h, att.q)), heads(lin(h, att.k)),
                   heads(lin(h, att.v)))
        # T5 attention is unscaled (the 1/sqrt(d) is folded into init)
        scores = torch.matmul(q.to(torch.float32),
                              k.to(torch.float32).transpose(-1, -2))
        probs = torch.softmax(scores + bias, dim=-1).to(v.dtype)
        o = torch.matmul(probs, v).transpose(1, 2).reshape(B, L, H * dk)
        x = x + lin(o, att.o)

        ff = blk.ff
        h = _rms_norm(x, ff.ln, eps)
        g = F.gelu(lin(h, ff.wi_0), approximate="tanh")
        return x + lin(g * lin(h, ff.wi_1), ff.wo)


def t5_encode(model: T5Encoder, input_ids: torch.Tensor,
              attention_mask: Optional[torch.Tensor] = None,
              mx_specs=None) -> torch.Tensor:
    """(B, L) token ids -> (B, L, d_model) final hidden states, on the
    model's device (``t5_block`` per layer; with ``mx_specs`` 7 MX-quantized
    projections a layer)."""
    with torch.inference_mode():
        input_ids = input_ids.to(model.embed.device)
        x = model.embed[input_ids]
        bias = position_bias(model, input_ids.shape[1], attention_mask)
        for blk in model.blocks:
            x = t5_block(blk, x, bias, model.cfg, mx_specs)
        return _rms_norm(x, model.final_ln, model.cfg.layer_norm_epsilon)


def init_t5_encoder(cfg: T5Config, generator: torch.Generator,
                    device="cuda") -> T5Encoder:
    """JAX's ``init_t5_encoder`` distributions: normal(0.02) projections,
    embedding and bias table, norm weights one.  Draws come from
    ``generator`` on its own device (a CPU generator gives the same weights
    on every device; a CUDA one draws T5-XXL's 4.8 B weights on the card)."""
    model = T5Encoder(cfg, device)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            if name.endswith("ln"):
                continue
            prm.copy_(0.02 * torch.randn(tuple(prm.shape),
                                         generator=generator,
                                         device=generator.device))
    return model


def load_t5_checkpoint(path_or_sd, cfg: T5Config) -> Dict[str, torch.Tensor]:
    """A transformers ``T5EncoderModel`` state dict (a torch .bin/.pt path,
    a safetensors path, or an in-memory dict) as a float32 state dict in
    the port's names, for ``T5Encoder.load_state_dict``."""
    if isinstance(path_or_sd, str):
        if path_or_sd.endswith(".safetensors"):
            from safetensors.torch import load_file
            sd = load_file(path_or_sd)
        else:
            sd = torch.load(path_or_sd, map_location="cpu",
                            weights_only=True)
    else:
        sd = path_or_sd

    def pick(*names):
        for n in names:
            if n in sd:
                return sd[n]
        raise KeyError(names)

    out = {
        "embed": pick("shared.weight", "encoder.embed_tokens.weight"),
        "rel_bias": pick("encoder.block.0.layer.0.SelfAttention"
                         ".relative_attention_bias.weight"),
        "final_ln": pick("encoder.final_layer_norm.weight"),
    }
    for i in range(cfg.num_layers):
        pre, ours = f"encoder.block.{i}.layer", f"blocks.{i}"
        out[f"{ours}.attn.ln"] = sd[f"{pre}.0.layer_norm.weight"]
        for n in ("q", "k", "v", "o"):
            out[f"{ours}.attn.{n}"] = sd[f"{pre}.0.SelfAttention.{n}.weight"]
        out[f"{ours}.ff.ln"] = sd[f"{pre}.1.layer_norm.weight"]
        for n in ("wi_0", "wi_1", "wo"):
            out[f"{ours}.ff.{n}"] = sd[f"{pre}.1.DenseReluDense.{n}.weight"]
    return {k: torch.as_tensor(v).detach().to(torch.float32)
            for k, v in out.items()}
