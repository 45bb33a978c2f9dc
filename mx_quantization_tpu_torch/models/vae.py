"""AutoencoderKL (sd-vae-ft-mse) decoder and encoder (port of the JAX
package's ``models/vae.py``): DiT's and PixArt's latents to images, and
images to latents (DiT's training input).

The architecture is diffusers' AutoencoderKL with block_out_channels
128/256/512/512, 2 resnets per down block and 3 per up block, GroupNorm(32)
+ SiLU resnets and a single-head mid attention; scaling_factor 0.18215.
``VaeConfig`` also takes narrower block channels (multiples of 32), which
the CPU tests use.  Convolutions are ``F.conv2d`` (JAX uses
``lax.conv``, not a Pallas kernel); GroupNorm is JAX's two-pass mean and
variance; the mid attention's products are ``torch.matmul``; the decoder's
nearest x2 upsample is ``ops.resize``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.resize import resize
from .dit import Affine

SCALING_FACTOR = 0.18215
BLOCK_CH = (128, 256, 512, 512)
LAYERS = 2   # resnets per down block (one more per up block)
LATENT = 4   # latent channels


@dataclasses.dataclass(frozen=True)
class VaeConfig:
    block_ch: Tuple[int, ...] = BLOCK_CH


def _gn(x, p, groups=32, eps=1e-6):
    N, C, H, W = x.shape
    xg = x.reshape(N, groups, C // groups, H, W)
    mean = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = torch.square(xg - mean).mean(dim=(2, 3, 4), keepdim=True)
    xn = ((xg - mean) * torch.rsqrt(var + eps)).reshape(N, C, H, W)
    return xn * p.weight.reshape(1, -1, 1, 1) + p.bias.reshape(1, -1, 1, 1)


def _conv(x, p, stride=1, padding=1):
    return F.conv2d(x, p.weight, p.bias, stride=stride, padding=padding)


def _resnet(x, p):
    h = F.silu(_gn(x, p.norm1))
    h = _conv(h, p.conv1)
    h = F.silu(_gn(h, p.norm2))
    h = _conv(h, p.conv2)
    if hasattr(p, "conv_shortcut"):
        x = _conv(x, p.conv_shortcut, padding=0)
    return x + h


def _attn(x, p):
    N, C, H, W = x.shape
    h = _gn(x, p.group_norm)
    flat = h.reshape(N, C, H * W).transpose(1, 2)  # (N, HW, C)
    q = flat @ p.to_q.weight.t() + p.to_q.bias
    k = flat @ p.to_k.weight.t() + p.to_k.bias
    v = flat @ p.to_v.weight.t() + p.to_v.bias
    s = (q @ k.transpose(1, 2)) / np.float32(math.sqrt(C))
    out = torch.softmax(s, dim=-1) @ v
    out = out @ p.to_out.weight.t() + p.to_out.bias
    return x + out.transpose(1, 2).reshape(N, C, H, W)


def _upsample(x, p):
    N, C, H, W = x.shape
    return _conv(resize(x, (N, C, 2 * H, 2 * W), "nearest"), p)


def _downsample(x, p):
    return _conv(F.pad(x, (0, 1, 0, 1)), p, stride=2, padding=0)


# ----------------------------------------------------------------------
class _Norm(nn.Module):
    def __init__(self, c, device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(c, device=device),
                                 requires_grad=False)


def _conv3(cin, cout, device):
    return Affine(cin, cout, device, (3, 3))


def _conv1(cin, cout, device):
    return Affine(cin, cout, device, (1, 1))


class _Resnet(nn.Module):
    def __init__(self, cin, cout, device):
        super().__init__()
        self.norm1 = _Norm(cin, device)
        self.conv1 = _conv3(cin, cout, device)
        self.norm2 = _Norm(cout, device)
        self.conv2 = _conv3(cout, cout, device)
        if cin != cout:
            self.conv_shortcut = _conv1(cin, cout, device)


class _Attention(nn.Module):
    def __init__(self, c, device):
        super().__init__()
        self.group_norm = _Norm(c, device)
        for name in ("to_q", "to_k", "to_v", "to_out"):
            setattr(self, name, Affine(c, c, device))


class _Mid(nn.Module):
    def __init__(self, c, device):
        super().__init__()
        self.resnets = nn.ModuleList([_Resnet(c, c, device),
                                      _Resnet(c, c, device)])
        self.attn = _Attention(c, device)


class _Block(nn.Module):
    """``n`` resnets, then the ``sampler`` conv ("upsampler" or
    "downsampler"), if any."""

    def __init__(self, cin, cout, n, sampler, device):
        super().__init__()
        self.resnets = nn.ModuleList(
            _Resnet(cin if j == 0 else cout, cout, device) for j in range(n))
        if sampler:
            setattr(self, sampler, _conv3(cout, cout, device))


class AutoencoderKL(nn.Module):
    """VAE parameters named after the JAX tree (``post_quant_conv``,
    ``decoder.mid.resnets.0.norm1.weight``,
    ``decoder.up_blocks.<i>.upsampler.weight``,
    ``encoder.down_blocks.<i>.downsampler.weight``, ...).  Zero-filled
    (norm weights one); ``init_vae`` or ``load_vae_checkpoint`` fills them."""

    def __init__(self, cfg: VaeConfig = VaeConfig(), device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        ch, top, nb = cfg.block_ch, cfg.block_ch[-1], len(cfg.block_ch)
        self.post_quant_conv = _conv1(LATENT, LATENT, device)
        self.quant_conv = _conv1(2 * LATENT, 2 * LATENT, device)

        dec = self.decoder = nn.Module()
        dec.conv_in = _conv3(LATENT, top, device)
        dec.mid = _Mid(top, device)
        dec_ch = list(reversed(ch))
        dec.up_blocks = nn.ModuleList(
            _Block(dec_ch[i - 1] if i else top, c, LAYERS + 1,
                   "upsampler" if i < nb - 1 else None, device)
            for i, c in enumerate(dec_ch))
        dec.conv_norm_out = _Norm(ch[0], device)
        dec.conv_out = _conv3(ch[0], 3, device)

        enc = self.encoder = nn.Module()
        enc.conv_in = _conv3(3, ch[0], device)
        enc.down_blocks = nn.ModuleList(
            _Block(ch[i - 1] if i else ch[0], c, LAYERS,
                   "downsampler" if i < nb - 1 else None, device)
            for i, c in enumerate(ch))
        enc.mid = _Mid(top, device)
        enc.conv_norm_out = _Norm(top, device)
        enc.conv_out = _conv3(top, 2 * LATENT, device)


def init_vae(cfg: VaeConfig, generator: torch.Generator,
             device="cuda") -> AutoencoderKL:
    """Random weights for runs without a checkpoint: convs and linears
    normal with std 1/sqrt(fan_in) (so activations keep their scale through
    the residual stack), biases normal(0.02), norm weights one.  Draws come
    from ``generator`` on its own device."""
    model = AutoencoderKL(cfg, device)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            if "norm" in name and name.endswith("weight"):
                continue
            shape = tuple(prm.shape)
            std = (1.0 / math.sqrt(int(np.prod(shape[1:])))
                   if len(shape) > 1 else 0.02)
            prm.copy_(std * torch.randn(shape, generator=generator,
                                        device=generator.device))
    return model


def decode_latents(model: AutoencoderKL, latents: torch.Tensor,
                   scale: bool = True) -> torch.Tensor:
    """(N, 4, h, w) latents -> (N, 3, 8h, 8w) images in [-1, 1] (for
    ``len(block_ch) == 4``), on the model's device."""
    d = model.decoder
    with torch.inference_mode():
        z = latents.to(model.post_quant_conv.weight.device, torch.float32)
        z = z / SCALING_FACTOR if scale else z
        z = _conv(z, model.post_quant_conv, padding=0)
        h = _conv(z, d.conv_in)
        h = _resnet(h, d.mid.resnets[0])
        h = _attn(h, d.mid.attn)
        h = _resnet(h, d.mid.resnets[1])
        for up in d.up_blocks:
            for rp in up.resnets:
                h = _resnet(h, rp)
            if hasattr(up, "upsampler"):
                h = _upsample(h, up.upsampler)
        h = F.silu(_gn(h, d.conv_norm_out))
        return _conv(h, d.conv_out)


def encode_images(model: AutoencoderKL, images: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  scale: bool = True) -> torch.Tensor:
    """(N, 3, H, W) [-1, 1] images -> (N, 4, H/8, W/8) latents: the mode of
    the latent distribution, or with ``generator`` a sample from it (JAX's
    ``sample_key``), as diffusers' ``encode().latent_dist`` (DiT
    train.py:204)."""
    e = model.encoder
    with torch.inference_mode():
        h = _conv(images.to(model.quant_conv.weight.device, torch.float32),
                  e.conv_in)
        for down in e.down_blocks:
            for rp in down.resnets:
                h = _resnet(h, rp)
            if hasattr(down, "downsampler"):
                h = _downsample(h, down.downsampler)
        h = _resnet(h, e.mid.resnets[0])
        h = _attn(h, e.mid.attn)
        h = _resnet(h, e.mid.resnets[1])
        h = F.silu(_gn(h, e.conv_norm_out))
        h = _conv(h, e.conv_out)
        moments = _conv(h, model.quant_conv, padding=0)
        mean, logvar = moments.chunk(2, dim=1)
        if generator is not None:
            std = torch.exp(0.5 * torch.clamp(logvar, -30, 20))
            noise = torch.randn(mean.shape, generator=generator,
                                device=generator.device)
            mean = mean + std * noise.to(mean.device)
        return mean * SCALING_FACTOR if scale else mean


# ----------------------------------------------------------------------
def vae_checkpoint_names(cfg: VaeConfig = VaeConfig()) -> Dict[str, str]:
    """Each parameter name of ``AutoencoderKL(cfg)`` -> its key in a
    diffusers AutoencoderKL state dict (diffusers >= 0.18 attention names
    ``to_q``/``to_k``/``to_v``/``to_out.0``), as JAX's loader maps them."""
    names: Dict[str, str] = {}

    def leaves(ours, theirs):
        for leaf in ("weight", "bias"):
            names[f"{ours}.{leaf}"] = f"{theirs}.{leaf}"

    def resnet(pre, cin, cout):
        for name in ("norm1", "conv1", "norm2", "conv2"):
            leaves(f"{pre}.{name}", f"{pre}.{name}")
        if cin != cout:
            leaves(f"{pre}.conv_shortcut", f"{pre}.conv_shortcut")

    def mid(ours, theirs):
        for j in range(2):  # the mid resnets keep their width
            for name in ("norm1", "conv1", "norm2", "conv2"):
                leaves(f"{ours}.resnets.{j}.{name}",
                       f"{theirs}.resnets.{j}.{name}")
        for name, key in (("group_norm", "group_norm"), ("to_q", "to_q"),
                          ("to_k", "to_k"), ("to_v", "to_v"),
                          ("to_out", "to_out.0")):
            leaves(f"{ours}.attn.{name}", f"{theirs}.attentions.0.{key}")

    ch, n = cfg.block_ch, LAYERS
    for name in ("post_quant_conv", "quant_conv", "decoder.conv_in",
                 "decoder.conv_norm_out", "decoder.conv_out",
                 "encoder.conv_in", "encoder.conv_norm_out",
                 "encoder.conv_out"):
        leaves(name, name)
    mid("decoder.mid", "decoder.mid_block")
    mid("encoder.mid", "encoder.mid_block")
    dec_ch = list(reversed(ch))
    prev = dec_ch[0]
    for i, c in enumerate(dec_ch):
        for j in range(n + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}",
                   prev if j == 0 else c, c)
        if i < len(dec_ch) - 1:
            leaves(f"decoder.up_blocks.{i}.upsampler",
                   f"decoder.up_blocks.{i}.upsamplers.0.conv")
        prev = c
    for i, c in enumerate(ch):
        cin = ch[i - 1] if i > 0 else ch[0]
        for j in range(n):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}",
                   cin if j == 0 else c, c)
        if i < len(ch) - 1:
            leaves(f"encoder.down_blocks.{i}.downsampler",
                   f"encoder.down_blocks.{i}.downsamplers.0.conv")
    return names


def load_vae_checkpoint(path: str, cfg: VaeConfig = VaeConfig()
                        ) -> Dict[str, torch.Tensor]:
    """A diffusers AutoencoderKL state dict (torch .bin/.pt, or
    .safetensors) as a float32 state dict in the port's names, for
    ``AutoencoderKL.load_state_dict``; the attention projections' weights
    are flattened to (out, in), as JAX's loader flattens them (older
    files store them as 1x1 convs)."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file
        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if "state_dict" in sd:
            sd = sd["state_dict"]
    out = {}
    for ours, theirs in vae_checkpoint_names(cfg).items():
        v = sd[theirs]
        if ".attn.to_" in ours and ours.endswith("weight"):
            v = v.reshape(v.shape[0], -1)
        out[ours] = v.detach().to(torch.float32)
    return out
