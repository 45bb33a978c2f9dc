"""CLIP, the ViT image tower and the causal text tower (port of the JAX
package's ``models/clip.py``): the CLIP-score scorer with
clip-vit-large-patch14 (the reference's PixArt/evaluation/clip_score.py
uses torchmetrics' CLIPScore with it), on the port's device.

transformers' CLIPModel semantics:
  * vision: conv patch embed (no bias) + class embedding + learned
    positions -> pre_layrnorm (sic) -> encoder -> pooled = the class token
    -> post_layernorm -> visual_projection (no bias)
  * text: token + learned position embeddings -> encoder with a causal
    mask plus the padding mask -> final_layer_norm -> pooled at the end of
    text token (the highest id for the legacy eos_token_id == 2 configs,
    the first eos otherwise) -> text_projection (no bias)
  * encoder layer: pre-LN residual attention (q scaled by d^-1/2) + pre-LN
    MLP with quick_gelu (x * sigmoid(1.702 x)); LN eps 1e-5

The linears run through ``ops.linear``, so an ``mx_specs`` quantizes the
towers as in JAX (the activation quantize is kernel K1 on the card); the
attention products are f32 ``torch.matmul``, the patch embed ``F.conv2d``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.linear import linear
from ..ops.resize import resize
from .dit import Affine


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    # vision tower
    image_size: int = 224
    patch_size: int = 14
    v_hidden: int = 1024
    v_layers: int = 24
    v_heads: int = 16
    v_mlp: int = 4096
    # text tower
    vocab_size: int = 49408
    max_positions: int = 77
    t_hidden: int = 768
    t_layers: int = 12
    t_heads: int = 12
    t_mlp: int = 3072
    projection_dim: int = 768
    eos_token_id: int = 2        # legacy configs: pooled at argmax(ids)
    eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


CLIP_CONFIGS = {
    "clip-vit-large-patch14": ClipConfig(),
}

# CLIPProcessor normalization constants (openai/clip-vit-large-patch14)
IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def _ln(x, p, eps):
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype) * p.weight \
        + p.bias


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _lin(x, p, mx_specs):
    return linear(x, p.weight, p.bias, mx_specs=mx_specs)


def _encoder_layer(p, x, heads, eps, mask=None, mx_specs=None):
    B, N, C = x.shape
    D = C // heads

    def split(t):
        return t.reshape(B, N, heads, D).transpose(1, 2)

    h = _ln(x, p.ln1, eps)
    q = split(_lin(h, p.q, mx_specs)) * (D ** -0.5)
    k = split(_lin(h, p.k, mx_specs))
    v = split(_lin(h, p.v, mx_specs))
    s = torch.matmul(q, k.transpose(-1, -2))
    if mask is not None:
        s = s + mask
    o = torch.matmul(torch.softmax(s, dim=-1), v)
    x = x + _lin(o.transpose(1, 2).reshape(B, N, C), p.out, mx_specs)
    h = _quick_gelu(_lin(_ln(x, p.ln2, eps), p.fc1, mx_specs))
    return x + _lin(h, p.fc2, mx_specs)


# ----------------------------------------------------------------------
def _param(*shape, device):
    return nn.Parameter(torch.zeros(*shape, device=device),
                        requires_grad=False)


class _LayerNorm(nn.Module):
    def __init__(self, c, device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device),
                                   requires_grad=False)
        self.bias = _param(c, device=device)


class _Layer(nn.Module):
    def __init__(self, c, m, device):
        super().__init__()
        self.ln1 = _LayerNorm(c, device)
        for name in ("q", "k", "v", "out"):
            setattr(self, name, Affine(c, c, device))
        self.ln2 = _LayerNorm(c, device)
        self.fc1 = Affine(c, m, device)
        self.fc2 = Affine(m, c, device)


class Clip(nn.Module):
    """CLIP parameters named after the JAX tree (``vision.patch_embedding``,
    ``vision.layers.<i>.q.weight``, ``text.token_embedding``,
    ``visual_projection``, ...).  Zero-filled (LN weights one);
    ``init_clip`` or ``load_clip_checkpoint`` fills them."""

    def __init__(self, cfg: ClipConfig = ClipConfig(), device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        v, t = nn.Module(), nn.Module()
        v.patch_embedding = _param(cfg.v_hidden, 3, cfg.patch_size,
                                   cfg.patch_size, device=device)
        v.class_embedding = _param(cfg.v_hidden, device=device)
        v.position_embedding = _param(cfg.num_patches + 1, cfg.v_hidden,
                                      device=device)
        v.pre_ln = _LayerNorm(cfg.v_hidden, device)
        v.post_ln = _LayerNorm(cfg.v_hidden, device)
        v.layers = nn.ModuleList(_Layer(cfg.v_hidden, cfg.v_mlp, device)
                                 for _ in range(cfg.v_layers))
        t.token_embedding = _param(cfg.vocab_size, cfg.t_hidden,
                                   device=device)
        t.position_embedding = _param(cfg.max_positions, cfg.t_hidden,
                                      device=device)
        t.final_ln = _LayerNorm(cfg.t_hidden, device)
        t.layers = nn.ModuleList(_Layer(cfg.t_hidden, cfg.t_mlp, device)
                                 for _ in range(cfg.t_layers))
        self.vision, self.text = v, t
        self.visual_projection = _param(cfg.projection_dim, cfg.v_hidden,
                                        device=device)
        self.text_projection = _param(cfg.projection_dim, cfg.t_hidden,
                                      device=device)


def clip_image_embed(model: Clip, pixel_values: torch.Tensor,
                     mx_specs=None) -> torch.Tensor:
    """(B, 3, H, W) normalized pixels -> (B, projection_dim) image embeds
    (CLIPVisionTransformer + visual_projection), on the model's device."""
    cfg, vp = model.cfg, model.vision
    with torch.inference_mode():
        px = pixel_values.to(vp.patch_embedding.device, torch.float32)
        B = px.shape[0]
        x = F.conv2d(px, vp.patch_embedding, stride=cfg.patch_size)
        x = x.reshape(B, cfg.v_hidden, -1).transpose(1, 2)  # (B, N, C)
        cls = vp.class_embedding.expand(B, 1, cfg.v_hidden)
        x = torch.cat([cls, x], dim=1) + vp.position_embedding
        x = _ln(x, vp.pre_ln, cfg.eps)
        for lp in vp.layers:
            x = _encoder_layer(lp, x, cfg.v_heads, cfg.eps,
                               mx_specs=mx_specs)
        pooled = _ln(x[:, 0], vp.post_ln, cfg.eps)
        return linear(pooled, model.visual_projection, None,
                      mx_specs=mx_specs)


def clip_text_embed(model: Clip, input_ids: torch.Tensor,
                    attention_mask: Optional[torch.Tensor] = None,
                    mx_specs=None) -> torch.Tensor:
    """(B, L) token ids -> (B, projection_dim) text embeds
    (CLIPTextTransformer + text_projection; causal and padding masks), on
    the model's device."""
    cfg, tp = model.cfg, model.text
    dev = tp.token_embedding.device
    with torch.inference_mode():
        ids = input_ids.to(dev)
        B, L = ids.shape
        x = tp.token_embedding[ids] + tp.position_embedding[:L]
        neg = torch.full((), torch.finfo(torch.float32).min, device=dev)
        zero = torch.zeros((), device=dev)
        pos = torch.arange(L, device=dev)
        mask = torch.where(pos[:, None] >= pos[None, :], zero, neg)[None, None]
        if attention_mask is not None:
            pad = torch.where(attention_mask.to(dev).bool(), zero, neg)
            mask = mask + pad[:, None, None, :]
        for lp in tp.layers:
            x = _encoder_layer(lp, x, cfg.t_heads, cfg.eps, mask=mask,
                               mx_specs=mx_specs)
        x = _ln(x, tp.final_ln, cfg.eps)
        if cfg.eos_token_id == 2:
            # legacy configs: the end of text is the highest id of a row
            eot = torch.argmax(ids, dim=-1)
        else:
            eot = torch.argmax((ids == cfg.eos_token_id).to(torch.int32),
                               dim=-1)
        pooled = x[torch.arange(B, device=dev), eot]
        return linear(pooled, model.text_projection, None,
                      mx_specs=mx_specs)


def preprocess_images(images: np.ndarray, cfg: ClipConfig,
                      device="cuda") -> torch.Tensor:
    """(N, H, W, 3) uint8 -> (N, 3, 224, 224) f32 normalized pixels on
    ``device`` (CLIPProcessor: bicubic resize of the short side to 224 with
    ``ops.resize`` (Keys a = -0.5, antialiased when downscaling, as JAX),
    centre crop, rescale by 1/255, normalize)."""
    device = resolve_device(device)
    n, h, w, _ = images.shape
    size = cfg.image_size
    if h <= w:
        nh, nw = size, max(size, int(round(w * size / h)))
    else:
        nh, nw = max(size, int(round(h * size / w))), size
    x = torch.from_numpy(np.ascontiguousarray(images)).to(device)
    x = resize(x.to(torch.float32) / 255.0, (n, nh, nw, 3), "bicubic")
    top, left = (nh - size) // 2, (nw - size) // 2
    x = x[:, top:top + size, left:left + size]
    mean = torch.from_numpy(IMAGE_MEAN).to(device)
    std = torch.from_numpy(IMAGE_STD).to(device)
    return ((x - mean) / std).permute(0, 3, 1, 2).contiguous()


# ----------------------------------------------------------------------
def init_clip(cfg: ClipConfig, generator: torch.Generator,
              device="cuda") -> Clip:
    """JAX's ``init_clip`` distributions: normal(0.02) weights and
    embeddings, zero biases, LN weights one.  Draws come from ``generator``
    on its own device."""
    model = Clip(cfg, device)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            owner = name.rsplit(".", 1)[0]
            if name.endswith("bias") or owner.endswith(("ln", "ln1", "ln2")):
                continue
            prm.copy_(0.02 * torch.randn(tuple(prm.shape),
                                         generator=generator,
                                         device=generator.device))
    return model


def clip_checkpoint_names(cfg: ClipConfig) -> Dict[str, str]:
    """Each parameter name of ``Clip(cfg)`` -> its key in a transformers
    CLIPModel state dict (clip-vit-large-patch14 naming)."""
    names = {
        "vision.patch_embedding":
            "vision_model.embeddings.patch_embedding.weight",
        "vision.class_embedding": "vision_model.embeddings.class_embedding",
        "vision.position_embedding":
            "vision_model.embeddings.position_embedding.weight",
        "text.token_embedding":
            "text_model.embeddings.token_embedding.weight",
        "text.position_embedding":
            "text_model.embeddings.position_embedding.weight",
        "visual_projection": "visual_projection.weight",
        "text_projection": "text_projection.weight",
    }
    for ours, theirs in (("vision.pre_ln", "vision_model.pre_layrnorm"),
                         ("vision.post_ln", "vision_model.post_layernorm"),
                         ("text.final_ln", "text_model.final_layer_norm")):
        for leaf in ("weight", "bias"):
            names[f"{ours}.{leaf}"] = f"{theirs}.{leaf}"
    layer = (("ln1", "layer_norm1"), ("q", "self_attn.q_proj"),
             ("k", "self_attn.k_proj"), ("v", "self_attn.v_proj"),
             ("out", "self_attn.out_proj"), ("ln2", "layer_norm2"),
             ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2"))
    for tower, model, n in (("vision", "vision_model", cfg.v_layers),
                            ("text", "text_model", cfg.t_layers)):
        for i in range(n):
            for ours, theirs in layer:
                for leaf in ("weight", "bias"):
                    names[f"{tower}.layers.{i}.{ours}.{leaf}"] = \
                        f"{model}.encoder.layers.{i}.{theirs}.{leaf}"
    return names


def load_clip_checkpoint(path_or_sd, cfg: ClipConfig
                         ) -> Dict[str, torch.Tensor]:
    """A transformers CLIPModel state dict (a path to a torch file or
    safetensors, or an in-memory dict) as a float32 state dict in the
    port's names, for ``Clip.load_state_dict``."""
    if isinstance(path_or_sd, dict):
        sd = path_or_sd
    elif str(path_or_sd).endswith(".safetensors"):
        from safetensors.torch import load_file
        sd = load_file(path_or_sd)
    else:
        sd = torch.load(path_or_sd, map_location="cpu", weights_only=True)
        sd = sd.get("state_dict", sd)
    return {ours: torch.as_tensor(sd[theirs]).detach().to(torch.float32)
            for ours, theirs in clip_checkpoint_names(cfg).items()}


def config_from_hf(hf_config) -> ClipConfig:
    """``ClipConfig`` from a transformers CLIPConfig (any variant)."""
    t, v = hf_config.text_config, hf_config.vision_config
    return ClipConfig(
        image_size=v.image_size, patch_size=v.patch_size,
        v_hidden=v.hidden_size, v_layers=v.num_hidden_layers,
        v_heads=v.num_attention_heads, v_mlp=v.intermediate_size,
        vocab_size=t.vocab_size, max_positions=t.max_position_embeddings,
        t_hidden=t.hidden_size, t_layers=t.num_hidden_layers,
        t_heads=t.num_attention_heads, t_mlp=t.intermediate_size,
        projection_dim=hf_config.projection_dim,
        eos_token_id=t.eos_token_id)


def load_clip_from_pretrained(model_path: str, device="cuda"
                              ) -> Tuple[ClipConfig, Clip]:
    """(ClipConfig, Clip on ``device``) from a local directory or sharded
    checkpoint (local files only, never the hub): transformers reads the
    weights and the config of any CLIP variant on the CPU once, then the
    state dict converts through ``load_clip_checkpoint``.  A single file
    with a known config loads through ``load_clip_checkpoint`` directly."""
    from transformers import CLIPModel

    m = CLIPModel.from_pretrained(model_path, local_files_only=True)
    cfg = config_from_hf(m.config)
    model = Clip(cfg, device)
    model.load_state_dict(load_clip_checkpoint(dict(m.state_dict()), cfg))
    return cfg, model
