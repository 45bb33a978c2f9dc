"""DiT, PixArt-alpha and DeiT weights into the port: from the JAX
package's parameter trees, and from the public checkpoint layouts (the DiT
release, diffusers' PixArtTransformer2DModel, timm's VisionTransformer);
port of the JAX package's ``utils/checkpoint.py`` loaders.  The T5
encoder's, the VAE's, the Inception extractor's and CLIP's JAX trees load
here too (``*_params_from_jax``); their public checkpoints load through
their modules' ``load_*_checkpoint``.

The port's ``DiT``, ``PixArt`` and ``ViT`` modules name their parameters
after the JAX trees (``blocks.<i>.attn.qkv.weight``,
``blocks.<i>.attn1.to_q.weight``, ``patch_embed.weight``, ...), so the
loaders produce state dicts in those names and hand them to
``load_state_dict``.  DeiT's position table is loaded as it is: the JAX
loader's optional bicubic resize to another patch count is not ported
(ROADMAP.md).  ``save_params`` / ``load_params`` keep a tree of tensors
(a trainer's state dicts) as a numpy pickle, as the JAX package's do.
"""

from __future__ import annotations

import pickle
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..evaluation.inception import InceptionV3
from ..models.clip import Clip, ClipConfig
from ..models.dit import DiT, DiTConfig
from ..models.pixart import PixArt, PixArtConfig
from ..models.t5 import T5Config, T5Encoder
from ..models.vae import AutoencoderKL, VaeConfig
from ..models.vit import ViT, VitConfig


def _tensor(a) -> torch.Tensor:
    # bf16 numpy arrays (ml_dtypes) have no torch counterpart: widen exactly
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def _fill_from_jax(model: nn.Module, np_tree: dict) -> nn.Module:
    """Load a JAX parameter tree (numpy arrays in nested dicts and lists;
    DiT's, PixArt's and the ViT's block parameters stacked along a leading
    depth axis under "blocks") into ``model`` by name."""
    sd: Dict[str, torch.Tensor] = {}
    for name in model.state_dict():
        parts = name.split(".")
        node, idx = np_tree, None
        if parts[0] == "blocks" and isinstance(np_tree["blocks"], dict):
            node, idx, parts = np_tree["blocks"], int(parts[1]), parts[2:]
        for key in parts:
            node = node[int(key)] if isinstance(node, (list, tuple)) \
                else node[key]
        sd[name] = _tensor(node if idx is None else np.asarray(node)[idx])
    model.load_state_dict(sd)
    return model


def dit_params_from_jax(np_tree: dict, cfg: DiTConfig,
                        device="cuda") -> DiT:
    """The JAX package's DiT parameter tree -> a ``DiT`` module."""
    return _fill_from_jax(DiT(cfg, device=device), np_tree)


def pixart_params_from_jax(np_tree: dict, cfg: PixArtConfig,
                           device="cuda") -> PixArt:
    """The JAX package's PixArt parameter tree -> a ``PixArt`` module (the
    position table is the module's own, computed from ``cfg``)."""
    return _fill_from_jax(PixArt(cfg, device=device), np_tree)


def vit_params_from_jax(np_tree: dict, cfg: VitConfig,
                        device="cuda") -> ViT:
    """The JAX package's ViT parameter tree -> a ``ViT`` module."""
    return _fill_from_jax(ViT(cfg, device=device), np_tree)


def t5_params_from_jax(np_tree: dict, cfg: T5Config,
                       device="cuda") -> T5Encoder:
    """The JAX package's T5 encoder tree -> a ``T5Encoder`` module."""
    return _fill_from_jax(T5Encoder(cfg, device=device), np_tree)


def vae_params_from_jax(np_tree: dict, cfg: VaeConfig = VaeConfig(),
                        device="cuda") -> AutoencoderKL:
    """The JAX package's VAE tree -> an ``AutoencoderKL`` module."""
    return _fill_from_jax(AutoencoderKL(cfg, device=device), np_tree)


def inception_params_from_jax(np_tree: dict, device="cuda") -> InceptionV3:
    """The JAX package's Inception tree (batch norms folded) -> an
    ``InceptionV3`` module."""
    return _fill_from_jax(InceptionV3(device=device), np_tree)


def clip_params_from_jax(np_tree: dict, cfg: ClipConfig,
                         device="cuda") -> Clip:
    """The JAX package's CLIP tree -> a ``Clip`` module."""
    return _fill_from_jax(Clip(cfg, device=device), np_tree)


def load_dit_checkpoint(path: str, depth: int = 28) -> Dict[str, torch.Tensor]:
    """Read a public DiT checkpoint (a train-state dict with an 'ema' or
    'model' entry, or a bare state dict) with ``torch.load`` and return a
    state dict in the port's names, for ``DiT.load_state_dict``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("ema", ckpt.get("model", ckpt))
    out = {
        "x_embedder.weight": sd["x_embedder.proj.weight"],
        "x_embedder.bias": sd["x_embedder.proj.bias"],
        "pos_embed": sd["pos_embed"],
        "t_embedder.mlp0.weight": sd["t_embedder.mlp.0.weight"],
        "t_embedder.mlp0.bias": sd["t_embedder.mlp.0.bias"],
        "t_embedder.mlp2.weight": sd["t_embedder.mlp.2.weight"],
        "t_embedder.mlp2.bias": sd["t_embedder.mlp.2.bias"],
        "y_embedder.table": sd["y_embedder.embedding_table.weight"],
        "final_layer.adaLN.weight":
            sd["final_layer.adaLN_modulation.1.weight"],
        "final_layer.adaLN.bias": sd["final_layer.adaLN_modulation.1.bias"],
        "final_layer.linear.weight": sd["final_layer.linear.weight"],
        "final_layer.linear.bias": sd["final_layer.linear.bias"],
    }
    names = {"attn.qkv": "attn.qkv", "attn.proj": "attn.proj",
             "mlp.fc1": "mlp.fc1", "mlp.fc2": "mlp.fc2",
             "adaLN": "adaLN_modulation.1"}
    for i in range(depth):
        for ours, theirs in names.items():
            for leaf in ("weight", "bias"):
                out[f"blocks.{i}.{ours}.{leaf}"] = \
                    sd[f"blocks.{i}.{theirs}.{leaf}"]
    return {k: v.detach().to(torch.float32) for k, v in out.items()}


def load_pixart_checkpoint(path: str, num_layers: int = 28
                           ) -> Dict[str, torch.Tensor]:
    """Read a diffusers PixArtTransformer2DModel state dict (the
    PixArt-alpha 256/512/1024 safetensors or a torch file) and return a
    state dict in the port's names, for ``PixArt.load_state_dict``.  The
    1024^2 model's micro-conditioning embedders map where the file has
    them."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file
        sd = load_file(path)
    else:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        sd = ckpt.get("state_dict", ckpt)
    names = {
        "pos_embed.proj": "pos_embed.proj",
        "adaln_single.emb_mlp0": "adaln_single.emb.timestep_embedder.linear_1",
        "adaln_single.emb_mlp2": "adaln_single.emb.timestep_embedder.linear_2",
        "adaln_single.linear": "adaln_single.linear",
        "caption_projection.linear_1": "caption_projection.linear_1",
        "caption_projection.linear_2": "caption_projection.linear_2",
        "proj_out": "proj_out",
    }
    if "adaln_single.emb.resolution_embedder.linear_1.weight" in sd:
        for ours, theirs in (("res", "resolution"), ("ar", "aspect_ratio")):
            for i in (1, 2):
                names[f"adaln_single.{ours}_mlp{2 * i - 2}"] = \
                    f"adaln_single.emb.{theirs}_embedder.linear_{i}"
    for i in range(num_layers):
        for attn in ("attn1", "attn2"):
            for lin in ("to_q", "to_k", "to_v"):
                names[f"blocks.{i}.{attn}.{lin}"] = \
                    f"transformer_blocks.{i}.{attn}.{lin}"
            names[f"blocks.{i}.{attn}.to_out"] = \
                f"transformer_blocks.{i}.{attn}.to_out.0"
        names[f"blocks.{i}.ff.fc1"] = f"transformer_blocks.{i}.ff.net.0.proj"
        names[f"blocks.{i}.ff.fc2"] = f"transformer_blocks.{i}.ff.net.2"
    out = {"scale_shift_table": sd["scale_shift_table"]}
    for i in range(num_layers):
        out[f"blocks.{i}.scale_shift_table"] = \
            sd[f"transformer_blocks.{i}.scale_shift_table"]
    for ours, theirs in names.items():
        w = sd[f"{theirs}.weight"]
        out[f"{ours}.weight"] = w
        # a linear without a bias adds zero
        out[f"{ours}.bias"] = sd.get(f"{theirs}.bias",
                                     torch.zeros(w.shape[0]))
    return {k: v.detach().to(torch.float32) for k, v in out.items()}


def load_deit_checkpoint(path: str, depth: int = 12,
                         interpolate_pos_embed_to: Optional[int] = None
                         ) -> Dict[str, torch.Tensor]:
    """Read a public DeiT checkpoint (timm VisionTransformer state dict,
    under a 'model' entry or bare) with ``torch.load`` and return a state
    dict in the port's names, for ``ViT.load_state_dict``.
    ``interpolate_pos_embed_to``: a new number of patches, to which the
    position table's patch grid is resized (``interpolate_pos_embed``; the
    reference's main.py:617-630, for another resolution)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt)
    out = {"patch_embed.weight": sd["patch_embed.proj.weight"],
           "patch_embed.bias": sd["patch_embed.proj.bias"]}
    for name in ("cls_token", "pos_embed", "norm.weight", "norm.bias",
                 "head.weight", "head.bias"):
        out[name] = sd[name]
    for i in range(depth):
        for mod in ("norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1",
                    "mlp.fc2"):
            for leaf in ("weight", "bias"):
                key = f"blocks.{i}.{mod}.{leaf}"
                out[key] = sd[key]
    out = {k: v.detach().to(torch.float32) for k, v in out.items()}
    if interpolate_pos_embed_to is not None:
        out["pos_embed"] = interpolate_pos_embed(out["pos_embed"],
                                                 interpolate_pos_embed_to)
    return out


def interpolate_pos_embed(pos_embed: torch.Tensor, new_num_patches: int
                          ) -> torch.Tensor:
    """A (1, 1 + N, D) position table with its patch grid (sqrt N)^2
    resized bicubically to (sqrt new_num_patches)^2, the class token's row
    passed through (the JAX package's ``interpolate_pos_embed``: its
    ``jax.image.resize`` bicubic, Keys' a = -0.5, through ``ops/resize.py``;
    ``F.interpolate``'s bicubic is a = -0.75)."""
    from ..ops.resize import resize
    extra, grid = pos_embed[:, :1], pos_embed[:, 1:]
    s_old = int(grid.shape[1] ** 0.5)
    s_new = int(new_num_patches ** 0.5)
    g = grid.reshape(1, s_old, s_old, -1)
    g = resize(g, (1, s_new, s_new, g.shape[-1]), "bicubic")
    return torch.cat([extra, g.reshape(1, s_new * s_new, -1)], dim=1)


def _to_numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def save_params(path: str, params) -> None:
    """Write a tree of tensors (nested dicts, lists and tuples) to ``path``
    as a pickle of numpy arrays (the JAX package's ``save_params``)."""
    with open(path, "wb") as f:
        pickle.dump(_to_numpy(params), f)


def load_params(path: str):
    """Read back what ``save_params`` wrote: the tree with numpy arrays.
    Unpickling runs code from the file, so load only files this program
    wrote."""
    with open(path, "rb") as f:
        return pickle.load(f)
