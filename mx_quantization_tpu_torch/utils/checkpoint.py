"""DiT weights into the port: from the JAX package's parameter tree, and
from the public DiT checkpoint layout (port of the DiT part of the JAX
package's ``utils/checkpoint.py``).

The port's ``DiT`` module names its parameters after the JAX tree
(``blocks.<i>.attn.qkv.weight``, ...), so both loaders produce a state dict
in those names and hand it to ``DiT.load_state_dict``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.dit import DiT, DiTConfig


def _tensor(a) -> torch.Tensor:
    # bf16 numpy arrays (ml_dtypes) have no torch counterpart: widen exactly
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def dit_params_from_jax(np_tree: dict, cfg: DiTConfig,
                        device="cuda") -> DiT:
    """The JAX package's DiT parameter tree (numpy arrays; the block
    parameters stacked along a leading depth axis) -> a ``DiT`` module."""
    model = DiT(cfg, device=device)
    sd: Dict[str, torch.Tensor] = {}
    for name in model.state_dict():
        parts = name.split(".")
        if parts[0] == "blocks":
            node, idx = np_tree["blocks"], int(parts[1])
            for key in parts[2:]:
                node = node[key]
            sd[name] = _tensor(np.asarray(node)[idx])
        else:
            node = np_tree
            for key in parts:
                node = node[key]
            sd[name] = _tensor(node)
    model.load_state_dict(sd)
    return model


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
