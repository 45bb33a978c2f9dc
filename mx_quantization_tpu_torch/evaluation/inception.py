"""InceptionV3, the FID variant (port of the JAX package's
``evaluation/inception.py``): the pt_inception-2015-12-05 network whose
pool_3 and spatial activations the ADM evaluator's TF graph computes.  It
loads the public pt_inception torch state dict
(pt_inception-2015-12-05-6726825d.pth) from a local path; nothing is
downloaded.

Outputs of ``inception_features``:
  pool3   (N, 2048)  the FID features
  spatial (N, 2023)  the first 7 channels of the Mixed_6e map, flattened
                     over its 17 x 17 positions (channels last): the ADM
                     "spatial" features for sFID
  pred    (N, 1008)  softmax of the logits, for the Inception Score

Each conv + batch norm + ReLU keeps the conv weight and the batch norm
folded into a scale and a bias at load time (eps 1e-3).  Convs are
``F.conv2d``, pools ``F.max_pool2d`` / ``F.avg_pool2d`` (padding not
counted in the 3x3 averages, a max pool in Mixed_7c's pool branch).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.resize import resize

# (name, in, out, kernel (h, w), stride, padding (h, w)) of each conv + BN
_STEM = (("Conv2d_1a_3x3", 3, 32, (3, 3), 2, (0, 0)),
         ("Conv2d_2a_3x3", 32, 32, (3, 3), 1, (0, 0)),
         ("Conv2d_2b_3x3", 32, 64, (3, 3), 1, (1, 1)),
         ("Conv2d_3b_1x1", 64, 80, (1, 1), 1, (0, 0)),
         ("Conv2d_4a_3x3", 80, 192, (3, 3), 1, (0, 0)))


def _block_a(cin, pool):
    return (("branch1x1", cin, 64, (1, 1), 1, (0, 0)),
            ("branch5x5_1", cin, 48, (1, 1), 1, (0, 0)),
            ("branch5x5_2", 48, 64, (5, 5), 1, (2, 2)),
            ("branch3x3dbl_1", cin, 64, (1, 1), 1, (0, 0)),
            ("branch3x3dbl_2", 64, 96, (3, 3), 1, (1, 1)),
            ("branch3x3dbl_3", 96, 96, (3, 3), 1, (1, 1)),
            ("branch_pool", cin, pool, (1, 1), 1, (0, 0)))


def _block_c(c7):
    return (("branch1x1", 768, 192, (1, 1), 1, (0, 0)),
            ("branch7x7_1", 768, c7, (1, 1), 1, (0, 0)),
            ("branch7x7_2", c7, c7, (1, 7), 1, (0, 3)),
            ("branch7x7_3", c7, 192, (7, 1), 1, (3, 0)),
            ("branch7x7dbl_1", 768, c7, (1, 1), 1, (0, 0)),
            ("branch7x7dbl_2", c7, c7, (7, 1), 1, (3, 0)),
            ("branch7x7dbl_3", c7, c7, (1, 7), 1, (0, 3)),
            ("branch7x7dbl_4", c7, c7, (7, 1), 1, (3, 0)),
            ("branch7x7dbl_5", c7, 192, (1, 7), 1, (0, 3)),
            ("branch_pool", 768, 192, (1, 1), 1, (0, 0)))


def _block_e(cin):
    return (("branch1x1", cin, 320, (1, 1), 1, (0, 0)),
            ("branch3x3_1", cin, 384, (1, 1), 1, (0, 0)),
            ("branch3x3_2a", 384, 384, (1, 3), 1, (0, 1)),
            ("branch3x3_2b", 384, 384, (3, 1), 1, (1, 0)),
            ("branch3x3dbl_1", cin, 448, (1, 1), 1, (0, 0)),
            ("branch3x3dbl_2", 448, 384, (3, 3), 1, (1, 1)),
            ("branch3x3dbl_3a", 384, 384, (1, 3), 1, (0, 1)),
            ("branch3x3dbl_3b", 384, 384, (3, 1), 1, (1, 0)),
            ("branch_pool", cin, 192, (1, 1), 1, (0, 0)))


BLOCKS = (
    ("Mixed_5b", _block_a(192, 32)), ("Mixed_5c", _block_a(256, 64)),
    ("Mixed_5d", _block_a(288, 64)),
    ("Mixed_6a", (("branch3x3", 288, 384, (3, 3), 2, (0, 0)),
                  ("branch3x3dbl_1", 288, 64, (1, 1), 1, (0, 0)),
                  ("branch3x3dbl_2", 64, 96, (3, 3), 1, (1, 1)),
                  ("branch3x3dbl_3", 96, 96, (3, 3), 2, (0, 0)))),
    ("Mixed_6b", _block_c(128)), ("Mixed_6c", _block_c(160)),
    ("Mixed_6d", _block_c(160)), ("Mixed_6e", _block_c(192)),
    ("Mixed_7a", (("branch3x3_1", 768, 192, (1, 1), 1, (0, 0)),
                  ("branch3x3_2", 192, 320, (3, 3), 2, (0, 0)),
                  ("branch7x7x3_1", 768, 192, (1, 1), 1, (0, 0)),
                  ("branch7x7x3_2", 192, 192, (1, 7), 1, (0, 3)),
                  ("branch7x7x3_3", 192, 192, (7, 1), 1, (3, 0)),
                  ("branch7x7x3_4", 192, 192, (3, 3), 2, (0, 0)))),
    ("Mixed_7b", _block_e(1280)), ("Mixed_7c", _block_e(2048)))
NUM_CLASSES = 1008


class ConvBN(nn.Module):
    """A conv's weight ``w`` and its batch norm folded into ``scale`` and
    ``bias``; its stride and padding."""

    def __init__(self, cin, cout, kernel, stride, padding, device):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.w = nn.Parameter(torch.zeros(cout, cin, *kernel, device=device),
                              requires_grad=False)
        self.scale = nn.Parameter(torch.ones(cout, device=device),
                                  requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout, device=device),
                                 requires_grad=False)

    def forward(self, x):
        x = F.conv2d(x, self.w, stride=self.stride, padding=self.padding)
        return F.relu(x * self.scale.reshape(1, -1, 1, 1)
                      + self.bias.reshape(1, -1, 1, 1))


class InceptionV3(nn.Module):
    """The FID Inception's parameters, named after the JAX tree
    (``Conv2d_1a_3x3.w``, ``Mixed_5b.branch1x1.scale``, ``fc.w``, ...).
    ``load_inception_checkpoint`` fills them."""

    def __init__(self, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        for name, *spec in _STEM:
            setattr(self, name, ConvBN(*spec, device))
        for block, convs in BLOCKS:
            mod = nn.Module()
            for name, *spec in convs:
                setattr(mod, name, ConvBN(*spec, device))
            setattr(self, block, mod)
        self.fc = nn.Module()
        self.fc.w = nn.Parameter(torch.zeros(NUM_CLASSES, 2048,
                                             device=device),
                                 requires_grad=False)
        self.fc.b = nn.Parameter(torch.zeros(NUM_CLASSES, device=device),
                                 requires_grad=False)


def _maxpool(x, k=3, s=2):
    return F.max_pool2d(x, k, s)


def _avgpool(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _inception_a(x, p):
    b1 = p.branch1x1(x)
    b5 = p.branch5x5_2(p.branch5x5_1(x))
    b3 = p.branch3x3dbl_3(p.branch3x3dbl_2(p.branch3x3dbl_1(x)))
    return torch.cat([b1, b5, b3, p.branch_pool(_avgpool(x))], dim=1)


def _inception_b(x, p):
    b3 = p.branch3x3(x)
    bd = p.branch3x3dbl_3(p.branch3x3dbl_2(p.branch3x3dbl_1(x)))
    return torch.cat([b3, bd, _maxpool(x)], dim=1)


def _inception_c(x, p):
    b1 = p.branch1x1(x)
    b7 = p.branch7x7_3(p.branch7x7_2(p.branch7x7_1(x)))
    bd = x
    for i in range(1, 6):
        bd = getattr(p, f"branch7x7dbl_{i}")(bd)
    return torch.cat([b1, b7, bd, p.branch_pool(_avgpool(x))], dim=1)


def _inception_d(x, p):
    b3 = p.branch3x3_2(p.branch3x3_1(x))
    b7 = x
    for i in range(1, 5):
        b7 = getattr(p, f"branch7x7x3_{i}")(b7)
    return torch.cat([b3, b7, _maxpool(x)], dim=1)


def _inception_e(x, p, pool):
    b1 = p.branch1x1(x)
    b3 = p.branch3x3_1(x)
    b3 = torch.cat([p.branch3x3_2a(b3), p.branch3x3_2b(b3)], dim=1)
    bd = p.branch3x3dbl_2(p.branch3x3dbl_1(x))
    bd = torch.cat([p.branch3x3dbl_3a(bd), p.branch3x3dbl_3b(bd)], dim=1)
    # the FID variant max-pools in the last block's pool branch
    bp = _avgpool(x) if pool == "avg" else F.max_pool2d(x, 3, 1, 1)
    return torch.cat([b1, b3, bd, p.branch_pool(bp)], dim=1)


def inception_features(model: InceptionV3, images: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, 3, 299, 299) images in [0, 1] -> (pool3, spatial, pred)."""
    with torch.inference_mode():
        x = images.to(model.fc.w.device, torch.float32) * 2.0 - 1.0
        x = model.Conv2d_2b_3x3(model.Conv2d_2a_3x3(model.Conv2d_1a_3x3(x)))
        x = _maxpool(x)
        x = _maxpool(model.Conv2d_4a_3x3(model.Conv2d_3b_1x1(x)))
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            x = _inception_a(x, getattr(model, name))
        x = _inception_b(x, model.Mixed_6a)
        for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = _inception_c(x, getattr(model, name))
        sp = x[:, :7]
        spatial = sp.permute(0, 2, 3, 1).reshape(sp.shape[0], -1)
        x = _inception_d(x, model.Mixed_7a)
        x = _inception_e(x, model.Mixed_7b, "avg")
        x = _inception_e(x, model.Mixed_7c, "max")
        pool3 = x.mean(dim=(2, 3))
        logits = pool3 @ model.fc.w.t() + model.fc.b
        return pool3, spatial, torch.softmax(logits, dim=-1)


def inception_checkpoint_names():
    """Each conv + BN's name in the port (``Mixed_5b.branch1x1``, ...),
    which is also its prefix in the pt_inception state dict
    (``<prefix>.conv.weight``, ``<prefix>.bn.{weight, bias, running_mean,
    running_var}``)."""
    names = [name for name, *_ in _STEM]
    for block, convs in BLOCKS:
        names += [f"{block}.{name}" for name, *_ in convs]
    return names


def load_inception_checkpoint(path_or_sd, eps: float = 1e-3
                              ) -> Dict[str, torch.Tensor]:
    """The pt_inception torch state dict (a path or an in-memory dict) as a
    float32 state dict in the port's names, each batch norm folded into its
    conv's scale and bias (inference only), as JAX's loader folds it (in
    float32: scale = gamma / sqrt(var + eps), bias = beta - mean * scale)."""
    sd = path_or_sd if isinstance(path_or_sd, dict) else torch.load(
        path_or_sd, map_location="cpu", weights_only=True)

    def t2n(k):
        return sd[k].detach().cpu().numpy().astype(np.float32)

    out = {}
    for pre in inception_checkpoint_names():
        scale = t2n(pre + ".bn.weight") / np.sqrt(
            t2n(pre + ".bn.running_var") + eps)
        out[pre + ".w"] = t2n(pre + ".conv.weight")
        out[pre + ".scale"] = scale
        out[pre + ".bias"] = t2n(pre + ".bn.bias") - t2n(
            pre + ".bn.running_mean") * scale
    out["fc.w"], out["fc.b"] = t2n("fc.weight"), t2n("fc.bias")
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in out.items()}


def extract_features_batched(model: InceptionV3, images_u8: np.ndarray,
                             batch: int = 64) -> Dict[str, np.ndarray]:
    """(N, H, W, 3) uint8 -> {"pool3", "spatial", "pred"} feature arrays on
    the host.  Each batch goes to the model's device, is scaled to [0, 1]
    and resized to 299 x 299 bilinearly (``ops.resize``: antialiased when
    downscaling, as ``jax.image.resize``)."""
    dev = model.fc.w.device
    pools, spatials, preds = [], [], []
    for i in range(0, len(images_u8), batch):
        chunk = torch.from_numpy(np.ascontiguousarray(
            images_u8[i:i + batch])).to(dev)
        chunk = (chunk.to(torch.float32) / 255.0).permute(0, 3, 1, 2)
        x = resize(chunk, (chunk.shape[0], 3, 299, 299), "bilinear")
        p3, sp, pr = inception_features(model, x)
        pools.append(p3.cpu().numpy())
        spatials.append(sp.cpu().numpy())
        preds.append(pr.cpu().numpy())
    return {"pool3": np.concatenate(pools),
            "spatial": np.concatenate(spatials),
            "pred": np.concatenate(preds)}
