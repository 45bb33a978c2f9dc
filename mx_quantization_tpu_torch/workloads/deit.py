"""DeiT ImageNet evaluation (port of the JAX package's ``workloads/deit.py``:
``default_mx_specs``, ``accuracy_counts``, ``evaluate``,
``imagenet_val_batches`` and the CLI).

Run (random weights unless --checkpoint names a DeiT checkpoint; one
synthetic batch unless --data-path names an ImageNet validation folder):
    python -m mx_quantization_tpu_torch.workloads.deit \
        --model deit_tiny_patch16_224 --checkpoint deit_tiny.pth \
        --data-path /data/imagenet/val --mx-quant --top-k --k 80
``--engine ref`` runs the emulation engine (plain torch, the parity
oracle) and ``--sparse-impl gather`` the gathered top-k attention, as in
JAX.  ``--anal`` (the analysis records) has no counterpart in the port yet
and raises, naming ROADMAP.md.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.vit import (VIT_CONFIGS, ViT, VitQuantConfig, init_vit,
                          vit_forward)
from ..predictors.elsa import orthogonal_matrix as structured_matrix
from ..specs import MxSpecs, finalize_mx_specs


def default_mx_specs(custom_tpu: str = "fused") -> MxSpecs:
    """The DeiT workload's exact specs (reference deit main.py:716-736):
    MXINT8 weights and activations, scale 8, block 32, bfloat=32 (the
    identity on f32 activations), no subnormal flush, inference only."""
    return finalize_mx_specs(dict(
        w_elem_format="int8", a_elem_format="int8", scale_bits=8,
        shared_exp_method="max", block_size=32, bfloat=32, fp=0,
        round="nearest", mx_flush_fp32_subnorms=False,
        quantize_backprop=False, custom_tpu=custom_tpu))


def accuracy_counts(logits: torch.Tensor, labels: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(top1_correct, top5_correct) counts of a batch, on its device."""
    top5 = torch.topk(logits, 5, dim=-1).indices
    c1 = (top5[:, 0] == labels).sum()
    c5 = (top5 == labels[:, None]).any(dim=1).sum()
    return c1, c5


def evaluate(model: ViT, qcfg: VitQuantConfig,
             batches: Iterable[Tuple[object, object]],
             orthogonal_matrix=None, log_every: int = 20,
             device="cuda") -> dict:
    """Top-1/top-5 over an iterable of (images (B, 3, H, W) float32,
    labels (B,) int), numpy arrays or tensors.  The counters accumulate on
    the device; the host reads them only at the log points and at the
    end, so the batches queue without a round trip each."""
    device = resolve_device(device)
    if next(model.parameters()).device.type != device.type:
        raise ValueError(f"the model is not on {device}")
    n = 0
    c1 = torch.zeros((), dtype=torch.int64, device=device)
    c5 = torch.zeros((), dtype=torch.int64, device=device)
    t0 = time.perf_counter()
    with torch.inference_mode():
        for i, (x, y) in enumerate(batches):
            x = torch.as_tensor(x).to(device, torch.float32)
            y = torch.as_tensor(y).to(device, torch.int64)
            b1, b5 = accuracy_counts(
                vit_forward(model, x, qcfg, orthogonal_matrix), y)
            c1 += b1
            c5 += b5
            n += len(y)
            if log_every and (i + 1) % log_every == 0:
                print(f"[{i + 1}] acc@1 {int(c1) / n:.4f} acc@5 "
                      f"{int(c5) / n:.4f} "
                      f"({n / (time.perf_counter() - t0):.1f} img/s)")
    return {"acc1": int(c1) / max(n, 1), "acc5": int(c5) / max(n, 1),
            "n": n}


def imagenet_val_batches(data_path: str, batch_size: int = 100,
                         img_size: int = 224, limit: Optional[int] = None):
    """Yield (images, labels) from an ImageNet-style folder tree
    (val/<wnid>/*.JPEG), decoded with PIL (the reference's bicubic eval
    transform; the native loader is not ported)."""
    from ..data.imagenet import iterate_imagenet
    yield from iterate_imagenet(data_path, batch_size, img_size, limit=limit,
                                native=False)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("DeiT MX evaluation (PyTorch port)")
    p.add_argument("--model", default="deit_tiny_patch16_224",
                   choices=sorted(VIT_CONFIGS))
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--data-path", default=None)
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--mx-quant", action="store_true")
    p.add_argument("--top-k", action="store_true")
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--no-approx", action="store_true",
                   help="top-k from true scores (approx_flag=False)")
    p.add_argument("--pred-mode", default="ex_pred")
    p.add_argument("--exclude-blocks", type=int, nargs="*", default=[])
    p.add_argument("--exclude-block-type", default="ex_pred")
    p.add_argument("--engine", default="fused", choices=["fused", "ref"])
    p.add_argument("--contract", default="exact",
                   choices=["exact", "serving"],
                   help="serving = relaxed fused-kernel attention tier")
    p.add_argument("--anal", action="store_true",
                   help="per-block predictor-quality records (not ported)")
    p.add_argument("--anal-dir", default="analysis_out")
    p.add_argument("--sparse-impl", default="dense",
                   choices=["dense", "gather"])
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.anal:
        raise NotImplementedError(
            "--anal has no counterpart in the port yet (ROADMAP.md)")
    device = resolve_device(args.device)
    cfg = VIT_CONFIGS[args.model]
    specs = default_mx_specs(args.engine) if args.mx_quant else None
    qcfg = VitQuantConfig(
        mx_specs=specs, mx_quant=args.mx_quant, top_k=args.top_k, k=args.k,
        approx_flag=not args.no_approx, pred_mode=args.pred_mode,
        exclude_blocks=tuple(args.exclude_blocks),
        exclude_block_type=args.exclude_block_type,
        sparse_impl=args.sparse_impl, contract=args.contract)

    if args.checkpoint:
        from ..utils.checkpoint import load_deit_checkpoint
        model = ViT(cfg, device=device)
        model.load_state_dict(load_deit_checkpoint(args.checkpoint,
                                                   depth=cfg.depth))
    else:
        print("WARNING: no checkpoint — random init (smoke test only)")
        model = init_vit(cfg, torch.Generator().manual_seed(0), device)

    om = None
    if args.pred_mode == "ELSA":
        om = structured_matrix(cfg.head_dim, device)

    if args.data_path:
        batches = imagenet_val_batches(args.data_path, args.batch_size,
                                       cfg.img_size, args.limit)
    else:
        print("WARNING: no --data-path — synthetic batch (smoke test only)")
        rng = np.random.RandomState(0)
        batches = iter([(rng.randn(args.batch_size, 3, cfg.img_size,
                                   cfg.img_size).astype(np.float32),
                         rng.randint(0, cfg.num_classes, args.batch_size))])

    stats = evaluate(model, qcfg, batches, om, device=device)
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
