"""One-command accuracy measurement at the reference protocols (port of the
JAX package's ``workloads/accuracy.py``).  Each subcommand runs its
measurement end to end on the card, given the public files; without
``--ckpt`` it warns and uses random weights:

  deit   - ImageNet top-1/top-5 at the reference operating points
           (run_deit.sh:14-52: tiny k=80 ex_pred / small k=60 ex_pred /
           base k=30 two_step_leading_ones, batch 100, MXINT8) through
           ``workloads/deit.py``'s ``main``
           assets: timm DeiT checkpoint (.pth), ImageNet val folder
  dit    - FID/sFID/IS/precision/recall over N balanced-class samples
           (run_dit_metric.sh:11-26: 100 steps, cfg 1.5, k=154) through
           ``sample_for_fid``, the VAE and ``evaluation/run_eval.py``
           assets: DiT-XL-2-256x256.pt, sd-vae-ft-mse, the ADM reference
           batch npz, pt_inception weights
  pixart - FID + CLIP score over COCO-2017-val prompts
           (run_pixart_alpha.sh:31-42: 20 DPM++ steps, self_k=77,
           two_step_leading_ones, batch 100) through ``sample_pixart``,
           the VAE, ``run_eval`` and the port's CLIP towers
           assets: PixArt-alpha checkpoint, VAE, T5 embeds (an npz from
           ``encode_prompts_t5``), COCO reference npz, pt_inception
           weights, a local CLIP-ViT-L/14 folder

Examples:
    python -m mx_quantization_tpu_torch.workloads.accuracy dit \\
        --ckpt DiT-XL-2-256x256.pt --vae sd-vae-ft-mse.pt \\
        --ref VIRTUAL_imagenet256_labeled.npz --inception pt_inception.pth \\
        --num-samples 10000 --k 154
    python -m mx_quantization_tpu_torch.workloads.accuracy pixart \\
        --ckpt pixart_alpha_256.safetensors --vae sd-vae-ft-ema.pt \\
        --prompt-embeds coco5k_t5.npz --ref coco256_ref.npz \\
        --inception pt_inception.pth --clip clip-vit-large-patch14

Every subcommand prints one JSON line with its metrics.  ``--device``
(the card by default, ``cpu`` on request) is the port's addition to JAX's
options; ``--clip-backend`` names the port's towers "port" and
transformers' CPU path "transformers" (JAX's "jax" and "torch").
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..device import resolve_device


def _decode_to_images(latents: np.ndarray, vae_path, batch: int,
                      device) -> np.ndarray:
    """Latents -> (N, H, W, 3) uint8 images: through the VAE from
    ``vae_path`` in batches, or, without one, the latents themselves as
    previews (JAX's behaviour, with a warning)."""
    from ..evaluation.npz_io import latents_to_images
    if not vae_path:
        print("# WARNING: no --vae; FID over raw latent previews", flush=True)
        return latents_to_images(latents)
    from ..models.vae import (AutoencoderKL, decode_latents,
                              load_vae_checkpoint)
    vae = AutoencoderKL(device=device)
    vae.load_state_dict(load_vae_checkpoint(vae_path))
    imgs = [latents_to_images(decode_latents(
        vae, torch.from_numpy(latents[i:i + batch])).cpu().numpy())
        for i in range(0, len(latents), batch)]
    return np.concatenate(imgs)


def _run_eval(args) -> dict:
    from ..evaluation.run_eval import main as eval_main
    ev = ["--ref", args.ref, "--gen", args.out, "--device", args.device]
    if args.inception:
        ev += ["--inception", args.inception]
    return eval_main(ev)


# ----------------------------------------------------------------------
def run_deit(args) -> dict:
    from .deit import main as deit_main
    # DeiT's evaluation CLI prints and returns the accuracy dict; without
    # --data it evaluates a synthetic batch (a smoke test)
    argv = ["--model", args.model, "--batch-size", str(args.batch),
            "--engine", args.engine, "--device", args.device]
    if args.data:
        argv += ["--data-path", args.data]
    if args.ckpt:
        argv += ["--checkpoint", args.ckpt]
    if args.k > 0:
        argv += ["--mx-quant", "--top-k", "--k", str(args.k),
                 "--pred-mode", args.pred_mode]
    elif args.mx_quant:
        argv += ["--mx-quant"]
    if args.limit:
        argv += ["--limit", str(args.limit)]
    return deit_main(argv)


# ----------------------------------------------------------------------
def run_dit(args) -> dict:
    from ..models.dit import DiT, DiT_models, DiTQuantConfig, init_dit
    from ..predictors.elsa import orthogonal_matrix
    from .dit import dit_mx_specs, sample_for_fid

    device = resolve_device(args.device)
    cfg = DiT_models[args.model](input_size=args.image_size // 8)
    qcfg = DiTQuantConfig(
        mx_specs=dit_mx_specs(args.engine) if args.mx_quant else None,
        mx_quant=args.mx_quant, top_k=args.k > 0, k=max(args.k, 1),
        ex_pred=args.k > 0, pred_mode=args.pred_mode,
        exclude_blocks=(cfg.depth - 1,))   # the reference excludes the last
    if args.ckpt:
        from ..utils.checkpoint import load_dit_checkpoint
        model = DiT(cfg, device=device)
        model.load_state_dict(load_dit_checkpoint(args.ckpt, cfg.depth))
    else:
        print("# WARNING: random weights (smoke test)", flush=True)
        model = init_dit(cfg, torch.Generator().manual_seed(0), device)
    om = (orthogonal_matrix(cfg.head_dim, device)
          if args.pred_mode == "ELSA" else None)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    lat = sample_for_fid(model, qcfg, args.num_samples, args.batch, gen,
                         rank=args.rank, world=args.world,
                         num_steps=args.num_steps, cfg_scale=args.cfg_scale,
                         orthogonal_matrix=om, start_index=args.start_index,
                         device=device)
    imgs = _decode_to_images(lat, args.vae, args.batch, device)
    np.savez(args.out, arr_0=imgs)
    if not args.ref:
        return {"samples": int(len(imgs)), "npz": args.out,
                "note": "no --ref npz: samples written, FID skipped"}
    return _run_eval(args)


# ----------------------------------------------------------------------
def run_pixart(args) -> dict:
    from ..models.pixart import (PixArt, PixArtConfig, PixArtQuantConfig,
                                 init_pixart)
    from .pixart import pixart_mx_specs, sample_pixart

    device = resolve_device(args.device)
    cfg = PixArtConfig(sample_size=args.image_size // 8)
    qcfg = PixArtQuantConfig(
        mx_specs=pixart_mx_specs(args.engine) if args.mx_quant else None,
        mx_quant=args.mx_quant, self_top_k=args.self_k > 0,
        self_k=max(args.self_k, 1), cross_top_k=args.cross_k > 0,
        cross_k=max(args.cross_k, 1), ex_pred=True,
        pred_mode=args.pred_mode, exclude_blocks=(cfg.num_layers - 1,))
    if args.ckpt:
        from ..utils.checkpoint import load_pixart_checkpoint
        model = PixArt(cfg, device=device)
        model.load_state_dict(load_pixart_checkpoint(args.ckpt,
                                                     cfg.num_layers))
    else:
        print("# WARNING: random weights (smoke test)", flush=True)
        model = init_pixart(cfg, torch.Generator().manual_seed(0), device)

    z = np.load(args.prompt_embeds)
    embeds, mask = z["embeds"], z["mask"]
    null = z["null_embeds"] if "null_embeds" in z else \
        np.zeros_like(embeds[:1])
    prompts = [str(s) for s in z["prompts"]] if "prompts" in z else None
    n = len(embeds) if args.limit is None else min(args.limit, len(embeds))

    gen = torch.Generator(device=device).manual_seed(args.seed)
    lat = [sample_pixart(model, qcfg,
                         torch.from_numpy(embeds[i:min(i + args.batch, n)]),
                         torch.from_numpy(mask[i:min(i + args.batch, n)]),
                         torch.from_numpy(null), gen,
                         num_steps=args.num_steps,
                         guidance_scale=args.cfg_scale,
                         device=device).cpu().numpy()
           for i in range(0, n, args.batch)]
    imgs = _decode_to_images(np.concatenate(lat), args.vae, args.batch,
                             device)
    np.savez(args.out, arr_0=imgs)

    out = {"samples": int(len(imgs)), "npz": args.out}
    if args.ref:
        out.update(_run_eval(args))
    if args.clip and prompts:
        if args.clip_backend == "transformers":
            from ..evaluation.clip_score import clip_score_transformers
            out["clip_score"] = clip_score_transformers(imgs, prompts[:n],
                                                        args.clip)
        else:
            from ..evaluation.clip_score import clip_score_port
            out["clip_score"] = clip_score_port(imgs, prompts[:n], args.clip,
                                                device=device)
    return out


# ----------------------------------------------------------------------
def build_argparser():
    p = argparse.ArgumentParser(
        "accuracy", description="reference-protocol accuracy runner "
        "(PyTorch port)")
    sub = p.add_subparsers(dest="workload", required=True)

    d = sub.add_parser("deit")
    d.add_argument("--model", default="deit_tiny_patch16_224")
    d.add_argument("--ckpt", default=None)
    d.add_argument("--data", default=None)
    d.add_argument("--batch", type=int, default=100)
    d.add_argument("--k", type=int, default=80)
    d.add_argument("--pred-mode", default="ex_pred")
    d.add_argument("--mx-quant", action="store_true", default=True)
    d.add_argument("--limit", type=int, default=None)
    d.add_argument("--engine", default="fused")

    t = sub.add_parser("dit")
    t.add_argument("--model", default="DiT-XL/2")
    t.add_argument("--image-size", type=int, default=256)
    t.add_argument("--ckpt", default=None)
    t.add_argument("--vae", default=None)
    t.add_argument("--ref", default=None)
    t.add_argument("--inception", default=None)
    t.add_argument("--num-samples", type=int, default=1000)
    t.add_argument("--batch", type=int, default=32)
    t.add_argument("--num-steps", type=int, default=100)
    t.add_argument("--cfg-scale", type=float, default=1.5)
    t.add_argument("--k", type=int, default=154)
    t.add_argument("--pred-mode", default="ex_pred")
    t.add_argument("--mx-quant", action="store_true", default=True)
    t.add_argument("--no-mx-quant", dest="mx_quant", action="store_false")
    t.add_argument("--engine", default="fused")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--rank", type=int, default=0)
    t.add_argument("--world", type=int, default=1)
    t.add_argument("--start-index", type=int, default=0)
    t.add_argument("--out", default="dit_samples.npz")

    x = sub.add_parser("pixart")
    x.add_argument("--image-size", type=int, default=256)
    x.add_argument("--ckpt", default=None)
    x.add_argument("--vae", default=None)
    x.add_argument("--prompt-embeds", required=True)
    x.add_argument("--ref", default=None)
    x.add_argument("--inception", default=None)
    x.add_argument("--clip", default=None)
    x.add_argument("--clip-backend", default="port",
                   choices=["port", "transformers"],
                   help="port = the port's CLIP towers (models/clip.py) on "
                   "the device; transformers = transformers' CPU path")
    x.add_argument("--batch", type=int, default=100)
    x.add_argument("--num-steps", type=int, default=20)
    x.add_argument("--cfg-scale", type=float, default=4.5)
    x.add_argument("--self-k", type=int, default=77)
    x.add_argument("--cross-k", type=int, default=0)
    x.add_argument("--pred-mode", default="two_step_leading_ones")
    x.add_argument("--mx-quant", action="store_true", default=True)
    x.add_argument("--engine", default="fused")
    x.add_argument("--limit", type=int, default=None)
    x.add_argument("--seed", type=int, default=0)
    x.add_argument("--out", default="pixart_samples.npz")
    for parser in (d, t, x):
        parser.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    fn = {"deit": run_deit, "dit": run_dit, "pixart": run_pixart}
    report = fn[args.workload](args)
    print(json.dumps({"workload": args.workload, **(report or {})}))
    return report


if __name__ == "__main__":
    main()
