"""PixArt-alpha text-to-image sampling (port of the JAX package's
``workloads/pixart.py``: ``pixart_mx_specs``, ``sample_pixart`` and the CLI).

The T5 text encoding runs offline, as in the reference pipeline: the CLI
reads an .npz of (embeds, mask, null_embeds) with --prompt-embeds, or makes
synthetic embeds from the seed.  The T5 encoder and the VAE decoder are not
ported yet (ROADMAP.md), so the CLI writes latents.

Run (random weights unless --transformer-ckpt names a checkpoint):
    python -m mx_quantization_tpu_torch.workloads.pixart --mx-quant \\
        --self-top-k --self-k 77 --pred-mode two_step_leading_ones
--image-size 1024 runs the alpha 1024^2 model (N = 4096 latent tokens, with
micro-conditioning; its operating point adds --cross-top-k --cross-k 60
--key-bits 8 --activation-dtype bfloat16 --prequantize); --pred-mode ELSA
builds the structured orthogonal projection, as the JAX CLI does;
--engine ref runs the emulation engine (plain torch, the parity oracle).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..diffusion import DPMSolverMultistep
from ..models.pixart import (PixArt, PixArtConfig, PixArtQuantConfig,
                             init_pixart, pixart_forward)
from ..predictors.elsa import orthogonal_matrix as structured_matrix
from ..specs import MxSpecs, finalize_mx_specs


def pixart_mx_specs(custom_tpu: str = "fused") -> MxSpecs:
    """The PixArt-alpha workload's exact specs (reference
    text_local_inference_alpha.py:108-124): MXINT8 weights and activations,
    scale 8, block 32, bfloat=32 (the f32 grid: the identity),
    mx_flush_fp32_subnorms=True, inference only."""
    return finalize_mx_specs(dict(
        w_elem_format="int8", a_elem_format="int8", scale_bits=8,
        shared_exp_method="max", block_size=32, bfloat=32, fp=0,
        round="nearest", mx_flush_fp32_subnorms=True,
        quantize_backprop=False, custom_tpu=custom_tpu))


def sample_pixart(model: PixArt, qcfg: PixArtQuantConfig,
                  prompt_embeds: torch.Tensor, prompt_mask: torch.Tensor,
                  null_embeds: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  num_steps: int = 20, guidance_scale: float = 4.5,
                  latents: Optional[torch.Tensor] = None,
                  device="cuda", orthogonal_matrix=None) -> torch.Tensor:
    """Latents (n, C, H, W) for a batch of n prompts with CFG: the prompt
    rows and the null rows in one model call per DPM-Solver++(2M) step.
    The initial latents are ``latents`` if given, else drawn from
    ``generator``.  ``orthogonal_matrix``: ELSA's projection."""
    device = resolve_device(device)
    if next(model.parameters()).device.type != device.type:
        raise ValueError(f"the model is not on {device}")
    cfg = model.cfg
    n = prompt_embeds.shape[0]
    solver = DPMSolverMultistep()
    ctx = prompt_embeds.to(device)
    ctx2 = torch.cat([ctx, null_embeds.to(device).expand(ctx.shape)], dim=0)
    mask = prompt_mask.to(device)
    mask2 = torch.cat([mask, torch.ones_like(mask)], dim=0)
    if latents is None:
        if generator is None:
            raise ValueError("pass a generator or the initial latents")
        latents = torch.randn(
            (n, cfg.in_channels, cfg.sample_size, cfg.sample_size),
            generator=generator, device=generator.device)
    x = latents.to(device)
    excluded = set(qcfg.exclude_timesteps)
    tsi_exc = next(iter(excluded)) if excluded else None
    ts = solver.timesteps(num_steps)
    prev_x0 = None
    with torch.inference_mode():
        for si, t_idx in enumerate(ts):
            t = torch.full((2 * n,), float(t_idx), device=device)
            out = pixart_forward(
                model, torch.cat([x, x], dim=0), ctx2, t, qcfg,
                encoder_attention_mask=mask2,
                timestep_idx=tsi_exc if si in excluded else None,
                orthogonal_matrix=orthogonal_matrix)
            eps_c, eps_u = out[:, :cfg.in_channels].chunk(2, dim=0)
            eps = eps_u + guidance_scale * (eps_c - eps_u)
            x, prev_x0 = solver.step(x, eps, ts, si, prev_x0)
    return x


def build_argparser():
    p = argparse.ArgumentParser("PixArt-alpha MX sampling (PyTorch port)")
    p.add_argument("--variant", default="alpha", choices=["alpha", "sigma"],
                   help="alpha: 120-token T5; sigma: 300-token T5, no "
                        "micro-conditioning")
    p.add_argument("--max-token-length", type=int, default=None,
                   help="T5 caption length (default: 120 alpha / 300 sigma)")
    p.add_argument("--transformer-ckpt", default=None)
    p.add_argument("--prompt-embeds", default=None,
                   help=".npz with embeds/mask/null_embeds (offline T5)")
    p.add_argument("--t5-path", default=None)
    p.add_argument("--prompts", nargs="*",
                   default=["an astronaut riding a horse"])
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--num-layers", type=int, default=28)
    p.add_argument("--num-heads", type=int, default=16)
    p.add_argument("--head-dim", type=int, default=72)
    p.add_argument("--caption-channels", type=int, default=4096)
    p.add_argument("--num-steps", type=int, default=20)
    p.add_argument("--guidance-scale", type=float, default=4.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="pixart_samples.npz")
    p.add_argument("--vae", default=None)
    p.add_argument("--mx-quant", action="store_true")
    p.add_argument("--self-top-k", action="store_true")
    p.add_argument("--self-k", type=int, default=77)
    p.add_argument("--cross-top-k", action="store_true")
    p.add_argument("--cross-k", type=int, default=20)
    p.add_argument("--no-ex-pred", action="store_true")
    p.add_argument("--pred-mode", default="two_step_leading_ones")
    p.add_argument("--exclude-blocks", type=int, nargs="*", default=[27])
    p.add_argument("--engine", default="fused", choices=["fused", "ref"])
    p.add_argument("--contract", default="exact",
                   choices=["exact", "serving"])
    p.add_argument("--key-bits", type=int, default=32, choices=[8, 16, 32],
                   help="top-k ranking precision (the 1024^2 point uses 8)")
    p.add_argument("--activation-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--prequantize", action="store_true",
                   help="snap the weights to the MX grid once and store "
                        "them in bf16, as the 1024^2 point does")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.t5_path or args.vae:
        raise NotImplementedError(
            "the T5 encoder and the VAE are not ported yet (ROADMAP.md); "
            "pass --prompt-embeds, and decode the latents elsewhere")
    device = resolve_device(args.device)
    cfg = PixArtConfig(sample_size=args.image_size // 8,
                       num_layers=args.num_layers,
                       num_attention_heads=args.num_heads,
                       attention_head_dim=args.head_dim,
                       caption_channels=args.caption_channels,
                       micro_conds=False if args.variant == "sigma" else None)
    tok_len = args.max_token_length or (300 if args.variant == "sigma"
                                        else 120)
    specs = pixart_mx_specs(args.engine) if args.mx_quant else None
    qcfg = PixArtQuantConfig(
        mx_specs=specs, mx_quant=args.mx_quant,
        self_top_k=args.self_top_k, self_k=args.self_k,
        cross_top_k=args.cross_top_k, cross_k=args.cross_k,
        ex_pred=not args.no_ex_pred, pred_mode=args.pred_mode,
        exclude_blocks=tuple(args.exclude_blocks), contract=args.contract,
        topk_key_bits=args.key_bits, activation_dtype=args.activation_dtype)

    if args.prompt_embeds:
        z = np.load(args.prompt_embeds)
        embeds, mask = z["embeds"], z["mask"]
        null = z["null_embeds"] if "null_embeds" in z else \
            np.zeros_like(embeds[:1])
    else:
        print("WARNING: no --prompt-embeds: synthetic embeds (smoke test)")
        rng = np.random.RandomState(0)
        embeds = rng.randn(len(args.prompts), tok_len,
                           cfg.caption_channels).astype(np.float32)
        mask = np.ones((len(args.prompts), tok_len), np.int32)
        null = rng.randn(1, tok_len, cfg.caption_channels).astype(np.float32)

    if args.transformer_ckpt:
        from ..utils.checkpoint import (load_pixart_checkpoint,
                                        pixart_params_from_jax)
        if args.transformer_ckpt.endswith((".safetensors", ".bin", ".pth",
                                           ".pt")):
            model = PixArt(cfg, device=device)
            model.load_state_dict(load_pixart_checkpoint(
                args.transformer_ckpt, cfg.num_layers))
        else:  # the JAX package's pickled numpy parameter tree
            import pickle
            with open(args.transformer_ckpt, "rb") as f:
                model = pixart_params_from_jax(pickle.load(f), cfg, device)
    else:
        print("WARNING: no --transformer-ckpt: random init (smoke test)")
        model = init_pixart(cfg, torch.Generator().manual_seed(0), device)
    if args.prequantize and specs is not None:
        from ..utils.prequantize import prequantize_weights
        model, specs = prequantize_weights(model, specs,
                                           serve_dtype=torch.bfloat16)
        qcfg = dataclasses.replace(qcfg, mx_specs=specs)

    om = None
    if args.pred_mode == "ELSA":
        om = structured_matrix(cfg.attention_head_dim, device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    lat = sample_pixart(model, qcfg, torch.from_numpy(embeds),
                        torch.from_numpy(mask), torch.from_numpy(null), gen,
                        args.num_steps, args.guidance_scale, device=device,
                        orthogonal_matrix=om)
    lat = lat.cpu().numpy()
    print(f"sampled {lat.shape} in {time.perf_counter() - t0:.1f}s")
    np.savez(args.out, latents=lat)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
