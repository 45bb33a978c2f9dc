"""DiT sampling: CFG sampling over the respaced DDPM loop (port of the JAX
package's ``workloads/dit.py``: ``dit_mx_specs``, ``sample_dit``,
``sample_for_fid`` and the CLI).

Run (random weights unless --ckpt names a DiT checkpoint):
    python -m mx_quantization_tpu_torch.workloads.dit --model DiT-XL/2 \
        --num-steps 100 --cfg-scale 4.0 --mx-quant --top-k --k 154 \
        --exclude-blocks 27 --key-bits 8 --activation-dtype bfloat16 \
        --prequantize --contract serving
--pred-mode takes every predictor of the kernels; ELSA builds the structured
orthogonal projection, as the JAX CLI does.  ``--engine ref`` runs the
emulation engine (plain torch, the parity oracle).  ``--vae`` (the decoder)
and ``--anal`` (the analysis records) are not ported yet and raise, naming
ROADMAP.md.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..diffusion.gaussian import create_diffusion
from ..models.dit import (DiT, DiT_models, DiTQuantConfig,
                          dit_forward_with_cfg, init_dit)
from ..predictors.elsa import orthogonal_matrix as structured_matrix
from ..specs import MxSpecs, finalize_mx_specs


def dit_mx_specs(custom_tpu: str = "fused") -> MxSpecs:
    """The DiT workload's exact specs (reference scripts/sample.py:36-52):
    MXINT8 weights and activations, scale 8, block 32, bfloat=16, no
    subnormal flush, inference only."""
    return finalize_mx_specs(dict(
        w_elem_format="int8", a_elem_format="int8", scale_bits=8,
        shared_exp_method="max", block_size=32, bfloat=16, fp=0,
        round="nearest", mx_flush_fp32_subnorms=False,
        quantize_backprop=False, custom_tpu=custom_tpu))


def sample_dit(model: DiT, qcfg: DiTQuantConfig, class_labels: Sequence[int],
               generator: Optional[torch.Generator] = None,
               num_steps: int = 100, cfg_scale: float = 4.0,
               z: Optional[torch.Tensor] = None,
               step_noise: Optional[Sequence[torch.Tensor]] = None,
               device="cuda", orthogonal_matrix=None) -> torch.Tensor:
    """Generate (n, 4, H, W) latents (pre-VAE) for the class labels.

    The initial latents ``z`` (n, C, H, W) and the per-step noise (one
    (2n, C, H, W) tensor per step, in sampling order) are drawn from
    ``generator`` unless given.  The CFG denoise step runs eagerly.
    ``orthogonal_matrix``: ELSA's projection."""
    device = resolve_device(device)
    if next(model.parameters()).device.type != device.type:
        raise ValueError(f"the model is not on {device}")
    cfg = model.cfg
    n = len(class_labels)
    diffusion = create_diffusion(str(num_steps))
    shape = (n, cfg.in_channels, cfg.input_size, cfg.input_size)

    def draw(shp):
        if generator is None:
            raise ValueError("pass a generator, or z and step_noise")
        return torch.randn(shp, generator=generator,
                           device=generator.device).to(device)

    z = draw(shape) if z is None else z.to(device)
    x = torch.cat([z, z], dim=0)
    y = torch.tensor(list(class_labels) + [cfg.num_classes] * n,
                     dtype=torch.int64, device=device)
    excluded = set(qcfg.exclude_timesteps)
    tsi_exc = next(iter(excluded)) if excluded else None

    with torch.inference_mode():
        for step, i in enumerate(reversed(range(diffusion.num_timesteps))):
            tsi = tsi_exc if i in excluded else None

            def model_fn(xt, t, y, tsi=tsi):
                return dit_forward_with_cfg(
                    model, xt, t, y, qcfg, cfg_scale, timestep_idx=tsi,
                    orthogonal_matrix=orthogonal_matrix)

            noise = (draw(x.shape) if step_noise is None
                     else step_noise[step].to(device))
            x = diffusion.p_sample_step(model_fn, x, i, noise,
                                        model_kwargs={"y": y})
    return x[:n]


def sample_for_fid(model: DiT, qcfg: DiTQuantConfig, num_samples: int,
                   batch: int, generator: Optional[torch.Generator] = None,
                   rank: int = 0, world: int = 1, num_steps: int = 100,
                   cfg_scale: float = 1.5, orthogonal_matrix=None,
                   start_index: int = 0, device="cuda") -> np.ndarray:
    """Balanced-class sharded sample generation (reference sample_ddp.py:
    105-171): rank r samples labels r, r+world, ... cycling over classes,
    in batches through ``sample_dit``, each batch's noise drawn from
    ``generator`` in turn.

    start_index resumes an interrupted run by skipping already-generated
    samples (the reference's --current-num-samples manual-resume knob,
    sample_ddp.py:170,198)."""
    labels = np.arange(num_samples) % model.cfg.num_classes
    shard = labels[rank::world][start_index:]
    outs = []
    for i in range(0, len(shard), batch):
        lat = sample_dit(model, qcfg, shard[i:i + batch].tolist(), generator,
                         num_steps=num_steps, cfg_scale=cfg_scale,
                         device=device, orthogonal_matrix=orthogonal_matrix)
        outs.append(lat.cpu().numpy())
    return np.concatenate(outs) if outs else np.zeros((0,))


def build_argparser():
    p = argparse.ArgumentParser("DiT MX sampling (PyTorch port)")
    p.add_argument("--model", default="DiT-XL/2", choices=sorted(DiT_models))
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--num-steps", type=int, default=100)
    p.add_argument("--cfg-scale", type=float, default=4.0)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--classes", type=int, nargs="*",
                   default=[207, 360, 387, 974, 88, 979, 417, 279])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="samples.npz")
    p.add_argument("--vae", default=None,
                   help="sd-vae-ft-mse params for decode (not ported)")
    p.add_argument("--mx-quant", action="store_true")
    p.add_argument("--top-k", action="store_true")
    p.add_argument("--k", type=int, default=154)
    p.add_argument("--no-ex-pred", action="store_true")
    p.add_argument("--pred-mode", default="ex_pred")
    p.add_argument("--exclude-blocks", type=int, nargs="*", default=[27])
    p.add_argument("--exclude-timesteps", type=int, nargs="*", default=[])
    p.add_argument("--engine", default="fused", choices=["fused", "ref"])
    p.add_argument("--contract", default="exact",
                   choices=["exact", "serving"])
    p.add_argument("--anal", action="store_true",
                   help="predictor-quality records (not ported)")
    p.add_argument("--anal-dir", default="analysis_out")
    p.add_argument("--key-bits", type=int, default=32, choices=[8, 16, 32],
                   help="top-k ranking precision (the bench point uses 8)")
    p.add_argument("--activation-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--prequantize", action="store_true",
                   help="snap the weights to the MX grid once and store "
                        "them in bf16, as the bench point does")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    for flag, unported in (("--vae", args.vae), ("--anal", args.anal)):
        if unported:
            raise NotImplementedError(
                f"{flag} has no counterpart in the port yet (ROADMAP.md)")
    device = resolve_device(args.device)
    cfg = DiT_models[args.model](input_size=args.image_size // 8,
                                 num_classes=args.num_classes)
    specs = dit_mx_specs(args.engine) if args.mx_quant else None
    if args.ckpt:
        from ..utils.checkpoint import load_dit_checkpoint
        model = DiT(cfg, device=device)
        model.load_state_dict(load_dit_checkpoint(args.ckpt, cfg.depth))
    else:
        print("WARNING: no --ckpt — random init (smoke test only)")
        model = init_dit(cfg, torch.Generator().manual_seed(0), device)
    if args.prequantize and specs is not None:
        from ..utils.prequantize import prequantize_weights
        model, specs = prequantize_weights(model, specs,
                                           serve_dtype=torch.bfloat16)
    qcfg = DiTQuantConfig(
        mx_specs=specs, mx_quant=args.mx_quant, top_k=args.top_k, k=args.k,
        ex_pred=not args.no_ex_pred, pred_mode=args.pred_mode,
        exclude_blocks=tuple(args.exclude_blocks),
        exclude_timesteps=tuple(args.exclude_timesteps),
        topk_key_bits=args.key_bits, contract=args.contract,
        activation_dtype=args.activation_dtype)

    om = None
    if args.pred_mode == "ELSA":
        om = structured_matrix(cfg.head_dim, device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    lat = sample_dit(model, qcfg, args.classes, gen, args.num_steps,
                     args.cfg_scale, device=device,
                     orthogonal_matrix=om).cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"sampled {lat.shape} in {dt:.1f}s "
          f"({len(args.classes) / dt:.3f} imgs/s)")
    np.savez(args.out, latents=lat, labels=np.asarray(args.classes))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
