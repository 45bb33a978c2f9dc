#!/usr/bin/env python3
"""Time DiT-XL/2 256^2 sampling steps of one source tree, so that two trees
can be compared end to end within one run on one card.

    python3 mx_quantization_tpu_torch/tools/time_dit_steps.py \\
        [--repo DIR] [--steps 20] [--images 32] [--save FILE.npz]
        [--against FILE.npz]

``--repo`` is the root of the checkout whose ``mx_quantization_tpu_torch``
is imported (default: the one this file lies in).  Run the trees in
separate processes, interleaved (A, B, B, A), and compare only numbers from
one run.  The paths are ``chip_smoke.py``'s: random weights from seed 0,
prequantized to bf16, ``--images`` class labels with CFG (twice the rows),
ex_pred top-k k = 154 at key_bits 8, block 27 dense, bf16 activations; the
default path (K1, K2) and the fused opt-ins (K5, K6, K7), each tier, two
warm steps, then ``--steps`` steps timed on the host clock around a
synchronized run.  Prints the card's name and power limit, one line per
path and last one JSON object of ms per step.  ``--save`` writes each
path's timed latents to an .npz, so that the trees' outputs can be
compared (the noise is drawn from one seeded generator in one order, so
equal trees give equal latents); ``--against`` prints, per path, whether
this run's latents equal those of an earlier run's ``--save`` and their
largest difference.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--images", type=int, default=32)
    ap.add_argument("--save", default=None)
    ap.add_argument("--against", default=None)
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    import torch
    from mx_quantization_tpu_torch.models.dit import (DiT_models,
                                                      DiTQuantConfig, init_dit)
    from mx_quantization_tpu_torch.utils.prequantize import \
        prequantize_weights
    from mx_quantization_tpu_torch.workloads.dit import (dit_mx_specs,
                                                         sample_dit)
    if not torch.cuda.is_available():
        print("time_dit_steps: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg = DiT_models["DiT-XL/2"](input_size=32)
    model = init_dit(cfg, torch.Generator().manual_seed(0), dev,
                     randomize_all=True)
    model, specs = prequantize_weights(model, dit_mx_specs(),
                                       serve_dtype=torch.bfloat16)
    base = DiTQuantConfig(mx_specs=specs, mx_quant=True, top_k=True, k=154,
                          ex_pred=True, exclude_blocks=(27,),
                          topk_key_bits=8, activation_dtype="bfloat16")
    fused = dataclasses.replace(base, fuse_ln_modulate=True, fuse_gelu=True,
                                qkv_layout="split_t")
    labels = list(range(args.images))
    out, latents = {}, {}
    for name, qc in (("default", base), ("opt-ins", fused)):
        for contract in ("serving", "exact"):
            q = dataclasses.replace(qc, contract=contract)
            sample_dit(model, q, labels, gen, num_steps=2, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lat = sample_dit(model, q, labels, gen, num_steps=args.steps,
                             device=dev)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / args.steps
            out[f"{name} {contract}"] = ms
            latents[f"{name} {contract}"] = lat.float().cpu().numpy()
            print(f"[step] {repo} DiT-XL/2 {name} {contract}: {ms:.2f} ms",
                  flush=True)
    import numpy as np
    if args.save:
        np.savez(args.save, **latents)
    if args.against:
        other = np.load(args.against)
        for key, lat in latents.items():
            print(f"[latents] {key} against {args.against}: bit-equal "
                  f"{np.array_equal(lat, other[key])}, max |diff| "
                  f"{np.abs(lat - other[key]).max():.3e}", flush=True)
    print(json.dumps({"repo": repo, "device": smi, "ms_per_step": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
