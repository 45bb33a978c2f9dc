#!/usr/bin/env python3
"""Continuous-batching serving throughput of the port on the card.

Measures the ``DiffusionServer`` end to end at the reference operating
points (the JAX package's tools/serving_bench.py):
  --model dit     DiT-XL/2 256^2: MXINT8 bfloat=16, weights prequantized to
                  bf16, bf16 activations, ex_pred top-k k=154 key_bits 8,
                  block 27 dense, CFG 4.0, DDPM 100 steps
  --model pixart  PixArt-alpha 256^2: MXINT8 with subnormal flush, weights
                  prequantized to bf16, bf16 activations, self top-k k=77
                  two_step_leading_ones key_bits 8 (block 27 dense), CFG 4.5,
                  DPM-Solver++ 20 steps, synthetic (120, 4096) caption
                  embeds per request with mask lengths from 8 to 120
with a request stream, reporting imgs/s, per-request latency and queue-wait
percentiles, and the mean engine step.  Random weights from seed 0.  One
warm drain of a pool's worth of requests comes first.

    python -m mx_quantization_tpu_torch.tools.serving_bench \\
        [--model dit|pixart] [--slots 32] [--steps N] [--reqs 64] \\
        [--contract exact|serving] [--arrival burst|staggered]

Prints the card's name and power limit, JAX's summary line, then one JSON
object of the numbers.  ``chip_smoke.py`` drives the servers through this
module's functions.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ..models.dit import DiT_models, DiTQuantConfig, dit_forward, init_dit
from ..models.pixart import (PixArtConfig, PixArtQuantConfig, init_pixart,
                             pixart_forward)
from ..serving import DiffusionServer, Request
from ..utils.prequantize import prequantize_weights
from ..workloads.dit import dit_mx_specs
from ..workloads.pixart import pixart_mx_specs

CAPTION_TOKENS = 120
CAPTION_CHANNELS = 4096  # T5-XXL


def dit_request(rid, i):
    return Request(rid, i % 1000)


def pixart_request(rid, i):
    """A synthetic caption: (120, 4096) embeds and a mask of 8-120 valid
    tokens, both from seed 1000 + i."""
    r = np.random.RandomState(1000 + i)
    embeds = r.randn(CAPTION_TOKENS, CAPTION_CHANNELS).astype(
        np.float32) * 0.02
    valid = r.randint(8, CAPTION_TOKENS + 1)
    mask = (np.arange(CAPTION_TOKENS) < valid).astype(np.float32)
    return Request(rid, {"embeds": embeds, "mask": mask})


def pixart_null():
    r = np.random.RandomState(0)
    return {"embeds": r.randn(CAPTION_TOKENS, CAPTION_CHANNELS).astype(
        np.float32) * 0.02, "mask": np.ones((CAPTION_TOKENS,), np.float32)}


def serve(srv, make_request, reqs, period=None):
    """Serve ``reqs`` requests: all at once (``period`` None) or one every
    ``period`` engine steps, the continuous-batching case.  Request i is
    ``make_request(10000 + i, i)``.  Returns the results, the wall
    seconds (host clock, ending once every result is on the host) and the
    engine steps dispatched."""
    srv._results.clear()
    d0 = srv.dispatches
    t0 = time.perf_counter()
    if period is None:
        for i in range(reqs):
            srv.submit(make_request(10000 + i, i))
        results = dict(srv.run_until_drained())
    else:
        sub = step_n = 0
        while sub < reqs or srv._host_busy.any() or \
                srv._pending is not None:
            if sub < reqs and step_n % period == 0:
                srv.submit(make_request(10000 + sub, sub))
                sub += 1
            srv.step()
            step_n += 1
        results = dict(srv._results)
    return dict(results=results, wall_s=time.perf_counter() - t0,
                dispatches=srv.dispatches - d0)


def summary(run):
    """imgs/s, latency and queue-wait p50/p95 (seconds, from submit()) and
    the mean engine step (wall / dispatches, ms) of one ``serve`` run."""
    res = run["results"].values()
    lats = np.array([r.latency_s for r in res])
    waits = np.array([r.queue_wait_s for r in res])
    return dict(reqs=len(lats), wall_s=run["wall_s"],
                dispatches=run["dispatches"],
                imgs_per_s=len(lats) / run["wall_s"],
                latency_p50_s=float(np.percentile(lats, 50)),
                latency_p95_s=float(np.percentile(lats, 95)),
                queue_wait_p50_s=float(np.percentile(waits, 50)),
                queue_wait_p95_s=float(np.percentile(waits, 95)),
                step_ms=1e3 * run["wall_s"] / max(run["dispatches"], 1))


def dit_qcfg(specs, contract):
    """The DiT-XL/2 operating point's plan (weights prequantized with
    ``specs``)."""
    return DiTQuantConfig(mx_specs=specs, mx_quant=True, top_k=True, k=154,
                          pred_mode="ex_pred", exclude_blocks=(27,),
                          topk_key_bits=8, contract=contract,
                          activation_dtype="bfloat16")


def pixart_qcfg(specs, contract):
    """The PixArt-alpha 256^2 operating point's plan (weights prequantized
    with ``specs``)."""
    return PixArtQuantConfig(mx_specs=specs, mx_quant=True, self_top_k=True,
                             self_k=77, ex_pred=True,
                             pred_mode="two_step_leading_ones",
                             exclude_blocks=(27,), topk_key_bits=8,
                             contract=contract, activation_dtype="bfloat16")


def dit_server(model, specs, contract, slots, steps, device):
    """The DiT-XL/2 operating point's server around ``model``."""
    qcfg = dit_qcfg(specs, contract)

    def model_fn(p, lat, t, y):
        return dit_forward(p, lat, t, y, qcfg)
    cfg = model.cfg
    return DiffusionServer(
        model_fn, (cfg.in_channels, cfg.input_size, cfg.input_size),
        num_steps=steps, slots=slots, null_condition=cfg.num_classes,
        cfg_scale=4.0, params=model, device=device)


def pixart_server(model, specs, contract, slots, steps, device):
    """The PixArt-alpha 256^2 operating point's server around ``model``."""
    qcfg = pixart_qcfg(specs, contract)

    def model_fn(p, lat, t, cond):
        return pixart_forward(p, lat, cond["embeds"], t, qcfg,
                              encoder_attention_mask=cond["mask"])
    cfg = model.cfg
    return DiffusionServer(
        model_fn, (cfg.in_channels, cfg.sample_size, cfg.sample_size),
        num_steps=steps, slots=slots, solver="dpm++", cfg_scale=4.5,
        params=model, null_condition=pixart_null(), device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=["dit", "pixart"], default="dit")
    ap.add_argument("--slots", type=int, default=32)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--reqs", type=int, default=64)
    ap.add_argument("--contract", choices=["exact", "serving"],
                    default="exact")
    ap.add_argument("--arrival", choices=["burst", "staggered"],
                    default="burst",
                    help="staggered: one request every steps/(0.8 slots) "
                    "engine steps, ~80%% occupancy")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("serving_bench: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    seed = torch.Generator().manual_seed(0)
    if args.model == "dit":
        args.steps = args.steps or 100
        model = init_dit(DiT_models["DiT-XL/2"](input_size=32), seed, dev,
                         randomize_all=True)
        model, specs = prequantize_weights(model, dit_mx_specs("fused"),
                                           serve_dtype=torch.bfloat16)
        srv = dit_server(model, specs, args.contract, args.slots,
                         args.steps, dev)
        make_request = dit_request
    else:
        args.steps = args.steps or 20
        model = init_pixart(PixArtConfig(), seed, dev)
        model, specs = prequantize_weights(model, pixart_mx_specs("fused"),
                                           serve_dtype=torch.bfloat16)
        srv = pixart_server(model, specs, args.contract, args.slots,
                            args.steps, dev)
        make_request = pixart_request

    serve(srv, make_request, args.slots)  # warm
    period = None
    if args.arrival == "staggered":
        period = max(1, round(args.steps / (0.8 * args.slots)))
    stats = summary(serve(srv, make_request, args.reqs, period))
    print(f"model={args.model} contract={args.contract} "
          f"slots={args.slots} steps={args.steps} reqs={args.reqs} "
          f"arrival={args.arrival}: {stats['imgs_per_s']:.3f} imgs/sec  "
          f"latency(from submit) p50={stats['latency_p50_s']:.1f}s "
          f"p95={stats['latency_p95_s']:.1f}s  "
          f"queue-wait p50={stats['queue_wait_p50_s']:.1f}s "
          f"p95={stats['queue_wait_p95_s']:.1f}s "
          f"wall={stats['wall_s']:.1f}s", flush=True)
    print(json.dumps(dict(device=smi, model=args.model,
                          contract=args.contract, slots=args.slots,
                          steps=args.steps, arrival=args.arrival, **stats)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
