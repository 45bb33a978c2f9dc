#!/usr/bin/env python3
"""Time the attention kernels of one source tree at the call sites of the
port's paths, so that two trees can be compared within one run on one
card: K2 and K7 (``csrc/topk_attention_qkv.cu``), K3 and K4
(``csrc/topk_attention_split.cu``).

    python3 mx_quantization_tpu_torch/tools/time_split_sites.py \
        [--repo DIR] [--kernels K2,K7,K3,K4] [--block-size 32] [--build-only]

``--repo`` is the root of the checkout whose ``mx_quantization_tpu_torch``
is imported (default: the one this file lies in); each checkout builds into
its own ``_build/``.  Run the trees in separate processes, interleaved (A,
B, B, A), and compare only numbers from one run.  Sites, with inputs from a
seeded generator (q and k scaled by 4, as ``chip_smoke.py`` times them):
  * K3 at PixArt-alpha 256^2's (200 rows, 16 heads, f32 in and out, flush,
    key_bits 32): self top-k two_step k = 77, self dense, and the cross
    attention against 120 caption tokens with a mask bias, each tier;
  * K4, where the tree has it, at DiT-XL/2 512^2's (8 rows, 16 heads,
    N = S = 1024, bf16 in and out, bfloat 16, key_bits 8): top-k ex_pred
    k = 154 and dense, each tier; and at PixArt-alpha 1024^2's (2 rows, 16
    heads, N = 4096, bf16 in and out, flush, key_bits 8): self top-k
    two_step k = 77, self dense, cross top-k two_step k = 60 against 120
    caption tokens with a mask bias, each tier;
  * K2 at DiT-XL/2 256^2's (qkv (64, 256, 3456) bf16, 16 heads of 72, bf16
    out, bfloat 16, key_bits 8): top-k ex_pred k = 154 and dense, each
    tier; K7 at the same sites from the split-emission operands (qk_t
    (3072, 64, 256) with each head's rows past 72 zero, v (64, 256, 1152)),
    and in two_step_leading_ones (the opt-ins path in that mode);
  * K2 at DeiT's top-k sites (qkv (100, 197, 3 * 64 H) f32, f32 out,
    key_bits 32, bfloat 0): DeiT-tiny ex_pred k = 80 (H = 3), DeiT-small
    ex_pred k = 60 (H = 6), DeiT-base two_step k = 30 (H = 12), each tier.
A site that a tree's kernel does not take (K2 or K7 in two_step before it
served that mode) is reported as null.
``--kernels`` picks the kernels (default: all four); ``--block-size``
times every site at that MX block (a tree's K2 and K7 take the kernel its
``qkv_route`` names, or the blocks kernel where it has none).
Prints the card's name and power limit, the ptxas lines of the build, one
line per site, and last one JSON object with every time (ms per call,
CUDA events, calls queued behind a GPU sleep).
"""

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import time

PIX = dict(scale=72 ** -0.5, block_size=32, mbits=8, scale_bits=8,
           key_bits=32, out_dtype="float32", bfloat=0, flush=True, ebits=0,
           emax=0, max_norm=1.984375)
DIT512 = dict(scale=72 ** -0.5, block_size=32, mbits=8, scale_bits=8,
              key_bits=8, out_dtype="bfloat16", bfloat=16, flush=False,
              ebits=0, emax=0, max_norm=1.984375)
DIT256 = DIT512  # the same operating point at N = 256
PIX1024 = dict(PIX, key_bits=8, out_dtype="bfloat16")
REPS = 30  # timed calls per site (5 where a call takes over 20 ms)
DEIT = dict(block_size=32, mbits=8, scale_bits=8, key_bits=32,
            out_dtype="float32", bfloat=0, flush=False, ebits=0, emax=0,
            max_norm=1.984375, scale=64 ** -0.5)
# K2 and K7: (kernel, label, qkv shape, qkv dtype, heads, keywords)
QKV_SITES = (
    ("K2", "DiT-256 top-k ex_pred k=154", (64, 256, 3456), "bfloat16", 16,
     dict(DIT256, k=154, approx=True, pred_mode="ex_pred")),
    ("K2", "DiT-256 dense", (64, 256, 3456), "bfloat16", 16,
     dict(DIT256, k=256, approx=False, pred_mode="ex_pred")),
    ("K7", "DiT-256 top-k ex_pred k=154", (64, 256, 3456), "bfloat16", 16,
     dict(DIT256, k=154, approx=True, pred_mode="ex_pred")),
    ("K7", "DiT-256 dense", (64, 256, 3456), "bfloat16", 16,
     dict(DIT256, k=256, approx=False, pred_mode="ex_pred")),
    ("K7", "DiT-256 top-k two_step k=154", (64, 256, 3456), "bfloat16", 16,
     dict(DIT256, k=154, approx=True, pred_mode="two_step_leading_ones")),
    ("K2", "DeiT-tiny top-k ex_pred k=80", (100, 197, 576), "float32", 3,
     dict(DEIT, k=80, approx=True, pred_mode="ex_pred")),
    ("K2", "DeiT-small top-k ex_pred k=60", (100, 197, 1152), "float32", 6,
     dict(DEIT, k=60, approx=True, pred_mode="ex_pred")),
    ("K2", "DeiT-base top-k two_step k=30", (100, 197, 2304), "float32", 12,
     dict(DEIT, k=30, approx=True, pred_mode="two_step_leading_ones")),
)
# (kernel, label, q shape, k shape, dtype, caption bias, keywords)
SITES = (
    ("K3", "PixArt-256 self top-k two_step k=77", (200, 16, 256, 72),
     (200, 16, 256, 72), "float32", False,
     dict(PIX, k=77, approx=True, pred_mode="two_step_leading_ones")),
    ("K3", "PixArt-256 self dense", (200, 16, 256, 72), (200, 16, 256, 72),
     "float32", False, dict(PIX, k=256, approx=False, pred_mode="ex_pred")),
    ("K3", "PixArt-256 cross dense S=120 bias", (200, 16, 256, 72),
     (200, 16, 120, 72), "float32", True,
     dict(PIX, k=120, approx=False, pred_mode="ex_pred")),
    ("K4", "DiT-512 top-k ex_pred k=154", (8, 16, 1024, 72),
     (8, 16, 1024, 72), "bfloat16", False,
     dict(DIT512, k=154, approx=True, pred_mode="ex_pred")),
    ("K4", "DiT-512 dense", (8, 16, 1024, 72), (8, 16, 1024, 72),
     "bfloat16", False,
     dict(DIT512, k=1024, approx=False, pred_mode="ex_pred")),
    ("K4", "PixArt-1024 self top-k two_step k=77", (2, 16, 4096, 72),
     (2, 16, 4096, 72), "bfloat16", False,
     dict(PIX1024, k=77, approx=True, pred_mode="two_step_leading_ones")),
    ("K4", "PixArt-1024 self dense", (2, 16, 4096, 72), (2, 16, 4096, 72),
     "bfloat16", False,
     dict(PIX1024, k=4096, approx=False, pred_mode="ex_pred")),
    ("K4", "PixArt-1024 cross top-k two_step k=60 bias", (2, 16, 4096, 72),
     (2, 16, 120, 72), "bfloat16", True,
     dict(PIX1024, k=60, approx=True, pred_mode="two_step_leading_ones")),
)


def time_ms(fn, reps, warmup=2):
    """Device ms per call over ``reps`` calls queued behind a GPU sleep
    (as ``chip_smoke.py`` times its kernels)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e9 * host_s * reps) + 10 ** 6)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def split_t_operands(qkv, heads, Dp):
    """The fused (B, N, 3*H*D) qkv as K7's qk_t (2*H*Dp, B, N), each
    head's rows past D zero, and v (B, N, H*D)."""
    import torch
    B, N, F = qkv.shape
    D = F // (3 * heads)
    qk = torch.nn.functional.pad(
        qkv[..., :2 * heads * D].reshape(B, N, 2, heads, D), (0, Dp - D))
    qk_t = qk.permute(2, 3, 4, 0, 1).reshape(2 * heads * Dp, B, N)
    return qk_t.contiguous(), qkv[..., 2 * heads * D:].contiguous()


def qkv_route_of(ta, kw):
    """The route the imported tree gives a K2 or K7 call (trees before
    ``qkv_route``: the blocks kernel at every block but 32)."""
    if hasattr(ta, "qkv_route"):
        pred = kw["pred_mode"] if kw["approx"] else None
        return ta.qkv_route(kw["block_size"], kw["ebits"], pred)
    return "qkv" if kw["block_size"] == 32 else "blocks"


def time_qkv_sites(ta, kernels, dev, reps=REPS, match="", block_size=32):
    """ms per call of K2 and K7 (those in ``kernels``) at QKV_SITES whose
    label holds ``match``, each tier, at MX block ``block_size``, through
    the wrappers of the imported tree."""
    import torch
    times = {}
    for kernel, label, shape, dtype, heads, kw in QKV_SITES:
        if kernel not in kernels or match not in label:
            continue
        kw = dict(kw, block_size=block_size)
        gen = torch.Generator(device=dev).manual_seed(0)
        qkv = torch.randn(*shape, generator=gen, device=dev).to(
            getattr(torch, dtype))
        D = shape[2] // (3 * heads)
        qk_t, v = split_t_operands(qkv, heads, -(-D // 32) * 32)
        for contract in ("serving", "exact"):
            call = dict(kw, out_dtype=getattr(torch, kw["out_dtype"]),
                        contract=contract)
            if kernel == "K2":
                def fn():
                    return ta.fused_topk_attention_qkv(qkv, heads, **call)
            else:
                def fn():
                    return ta.fused_topk_attention_qkv_t(
                        qk_t, v, heads, n_valid=shape[1], **call)
            try:
                ms = time_ms(fn, reps)
            except NotImplementedError as err:  # a mode the tree lacks
                times[f"{kernel} {label} {contract}"] = None
                print(f"[time] {kernel} {label} {contract}: not taken "
                      f"({err})", flush=True)
                continue
            times[f"{kernel} {label} {contract}"] = ms
            route = qkv_route_of(ta, dict(kw, approx=kw["approx"] and
                                          kw["k"] < shape[1]))
            print(f"[time] {kernel} {label} {contract} block {block_size} "
                  f"({route}): {ms:.4f} ms", flush=True)
        del qkv, qk_t, v
    return times


def time_split(ta, kernels, dev, reps=REPS, block_size=32):
    """ms per call of K3 and K4 (those in ``kernels``) at SITES, each tier,
    at MX block ``block_size``, through the wrappers of the imported
    tree."""
    import torch
    fns = {"K3": ta.fused_topk_attention,
           "K4": getattr(ta, "fused_topk_attention_tiled", None)}
    times = {}
    for kernel, label, qs, ks, dtype, with_bias, kw in SITES:
        fn = fns[kernel]
        if fn is None or kernel not in kernels:
            continue
        gen = torch.Generator(device=dev).manual_seed(0)
        dt = getattr(torch, dtype)

        def randn(shape, scale=1.0):
            return (scale * torch.randn(*shape, generator=gen, device=dev)
                    ).to(dt)

        q, kx, vx = randn(qs, 4.0), randn(ks, 4.0), randn(ks)
        bias = None
        if with_bias:  # caption masks of 8 .. S valid tokens
            B, S = ks[0], ks[2]
            valid = torch.linspace(8, S, B, device=dev).round()
            mask = (torch.arange(S, device=dev)[None] < valid[:, None])
            bias = ((~mask).float() * -10000.0)[:, None, None, :]
        for contract in ("serving", "exact"):
            call = dict(kw, out_dtype=getattr(torch, kw["out_dtype"]),
                        contract=contract, block_size=block_size)
            ms = time_ms(lambda: fn(q, kx, vx, bias, **call), 1)
            if ms < 20:
                ms = time_ms(lambda: fn(q, kx, vx, bias, **call), reps)
            else:
                ms = time_ms(lambda: fn(q, kx, vx, bias, **call), 5)
            times[f"{kernel} {label} {contract}"] = ms
            print(f"[time] {kernel} {label} {contract}: {ms:.4f} ms",
                  flush=True)
        del q, kx, vx
    return times


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--kernels", default="K2,K7,K3,K4")
    ap.add_argument("--block-size", type=int, default=32)
    ap.add_argument("--build-only", action="store_true")
    args = ap.parse_args()
    chosen = set(args.kernels.split(","))
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    import torch
    from mx_quantization_tpu_torch.ops.kernels import build
    from mx_quantization_tpu_torch.ops.kernels import topk_attention as ta
    if not os.path.abspath(ta.__file__).startswith(repo + os.sep):
        raise SystemExit(f"imported {ta.__file__}, not from {repo}")
    # trees from before K4 name the split source's definitions K3_DEFINES
    # and trees from before the parted K2 build have one K2 library
    todo = []
    bs = args.block_size
    if chosen & {"K2", "K7"} and bs == 32:
        todo += (ta.qkv_builds() if hasattr(ta, "qkv_builds")
                 else [(ta.SOURCE, ta.K2_DEFINES)])
    elif chosen & {"K2", "K7"}:
        try:  # trees with K2's and K7's int-grid builds per block
            todo += ta.qkv_builds(bs)
        except TypeError:
            pass
    if bs != 32:
        todo.append((ta.BLOCKS_SOURCE, ta.BLOCK_DEFINES))
    if chosen & {"K3", "K4"} and hasattr(ta, "split_builds"):
        todo += ta.split_builds()
    elif chosen & {"K3", "K4"}:
        todo.append((ta.SPLIT_SOURCE, getattr(
            ta, "SPLIT_DEFINES", None) or ta.K3_DEFINES))
    with concurrent.futures.ThreadPoolExecutor(max(1, len(todo))) as pool:
        libs = list(pool.map(lambda sd: build.build(*sd), todo))
    print(f"[build] {repo}: {[lib.name for lib in libs]}", flush=True)
    if args.build_only:
        return 0
    if not torch.cuda.is_available():
        print("time_split_sites: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}")
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "spill" in line or "registers" in line or \
                    "Function pro" in line:
                print(f"[build] {line.strip()[:150]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    times = time_qkv_sites(ta, chosen, dev, block_size=bs)
    times.update(time_split(ta, chosen, dev, block_size=bs))
    print(json.dumps({"repo": repo, "device": smi, "block_size": bs,
                      "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
