#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``mx_quantization_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA GPU (Hopper: the CUDA kernel is built for sm_90a) and the
CUDA toolkit's nvcc.  Phases, in order; any failure exits nonzero:
  1. device: the card's name and power limit; TF32 off
  2. build: K2 from csrc/ with nvcc (K1 compiles through Triton's JIT)
  3. K1 (MX quantize) against its plain version at the main-path shapes,
     bit for bit
  4. K2 (fused qkv top-k attention) against its plain version at the
     main-path shape, both contracts, top-k and dense
  5. the slice: DiT-XL/2 at full width (random weights from a seed,
     prequantized to bf16), 32 images with CFG (64 rows), 100 DDPM steps,
     serving tier then exact tier; launch counts per forward checked, and
     each kernel's launches per call site (shape, dtype, arguments) kept
  6. two serving steps under torch.profiler: device busy share, top kernels
  7. kernel times with CUDA events at every call site the slice launched
     (calls queued behind a GPU sleep, so that the host's launch time
     stays out), beside their bounds and plain versions, weighted by those
     launches
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

import collections
import dataclasses
import json
import os
import subprocess
import sys
import time

# H100 SXM published peaks: HBM bytes/s, bf16 dense tensor-core op/s, and
# non-tensor f32 instructions/s (67 TFLOP/s counts a fused multiply-add as 2)
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
F32_INSTR_PER_S = 33.5e12

STEPS = 100
IMAGES = 32


def time_ms(fn, reps, warmup=2):
    """Device ms per call of ``fn``, over ``reps`` calls queued behind a
    GPU sleep: launched back to back, a short kernel measures the host's
    launch time instead of its own.  Also returns whether the host had
    queued every call before the timed span began."""
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
    # about twice the host's time for the calls, at up to 2 GHz
    torch.cuda._sleep(int(4e9 * host_s * reps) + 10 ** 6)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    queued = not start.query()
    stop.synchronize()
    return start.elapsed_time(stop) / reps, queued


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mx_quantization_tpu_torch.models.dit import (DiT_models,
                                                      DiTQuantConfig, init_dit)
    from mx_quantization_tpu_torch.ops.kernels import build
    from mx_quantization_tpu_torch.ops.kernels.quantize import (
        mx_quantize, mx_quantize_ref)
    from mx_quantization_tpu_torch.ops.kernels.topk_attention import (
        SOURCE, fused_topk_attention_qkv, fused_topk_attention_qkv_ref)
    from mx_quantization_tpu_torch.utils.prequantize import prequantize_weights
    from mx_quantization_tpu_torch.workloads.dit import (dit_mx_specs,
                                                         sample_dit)

    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{kind} x{torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    # ---- 2. build
    t0 = time.perf_counter()
    lib = build.build(SOURCE)
    print(f"[build] {SOURCE} -> {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[build] {line.strip()}")

    # ---- 3. K1 against its plain version, bit for bit
    k1_err = 0.0
    for K in (1152, 4608):
        base = torch.randn(16384, K, generator=gen, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            x = base.to(dtype)
            for fmt in ("int8", "fp8_e4m3"):
                for bfloat in (0, 16):
                    got = mx_quantize(x, fmt, 32, 8, bfloat=bfloat)
                    want = mx_quantize_ref(x, fmt, 32, 8, bfloat=bfloat)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    k1_err = max(k1_err, err)
                    if not torch.equal(got, want):
                        fail(f"K1 {fmt} {dtype} bfloat={bfloat} K={K}: "
                             f"max |diff| {err}")
        print(f"[k1] (16384, {K}) bf16/f32 x int8/fp8_e4m3 x bfloat 0/16: "
              "bit-equal", flush=True)
    del base, x, got, want

    # ---- 4. K2 against its plain version at the main-path shape
    B, N, H, D = 2 * IMAGES, 256, 16, 72
    qkv = torch.randn(B, N, 3 * H * D, generator=gen, device=dev
                      ).to(torch.bfloat16)
    k2_err = 0.0
    for contract, k in (("serving", 154), ("serving", N), ("exact", 154),
                        ("exact", N)):
        for out_dtype in (torch.float32, torch.bfloat16):
            kw = dict(k=k, scale=D ** -0.5, key_bits=8, bfloat=16,
                      contract=contract, out_dtype=out_dtype)
            got = fused_topk_attention_qkv(qkv, H, **kw).float()
            want = fused_topk_attention_qkv_ref(qkv, H, **kw).float()
            torch.cuda.synchronize()
            # f32: the kernel and the plain version share arithmetic and
            # summation order (tests/test_fused_attention_kernel.py bound);
            # bf16: one bf16 ulp
            rtol = 2e-5 if out_dtype == torch.float32 else 2 ** -8
            diff = (got - want).abs()
            k2_err = max(k2_err, diff.max().item())
            eq = (got == want).float().mean().item()
            bad = (diff > 2e-5 + rtol * want.abs()).sum().item()
            print(f"[k2] {contract} k={k} out={out_dtype}: rtol={rtol:g} "
                  f"atol=2e-05 bit-equal share {eq:.6f} "
                  f"max |diff| {diff.max().item():.3e} out-of-tol {bad}",
                  flush=True)
            if bad or not torch.isfinite(got).all():
                fail(f"K2 {contract} k={k} {out_dtype} outside tolerance")
    del qkv, got, want

    # ---- 5. the slice: DiT-XL/2, full width, both tiers
    cfg = DiT_models["DiT-XL/2"](input_size=32)
    t0 = time.perf_counter()
    model = init_dit(cfg, torch.Generator().manual_seed(0), dev,
                     randomize_all=True)
    model, specs = prequantize_weights(model, dit_mx_specs(),
                                       serve_dtype=torch.bfloat16)
    print(f"[slice] DiT-XL/2 random weights, prequantized bf16, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    base_q = DiTQuantConfig(mx_specs=specs, mx_quant=True, top_k=True, k=154,
                            ex_pred=True, exclude_blocks=(27,),
                            topk_key_bits=8, activation_dtype="bfloat16")
    per_fwd = {"mx_quantize": 4 * cfg.depth + 2,
               "fused_topk_attention_qkv": cfg.depth}
    wrappers = {"mx_quantize": mx_quantize,
                "fused_topk_attention_qkv": fused_topk_attention_qkv}
    main_launches = {n: 0 for n in wrappers}
    main_sites = {n: collections.Counter() for n in wrappers}
    tiers = {}
    labels = list(range(IMAGES))
    for contract in ("serving", "exact"):
        qc = dataclasses.replace(base_q, contract=contract)
        sample_dit(model, qc, labels, gen, num_steps=2, device=dev)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
            w.sites.clear()
        t0 = time.perf_counter()
        lat = sample_dit(model, qc, labels, gen, num_steps=STEPS, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {n: w.launches for n, w in wrappers.items()}
        for n, w in wrappers.items():
            main_sites[n].update(w.sites)
        for n, c in counts.items():
            main_launches[n] += c
            if c != per_fwd[n] * STEPS:
                fail(f"{contract}: {n} launched {c} times, expected "
                     f"{per_fwd[n]} per forward x {STEPS}")
        if lat.shape != (IMAGES, 4, 32, 32) or not torch.isfinite(lat).all():
            fail(f"{contract}: latents not finite / wrong shape")
        tiers[contract] = dict(imgs_per_s=IMAGES / dt,
                               step_ms=1e3 * dt / STEPS,
                               max_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        print(f"[slice] {contract}: {IMAGES} images x {STEPS} steps in "
              f"{dt:.2f} s = {IMAGES / dt:.4f} imgs/s, step {1e3 * dt / STEPS:.2f} ms, "
              f"max_memory_allocated {tiers[contract]['max_mem_gb']:.2f} GB, "
              f"launches {counts}, latent std {lat.float().std().item():.4g}",
              flush=True)
        for (shape, dtype, *_), c in mx_quantize.sites.items():
            print(f"[slice] {contract}: K1 at {tuple(shape)} {dtype}: {c}")
        for (_, _, _, kw), c in fused_topk_attention_qkv.sites.items():
            kw = dict(kw)
            print(f"[slice] {contract}: K2 {kw['contract']} k={kw['k']}: {c}")

    # ---- 6. where the time goes: serving steps under the profiler (two:
    # respacing to a single step leaves no posterior variance table)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    qc = dataclasses.replace(base_q, contract="serving")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sample_dit(model, qc, labels, gen, num_steps=2, device=dev)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / 2
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 2e3
    print(f"[profile] per serving step (profiled): wall {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.1f} ms ({busy_ms / wall_ms:.1%})")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:16]:
        print(f"[profile] {e.self_device_time_total / 2e3:9.2f} ms/step "
              f"{e.count // 2:6d}x  {e.key[:90]}")
    del model

    # ---- 7. kernel times at every call site the slice launched, weighted
    # by its launches there
    def mix(sites):
        total = sum(st["launches"] for st in sites)
        out = {key: sum(st[key] * st["launches"] for st in sites) / total
               for key in ("ms", "plain_ms", "bound_ms")}
        # the term that sets most of the launch-weighted bound
        share = collections.Counter()
        for st in sites:
            share[st["bound_by"]] += st["bound_ms"] * st["launches"]
        out["bound_by"] = share.most_common(1)[0][0]
        return out

    k1_sites = []
    for (shape, dtype, *args), n in sorted(main_sites["mx_quantize"].items(),
                                           key=lambda kv: -kv[1]):
        x = torch.randn(*shape, generator=gen, device=dev).to(dtype)
        run = lambda: mx_quantize(x, *args)  # noqa: E731
        plain = lambda: mx_quantize_ref(x, *args)  # noqa: E731
        (ms, queued), (pms, _) = time_ms(run, 200), time_ms(plain, 10)
        out_dtype = args[3]
        nbytes = x.numel() * (x.element_size() + out_dtype.itemsize)
        bound = 1e3 * nbytes / HBM_BYTES_PER_S  # ~20 instr/elem: far below
        k1_sites.append(dict(shape=list(shape), dtype=str(dtype),
                             format=args[0], bfloat=args[5], launches=n,
                             ms=ms, plain_ms=pms, bound_ms=bound,
                             bound_by="bytes", queued=queued))
        print(f"[time] K1 {tuple(shape)} {dtype} x{n}: {ms:.4f} ms "
              f"(plain {pms:.3f} ms, bound {bound:.4f} ms by bytes; "
              f"launches queued ahead: {queued})", flush=True)
    k1 = mix(k1_sites)

    k2_sites = []
    for (shape, dtype, heads, kw), n in sorted(
            main_sites["fused_topk_attention_qkv"].items(),
            key=lambda kv: -kv[1]):
        kw = dict(kw)
        x = torch.randn(*shape, generator=gen, device=dev).to(dtype)
        run = lambda: fused_topk_attention_qkv(x, heads, **kw)  # noqa: E731
        plain = lambda: fused_topk_attention_qkv_ref(x, heads, **kw)  # noqa
        (ms, queued), (pms, _) = time_ms(run, 20), time_ms(plain, 2,
                                                           warmup=1)
        b, t, f = shape
        d = f // (3 * heads)
        rows = b * heads * t
        k = min(kw["k"], t)
        nbytes = x.numel() * x.element_size() + \
            b * t * heads * d * kw["out_dtype"].itemsize
        # tensor-core work: true scores and (top-k only) predictor over
        # every (query, key) pair at the true head dim, PV over the k keys
        # each row selects (the serving tier may keep more on ties, which
        # stays below the bytes term even at all t keys); CUDA-core work:
        # a compare per key per bisection pass, plus max, exp, sum and
        # divide of the softmax, for every (query, key) pair.  Memory
        # traffic and both kinds of operations can overlap, so the bound is
        # the largest of the three times
        pairs = rows * t
        topk = kw["k"] < t
        t_tc = 1e3 * (2 * pairs * d * (2 if topk else 1)
                      + 2 * rows * k * d) / BF16_OPS_PER_S
        t_cc = 1e3 * pairs * ((kw["key_bits"] if topk else 0) + 4) \
            / F32_INSTR_PER_S
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        bound, by = max((t_bytes, "bytes"), (t_tc, "operations"),
                        (t_cc, "operations"))
        k2_sites.append(dict(contract=kw["contract"], k=kw["k"],
                             shape=list(shape), dtype=str(dtype), launches=n,
                             ms=ms, plain_ms=pms, bound_ms=bound,
                             bound_by=by, queued=queued))
        print(f"[time] K2 {kw['contract']} k={kw['k']} x{n}: {ms:.4f} ms "
              f"(plain {pms:.2f} ms, bound {bound:.4f} ms by {by}: bytes "
              f"{t_bytes:.4f}, tensor-core ops {t_tc:.4f}, CUDA-core ops "
              f"{t_cc:.4f}; launches queued ahead: {queued})", flush=True)
    k2 = mix(k2_sites)

    kernels = [
        dict(name="mx_quantize", route="triton",
             source="mx_quantization_tpu_torch/ops/kernels/quantize.py",
             replaces="mx_quantization_tpu/ops/kernels/quantize.py:119",
             launches=main_launches["mx_quantize"], max_abs_err=k1_err,
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None, sites=k1_sites),
        dict(name="fused_topk_attention_qkv", route="cuda",
             source="mx_quantization_tpu_torch/csrc/topk_attention_qkv.cu",
             replaces="mx_quantization_tpu/ops/kernels/topk_attention.py:1054",
             launches=main_launches["fused_topk_attention_qkv"],
             max_abs_err=k2_err, ms=k2["ms"], plain_ms=k2["plain_ms"],
             bound_ms=k2["bound_ms"], bound_by=k2["bound_by"],
             library_ms=None, sites=k2_sites),
    ]
    print(json.dumps({"tiers": tiers}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
