#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``mx_quantization_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA GPU (Hopper: the CUDA kernels are built for sm_90a) and the
CUDA toolkit's nvcc.  Phases, in order; any failure exits nonzero:
  1. device: the card's name and power limit; TF32 off
  2. build: K2 and K7 (one source, built in six parts), K3 and K4 (one
     source, built in five parts), K5, K2/K7/K3/K4 at the block sizes
     other than 32 (one source), K8 (the ablation tools' kernel) and K9,
     K10 and K11 (the measurement tools' kernels) from csrc/, one nvcc
     each, started together (K1 and K6 compile through Triton's JIT)
  3. K1 (MX quantize) against its plain version, bit for bit: at the DiT
     shapes (bf16/f32 in, bfloat 0/16), at the PixArt sites (f32 in,
     flush, bfloat 0/32) and at DeiT's five widths (100 x 197 rows, f32,
     bfloat 32)
  4. K2 (fused qkv top-k attention) against its plain version at the DiT
     shape, both contracts, top-k and dense, f32 and bf16 output; K2 and
     K7 on the same values in every predictor of the TPU kernels' qkv
     entries at the DiT site in both tiers, and at N = 384 and 512 on the
     int8 and fp8_e4m3 grids, K7 also against K2; DeiT-base's qkv site in
     two_step (k = 30); and the three DeiT qkv sites (f32 qkv, bfloat 0,
     key_bits 32, N = 197, D = 64, H = 3 / 6 / 12, k = 80 / 60 and dense),
     bit for bit
  5. K3 (split q/k/v top-k attention) against its plain version at the
     three PixArt-alpha 256^2 sites at 200 rows (self top-k two_step k=77,
     self dense, cross dense S=120 with a caption-mask bias), both
     contracts, f32 and bf16 output; the domain cases at a small batch;
     DeiT-base's site ((100, 12, 197, 64) f32, key_bits 32, two_step k=30
     and ELSA).  K4 (the query-tiled long-sequence path of the same
     function) against the same plain version, bit for bit: at the DiT-XL/2
     512^2 sites (8 rows, N = S = 1024, bf16, top-k k=154 ex_pred key_bits
     8 and dense), at PixArt-alpha 1024^2's (2 rows, N = 4096: self top-k
     two_step k=77 and self dense, cross against 120 caption tokens with a
     mask bias, dense and top-k k=60; f32 and bf16), all in both contracts,
     the plain version taken per group of heads; the domain cases at a
     small batch; and K4 against K3 on shapes both take
  6. K5 (LN + modulate + MX quantize), K6 (GELU + MX quantize) and K7
     (split-emission qkv top-k attention) against their plain versions, bit
     for bit: K5 at the DiT site and its domain cases (C from 96 to its
     MAX_CHANNELS, rows in registers and in shared memory), K6 at the DiT fc2
     site, PixArt's fc2 site and in erf form, and at DeiT-base's fc2 site
     (erf, f32, bfloat 32), K7 at the DiT site in both tiers, top-k and
     dense, and K7 against K2 on the same values
  6b. the emulation engine (custom_tpu="ref", plain torch, no kernel): its
     quantizers on CUDA tensors over every key of tests/golden/
     {elemwise,mx}.npz, under the goldens' rule and bit for bit the CPU's;
     the ref linear against the fast one (K1) at the DiT and DeiT linear
     sites, the largest difference printed, within 1e-6; and a serving
     config off the kernels raising, as in JAX
  7. the DiT slice: DiT-XL/2 at full width (random weights from a seed,
     prequantized to bf16), 32 images with CFG (64 rows), 100 DDPM steps,
     serving tier then exact tier, the noise drawn in the server's order;
     after each tier the continuous-batching server (``serving.py``, DDPM,
     32 slots) takes the same 32 requests as one burst: exactly 100
     dispatches, every latent bit-equal to the tier's sample_dit result;
     then the server, serving tier, takes a staggered stream of 48
     requests, one per engine step, at the "25" respacing (slots at
     different depths in one batch); each server run holds its dispatch
     and refill under torch.cuda.set_sync_debug_mode("error"); then the
     fused opt-ins (fuse_ln_modulate, fuse_gelu, qkv_layout="split_t": K5,
     K6, K7), 10 steps per tier; the fused opt-ins in
     two_step_leading_ones (K7 in the new mode; 10 steps per tier); the
     opt-ins' paths and 512^2 were cut from 100 steps to keep the script's
     time; DiT-XL/2 in each other predictor of the
     qkv entry (K2 in every block, 2 steps per tier) and with ELSA (K3);
     then DiT-XL/2 512^2 (N = 1024 tokens: K4 in every block), 4 images
     with CFG (8 rows), 10 DDPM steps, serving tier then exact tier
  7b. the MX block sizes other than 32 (K2, K7, K3 and K4 on the blocks
     kernel, csrc/topk_attention_blocks.cu; K5 with its block a launch
     argument; K1 and K6 likewise): each kernel against its plain version,
     bit for bit, at blocks 8, 16, 64 and 128 at real sites (K2 at DiT's
     site and DeiT-small's f32 site in both tiers, K7 at DiT's
     split-emission site, K3 at PixArt-alpha 256^2's self and
     caption-biased cross sites and at DiT's ELSA site in both tiers, K4
     at DiT-XL/2 512^2's and, at 16 and 64, PixArt-alpha 1024^2's self
     site, K1, K5 and K6 at DiT's sites), timed at 16 and 64; then
     DiT-XL/2 256^2 at full width, 32 images with CFG, at blocks 16 and 64
     in each tier (5 steps, cut from 100), the fused opt-ins at block 16
     (serving, 5 steps), ELSA at block 64 (K3; serving, 2 steps),
     DiT-XL/2 512^2 at block 16 (K4; serving, 2 steps) and DeiT-small at
     block 16 (2 batches of 100), each with its launch counts asserted
     beside the block size; then every call site those paths gave a
     kernel, bit for bit against its plain version
  7c. the ablation tools' path (K8, csrc/topk_attention_ablate.cu): the
     port's four tools (mx_quantization_tpu_torch/tools/attnk_bench.py,
     attnk3_bench.py, servingk_bench.py, passprice_bench.py) run every
     mode string of their TPU counterparts through ``run`` at the TPU
     tools' point (256 cells of 256 tokens, D = 72, k = 154, bf16), with
     every count set to 0 just before and read just after: each variant
     bit for bit against its plain version, then timed, and its output
     against the port's K3 in its tier: bit for bit in exactly the modes
     of ``ablate_common.EQUAL_TO_PROD`` (the all-on exact and serving
     words among them); K8 launched by every variant and no kernel but K3 (the
     tools' prod); every model path of 7 and 8 launches K8 0 times
  7d. the measurement tools' path (K9, csrc/mx_matmul_ablation.cu; K10,
     csrc/kth_select.cu; K11, csrc/lane_quantize.cu): the port's
     mx_matmul_ablation (DiT-XL/2's four linears at 16384 rows, MXINT8,
     block 32), kth_bench (256 cells of 256 x 256, k = 154, the three
     count strategies) and lanequant_bench (DiT-XL/2's fc2 and qkv inputs
     at 16384 rows, bf16, int8 and fp8_e4m3, bfloat 16 and 0) through
     ``run`` at the TPU tools' points, with every count set to 0 just
     before and read just after: each variant bit for bit against its
     plain version, then timed; K11 equal to K1 at every site, K10's three
     strategies equal to torch.kthvalue, K9 within K 2^-24 sum |Q(A) Q(B)|
     of the unfused path (K1 and a cuBLAS bf16 GEMM, f32 out); K9, K10 and
     K11 launched by every variant and no kernel but K1 (the tools'
     comparisons); every model path of 7 and 8 launches K9-K11 0 times
  8. the PixArt slice: PixArt-alpha 256^2 at full width (random weights from
     a seed), 100 prompts with CFG (200 rows), synthetic (100, 120, 4096)
     caption embeds with varying mask lengths, 20 DPM-Solver++ steps, each
     tier; the DeiT slice: DeiT-tiny (ex_pred k=80), DeiT-small (ex_pred
     k=60) and DeiT-base (two_step k=30) at full width and depth (random
     weights from a seed, prequantized), batches of 100 synthetic 224^2
     images through ``workloads/deit.py`` ``evaluate`` (K2 in every
     block, as in JAX), serving tier then exact, DeiT-small also serving
     with ``fuse_gelu`` (K6), warmed, 10 batches timed.  The emulation
     path (slice 11): DeiT-small and DeiT-base on the ref engine (weights
     prequantized through its branch, exact tier) and DeiT-small with
     sparse_impl="gather" on the fused engine, 2 batches each; block 0's
     attention at DeiT-small on the ref engine against K2's exact tier;
     DiT-XL/2 256^2 (16 rows, 2 DDPM steps) and PixArt-alpha 256^2 (16
     rows, 2 DPM-Solver++ steps) on the ref engine, each step time and
     peak device memory printed.  The PixArt server: the 256^2 weights
     prequantized to bf16, K1 and K3 at its sites (64 rows, bf16, key_bits
     8, per-row caption masks) against their plain versions bit for bit,
     then a staggered stream of 48 synthetic captions (mask lengths 8 to
     120), one per engine step, DPM-Solver++ 20 steps, 32 slots, serving
     tier, dispatch and refill under the sync check; each result's largest
     difference from sample_pixart on the same caption and initial latent
     printed, not gated.  PixArt-alpha 1024^2: 5 steps per tier (cut
     from the probe's 20).  Every server run prints imgs/s, latency and
     queue-wait p50/p95 from submit() and the mean engine step
  8e. the end-task path (after PixArt-alpha 256^2, on its model): each of
     T5, the VAE, Inception and CLIP on the card against itself on the CPU
     at a small size; T5-XXL (t5-v1_1-xxl, 4.76 B weights, f32, random from
     a seed on the card) encodes 4 seeded prompts and the empty one (120
     tokens, mask lengths 8 to 120), f32 and MXINT8 (K1 168 launches per
     encode, every other kernel 0; K1 bit for bit at its two new sites),
     then is freed; PixArt-alpha 256^2 samples the 4 prompts for 20 steps;
     the VAE (sd-vae-ft-mse's widths) decodes them, phase 7's 32 DiT
     latents and one 1024^2 latent, and encodes 4 images; the full
     Inception network extracts features (256^2 and 1024^2 inputs); CLIP
     ViT-L/14 embeds the PixArt images and 4 seeded 77-token ids, f32 and
     MXINT8 (K1 218 launches), the score in [0, 100]; then ``accuracy dit``
     (10 samples, 2 steps) and ``accuracy pixart`` (the 4 prompts, 2 steps)
     through their ``main``, reading the VAE, Inception, reference and
     embeds files written to a temporary directory; each step's time and
     peak memory printed
  8t. quantization-aware training (after 8e): the reference torch
     trajectory golden (tests/golden/train_traj.npz, 4 SGD steps, the
     emulation engine) at tests/test_train_trajectory_golden.py's bounds;
     a tiny DiT step (depth 2) on the card against itself on the CPU, the
     loss and every gradient; DiT-XL/2 256^2 at full width and depth
     (random weights, MXINT8 with quantize_backprop, fused engine, exact
     tier, ex_pred k=154, key_bits 8, block 27 dense), batch 32 of VAE
     latents of synthetic images read back through latent_npz_dataset,
     AdamW and the EMA, and DeiT-small 224^2 (ex_pred k=60, batch 64):
     each one warm-up step (K1 and K2 held bit for bit to their plain
     versions at one training-step call each) and 2 timed steps, K1 and
     K2 at their per-step counts (the surrogate backward's K1 included),
     every loss and gradient finite; step time and peak memory printed
     In 7 and 8 every launch count is set to 0 just before a run and read
     just after: each kernel of the path must have launched its per-forward
     count times the steps (DeiT: batches; a server: its dispatches), and
     no other kernel at all (on the ref engine none, with "gather" K1
     only);
     each kernel's launches per call site (shape, dtype, arguments) are
     kept
  9. two serving steps of each sampling path, two engine steps of each
     server's full pool, one serving batch of DeiT-small and of DeiT-base,
     and one DiT-XL/2 training step (its forward, backward and optimizer
     spans from CUDA events) under torch.profiler: device busy share, top
     kernels
 10. kernel times with CUDA events at every call site the paths launched
     (calls queued behind a GPU sleep, so that the host's launch time
     stays out), each site first held bit for bit to its plain version,
     beside their bounds and plain versions, weighted by those launches
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

import collections
import concurrent.futures
import copy
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

DIT_STEPS = 100
# the opt-ins' paths and 512^2, cut from 100 steps (the 1024^2 path from
# the probe's 20) to keep the script's time with the servers' runs, and
# to 10 with the training phase
DIT_OPT_IN_STEPS = 10
DIT_TWO_STEP_STEPS = 10  # the opt-ins path in two_step: ~0.3 s a step
DIT_IMAGES = 32
DIT512_IMAGES = 4  # tools/workload_probe.py dit512_probe
DIT512_STEPS = 10
PIXART_STEPS = 20
PIXART_PROMPTS = 100  # the reference's batch (SURVEY.md, PixArt-alpha 256^2)
CAPTION_TOKENS = 120
PIXART1024_STEPS = 5
# the servers (tools/serving_bench.py operating points): 32 slots (64 model
# rows), a staggered stream of 48 requests, one per engine step; the DiT
# stream at the "25" respacing so that slots at different depths share a
# batch
SERVER_SLOTS = 32
SERVER_SEED = 0  # DiffusionServer's default seed
STAGGERED_REQS = 48
STAGGERED_DIT_STEPS = 25
MODE_PROMPTS = 8
# the end-task phase: T5-XXL encodes T5_PROMPTS seeded prompts and the
# empty one; the accuracy CLIs sample a few images for a few steps (the
# Inception Score's ten splits need ten samples)
T5_PROMPTS = 4
CLIP_TOKENS = 77
ACCURACY_SAMPLES = 10
ACCURACY_STEPS = 2
# the training phase: DiT-XL/2 at 32 latents a card (the official DiT
# train.py's global batch 256 over 8 GPUs), DeiT-small at 64 images (DeiT
# main.py's per-GPU default); one warm-up step, then TRAIN_TIMED_STEPS timed
TRAIN_DIT_BATCH = 32
TRAIN_DEIT_BATCH = 64
TRAIN_TIMED_STEPS = 2
DEIT_BATCH = 100  # tools/workload_probe.py deit_probe
DEIT_BATCHES = 10
DEIT_TOKENS = 197  # 14 x 14 patches and the cls token
EMULATION_BATCHES = 2  # the ref engine's and "gather"'s DeiT runs
EMULATION_STEPS = 2  # the ref engine's DiT and PixArt runs
# the ref engine's DiT run, cut from the main path's 32 images (a step at
# 64 rows takes ~19 s) with the training phase
EMULATION_DIT_IMAGES = 8
# (model, predictor, k): tools/workload_probe.py:127-131
DEIT_POINTS = (("deit_tiny_patch16_224", "ex_pred", 80),
               ("deit_small_patch16_224", "ex_pred", 60),
               ("deit_base_patch16_224", "two_step_leading_ones", 30))
# phase 7b: the block sizes other than 32 held to the plain versions, those
# timed (and run end to end at DiT-XL/2 256^2), and its steps and batches
# (the paths cut from 100 steps, the ELSA and 512^2 runs to 2, to keep the
# phase near 100 s: a DiT step at these blocks takes ~0.7-0.9 s)
OTHER_BLOCKS = (8, 16, 64, 128)
TIMED_BLOCKS = (16, 64)
# 10 steps until phase 7c came in (5 runs at ~0.7-0.9 s a step: ~20 s)
BLOCK_STEPS = 5
BLOCK_SHORT_STEPS = 2
BLOCK_DEIT_BATCHES = 2
# K3's and K4's predictors beyond ex_pred and two_step
NEW_MODES = ("MXINT4", "partial_Q", "partial_K", "true_ex", "threshold_ex",
             "ELSA")


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


def event_ms(fn):
    """``fn()`` and its device ms from CUDA events around the one call (for
    calls of 10 ms and more, where the host's launch time is small)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def attention_bound(cells, n, s, d, in_bytes, out_bytes, k, key_bits, topk,
                    extra_bytes=0, pred="ex_pred"):
    """The least time (ms) and its term for one top-k attention call over
    ``cells`` (row, head) cells of n queries and s keys of width d.  Bytes:
    q, k, v read once and the output written once (plus ``extra_bytes``).
    Tensor-core work: the true scores and (top-k) the predictor over every
    (query, key) pair at the true head dim, PV over the k keys a row
    selects (all s when dense; the serving tier may keep more on ties,
    which stays below the bytes term even at all s).  CUDA-core work at the
    top-k sites: finding the k-th key, one pass of one operation per pair
    for each 8 key bits (a radix histogram), and the softmax's max, exp,
    sum and divide over the k keys a row keeps; when dense, the softmax
    over every pair.  By predictor: ex_pred, two_step, MXINT4, partial and
    threshold_ex one product per pair on the tensor cores; ELSA none there,
    but on the CUDA cores its projection, bits * d multiply-adds (2
    operations) per token and side (bits = d), and per pair the xor and
    popcount of its d / 32 words, their sum, the table read and the norm's
    product; true_ex, as its design computes it, every product (the true
    score, the predictor, PV) as CUDA-core multiply-adds (one instruction
    each).  Memory traffic and both kinds of operations can overlap, so the
    bound is the largest of the three."""
    rows = cells * n
    pairs = rows * s
    nbytes = cells * ((n + 2 * s) * d * in_bytes + n * d * out_bytes) \
        + extra_bytes
    kk = min(k, s)
    tc_pred = topk and pred not in ("ELSA", "true_ex")
    tc_ops = 2 * pairs * d * (2 if tc_pred else 1) + 2 * rows * kk * d
    cc_ops = (pairs * -(-key_bits // 8) if topk else 0) + 4 * rows * kk
    if topk and pred == "ELSA":
        cc_ops += 2 * d * d * (rows + cells * s) + pairs * (2 * -(-d // 32) + 3)
    if pred == "true_ex":
        cc_ops += tc_ops // 2
        tc_ops = 0
    t_tc = 1e3 * tc_ops / BF16_OPS_PER_S
    t_cc = 1e3 * cc_ops / F32_INSTR_PER_S
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    bound, by = max((t_bytes, "bytes"), (t_tc, "operations"),
                    (t_cc, "operations"))
    return bound, by, dict(bytes=t_bytes, tensor_core=t_tc, cuda_core=t_cc)


def mx_ops(fmt, flush, bf16_round, in_bf16):
    """Operations per element of K1's MX quantize as the plain versions
    spell it (``ops/fastquant.py`` ``quantize_blocks`` with scale_first,
    ``bf16_round_half_away``): the f32 cast of a bf16 input 1; the half-away
    bf16 round 4 (add, and, isnan, where); the block maximum 2 (magnitude
    bits, max); the flush 1 (where); the int grids 11 (two multiplies,
    round_half_away's abs, add, floor, sign and multiply, a two-sided clamp,
    two multiplies), the MXFP grids 23 (a multiply; the element exponent's
    and, shift, subtract and clamp; its step's subtract and two-sided
    clamp; two powers of two from bits, 3 + 2; two multiplies; the round,
    5; a two-sided clamp; the block scale); the cast to the output type 1.
    The per-block exponent work (1/32 of an element's) is left out."""
    return (int(in_bf16) + 4 * int(bf16_round) + 2 + int(flush)
            + (11 if fmt.startswith("int") else 23) + 1)


def elementwise_bound(nbytes, ops):
    """The least time (ms) and its term for a pass that moves ``nbytes``
    (each input read once, each output written once) and does ``ops``
    f32 and integer operations on the CUDA cores; they can overlap, so the
    bound is the larger."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_cc = 1e3 * ops / F32_INSTR_PER_S
    bound, by = max((t_bytes, "bytes"), (t_cc, "operations"))
    return bound, by, dict(bytes_ms=t_bytes, cuda_core_ms=t_cc)


def mix(sites):
    """Launch-weighted means of a kernel's per-site times and bounds, and
    the term that sets most of the weighted bound."""
    total = sum(st["launches"] for st in sites)
    out = {key: sum(st[key] * st["launches"] for st in sites) / total
           for key in ("ms", "plain_ms", "bound_ms", "bytes_ms",
                       "cuda_core_ms") if key in sites[0]}
    share = collections.Counter()
    for st in sites:
        share[st["bound_by"]] += st["bound_ms"] * st["launches"]
    out["bound_by"] = share.most_common(1)[0][0]
    return out


def caption_bias(B, S, device, shortest=8):
    """(B, 1, 1, S) additive bias of caption masks whose valid lengths run
    from ``shortest`` to S: (1 - mask) * -10000, as PixArt's forward makes
    it."""
    import torch
    valid = torch.linspace(shortest, S, B, device=device).round()
    mask = (torch.arange(S, device=device)[None] < valid[:, None]).float()
    return ((1 - mask) * -10000.0)[:, None, None, :], mask


def random_pt_inception(seed):
    """pt_inception-2015-12-05's keys with random values: He-scaled conv
    weights, batch norms with random affine parameters and statistics."""
    import torch
    from mx_quantization_tpu_torch.evaluation import inception as inc
    g = torch.Generator().manual_seed(seed)
    shapes = {n: tuple(p.shape)
              for n, p in inc.InceptionV3("cpu").named_parameters()}
    sd = {}
    for pre in inc.inception_checkpoint_names():
        w = shapes[pre + ".w"]
        sd[pre + ".conv.weight"] = torch.randn(w, generator=g) * (
            2.0 / (w[1] * w[2] * w[3])) ** 0.5
        sd[pre + ".bn.weight"] = 0.5 + torch.rand(w[0], generator=g)
        sd[pre + ".bn.bias"] = 0.1 * torch.randn(w[0], generator=g)
        sd[pre + ".bn.running_mean"] = 0.1 * torch.randn(w[0], generator=g)
        sd[pre + ".bn.running_var"] = 0.5 + torch.rand(w[0], generator=g)
    sd["fc.weight"] = 0.05 * torch.randn(inc.NUM_CLASSES, 2048, generator=g)
    sd["fc.bias"] = 0.01 * torch.randn(inc.NUM_CLASSES, generator=g)
    return sd


def endtask(dev, smi, pmodel, pix_q, pix_per_fwd, dit_latents, dit_per_fwd,
            run_path, check_k1):
    """The end-task path at full width with random weights from seeds:
    T5-XXL prompt encoding (f32 and MXINT8, K1 launches per encode counted,
    K1 bit for bit at T5's two new sites), PixArt-alpha 256^2 sampling on
    those embeds, the VAE (PixArt's and DiT's latents, one 1024^2 latent,
    encode_images), the Inception extractor, CLIP ViT-L/14 (f32 and
    MXINT8) and the CLIP score, then ``accuracy dit`` (its FID report
    between phase 7's DiT images and its samples, every metric finite) and
    ``accuracy pixart`` through their ``main`` on files written to a
    temporary directory.  Each module first agrees on a small input with
    itself on the CPU.  Returns each step's ms and peak GB."""
    import tempfile

    import numpy as np
    import torch
    from mx_quantization_tpu_torch.evaluation import inception as inc
    from mx_quantization_tpu_torch.evaluation.clip_score import \
        clip_score_from_features
    from mx_quantization_tpu_torch.evaluation.npz_io import \
        latents_to_images
    from mx_quantization_tpu_torch.models import clip, t5, vae
    from mx_quantization_tpu_torch.workloads import accuracy
    from mx_quantization_tpu_torch.workloads.pixart import (pixart_mx_specs,
                                                            sample_pixart)
    K1 = "mx_quantize"
    specs = pixart_mx_specs()
    stats = {}
    print(f"[endtask] {smi}", flush=True)

    def step(label, fn, per=1):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 1e9
        stats[label] = dict(ms=ms, ms_each=ms / per, peak_gb=peak)
        print(f"[endtask] {label}: {ms:.2f} ms ({ms / per:.2f} ms each of "
              f"{per}), max_memory_allocated {peak:.2f} GB", flush=True)
        return res

    def finite(label, x, shape):
        if tuple(x.shape) != tuple(shape) or not torch.isfinite(x).all():
            fail(f"{label}: {tuple(x.shape)} not finite / not {shape}")

    def agree(label, got, want, rel=1e-4):
        got, want = got.float().cpu(), want.float().cpu()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        print(f"[endtask] {label}: card against CPU max |diff| {err:.3e} "
              f"(largest {scale:.3e})", flush=True)
        if not err <= rel * scale:
            fail(f"{label}: the card's result is not within {rel} of the "
                 "CPU's")

    # 0. each module on the card against itself on the CPU, small inputs
    cpu, gc = torch.device("cpu"), torch.Generator().manual_seed(5)
    tiny_t5 = t5.T5Config(vocab_size=256, d_model=64, d_kv=16, d_ff=128,
                          num_layers=3, num_heads=4,
                          relative_attention_num_buckets=8,
                          relative_attention_max_distance=32)
    mc = t5.init_t5_encoder(tiny_t5, gc, cpu)
    md = t5.T5Encoder(tiny_t5, dev)
    md.load_state_dict(mc.state_dict())
    ids = torch.randint(0, 256, (3, 20), generator=gc)
    msk = (torch.arange(20)[None] < torch.tensor([[20], [11], [1]])).int()
    agree("T5 tiny encode", t5.t5_encode(md, ids, msk),
          t5.t5_encode(mc, ids, msk))
    # MXINT8: K1 on the card, its plain version on the CPU; f32 sums in
    # another order may move an element by one MX grid step (2^-6 of the
    # largest magnitude)
    agree("T5 tiny encode MXINT8", t5.t5_encode(md, ids, msk, specs),
          t5.t5_encode(mc, ids, msk, specs), rel=2.0 ** -6)
    narrow = vae.VaeConfig(block_ch=(32, 64))
    mc = vae.init_vae(narrow, gc, cpu)
    md = vae.AutoencoderKL(narrow, dev)
    md.load_state_dict(mc.state_dict())
    z = torch.randn(2, 4, 6, 5, generator=gc)
    agree("VAE narrow decode", vae.decode_latents(md, z),
          vae.decode_latents(mc, z))
    x = torch.rand(2, 3, 16, 12, generator=gc) * 2 - 1
    agree("VAE narrow encode", vae.encode_images(md, x),
          vae.encode_images(mc, x))
    inc_sd = inc.load_inception_checkpoint(random_pt_inception(0))
    mc, md = inc.InceptionV3(cpu), inc.InceptionV3(dev)
    mc.load_state_dict(inc_sd)
    md.load_state_dict(inc_sd)
    u8 = torch.randint(0, 256, (1, 96, 96, 3), generator=gc,
                       dtype=torch.uint8).numpy()
    fc_, fd_ = (inc.extract_features_batched(m, u8) for m in (mc, md))
    for key in ("pool3", "spatial", "pred"):
        agree(f"Inception {key}", torch.from_numpy(fd_[key]),
              torch.from_numpy(fc_[key]))
    tiny_clip = clip.ClipConfig(
        image_size=28, patch_size=14, v_hidden=64, v_layers=2, v_heads=2,
        v_mlp=128, vocab_size=100, max_positions=16, t_hidden=32,
        t_layers=2, t_heads=2, t_mlp=64, projection_dim=24)
    mc = clip.init_clip(tiny_clip, gc, cpu)
    md = clip.Clip(tiny_clip, dev)
    md.load_state_dict(mc.state_dict())
    px = torch.randn(2, 3, 28, 28, generator=gc)
    agree("CLIP tiny image embeds", clip.clip_image_embed(md, px),
          clip.clip_image_embed(mc, px))
    ids = torch.randint(3, 99, (3, 16), generator=gc)
    agree("CLIP tiny text embeds", clip.clip_text_embed(md, ids, msk[:, :16]),
          clip.clip_text_embed(mc, ids, msk[:, :16]))
    del mc, md

    # 1. T5-XXL: 4 prompts and the empty prompt, seeded ids, 120 tokens
    # (mask lengths 8 to 120; the empty prompt is its end token alone)
    tcfg = t5.T5_CONFIGS["t5-v1_1-xxl"]
    torch.cuda.reset_peak_memory_stats()
    model = step("T5-XXL init on the card (f32)", lambda: t5.init_t5_encoder(
        tcfg, torch.Generator(device=dev).manual_seed(0), dev))
    n_par = sum(p.numel() for p in model.parameters())
    rng = np.random.RandomState(0)
    lengths = [*np.linspace(8, CAPTION_TOKENS, T5_PROMPTS).round().astype(
        int), 1]
    ids = np.zeros((T5_PROMPTS + 1, CAPTION_TOKENS), np.int64)
    for i, n in enumerate(lengths):
        ids[i, :n - 1] = rng.randint(2, tcfg.vocab_size, n - 1)
        ids[i, n - 1] = 1  # T5's end token
    mask = (np.arange(CAPTION_TOKENS)[None] <
            np.array(lengths)[:, None]).astype(np.int32)
    ids, mask = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
    t5.t5_encode(model, ids, mask)  # warm
    emb = run_path("T5-XXL encode", "f32", 1, {}, T5_PROMPTS + 1,
                   lambda: step("T5-XXL encode f32 (5 prompts)",
                                lambda: t5.t5_encode(model, ids, mask),
                                T5_PROMPTS + 1), unit="prompts")
    finite("T5-XXL f32", emb, (T5_PROMPTS + 1, CAPTION_TOKENS, tcfg.d_model))
    t5.t5_encode(model, ids, mask, mx_specs=specs)  # warm
    per_encode = {K1: 7 * tcfg.num_layers}
    embq = run_path("T5-XXL encode MXINT8", "fused", 1, per_encode,
                    T5_PROMPTS + 1,
                    lambda: step("T5-XXL encode MXINT8 (5 prompts)",
                                 lambda: t5.t5_encode(model, ids, mask,
                                                      mx_specs=specs),
                                 T5_PROMPTS + 1), unit="prompts")
    finite("T5-XXL MXINT8", embq, emb.shape)
    rel = ((embq - emb).abs().mean() / emb.abs().mean()).item()
    print(f"[endtask] T5-XXL: {n_par / 1e9:.3f} B parameters; K1 "
          f"{per_encode[K1]} launches per MXINT8 encode and no other kernel "
          f"(asserted); MXINT8 against f32 embeds: mean |diff| / mean |x| "
          f"{rel:.3e}", flush=True)
    for c in (tcfg.d_model, tcfg.d_ff):
        check_k1(torch.randn(T5_PROMPTS + 1, CAPTION_TOKENS, c, device=dev),
                 flush=True, bfloat=32)
    print(f"[k1] T5-XXL's sites ({T5_PROMPTS + 1}, {CAPTION_TOKENS}, "
          f"{tcfg.d_model} / {tcfg.d_ff}) f32 flush bfloat 32: bit-equal",
          flush=True)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del model
    torch.cuda.empty_cache()
    stats["T5-XXL peak_gb"] = peak
    print(f"[endtask] T5-XXL freed: peak {peak:.2f} GB, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated after",
          flush=True)

    # 2. the T5-XXL embeds through PixArt-alpha 256^2, 20 steps
    embeds, null = emb[:T5_PROMPTS], emb[T5_PROMPTS:]
    gen = torch.Generator(device=dev).manual_seed(1)
    sample_pixart(pmodel, pix_q, embeds, mask[:T5_PROMPTS], null, gen,
                  num_steps=1, device=dev)  # warm
    plat = run_path("PixArt-alpha-256 on T5-XXL embeds", "serving",
                    PIXART_STEPS, pix_per_fwd, T5_PROMPTS,
                    lambda: sample_pixart(pmodel, pix_q, embeds,
                                          mask[:T5_PROMPTS], null, gen,
                                          num_steps=PIXART_STEPS,
                                          device=dev))
    finite("PixArt on T5 embeds", plat, (T5_PROMPTS, 4, 32, 32))

    # 3. the VAE (sd-vae-ft-mse's architecture)
    vmodel = step("VAE init on the card", lambda: vae.init_vae(
        vae.VaeConfig(), torch.Generator(device=dev).manual_seed(2), dev))
    vae.decode_latents(vmodel, plat[:1])  # warm
    pix_imgs = step(f"VAE decode PixArt-256 latents ({T5_PROMPTS})",
                    lambda: vae.decode_latents(vmodel, plat), T5_PROMPTS)
    finite("VAE PixArt-256", pix_imgs, (T5_PROMPTS, 3, 256, 256))
    n_dit = len(dit_latents)
    dit_imgs = step(f"VAE decode DiT-256 latents ({n_dit}, batches of 8)",
                    lambda: torch.cat([vae.decode_latents(
                        vmodel, dit_latents[i:i + 8])
                        for i in range(0, n_dit, 8)]), n_dit)
    finite("VAE DiT-256", dit_imgs, (n_dit, 3, 256, 256))
    z = torch.randn(1, 4, 128, 128, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3))
    big = step("VAE decode 1024^2 (1, 4, 128, 128; mid attention over "
               "16,384 tokens)", lambda: vae.decode_latents(vmodel, z))
    finite("VAE 1024^2", big, (1, 3, 1024, 1024))
    enc = step(f"VAE encode_images ({T5_PROMPTS} x 256^2)",
               lambda: vae.encode_images(vmodel, pix_imgs.clamp(-1, 1)),
               T5_PROMPTS)
    finite("VAE encode", enc, (T5_PROMPTS, 4, 32, 32))

    def to_u8(x):
        return latents_to_images(x.float().cpu().numpy())
    pix_u8, dit_u8, big_u8 = to_u8(pix_imgs), to_u8(dit_imgs), to_u8(big)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_endtask_") as tmp:
        # 4. Inception (the full network) and the FID report
        inc_path = os.path.join(tmp, "pt_inception.pth")
        torch.save(random_pt_inception(1), inc_path)
        imodel = inc.InceptionV3(dev)
        imodel.load_state_dict(inc.load_inception_checkpoint(inc_path))
        inc.extract_features_batched(imodel, dit_u8[:2])  # warm
        fd = step(f"Inception features ({n_dit} x 256^2, resized to 299)",
                  lambda: inc.extract_features_batched(imodel, dit_u8),
                  n_dit)
        fb = step("Inception features (1 x 1024^2, antialiased to 299)",
                  lambda: inc.extract_features_batched(imodel, big_u8))
        for f, n in ((fd, n_dit), (fb, 1)):
            if f["pool3"].shape != (n, 2048) or \
                    f["spatial"].shape != (n, 2023) or \
                    not all(np.isfinite(v).all() for v in f.values()):
                fail("Inception features not finite / wrong shape")

        # 5. CLIP ViT-L/14: the PixArt images and seeded 77-token ids
        ccfg = clip.ClipConfig()
        cmodel = step("CLIP ViT-L/14 init on the card", lambda: clip.init_clip(
            ccfg, torch.Generator(device=dev).manual_seed(4), dev))
        px = step(f"CLIP preprocess ({T5_PROMPTS} x 256^2 -> 224^2, "
                  "bicubic)", lambda: clip.preprocess_images(pix_u8, ccfg,
                                                             dev))
        clen = np.linspace(5, CLIP_TOKENS, T5_PROMPTS).round().astype(int)
        cids = np.zeros((T5_PROMPTS, CLIP_TOKENS), np.int64)
        for i, n in enumerate(clen):
            cids[i, :n - 1] = rng.randint(1, ccfg.vocab_size - 2, n - 1)
            cids[i, n - 1] = ccfg.vocab_size - 1  # the end token: highest
        cmask = torch.from_numpy((np.arange(CLIP_TOKENS)[None] <
                                  clen[:, None]).astype(np.int32)).to(dev)
        cids = torch.from_numpy(cids).to(dev)
        clip.clip_image_embed(cmodel, px)  # warm
        clip.clip_text_embed(cmodel, cids, cmask)
        ie = step(f"CLIP image embeds ({T5_PROMPTS})",
                  lambda: clip.clip_image_embed(cmodel, px), T5_PROMPTS)
        te = step(f"CLIP text embeds ({T5_PROMPTS} x {CLIP_TOKENS})",
                  lambda: clip.clip_text_embed(cmodel, cids, cmask),
                  T5_PROMPTS)
        finite("CLIP image", ie, (T5_PROMPTS, ccfg.projection_dim))
        finite("CLIP text", te, (T5_PROMPTS, ccfg.projection_dim))
        score = clip_score_from_features(ie.cpu().numpy(), te.cpu().numpy())
        print(f"[endtask] CLIP score (random towers) {score:.4f}", flush=True)
        if not 0 <= score <= 100:
            fail(f"CLIP score {score} outside [0, 100]")
        for shape in ((T5_PROMPTS, ccfg.num_patches + 1, ccfg.v_hidden),
                      (T5_PROMPTS, ccfg.num_patches + 1, ccfg.v_mlp),
                      (T5_PROMPTS, CLIP_TOKENS, ccfg.t_hidden),
                      (T5_PROMPTS, CLIP_TOKENS, ccfg.t_mlp)):
            check_k1(torch.randn(*shape, device=dev), flush=True, bfloat=32)
        print("[k1] CLIP ViT-L/14's sites f32 flush bfloat 32: bit-equal",
              flush=True)
        per_pair = {K1: 6 * (ccfg.v_layers + ccfg.t_layers) + 2}
        clip.clip_image_embed(cmodel, px, mx_specs=specs)  # warm
        clip.clip_text_embed(cmodel, cids, cmask, mx_specs=specs)
        ieq, teq = run_path(
            "CLIP ViT-L/14 MXINT8 (image and text towers)", "fused", 1,
            per_pair, T5_PROMPTS, lambda: step(
                f"CLIP MXINT8 image + text embeds ({T5_PROMPTS} pairs)",
                lambda: (clip.clip_image_embed(cmodel, px, mx_specs=specs),
                         clip.clip_text_embed(cmodel, cids, cmask,
                                              mx_specs=specs)),
                T5_PROMPTS), unit="pairs")
        scoreq = clip_score_from_features(ieq.cpu().numpy(),
                                          teq.cpu().numpy())
        print(f"[endtask] CLIP score MXINT8 {scoreq:.4f} (f32 {score:.4f})",
              flush=True)
        if not 0 <= scoreq <= 100:
            fail(f"CLIP MXINT8 score {scoreq} outside [0, 100]")
        del cmodel, px, ie, te, ieq, teq

        # 6. accuracy dit and accuracy pixart through their main: the VAE,
        # Inception and reference files and the embeds npz as a user has
        # them, read by the normal loaders
        vae_path = os.path.join(tmp, "vae.bin")
        sd = vmodel.state_dict()
        torch.save({theirs: sd[ours].cpu() for ours, theirs
                    in vae.vae_checkpoint_names().items()}, vae_path)
        del vmodel, sd
        ref_path = os.path.join(tmp, "ref_images.npz")
        np.savez(ref_path, arr_0=dit_u8)
        emb_path = os.path.join(tmp, "t5_embeds.npz")
        np.savez(emb_path, embeds=emb[:T5_PROMPTS].cpu().numpy(),
                 mask=mask[:T5_PROMPTS].cpu().numpy(),
                 null_embeds=emb[T5_PROMPTS:].cpu().numpy())
        common = ["--vae", vae_path, "--ref", ref_path, "--inception",
                  inc_path, "--num-steps", str(ACCURACY_STEPS),
                  "--device", str(dev)]
        rep = run_path(
            "accuracy dit (DiT-XL/2 256^2)", "exact", ACCURACY_STEPS,
            dit_per_fwd, ACCURACY_SAMPLES, lambda: step(
                f"accuracy dit ({ACCURACY_SAMPLES} samples, "
                f"{ACCURACY_STEPS} steps, VAE, Inception, FID)",
                lambda: accuracy.main(
                    ["dit", "--num-samples", str(ACCURACY_SAMPLES),
                     "--batch", str(ACCURACY_SAMPLES), "--out",
                     os.path.join(tmp, "dit.npz")] + common),
                ACCURACY_SAMPLES))
        # the report between two generated sets (phase 7's DiT images and
        # these samples): every metric finite (the Inception Score's ten
        # splits need the ten samples)
        if set(rep) != {"fid", "sfid", "inception_score", "precision",
                        "recall"} or not np.isfinite(list(rep.values())).all():
            fail(f"accuracy dit: {rep}")
        rep = run_path(
            "accuracy pixart (PixArt-alpha 256^2, T5-XXL embeds)", "exact",
            ACCURACY_STEPS, pix_per_fwd, T5_PROMPTS, lambda: step(
                f"accuracy pixart ({T5_PROMPTS} prompts, {ACCURACY_STEPS} "
                "steps, VAE, Inception, FID)",
                lambda: accuracy.main(
                    ["pixart", "--prompt-embeds", emb_path, "--batch",
                     str(T5_PROMPTS), "--out",
                     os.path.join(tmp, "pixart.npz")] + common),
                T5_PROMPTS))
        if rep["samples"] != T5_PROMPTS or not np.isfinite(rep["fid"]):
            fail(f"accuracy pixart: {rep}")
    return stats


def training(dev, smi, run_path, profile, stamp):
    """Phase 8t, quantization-aware training (``workloads/dit_train.py``,
    ``workloads/deit_train.py``): the forward through K1 and K2, the
    backward as the JAX package's custom VJPs in plain torch (the
    surrogate's rematerialized forward launches K1 at its PV or score
    product).  1. the reference torch trajectory golden on the card;
    2. DiT-XL/2 256^2 at full width and depth; 3. DeiT-small 224^2; each
    one warm-up step (K1 and K2 held bit for bit to their plain versions
    at one training-step call each) and TRAIN_TIMED_STEPS timed through
    ``run_path`` (every kernel's launches per step checked), every loss and
    gradient finite; 4. a tiny training step on the card against itself on
    the CPU; and one DiT-XL/2 step under the profiler, with the forward /
    backward / optimizer split from the pieces timed alone.  Returns the
    phase's numbers."""
    import tempfile

    import numpy as np
    import torch
    from mx_quantization_tpu_torch import attention
    from mx_quantization_tpu_torch.data.datasets import latent_npz_dataset
    from mx_quantization_tpu_torch.diffusion import create_diffusion
    from mx_quantization_tpu_torch.models import vae
    from mx_quantization_tpu_torch.models.dit import (DiT, DiT_models,
                                                      DiTConfig,
                                                      DiTQuantConfig,
                                                      dit_forward, init_dit)
    from mx_quantization_tpu_torch.models.vit import (VIT_CONFIGS,
                                                      VitConfig,
                                                      VitQuantConfig,
                                                      init_vit, vit_forward)
    from mx_quantization_tpu_torch.ops.kernels import quantize as k1mod
    from mx_quantization_tpu_torch.ops.kernels import topk_attention as ta
    from mx_quantization_tpu_torch.specs import finalize_mx_specs
    from mx_quantization_tpu_torch.utils.checkpoint import \
        load_dit_checkpoint
    from mx_quantization_tpu_torch.workloads import deit_train, dit_train
    from mx_quantization_tpu_torch.workloads.deit import default_mx_specs
    from mx_quantization_tpu_torch.workloads.dit import dit_mx_specs
    K1, K2 = "mx_quantize", "fused_topk_attention_qkv"
    root = os.path.dirname(os.path.abspath(__file__))
    gold = os.path.join(root, "tests", "golden")
    stats = {}
    diffusion = create_diffusion(None)
    print(f"[train] {smi}", flush=True)

    def finite_grads(label, tensors):
        """Every gradient finite, and some nonzero."""
        grads = [p.grad for p in tensors]
        if any(g is None or not torch.isfinite(g).all() for g in grads):
            fail(f"{label}: a gradient is missing or not finite")
        nonzero = sum(int(g.count_nonzero() > 0) for g in grads)
        if nonzero == 0:
            fail(f"{label}: every gradient is zero")
        print(f"[train] {label}: {len(grads)} gradients finite, "
              f"{nonzero} nonzero", flush=True)

    def warm_up_held(label, fn):
        """Run ``fn`` (a warm-up step) with K1's first call on a 4-D
        tensor (the surrogate's product operand) and K2's first call each
        also run through its plain version on the same input and compared
        bit for bit.  The kernels count on the names they are bound to, so
        the stand-ins carry counters too (the warm-up's counts are not
        read)."""
        held = {}

        def holding(name, kernel, plain, pick):
            def call(*a, **kw):
                out = kernel(*a, **kw)
                if name not in held and pick(a[0]):
                    held[name] = (tuple(a[0].shape),
                                  torch.equal(out, plain(*a, **kw)))
                return out
            call.launches, call.sites = 0, collections.Counter()
            return call
        saved = (k1mod.mx_quantize, attention.fused_topk_attention_qkv)
        k1mod.mx_quantize = holding(K1, saved[0], k1mod.mx_quantize_ref,
                                    lambda x: x.dim() == 4)
        attention.fused_topk_attention_qkv = holding(
            K2, saved[1], ta.fused_topk_attention_qkv_ref, lambda x: True)
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            k1mod.mx_quantize, attention.fused_topk_attention_qkv = saved
        for name in (K1, K2):
            if name not in held or not held[name][1]:
                fail(f"{label}: {name} at a training-step call "
                     f"{held.get(name)} differs from its plain version")
            print(f"[train] {label}: {name} at the training step's "
                  f"{held[name][0]} bit-equal to its plain version",
                  flush=True)
        return out

    # 1. the trajectory golden (tests/test_train_trajectory_golden.py's
    # bounds): 4 SGD steps at lr 1e-3, MXINT8, bfloat 16, quantize_backprop,
    # k = 8, block 1 excluded, on the emulation engine (no kernel)
    golden = np.load(os.path.join(gold, "train_traj.npz"))
    gcfg = DiTConfig(input_size=8, hidden_size=64, depth=2, num_heads=2,
                     num_classes=10, class_dropout_prob=0.0)
    gmodel = DiT(gcfg, dev)
    gmodel.load_state_dict(load_dit_checkpoint(
        os.path.join(gold, "train_sd.pt"), depth=2))
    gspecs = finalize_mx_specs(dict(
        w_elem_format="int8", a_elem_format="int8", scale_bits=8,
        shared_exp_method="max", block_size=32, bfloat=16, fp=0,
        round="nearest", mx_flush_fp32_subnorms=False,
        quantize_backprop=True))
    gq = DiTQuantConfig(mx_specs=gspecs, mx_quant=True, top_k=True, k=8,
                        ex_pred=True, exclude_blocks=(1,))
    opt = torch.optim.SGD(dit_train.trainable_tensors(gmodel), lr=1e-3)
    got = []
    for s in range(4):
        x0, y, t, noise = (torch.from_numpy(golden[f"s{s}_{k}"]).to(dev)
                           for k in ("x0", "y", "t", "noise"))
        terms = diffusion.training_losses(
            lambda xt, tt, y: dit_forward(gmodel, xt, tt, y, gq), x0, t,
            model_kwargs={"y": y}, noise=noise)
        loss = terms["loss"].mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        got.append([loss.item(), terms["mse"].mean().item(),
                    terms["vb"].mean().item()])
    want = [golden["losses"], golden["mses"], golden["vbs"]]
    rel = [[abs(got[s][i] / want[i][s] - 1) for i in range(3)]
           for s in range(4)]
    print(f"[train] trajectory golden on the card: losses "
          f"{[g[0] for g in got]} against {list(golden['losses'])}; "
          f"relative differences {rel}", flush=True)
    if not (rel[0][0] <= 2e-4 and rel[0][1] <= 2e-4 and rel[0][2] <= 2e-3
            and all(r[0] <= 2e-2 for r in rel[1:])
            and got[0][0] > got[-1][0]):
        fail("the trajectory golden on the card is off its bounds")
    stats["trajectory_golden"] = dict(losses=[g[0] for g in got],
                                      rel_err=[r[0] for r in rel])
    stamp("training: golden done")
    del gmodel, opt

    # 4. a tiny training step on the card against itself on the CPU:
    # depth 2, hidden 64, the same weights and inputs; K1 and K2 on the
    # card, their plain versions on the CPU.  The f32 sums add in other
    # orders, which can move an MX grid point: the loss within 1e-5, each
    # gradient within one bf16 step (2^-7) plus 1e-6 on 99% of its elements
    tcfg = DiTConfig(input_size=8, hidden_size=64, depth=2, num_heads=2,
                     num_classes=10)
    tq = DiTQuantConfig(mx_specs=dit_mx_specs().replace(
        quantize_backprop=True), mx_quant=True, top_k=True, k=6,
        exclude_blocks=(1,), topk_key_bits=8)
    gc = torch.Generator().manual_seed(7)
    x0, noise = (torch.randn(2, 4, 8, 8, generator=gc) for _ in range(2))
    y, t = torch.tensor([1, 7]), torch.tensor([0, 637])
    res = []
    for d in ("cpu", dev):
        m = init_dit(tcfg, torch.Generator().manual_seed(0), d,
                     randomize_all=True)
        tensors = dit_train.trainable_tensors(m)
        loss = diffusion.training_losses(
            lambda xt, tt, y: dit_forward(m, xt, tt, y, tq), x0.to(d),
            t.to(d), model_kwargs={"y": y.to(d)},
            noise=noise.to(d))["loss"].mean()
        loss.backward()
        res.append((loss.item(), [p.grad.cpu() for p in tensors]))
    (lc, gcpu), (ld, gdev) = res
    shares = [torch.isclose(a, b, rtol=2.0 ** -7, atol=1e-6).float().mean()
              .item() for a, b in zip(gdev, gcpu)]
    print(f"[train] tiny step, card against CPU: loss {ld:.7g} against "
          f"{lc:.7g}; gradients within one bf16 step on at least "
          f"{min(shares):.4f} of each tensor's elements", flush=True)
    if not (abs(ld / lc - 1) <= 1e-5 and min(shares) >= 0.99
            and all(torch.isfinite(g).all() for g in gdev)):
        fail("the tiny training step on the card is off the CPU's")
    stats["tiny_card_vs_cpu"] = dict(loss_rel=abs(ld / lc - 1),
                                     min_share=min(shares))

    # 2. DiT-XL/2 256^2 quantization-aware training: random weights from a
    # seed, MXINT8 as dit_mx_specs() with quantize_backprop, the fused
    # engine, exact tier, ex_pred k = 154, key_bits 8, block 27 dense; f32
    # activations; batch 32 a card (the DiT train.py's global 256 over 8);
    # synthetic 256^2 images through the VAE into an npz read back by
    # latent_npz_dataset
    cfg = DiT_models["DiT-XL/2"](input_size=32)
    n = TRAIN_DIT_BATCH * (TRAIN_TIMED_STEPS + 2)
    gen = torch.Generator(device=dev).manual_seed(11)
    vm = vae.init_vae(vae.VaeConfig(), torch.Generator(device=dev)
                      .manual_seed(3), dev)
    imgs = torch.rand(n, 3, 256, 256, generator=gen, device=dev) * 2 - 1
    lat = torch.cat([vae.encode_images(vm, imgs[i:i + 16], generator=gen)
                     for i in range(0, n, 16)])
    labels = torch.randint(0, cfg.num_classes, (n,), generator=gen,
                           device=dev)
    del vm, imgs
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "latents.npz")
        np.savez(path, latents=lat.cpu().numpy(),
                 labels=labels.cpu().numpy())
        np.random.seed(0)
        data = latent_npz_dataset(path, TRAIN_DIT_BATCH)
        batches = [tuple(torch.from_numpy(a).to(dev) for a in next(data))
                   for _ in range(TRAIN_TIMED_STEPS + 2)]
    if not all(torch.isfinite(b[0]).all() for b in batches):
        fail("DiT training: the VAE latents are not finite")
    print(f"[train] DiT-XL/2: {n} synthetic 256^2 images through the VAE, "
          f"latent std {lat.std().item():.4g}, batches of "
          f"{TRAIN_DIT_BATCH} from latent_npz_dataset", flush=True)
    del lat
    t0 = time.perf_counter()
    model = init_dit(cfg, torch.Generator().manual_seed(0), dev,
                     randomize_all=True)
    qcfg = DiTQuantConfig(mx_specs=dit_mx_specs().replace(
        quantize_backprop=True), mx_quant=True, top_k=True, k=154,
        ex_pred=True, exclude_blocks=(27,), topk_key_bits=8)
    tensors = dit_train.trainable_tensors(model)
    ema = [p.detach().clone() for p in tensors]
    opt = torch.optim.AdamW(tensors, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.0)
    step = dit_train.make_train_step(model, ema, qcfg, diffusion, opt)
    tgen = torch.Generator(device=dev).manual_seed(12)
    print(f"[train] DiT-XL/2 random weights, optimizer and EMA in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def dit_steps(bs):
        losses = []
        for x0, y in bs:
            t, noise, _ = dit_train.draw_timesteps_and_noise(
                tgen, x0, diffusion.num_timesteps)
            losses.append(step(x0, y, t, noise))
        return torch.stack(losses)

    # per step: the forward's K1 in front of the 4 quantized linears of
    # each block and the final layer's 2, the surrogate's K1 at each
    # block's PV product (the (B, 16, 256, 256) probabilities; its score
    # product's q is 72 wide, no whole blocks, so plain torch); K2 in
    # every block (block 27 dense)
    depth = cfg.depth
    per_step = {K1: 5 * depth + 2, K2: depth}
    _, warm_ms = event_ms(lambda: warm_up_held(
        "DiT-XL/2 QAT", lambda: dit_steps(batches[:1])))
    losses, step_ms = event_ms(lambda: run_path(
        "DiT-XL/2 256 QAT train", "exact", TRAIN_TIMED_STEPS, per_step,
        TRAIN_DIT_BATCH * TRAIN_TIMED_STEPS,
        lambda: dit_steps(batches[1:1 + TRAIN_TIMED_STEPS]), unit="images"))
    step_ms /= TRAIN_TIMED_STEPS
    if not torch.isfinite(losses).all():
        fail(f"DiT training: losses {losses.tolist()} not finite")
    finite_grads("DiT-XL/2 QAT", tensors)
    print(f"[train] DiT-XL/2 QAT: warm-up step {warm_ms:.0f} ms, losses "
          f"{losses.tolist()}", flush=True)
    stats["dit_xl2_256"] = dict(batch=TRAIN_DIT_BATCH, warm_ms=warm_ms,
                                losses=losses.tolist(), per_step=per_step)
    stamp("training: DiT-XL/2 steps done")

    # 9. one DiT-XL/2 step under the profiler: the port's own step.  The
    # forward / backward / optimizer split: CUDA events around a forward
    # alone (its loss, the graph built and then dropped) and around the
    # optimizer + EMA alone (on the profiled step's gradients); the
    # backward is the rest of the timed steps' mean
    x0, y = batches[-1]
    t, noise, _ = dit_train.draw_timesteps_and_noise(
        tgen, x0, diffusion.num_timesteps)
    profile("DiT-XL/2 256 QAT train step", lambda: step(x0, y, t, noise), 1)
    _, fwd = event_ms(lambda: diffusion.training_losses(
        lambda xt, tt, y: dit_forward(model, xt, tt, y, qcfg), x0, t,
        model_kwargs={"y": y}, noise=noise)["loss"].mean())
    _, upd = event_ms(lambda: (opt.step(),
                               dit_train.update_ema(ema, tensors)))
    bwd = step_ms - fwd - upd
    print(f"[train] DiT-XL/2 QAT step split: step {step_ms:.1f} ms (timed "
          f"steps' mean), forward {fwd:.1f} ms, optimizer + EMA {upd:.1f} "
          f"ms, so backward {bwd:.1f} ms ({bwd / step_ms:.1%})", flush=True)
    stats["dit_xl2_256"].update(step_ms=step_ms, forward_ms=fwd,
                                backward_ms=bwd, optimizer_ms=upd)
    stamp("training: DiT-XL/2 profile done")
    del model, ema, opt, tensors, step, batches

    # 3. DeiT-small 224^2: DeiT's specs with quantize_backprop, ex_pred
    # k = 60, batch 64 (DeiT main.py's per-GPU default), synthetic images
    vcfg = VIT_CONFIGS["deit_small_patch16_224"]
    vmodel = init_vit(vcfg, torch.Generator().manual_seed(0), dev)
    vq = VitQuantConfig(mx_specs=default_mx_specs().replace(
        quantize_backprop=True), mx_quant=True, top_k=True, k=60,
        pred_mode="ex_pred")
    vmodel.requires_grad_(True)
    vt = list(vmodel.parameters())
    vema = [p.detach().clone() for p in vt]
    vopt = torch.optim.AdamW(vt, lr=5e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.05)
    steps = TRAIN_TIMED_STEPS + 1
    vstep = deit_train.make_train_step(vmodel, vema, vq, vopt, 5e-4, steps)
    vbatches = [(torch.randn(TRAIN_DEIT_BATCH, 3, 224, 224, generator=gen,
                             device=dev),
                 torch.randint(0, 1000, (TRAIN_DEIT_BATCH,), generator=gen,
                               device=dev)) for _ in range(steps)]

    def deit_steps(first, bs):
        return torch.stack([vstep(first + i, x, y)
                            for i, (x, y) in enumerate(bs)])
    # per step: K1 in front of the 4 quantized linears of each block and at
    # the surrogate's score product (q, 64 wide; its PV operand is 197
    # wide, no whole blocks); K2 in every block (block 11 dense)
    vper = {K1: 5 * vcfg.depth, K2: vcfg.depth}
    _, vwarm = event_ms(lambda: warm_up_held(
        "DeiT-small QAT", lambda: deit_steps(0, vbatches[:1])))
    vlosses = run_path("DeiT-small QAT train", "exact", TRAIN_TIMED_STEPS,
                       vper, TRAIN_DEIT_BATCH * TRAIN_TIMED_STEPS,
                       lambda: deit_steps(1, vbatches[1:]))
    if not torch.isfinite(vlosses).all():
        fail(f"DeiT training: losses {vlosses.tolist()} not finite")
    finite_grads("DeiT-small QAT", vt)
    print(f"[train] DeiT-small QAT: warm-up step {vwarm:.0f} ms, losses "
          f"{vlosses.tolist()}", flush=True)
    stats["deit_small_224"] = dict(batch=TRAIN_DEIT_BATCH, warm_ms=vwarm,
                                   losses=vlosses.tolist(), per_step=vper)
    del vmodel, vema, vopt, vt, vbatches
    torch.cuda.empty_cache()
    return stats


def main():
    import torch
    start = time.perf_counter()

    def stamp(what):
        print(f"[clock] {what} at {time.perf_counter() - start:.1f} s",
              flush=True)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    from mx_quantization_tpu_torch.attention import (TopKAttentionConfig,
                                                      _topk_mask,
                                                      fused_qkv_topk_attention,
                                                      predict_scores,
                                                      topk_attention)
    from mx_quantization_tpu_torch.formats import format_params
    from mx_quantization_tpu_torch.models.dit import (DiT_models,
                                                      DiTQuantConfig, init_dit)
    from mx_quantization_tpu_torch.models.pixart import (PixArtConfig,
                                                         PixArtQuantConfig,
                                                         init_pixart)
    from mx_quantization_tpu_torch.models.vit import (VIT_CONFIGS,
                                                      VitQuantConfig,
                                                      init_vit, layer_norm,
                                                      vit_embed, vit_forward)
    from mx_quantization_tpu_torch.ops.linear import linear
    from mx_quantization_tpu_torch.ops.kernels import build, tpu_site
    from mx_quantization_tpu_torch.ops.kernels import kth_select as kthsel
    from mx_quantization_tpu_torch.ops.kernels import lane_quantize as laneq
    from mx_quantization_tpu_torch.ops.kernels import mx_matmul as mxmm
    from mx_quantization_tpu_torch.ops.kernels import \
        ln_modulate_quantize as lnq
    from mx_quantization_tpu_torch.ops.kernels import topk_ablate as ab
    from mx_quantization_tpu_torch.ops.kernels import topk_attention as ta
    from mx_quantization_tpu_torch.predictors.elsa import orthogonal_matrix
    from mx_quantization_tpu_torch.tools import ablate_common as abc
    from mx_quantization_tpu_torch.tools import kth_bench as kth_tool
    from mx_quantization_tpu_torch.tools import lanequant_bench as lane_tool
    from mx_quantization_tpu_torch.tools import mx_matmul_ablation as mm_tool
    from mx_quantization_tpu_torch.tools import serving_bench as sb
    from mx_quantization_tpu_torch.tools.passprice_bench import \
        deltas as passprice_deltas
    from mx_quantization_tpu_torch.ops.kernels.quantize import (
        gelu_quantize, gelu_quantize_ref, mx_quantize, mx_quantize_ref)
    from mx_quantization_tpu_torch.utils.prequantize import prequantize_weights
    from mx_quantization_tpu_torch.workloads.dit import (dit_mx_specs,
                                                         sample_dit)
    from mx_quantization_tpu_torch.workloads.pixart import (pixart_mx_specs,
                                                            sample_pixart)
    from mx_quantization_tpu_torch.workloads.deit import (default_mx_specs,
                                                          evaluate)
    K1, K2, K3 = "mx_quantize", "fused_topk_attention_qkv", \
        "fused_topk_attention"
    K4 = "fused_topk_attention_tiled"
    K5, K6, K7 = "ln_modulate_quantize", "gelu_quantize", \
        "fused_topk_attention_qkv_t"
    K8 = "ablate_attention"
    K9, K10, K11 = "mx_matmul", "kth_select", "lane_quantize"
    wrappers = {K1: mx_quantize, K2: ta.fused_topk_attention_qkv,
                K3: ta.fused_topk_attention,
                K4: ta.fused_topk_attention_tiled,
                K5: lnq.ln_modulate_quantize,
                K6: gelu_quantize, K7: ta.fused_topk_attention_qkv_t,
                K8: ab.ablate_attention, K9: mxmm.mx_matmul,
                K10: kthsel.kth_select, K11: laneq.lane_quantize}

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

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(*shape, generator=gen, device=dev)
                ).to(dtype)

    # ---- 2. build, one nvcc per source, all started together (K2's and
    # K7's builds at the other MX blocks: the parts phase 7b launches, the
    # int grids' ex_pred by packed and radix selection at every block, and
    # at TIMED_BLOCKS the paths' dense calls, part 4)
    t0 = time.perf_counter()
    sources = (*ta.qkv_builds(), *ta.split_builds(),
               *(sd for bs in OTHER_BLOCKS for i, sd in
                 enumerate(ta.qkv_builds(bs))
                 if i < 2 or (i == 4 and bs in TIMED_BLOCKS)),
               (lnq.SOURCE, lnq.DEFINES),
               (ta.BLOCKS_SOURCE, ta.BLOCK_DEFINES), (ab.SOURCE, ()),
               (mxmm.SOURCE, ()), (kthsel.SOURCE, ()), (laneq.SOURCE, ()))
    def timed_build(sd):
        t = time.perf_counter()
        return build.build(*sd), time.perf_counter() - t

    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(timed_build, sources))
    libs = [lib for lib, _ in built]
    print(f"[build] {[lib.name for lib in libs]} in "
          f"{time.perf_counter() - t0:.1f} s")
    print("[build] per source (s): " + ", ".join(
        f"{lib.name} {s:.1f}" for lib, s in
        sorted(built, key=lambda b: -b[1])), flush=True)
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Function pro" in line:
                print(f"[build] {line.strip()[:150]}")

    stamp("build done")
    # ---- 3. K1 against its plain version, bit for bit
    k1_err = 0.0

    def check_k1(x, fmt="int8", **kw):
        nonlocal k1_err
        got = mx_quantize(x, fmt, 32, 8, **kw)
        want = mx_quantize_ref(x, fmt, 32, 8, **kw)
        torch.cuda.synchronize()
        k1_err = max(k1_err, (got.float() - want.float()).abs().max().item())
        if not torch.equal(got, want):
            fail(f"K1 {tuple(x.shape)} {x.dtype} {fmt} {kw} differs")

    # the DiT sites: bf16 and f32 input, bfloat 0/16
    for K in (1152, 4608):
        base = randn(16384, K)
        for dtype in (torch.bfloat16, torch.float32):
            for fmt in ("int8", "fp8_e4m3"):
                for bfloat in (0, 16):
                    check_k1(base.to(dtype), fmt, bfloat=bfloat)
        print(f"[k1] (16384, {K}) bf16/f32 x int8/fp8_e4m3 x bfloat 0/16: "
              "bit-equal", flush=True)
    del base
    # the PixArt sites: f32 activations, flush, bfloat=32 (the identity)
    B2 = 2 * PIXART_PROMPTS
    for shape in ((B2, 256, 1152), (B2, CAPTION_TOKENS, 1152),
                  (B2, 256, 4608)):
        x = randn(*shape)
        x[0, 0, :32] = 1e-39   # a block of subnormals: flushed
        x[1, 3, 32:64] *= 1e-38
        for bfloat in (0, 32):
            check_k1(x, flush=True, bfloat=bfloat)
        print(f"[k1] {shape} f32 flush bfloat 0/32: bit-equal", flush=True)
    del x
    # the DeiT sites: f32 activations, bfloat=32 (the identity), no flush
    for c in (192, 384, 768, 1536, 3072):
        check_k1(randn(DEIT_BATCH, DEIT_TOKENS, c), bfloat=32)
    print(f"[k1] DeiT ({DEIT_BATCH}, {DEIT_TOKENS}, 192/384/768/1536/3072) "
          "f32 bfloat 32: bit-equal", flush=True)

    # ---- 4. K2 against its plain version at the DiT shape
    B, N, H, D = 2 * DIT_IMAGES, 256, 16, 72
    qkv = randn(B, N, 3 * H * D, dtype=torch.bfloat16)
    k2_err = 0.0
    for contract, k in (("serving", 154), ("serving", N), ("exact", 154),
                        ("exact", N)):
        for out_dtype in (torch.float32, torch.bfloat16):
            kw = dict(k=k, scale=D ** -0.5, key_bits=8, bfloat=16,
                      contract=contract, out_dtype=out_dtype)
            got = ta.fused_topk_attention_qkv(qkv, H, **kw)
            want = ta.fused_topk_attention_qkv_ref(qkv, H, **kw)
            torch.cuda.synchronize()
            # the kernel and the plain version share arithmetic and
            # summation order: f32 output bit-equal; bf16 output (the RNE
            # cast of the same f32 values) also held bit for bit
            diff = (got.float() - want.float()).abs()
            k2_err = max(k2_err, diff.max().item())
            eq = (got == want).float().mean().item()
            print(f"[k2] {contract} k={k} out={out_dtype}: bit-equal share "
                  f"{eq:.6f} max |diff| {diff.max().item():.3e}", flush=True)
            if not torch.equal(got, want) or not torch.isfinite(got).all():
                fail(f"K2 {contract} k={k} {out_dtype} differs from its "
                     "plain version")
    # every predictor of the TPU kernels' qkv entries, K2 and K7 on the same
    # values (K7's operands cut from the same qkv), each bit for bit to its
    # plain version and K7 to K2: at the DiT site in both tiers, and at N =
    # 384 and 512 (the radix select; fewer warps or two phases where a cell
    # does not fit) on the int8 and fp8_e4m3 grids, key_bits 8 and 32
    k7_err = 0.0

    def check_qkv(label, qkv, H, **kw):
        nonlocal k2_err, k7_err
        B, N, F = qkv.shape
        D = F // (3 * H)
        Dp = -(-D // 32) * 32
        qk = torch.nn.functional.pad(
            qkv[..., :2 * H * D].reshape(B, N, 2, H, D), (0, Dp - D))
        qk_t = qk.permute(2, 3, 4, 0, 1).reshape(2 * H * Dp, B, N)
        v = qkv[..., 2 * H * D:].contiguous()
        got = ta.fused_topk_attention_qkv(qkv, H, **kw)
        want = ta.fused_topk_attention_qkv_ref(qkv, H, **kw)
        k7 = ta.fused_topk_attention_qkv_t(qk_t.contiguous(), v, H,
                                           n_valid=N, **kw)
        torch.cuda.synchronize()
        d2 = (got.float() - want.float()).abs().max().item()
        d7 = (k7.float() - got.float()).abs().max().item()
        k2_err, k7_err = max(k2_err, d2), max(k7_err, d7)
        lib0 = ta._qkv_library(0)
        args = ta.qkv_call_args(N, N, D, {"approx": True, "ebits": 0, **kw})
        plan = lib0.topk_attention_qkv_plan(*args)
        print(f"[k2/k7] {label}: max |diff| {d2:.3e} (K7 - K2 {d7:.3e}); "
              f"warps {plan & 15}, two phases {bool(plan & 16)}, radix "
              f"{bool(plan & 32)}, key cache {bool(plan & 64)}, shared "
              f"memory {lib0.topk_attention_qkv_smem_bytes(*args)} B, part "
              f"{lib0.topk_attention_qkv_part(*args)}", flush=True)
        if not torch.equal(got, want) or not torch.isfinite(got).all():
            fail(f"K2 {label} differs from its plain version")
        if not torch.equal(k7, got):
            fail(f"K7 {label} differs from K2 (its plain version's)")

    qkv = randn(B, N, 3 * H * D, dtype=torch.bfloat16)
    for mode in ta.QKV_PRED_MODES:
        for contract in ("serving", "exact"):
            check_qkv(f"DiT site {mode} {contract}", qkv, H, k=154,
                      scale=D ** -0.5, key_bits=8, bfloat=16,
                      pred_mode=mode, contract=contract,
                      out_dtype=torch.bfloat16)
    for n in (384, 512):
        qkv = randn(8, n, 3 * H * D, dtype=torch.bfloat16)
        for fmt in ("int8", "fp8_e4m3"):
            ebits, mbits, emax, max_norm, _ = format_params(fmt)
            for mode in ta.QKV_PRED_MODES:
                for contract, kb in (("serving", 8), ("exact", 32)):
                    check_qkv(f"N={n} {fmt} {mode} {contract} "
                              f"key_bits={kb}", qkv, H, k=n * 3 // 5,
                              scale=D ** -0.5, key_bits=kb, bfloat=16,
                              ebits=ebits, mbits=mbits, emax=emax,
                              max_norm=max_norm, pred_mode=mode,
                              contract=contract, out_dtype=torch.bfloat16)
    # the DeiT qkv sites: f32 qkv, bfloat 0, key_bits 32, N = 197 (keys and
    # tokens padded to 224), D = 64; DeiT-base's top-k blocks in two_step
    # (k = 30) and its dense block 11
    qkv = randn(DEIT_BATCH, DEIT_TOKENS, 3 * 12 * 64)
    for contract in ("serving", "exact"):
        check_qkv(f"DeiT-base two_step k=30 {contract}", qkv, 12, k=30,
                  scale=64 ** -0.5, key_bits=32,
                  pred_mode="two_step_leading_ones", contract=contract)
    for H, topk in ((3, 80), (6, 60), (12, None)):
        qkv = randn(DEIT_BATCH, DEIT_TOKENS, 3 * H * 64)
        for contract in ("serving", "exact"):
            for k in (topk, DEIT_TOKENS) if topk else (DEIT_TOKENS,):
                kw = dict(k=k, scale=64 ** -0.5, key_bits=32, bfloat=0,
                          contract=contract, out_dtype=torch.float32)
                got = ta.fused_topk_attention_qkv(qkv, H, **kw)
                want = ta.fused_topk_attention_qkv_ref(qkv, H, **kw)
                torch.cuda.synchronize()
                diff = (got - want).abs().max().item()
                k2_err = max(k2_err, diff)
                print(f"[k2] DeiT H={H} {contract} k={k} f32: max |diff| "
                      f"{diff:.3e}", flush=True)
                if not torch.equal(got, want) or \
                        not torch.isfinite(got).all():
                    fail(f"K2 DeiT H={H} {contract} k={k} differs from its "
                         "plain version")
    del qkv, got, want

    # ---- 5. K3 against its plain version, bit for bit (f32 and bf16
    # output: the bf16 output is the RNE cast of the same f32 values)
    k3_err = 0.0
    mode_times = []  # phase 5's timed checks of the modes

    def check_k3(label, q, keys, values, bias, timed=False, **kw):
        """Hold K3 to its plain version; with ``timed``, the device ms of
        a second kernel call and of the plain version's call."""
        nonlocal k3_err
        got, ms = event_ms(lambda: ta.fused_topk_attention(q, keys, values,
                                                          bias, **kw))
        want, pms = event_ms(lambda: ta.fused_topk_attention_ref(
            q, keys, values, bias, **kw))
        if timed:
            _, ms = event_ms(lambda: ta.fused_topk_attention(
                q, keys, values, bias, **kw))
        g, w = got.float(), want.float()
        diff = (g - w).abs()
        k3_err = max(k3_err, diff.max().item())
        eq = (got == want).float().mean().item()
        ok = torch.equal(got, want)
        print(f"[k3] {label} {kw.get('contract', 'exact')} "
              f"out={kw.get('out_dtype', torch.float32)}: bit-equal share "
              f"{eq:.6f} max |diff| {diff.max().item():.3e}"
              + (f"; {ms:.3f} ms (plain {pms:.1f} ms)" if timed else ""),
              flush=True)
        if not ok or not torch.isfinite(got).all():
            fail(f"K3 {label} {kw} differs from its plain version")
        return ms, pms

    H, D = 16, 72
    pix = dict(scale=D ** -0.5, key_bits=32, flush=True, bfloat=0)
    q = randn(B2, H, 256, D, scale=4.0)
    kx = randn(B2, H, 256, D, scale=4.0)
    vx = randn(B2, H, 256, D)
    kc = randn(B2, H, CAPTION_TOKENS, D, scale=4.0)
    vc = randn(B2, H, CAPTION_TOKENS, D)
    bias, _ = caption_bias(B2, CAPTION_TOKENS, dev)
    for contract in ("exact", "serving"):
        for out_dtype in (torch.float32, torch.bfloat16):
            kw = dict(pix, contract=contract, out_dtype=out_dtype)
            check_k3("self top-k two_step k=77", q, kx, vx, None, k=77,
                     pred_mode="two_step_leading_ones", **kw)
            check_k3("self dense", q, kx, vx, None, k=256, approx=False, **kw)
            check_k3("cross dense S=120 bias", q, kc, vc, bias, k=120,
                     approx=False, **kw)
    del q, kx, vx, kc, vc
    # the domain at a small batch: ex_pred, true-score top-k, cross top-k
    # with the bias, N = S = 512, N = 300 with S = 77, bf16 input, a
    # subnormal block under flush; S = 512 at D = 128 with two_step (the
    # K side streamed in chunks) and S != N there; the MXFP formats
    b, h = 2, 4

    def small(n, s, dtype=torch.float32, d=D):
        return (randn(b, h, n, d, scale=4.0, dtype=dtype),
                randn(b, h, s, d, scale=4.0, dtype=dtype),
                randn(b, h, s, d, dtype=dtype))

    sq, sk, sv = small(256, 256)
    cq, ck, cv = small(256, CAPTION_TOKENS)
    cbias, _ = caption_bias(b, CAPTION_TOKENS, dev)
    lq, lk, lv = small(512, 512)
    rq, rk, rv = small(300, 77)
    rbias, _ = caption_bias(b, 77, dev)
    hq, hk, hv = small(256, 256, torch.bfloat16)
    fq, fk, fv = small(256, 256)
    fk[0, 1, 9, 32:64] = 1e-39
    fv[1, 2, 64:96, 5] = 2e-39
    fq[1, 0, 4, :32] = -3e-40
    wq, wk, wv = small(512, 512, d=128)
    xq, xk, xv = small(320, 512, d=128)
    xbias, _ = caption_bias(b, 512, dev, shortest=300)
    ebits8, mbits8, emax8, norm8, _ = format_params("fp8_e4m3")
    fmt8 = dict(ebits=ebits8, mbits=mbits8, emax=emax8, max_norm=norm8)
    cases = [
        ("ex_pred k=77", (sq, sk, sv, None),
         dict(k=77, pred_mode="ex_pred")),
        ("approx off k=77", (sq, sk, sv, None), dict(k=77, approx=False)),
        ("cross top-k two_step k=20 bias", (cq, ck, cv, cbias),
         dict(k=20, pred_mode="two_step_leading_ones")),
        ("cross top-k ex_pred k=20 bias", (cq, ck, cv, cbias),
         dict(k=20, pred_mode="ex_pred")),
        ("N=S=512 two_step k=77", (lq, lk, lv, None),
         dict(k=77, pred_mode="two_step_leading_ones")),
        ("N=S=512 dense", (lq, lk, lv, None), dict(k=512)),
        ("N=300 S=77 two_step k=20 bias", (rq, rk, rv, rbias),
         dict(k=20, pred_mode="two_step_leading_ones")),
        ("bf16 input two_step k=77", (hq, hk, hv, None),
         dict(k=77, pred_mode="two_step_leading_ones")),
        ("bf16 input bfloat=16 ex_pred k=77 key_bits=8", (hq, hk, hv, None),
         dict(k=77, pred_mode="ex_pred", bfloat=16, key_bits=8)),
        ("subnormal blocks under flush two_step k=77", (fq, fk, fv, None),
         dict(k=77, pred_mode="two_step_leading_ones")),
        ("N=S=512 D=128 two_step k=77 (streamed)", (wq, wk, wv, None),
         dict(k=77, pred_mode="two_step_leading_ones")),
        ("N=320 S=512 D=128 two_step k=50 bias (streamed)",
         (xq, xk, xv, xbias), dict(k=50, pred_mode="two_step_leading_ones")),
        ("cross fp8_e4m3 two_step k=20 bias", (cq, ck, cv, cbias),
         dict(k=20, pred_mode="two_step_leading_ones", **fmt8)),
        ("fp8_e4m3 ex_pred k=77 bfloat=16", (sq, sk, sv, None),
         dict(k=77, pred_mode="ex_pred", bfloat=16, **fmt8)),
    ]
    for label, args, extra in cases:
        for contract in ("exact", "serving"):
            for out_dtype in (torch.float32, torch.bfloat16):
                kw = dict(pix, contract=contract, out_dtype=out_dtype)
                kw.update(extra)
                check_k3(label, *args, **kw)
    # K4 against K3 at N = S = 512, bit for bit
    for label, args, extra in (
            ("N=S=512 two_step k=77", (lq, lk, lv, None),
             dict(k=77, pred_mode="two_step_leading_ones")),
            ("N=S=512 D=128 ex_pred k=77 key_bits 8", (wq, wk, wv, None),
             dict(k=77, pred_mode="ex_pred", key_bits=8))):
        for contract in ("exact", "serving"):
            kw = dict(pix, contract=contract)
            kw.update(extra)
            same = torch.equal(ta.fused_topk_attention_tiled(*args, **kw),
                               ta.fused_topk_attention(*args, **kw))
            print(f"[k4] against K3, {label} {contract}: bit-equal {same}",
                  flush=True)
            if not same:
                fail(f"K4 and K3 differ at {label} {contract}")
    del cases, sq, sk, sv, cq, ck, cv, lq, lk, lv, rq, rk, rv, hq, hk, hv
    del fq, fk, fv, wq, wk, wv, xq, xk, xv
    # DeiT-base's split site: (100, 12, 197, 64) f32, key_bits 32, no flush,
    # two_step k = 30 (the operating point) and ELSA (--pred-mode)
    dq_, dk_ = (randn(DEIT_BATCH, 12, DEIT_TOKENS, 64, scale=4.0)
                for _ in range(2))
    dv_ = randn(DEIT_BATCH, 12, DEIT_TOKENS, 64)
    for contract in ("exact", "serving"):
        kw = dict(k=30, scale=64 ** -0.5, key_bits=32, contract=contract,
                  out_dtype=torch.float32)
        check_k3("DeiT-base two_step k=30", dq_, dk_, dv_, None,
                 pred_mode="two_step_leading_ones", **kw)
        check_k3("DeiT-base ELSA k=30", dq_, dk_, dv_, None, pred_mode="ELSA",
                 proj=orthogonal_matrix(64, dev), **kw)
    del dq_, dk_, dv_

    # ---- 5. K4 against the same plain version, bit for bit, the plain
    # version per group of heads (at (2, 16, 4096, 4096) one f32 score
    # tensor is 2.1 GB, and the plain version keeps several)
    k4_err = 0.0

    def check_k4(label, q, keys, values, bias, heads=16, timed=False, **kw):
        """Hold K4 to its plain version, taken per ``heads`` heads; with
        ``timed``, the device ms of a second kernel call and of the plain
        version's calls."""
        nonlocal k4_err
        got, ms = event_ms(lambda: ta.fused_topk_attention_tiled(
            q, keys, values, bias, **kw))
        if timed:
            _, ms = event_ms(lambda: ta.fused_topk_attention_tiled(
                q, keys, values, bias, **kw))
        same, pms = True, 0.0
        for h0 in range(0, q.shape[1], heads):
            hs = slice(h0, h0 + heads)
            want, t = event_ms(lambda: ta.fused_topk_attention_ref(
                q[:, hs].contiguous(), keys[:, hs].contiguous(),
                values[:, hs].contiguous(), bias, **kw))
            pms += t
            diff = (got[:, hs].float() - want.float()).abs().max().item()
            k4_err = max(k4_err, diff)
            same = same and torch.equal(got[:, hs], want)
            del want
        print(f"[k4] {label} {kw.get('contract', 'exact')} "
              f"in={q.dtype} out={kw.get('out_dtype', torch.float32)}: "
              f"bit-equal {same}"
              + (f"; {ms:.3f} ms (plain {pms:.1f} ms)" if timed else ""),
              flush=True)
        if not same or not torch.isfinite(got).all():
            fail(f"K4 {label} {kw} differs from its plain version")
        return ms, pms

    H, D = 16, 72
    # DiT-XL/2 512^2: 4 images with CFG, N = S = 1024, bf16 in and out
    dq, dk, dv = (randn(2 * DIT512_IMAGES, H, 1024, D, scale=sc,
                        dtype=torch.bfloat16) for sc in (4.0, 4.0, 1.0))
    for contract in ("serving", "exact"):
        kw = dict(scale=D ** -0.5, key_bits=8, bfloat=16, contract=contract,
                  out_dtype=torch.bfloat16)
        check_k4("DiT-512 top-k ex_pred k=154", dq, dk, dv, None, k=154,
                 pred_mode="ex_pred", **kw)
        check_k4("DiT-512 dense", dq, dk, dv, None, k=1024, approx=False,
                 **kw)
    del dq, dk, dv
    # PixArt-alpha 1024^2: 1 prompt with CFG, N = 4096, S = 4096 or 120
    pq = randn(2, H, 4096, D, scale=4.0)
    pk, pv = randn(2, H, 4096, D, scale=4.0), randn(2, H, 4096, D)
    ck, cv = randn(2, H, CAPTION_TOKENS, D, scale=4.0), \
        randn(2, H, CAPTION_TOKENS, D)
    cbias, _ = caption_bias(2, CAPTION_TOKENS, dev)
    for dtype in (torch.float32, torch.bfloat16):
        args = [t.to(dtype) for t in (pq, pk, pv, ck, cv)]
        for contract in ("serving", "exact"):
            kw = dict(scale=D ** -0.5, key_bits=8, flush=True,
                      contract=contract, out_dtype=dtype)
            check_k4("PixArt-1024 self top-k two_step k=77", *args[:3], None,
                     heads=8, k=77, pred_mode="two_step_leading_ones", **kw)
            check_k4("PixArt-1024 self dense", *args[:3], None, heads=8,
                     k=4096, approx=False, **kw)
            check_k4("PixArt-1024 cross dense S=120 bias", args[0],
                     *args[3:], cbias, k=CAPTION_TOKENS, approx=False, **kw)
            check_k4("PixArt-1024 cross top-k two_step k=60 bias", args[0],
                     *args[3:], cbias, k=60,
                     pred_mode="two_step_leading_ones", **kw)
        del args
    # ---- 5. the other predictor modes on K3 and K4, bit for bit against
    # the plain version in both tiers: K3 at PixArt-256's self site (200
    # rows, f32) and, the exponent modes, its cross site with the bias; K4
    # at PixArt-1024's self site (bf16, key_bits 8, the plain version per 8
    # heads) and, the exponent modes, its cross site (S = 120, bias); ELSA
    # at the self sites only (square).  Each check's calls are timed with
    # CUDA events (one call each: 10-1000 ms); phase 10 reports them per mode
    proj = orthogonal_matrix(D, dev)
    split0 = ta._split_library(0)  # host code: every part answers
    for mode in ("two_step_leading_ones",) + NEW_MODES:
        sizes = []
        for b_, s_ in ((2, 4096), (B2, 256)):
            for relaxed in (0, 1):
                sizes.append(split0.topk_attention_split_workspace_bytes(
                    b_, H, s_, D, 77, 1, ta.SPLIT_PRED_MODES.index(mode),
                    relaxed, 0) / 2 ** 20)
        print(f"[k3/k4] {mode} workspace MiB at (2, 16, 4096) exact/serving "
              f"{sizes[0]:.1f}/{sizes[1]:.1f}, at (200, 16, 256) "
              f"{sizes[2]:.1f}/{sizes[3]:.1f}", flush=True)
    sq3 = randn(B2, H, 256, D, scale=4.0)
    sk3, sv3 = randn(B2, H, 256, D, scale=4.0), randn(B2, H, 256, D)
    ck3, cv3 = randn(B2, H, CAPTION_TOKENS, D, scale=4.0), \
        randn(B2, H, CAPTION_TOKENS, D)
    bias3, _ = caption_bias(B2, CAPTION_TOKENS, dev)
    pk16, pv16 = pk.to(torch.bfloat16), pv.to(torch.bfloat16)
    pq16, ck16, cv16 = (t.to(torch.bfloat16) for t in (pq, ck, cv))
    for mode in NEW_MODES:
        mp = proj if mode == "ELSA" else None
        for contract in ("exact", "serving"):
            kw = dict(pix, contract=contract, pred_mode=mode, proj=mp)
            ms, pms = check_k3(f"{mode} self k=77", sq3, sk3, sv3, None,
                               timed=True, k=77, **kw)
            mode_times.append(dict(kernel=K3, mode=mode, site="self",
                                   contract=contract, ms=ms, plain_ms=pms,
                                   shape=(B2, H, 256, 256, D, 4, None)))
            if mode != "ELSA":
                ms, pms = check_k3(f"{mode} cross k=60 S=120 bias", sq3, ck3,
                                   cv3, bias3, timed=True, k=60, **kw)
                mode_times.append(dict(
                    kernel=K3, mode=mode, site="cross", contract=contract,
                    ms=ms, plain_ms=pms,
                    shape=(B2, H, 256, CAPTION_TOKENS, D, 4, True)))
            kw = dict(scale=D ** -0.5, key_bits=8, flush=True, bfloat=0,
                      contract=contract, out_dtype=torch.bfloat16,
                      pred_mode=mode, proj=mp)
            ms, pms = check_k4(f"PixArt-1024 self {mode} k=77", pq16, pk16,
                               pv16, None, heads=8, timed=True, k=77, **kw)
            mode_times.append(dict(kernel=K4, mode=mode, site="self",
                                   contract=contract, ms=ms, plain_ms=pms,
                                   shape=(2, H, 4096, 4096, D, 2, None)))
            if mode != "ELSA":
                ms, pms = check_k4(f"PixArt-1024 cross {mode} k=60 bias",
                                   pq16, ck16, cv16, cbias, timed=True, k=60,
                                   **kw)
                mode_times.append(dict(
                    kernel=K4, mode=mode, site="cross", contract=contract,
                    ms=ms, plain_ms=pms,
                    shape=(2, H, 4096, CAPTION_TOKENS, D, 2, True)))
    # the two paths' own sites of these modes: DiT-XL/2's ELSA site (K3,
    # 64 rows of bf16, bfloat 16, key_bits 8, k = 154, no flush) and block
    # 27's cross attention at PixArt-1024 (K4, ex_pred, k = 60, the bias)
    int8_norm = format_params("int8")[3]
    dq3, dk3, dv3 = (randn(2 * DIT_IMAGES, H, 256, D, scale=sc,
                           dtype=torch.bfloat16) for sc in (4.0, 4.0, 1.0))
    for contract in ("exact", "serving"):
        check_k3("DiT-256 ELSA k=154", dq3, dk3, dv3, None, k=154,
                 scale=D ** -0.5, key_bits=8, bfloat=16, contract=contract,
                 out_dtype=torch.bfloat16, pred_mode="ELSA", proj=proj,
                 max_norm=int8_norm)
        check_k4("PixArt-1024 cross ex_pred k=60 bias (block 27)", pq16,
                 ck16, cv16, cbias, k=60, pred_mode="ex_pred",
                 scale=D ** -0.5, key_bits=8, flush=True, contract=contract,
                 out_dtype=torch.bfloat16, max_norm=int8_norm)
    del dq3, dk3, dv3
    del sq3, sk3, sv3, ck3, cv3, pk16, pv16, pq16, ck16, cv16
    del pq, pk, pv, ck, cv
    # the domain at a small batch: N not a multiple of 32, N = 200 against
    # S = 4096, key_bits 16 and 32 (32 at S = 4096 takes 8-row tiles),
    # true-score top-k, the other element formats, subnormal blocks under
    # flush
    ebits4, mbits4, emax4, norm4, _ = format_params("int4")
    fmt4 = dict(ebits=ebits4, mbits=mbits4, emax=emax4, max_norm=norm4)
    aq, ak, av = small(613, 700)
    nq, nk, nv = small(200, 4096)
    nbias, _ = caption_bias(b, 4096, dev, shortest=3000)
    fq, fk, fv = small(640, 640)
    fk[0, 1, 9, 32:64] = 1e-39
    fv[1, 2, 64:96, 5] = 2e-39
    fq[1, 0, 600, :32] = -3e-40
    cases = [
        ("N=613 S=700 ex_pred k=154 key_bits 8", (aq, ak, av, None),
         dict(k=154, pred_mode="ex_pred", key_bits=8)),
        ("N=613 S=700 true-score top-k key_bits 16", (aq, ak, av, None),
         dict(k=77, approx=False, key_bits=16)),
        ("N=200 S=4096 two_step k=154 key_bits 16 bias", (nq, nk, nv, nbias),
         dict(k=154, pred_mode="two_step_leading_ones", key_bits=16)),
        ("N=200 S=4096 ex_pred k=77 key_bits 32", (nq, nk, nv, None),
         dict(k=77, pred_mode="ex_pred", key_bits=32)),
        ("N=640 int4 two_step k=77", (fq, fk, fv, None),
         dict(k=77, pred_mode="two_step_leading_ones", **fmt4)),
        ("N=640 fp8_e4m3 ex_pred k=77 bfloat=16", (fq, fk, fv, None),
         dict(k=77, pred_mode="ex_pred", bfloat=16, **fmt8)),
        ("subnormal blocks under flush, dense", (fq, fk, fv, None),
         dict(k=640, approx=False)),
    ]
    for label, args, extra in cases:
        for contract in ("exact", "serving"):
            for out_dtype in (torch.float32, torch.bfloat16):
                kw = dict(pix, contract=contract, out_dtype=out_dtype)
                kw.update(extra)
                check_k4(label, *args, **kw)
    del cases, aq, ak, av, nq, nk, nv, fq, fk, fv
    # K4 against K3 where both apply (N, S <= 512), bit for bit
    sq, sk, sv = small(256, 256)
    cq, ck, cv = small(256, CAPTION_TOKENS)
    for label, args, extra in (
            ("N=S=256 ex_pred k=77", (sq, sk, sv, None),
             dict(k=77, pred_mode="ex_pred", key_bits=8)),
            ("S=120 bias two_step k=20", (cq, ck, cv, cbias),
             dict(k=20, pred_mode="two_step_leading_ones"))):
        for contract in ("exact", "serving"):
            kw = dict(pix, contract=contract)
            kw.update(extra)
            got = ta.fused_topk_attention_tiled(*args, **kw)
            want = ta.fused_topk_attention(*args, **kw)
            torch.cuda.synchronize()
            same = torch.equal(got, want)
            print(f"[k4] against K3, {label} {contract}: bit-equal {same}",
                  flush=True)
            if not same:
                fail(f"K4 and K3 differ at {label} {contract}")
    del sq, sk, sv, cq, ck, cv, got, want

    # ---- 6. K5, K6 and K7 against their plain versions, bit for bit
    errs = {K5: 0.0, K6: 0.0, K7: k7_err}

    def check_equal(name, label, got, want):
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs().max().item()
        errs[name] = max(errs[name], diff)
        print(f"[{name}] {label}: max |diff| {diff:.3e}", flush=True)
        if not torch.equal(got, want):
            fail(f"{name} {label} differs from its plain version")

    def check_k5(label, x, shift, scale, **kw):
        check_equal(K5, label, lnq.ln_modulate_quantize(x, shift, scale, **kw),
                    lnq.ln_modulate_quantize_ref(x, shift, scale, **kw))

    # the DiT site, shift and scale as the model passes them: bf16 chunks
    # of the adaLN output (rows 6 C apart)
    B, C = 2 * DIT_IMAGES, 1152
    mod = randn(B, 6 * C, scale=0.3, dtype=torch.bfloat16)
    check_k5("DiT site (64, 256, 1152) bf16 int8 bfloat=16",
             randn(B, 256, C, scale=3.0, dtype=torch.bfloat16),
             mod[:, :C], mod[:, C:2 * C], bfloat=16)
    # the domain: rows in registers (96, 1152, 1280) and in shared memory
    # (2304, 12288, the widest lnq.MAX_CHANNELS takes); 250 rows per batch
    # element, no multiple of the kernel's 32-row tile
    for c in (96, C, 1280, 2304, lnq.MAX_CHANNELS):
        for dtype in (torch.float32, torch.bfloat16):
            x = randn(3, 250, c, scale=3.0, dtype=dtype)
            sh, sc = randn(3, c, scale=0.3), randn(3, c, scale=0.3)
            sc[0, :32], sh[0, :32] = -1.0, 1e-39  # a subnormal block
            for fmt in ("int8", "fp8_e4m3"):
                for bfloat in (0, 16):
                    for flush in (False, True):
                        check_k5(f"C={c} {dtype} {fmt} bfloat={bfloat} "
                                 f"flush={flush}", x, sh, sc, elem_format=fmt,
                                 bfloat=bfloat, flush=flush)
    for c in (C, 2304):  # f32 output, rows in registers and in shared memory
        x = randn(3, 250, c, scale=3.0, dtype=torch.bfloat16)
        sh, sc = randn(3, c, scale=0.3), randn(3, c, scale=0.3)
        check_k5(f"C={c} bf16 in, f32 out, bfloat=16", x, sh, sc, bfloat=16,
                 out_dtype=torch.float32)
    wide = torch.zeros(1, 2, lnq.MAX_CHANNELS + 32, device=dev)
    try:
        lnq.ln_modulate_quantize(wide, wide[:, 0], wide[:, 0])
        fail("K5 took a row past lnq.MAX_CHANNELS")
    except NotImplementedError as err:
        if "MAX_CHANNELS" not in str(err):
            fail(f"K5's refusal does not name MAX_CHANNELS: {err}")
    del x, sh, sc, wide

    def check_k6(label, x, **kw):
        check_equal(K6, label, gelu_quantize(x, **kw),
                    gelu_quantize_ref(x, **kw))

    h = randn(B, 256, 4608, scale=2.0, dtype=torch.bfloat16)
    check_k6("DiT fc2 site (64, 256, 4608) bf16 bfloat=16", h, bfloat=16)
    check_k6("DiT fc2 site erf form", h, bfloat=16, approximate=False)
    check_k6("DiT fc2 site fp8_e4m3", h, bfloat=16, elem_format="fp8_e4m3")
    h = randn(B2, 256, 4608, scale=2.0)
    h[0, 0, :32] = 1e-39
    check_k6("PixArt fc2 site (200, 256, 4608) f32 flush bfloat=32", h,
             flush=True, bfloat=32)
    check_k6("PixArt fc2 site erf form", h, flush=True, bfloat=32,
             approximate=False)
    h = randn(DEIT_BATCH, DEIT_TOKENS, 3072, scale=2.0)
    check_k6("DeiT-base fc2 site (100, 197, 3072) f32 erf bfloat=32", h,
             bfloat=32, approximate=False)
    del h

    H, D, Dp = 16, 72, 96
    qkv = randn(B, 256, 3 * H * D, dtype=torch.bfloat16)
    qk = torch.nn.functional.pad(qkv[..., :2 * H * D].reshape(
        B, 256, 2, H, D), (0, Dp - D))
    qk_t = qk.permute(2, 3, 4, 0, 1).reshape(2 * H * Dp, B, 256).contiguous()
    v = qkv[..., 2 * H * D:].contiguous()
    del qk
    for contract in ("serving", "exact"):
        for k in (154, 256):
            kw = dict(k=k, scale=D ** -0.5, key_bits=8, bfloat=16,
                      contract=contract, out_dtype=torch.bfloat16)
            got = ta.fused_topk_attention_qkv_t(qk_t, v, H, n_valid=256, **kw)
            check_equal(K7, f"DiT site {contract} k={k}", got,
                        ta.fused_topk_attention_qkv_t_ref(qk_t, v, H,
                                                          n_valid=256, **kw))
            check_equal(K7, f"DiT site {contract} k={k} against K2", got,
                        ta.fused_topk_attention_qkv(qkv, H, **kw))
    del qkv, qk_t, v, got

    stamp("kernel checks done")
    # ---- 6b. the emulation engine: its quantizers over every golden key on
    # CUDA tensors (the goldens' rule, and the CPU's bits), no kernel
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from emulation_goldens import golden_cases, golden_mismatches, load
    elem_npz, mx_npz = load()
    n_keys = 0
    for fam, _, key, x, call in golden_cases(elem_npz, mx_npz):
        xt = torch.from_numpy(np.ascontiguousarray(x))
        got = call(xt.to(dev)).cpu()
        if golden_mismatches(got, (mx_npz if fam.startswith("mx")
                                   else elem_npz)[key]):
            fail(f"the emulation quantizer differs from the golden {key} "
                 "on the card")
        cpu = call(xt)
        keep = ~cpu.isnan()
        if not (torch.equal(got.isnan(), cpu.isnan()) and torch.equal(
                got[keep].view(torch.int32), cpu[keep].view(torch.int32))):
            fail(f"the emulation quantizer's bits differ between the card "
                 f"and the CPU at {key}")
        n_keys += 1
    print(f"[emulation] {n_keys} golden keys of elemwise.npz and mx.npz: "
          "equal on the card, bit for bit the CPU's", flush=True)

    # the ref linear against the fast one (K1, the bf16 GEMM) at the DiT and
    # DeiT linear sites, on the fly quantized f32 weights
    for label, shape, out_f, dtype, specs_fn in (
            ("DiT-XL/2 qkv", (2 * DIT_IMAGES, 256, 1152), 3456,
             torch.bfloat16, dit_mx_specs),
            ("DiT-XL/2 fc2", (2 * DIT_IMAGES, 256, 4608), 1152,
             torch.bfloat16, dit_mx_specs),
            ("DeiT-small qkv", (DEIT_BATCH, DEIT_TOKENS, 384), 1152,
             torch.float32, default_mx_specs),
            ("DeiT-base fc1", (DEIT_BATCH, DEIT_TOKENS, 768), 3072,
             torch.float32, default_mx_specs)):
        x = randn(*shape, scale=2.0, dtype=dtype)
        w = randn(out_f, shape[-1], scale=shape[-1] ** -0.5)
        b = randn(out_f, scale=0.1)
        fused = linear(x, w, b, mx_specs=specs_fn())
        ref = linear(x, w, b, mx_specs=specs_fn("ref"))
        diff = (ref - fused).abs().max().item()
        print(f"[emulation] linear ref against fused at {label} "
              f"{tuple(shape)} {dtype}: max |diff| {diff:.3e} (bound 1e-6 "
              "+ 1e-6 relative)", flush=True)
        if not torch.allclose(ref, fused, rtol=1e-6, atol=1e-6):
            fail(f"the ref linear differs from the fused one at {label}")
    del x, w, b, fused, ref
    # the serving tier is a kernel tier: off the kernels it raises, as in
    # JAX, and never falls back to the XLA path
    qx = randn(2, 2, 64, 64)
    try:
        topk_attention(qx, qx, qx, 0.125, dit_mx_specs(), TopKAttentionConfig(
            k=8, sparse_impl="gather", contract="serving"))
        fail("a serving config off the kernels ran on the XLA path")
    except ValueError:
        pass
    stamp("emulation checks done")
    # ---- 6./7. the slices
    main_launches = {n: 0 for n in wrappers}
    main_sites = {n: collections.Counter() for n in wrappers}
    path_launches = {}
    tiers = {}

    def run_path(name, contract, steps, per_fwd, units, fn, unit="images",
                 sinks=None):
        """Drive one tier of a slice with every count set to 0 just before
        and read just after; the sites and launches go to ``sinks``
        ((sites, launches); the main paths' by default)."""
        sites_to, launches_to = sinks or (main_sites, main_launches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
            w.sites.clear()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {n: w.launches for n, w in wrappers.items()}
        for n, w in wrappers.items():
            sites_to[n].update(w.sites)
            launches_to[n] += counts[n]
        path_launches[f"{name} {contract}"] = counts
        for n, c in counts.items():
            if c != per_fwd.get(n, 0) * steps:
                fail(f"{name} {contract}: {n} launched {c} times, expected "
                     f"{per_fwd.get(n, 0)} per forward x {steps}")
        tiers[f"{name} {contract}"] = dict(
            imgs_per_s=units / dt, step_ms=1e3 * dt / steps,
            max_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        print(f"[slice] {name} {contract}: {units} {unit}, {steps} steps "
              f"in {dt:.2f} s = {units / dt:.4f} {unit}/s, step "
              f"{1e3 * dt / steps:.2f} ms, max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches "
              f"{counts}", flush=True)
        for n, w in wrappers.items():
            for site, c in w.sites.items():
                desc = site[:-1] + (dict(site[-1]),) \
                    if n in (K2, K3, K4, K7) else site
                print(f"[slice] {name} {contract}: {n} at {desc}: {c}")
        return out

    servers = {}

    def no_sync(fn):
        """``fn`` with every synchronizing CUDA call an error."""
        def run(*args, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return run

    def run_server(name, contract, srv, make_request, reqs, per_dispatch,
                   shape, period=None):
        """Serve ``reqs`` requests (a burst, or one every ``period``
        engine steps) with the server's dispatch and refill under
        ``no_sync`` and every count set to 0 just before and read just
        after: each kernel of the path must have launched its per-forward
        count times the dispatches, and no other kernel at all; every
        request answered with a finite latent of ``shape``."""
        srv._dispatch = no_sync(srv._dispatch)
        srv._fill_slots = no_sync(srv._fill_slots)
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
            w.sites.clear()
        run = sb.serve(srv, make_request, reqs, period)
        torch.cuda.synchronize()
        label = f"{name} {contract}"
        counts = {n: w.launches for n, w in wrappers.items()}
        for n, w in wrappers.items():
            main_sites[n].update(w.sites)
            main_launches[n] += counts[n]
        path_launches[label] = counts
        for n, c in counts.items():
            if c != per_dispatch.get(n, 0) * run["dispatches"]:
                fail(f"{label}: {n} launched {c} times, expected "
                     f"{per_dispatch.get(n, 0)} per dispatch x "
                     f"{run['dispatches']}")
        if sorted(run["results"]) != [10000 + i for i in range(reqs)]:
            fail(f"{label}: answered {sorted(run['results'])}")
        for r in run["results"].values():
            if r.latent.shape != shape or not np.isfinite(r.latent).all():
                fail(f"{label}: request {r.request_id}'s latent is not "
                     "finite / of its shape")
        stats = servers[label] = sb.summary(run)
        print(f"[server] {label}: {reqs} requests, "
              f"{'burst' if period is None else 'one per engine step'}, "
              f"{stats['dispatches']} dispatches in {stats['wall_s']:.2f} s "
              f"= {stats['imgs_per_s']:.4f} imgs/s; latency from submit "
              f"p50 {stats['latency_p50_s']:.3f} s p95 "
              f"{stats['latency_p95_s']:.3f} s; queue wait p50 "
              f"{stats['queue_wait_p50_s']:.4f} s p95 "
              f"{stats['queue_wait_p95_s']:.4f} s; engine step "
              f"{stats['step_ms']:.2f} ms; dispatch and refill without a "
              f"host sync; launches {counts}", flush=True)
        return run

    # 7. DiT-XL/2
    cfg = DiT_models["DiT-XL/2"](input_size=32)
    t0 = time.perf_counter()
    model = init_dit(cfg, torch.Generator().manual_seed(0), dev,
                     randomize_all=True)
    model, specs = prequantize_weights(model, dit_mx_specs(),
                                       serve_dtype=torch.bfloat16)
    print(f"[slice] DiT-XL/2 random weights, prequantized bf16, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    dit_q = DiTQuantConfig(mx_specs=specs, mx_quant=True, top_k=True, k=154,
                           ex_pred=True, exclude_blocks=(27,),
                           topk_key_bits=8, activation_dtype="bfloat16")
    labels = list(range(DIT_IMAGES))
    dit_per_fwd = {K1: 4 * cfg.depth + 2, K2: cfg.depth}
    # the servers' draws, replayed: a burst of DIT_IMAGES requests into as
    # many slots runs in lockstep, so sample_dit on these draws is the
    # server's result, bit for bit
    replay = torch.Generator(device=dev).manual_seed(SERVER_SEED)
    z = torch.stack([torch.randn((4, 32, 32), generator=replay, device=dev)
                     for _ in labels])
    step_noise = [torch.randn((SERVER_SLOTS, 4, 32, 32), generator=replay,
                              device=dev).repeat(2, 1, 1, 1)
                  for _ in range(DIT_STEPS)]
    for contract in ("serving", "exact"):
        qc = dataclasses.replace(dit_q, contract=contract)
        sample_dit(model, qc, labels, gen, num_steps=2, device=dev)  # warm
        lat = run_path("DiT-XL/2", contract, DIT_STEPS, dit_per_fwd,
                       DIT_IMAGES,
                       lambda: sample_dit(model, qc, labels, z=z,
                                          step_noise=step_noise,
                                          num_steps=DIT_STEPS, device=dev))
        if lat.shape != (DIT_IMAGES, 4, 32, 32) or \
                not torch.isfinite(lat).all():
            fail(f"DiT {contract}: latents not finite / wrong shape")
        print(f"[slice] DiT-XL/2 {contract}: latent std "
              f"{lat.float().std().item():.4g}")
        # 7s. the DiT server: the same burst, DDPM, CFG 4.0, as many slots
        srv = sb.dit_server(model, specs, contract, SERVER_SLOTS, DIT_STEPS,
                            dev)
        run = run_server("DiT-XL/2 server burst", contract, srv,
                         sb.dit_request, DIT_IMAGES, dit_per_fwd,
                         (4, 32, 32))
        if run["dispatches"] != DIT_STEPS:
            fail(f"DiT server {contract}: {run['dispatches']} dispatches for "
                 f"one wave of {DIT_STEPS} steps")
        for i in range(DIT_IMAGES):
            if not torch.equal(torch.from_numpy(
                    run["results"][10000 + i].latent), lat[i].cpu()):
                fail(f"DiT server {contract}: request {i}'s latent differs "
                     "from sample_dit's")
        print(f"[server] DiT-XL/2 burst {contract}: {DIT_IMAGES} latents "
              f"bit-equal to sample_dit's, {run['dispatches']} dispatches",
              flush=True)
    dit_latents = lat  # the exact tier's, decoded in the end-task phase
    del z, step_noise

    def profile(label, fn, steps):
        """``fn`` (``steps`` steps) under the profiler: wall, device busy,
        top kernels.  It records the device alone and sums the profiler's
        raw device events by name (a training step launches ~300,000
        kernels; building ``key_averages``' per-event objects for them took
        ~90 s, and ~250 s with the host's events)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        torch.cuda.synchronize()
        with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / steps
        by_name = collections.defaultdict(lambda: [0.0, 0])
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA and \
                    not e.is_user_annotation():
                acc = by_name[e.name()]
                acc[0] += e.duration_ns() / 1e3  # us
                acc[1] += 1
        kern = [(k, us, n) for k, (us, n) in by_name.items()]
        busy_ms = sum(us for _, us, _ in kern) / (1e3 * steps)
        print(f"[profile] {label} per step (profiled): wall "
              f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
              f"({busy_ms / wall_ms:.1%})")
        for key, us, n in sorted(kern, key=lambda e: -e[1])[:16]:
            print(f"[profile] {label} {us / (1e3 * steps):9.2f}"
                  f" ms/step {n // steps:6d}x  {key[:90]}")

    def profile_server(label, srv, make_request):
        """Two engine steps of a drained server's full pool under the
        profiler."""
        for i in range(srv.slots):
            srv.submit(make_request(i, i))
        srv.step()  # fills the pool
        profile(label, lambda: [srv.step() for _ in range(2)], 2)

    # 9. where the time goes (two steps: respacing to a single DDPM step
    # leaves no posterior variance table)
    qc = dataclasses.replace(dit_q, contract="serving")
    profile("DiT-XL/2", lambda: sample_dit(model, qc, labels, gen,
                                           num_steps=2, device=dev), 2)

    # 7s. the DiT server, serving tier, a staggered stream at the "25"
    # respacing: slots at different depths share every batch
    srv = sb.dit_server(model, specs, "serving", SERVER_SLOTS,
                        STAGGERED_DIT_STEPS, dev)
    run_server(f"DiT-XL/2 server staggered {STAGGERED_DIT_STEPS} steps",
               "serving", srv, sb.dit_request, STAGGERED_REQS, dit_per_fwd,
               (4, 32, 32), period=1)
    profile_server("DiT-XL/2 server", srv, sb.dit_request)

    # 7. DiT-XL/2 with the fused opt-ins: the same model and weights; per
    # forward, serving: K5 before qkv and fc1 of every block and the final
    # linear, K6 in every block, K7 in every block (block 27 dense), K1 in
    # front of proj and the final adaLN linear; exact: K5 and K6 do not
    # apply (bfloat=16), K7 in every block, K1 as the default path
    fused_q = dataclasses.replace(dit_q, fuse_ln_modulate=True,
                                  fuse_gelu=True, qkv_layout="split_t")
    depth = cfg.depth
    fused_per_fwd = {
        "serving": {K1: depth + 1, K5: 2 * depth + 1, K6: depth, K7: depth},
        "exact": {K1: 4 * depth + 2, K7: depth}}
    for contract in ("serving", "exact"):
        qc = dataclasses.replace(fused_q, contract=contract)
        sample_dit(model, qc, labels, gen, num_steps=2, device=dev)  # warm
        lat = run_path("DiT-XL/2 fused opt-ins", contract, DIT_OPT_IN_STEPS,
                       fused_per_fwd[contract], DIT_IMAGES,
                       lambda: sample_dit(model, qc, labels, gen,
                                          num_steps=DIT_OPT_IN_STEPS,
                                          device=dev))
        if lat.shape != (DIT_IMAGES, 4, 32, 32) or \
                not torch.isfinite(lat).all():
            fail(f"DiT fused opt-ins {contract}: latents not finite / wrong "
                 "shape")
        print(f"[slice] DiT-XL/2 fused opt-ins {contract}: latent std "
              f"{lat.float().std().item():.4g}")
    qc = dataclasses.replace(fused_q, contract="serving")
    profile("DiT-XL/2 fused opt-ins", lambda: sample_dit(
        model, qc, labels, gen, num_steps=2, device=dev), 2)

    # 7. DiT-XL/2 with the fused opt-ins and two_step_leading_ones: K7 in
    # the new mode (block 27 dense), the counts as above
    for contract in ("serving", "exact"):
        qc = dataclasses.replace(fused_q, pred_mode="two_step_leading_ones",
                                 contract=contract)
        sample_dit(model, qc, labels, gen, num_steps=2, device=dev)  # warm
        lat = run_path("DiT-XL/2 fused opt-ins two_step", contract,
                       DIT_TWO_STEP_STEPS, fused_per_fwd[contract],
                       DIT_IMAGES,
                       lambda: sample_dit(model, qc, labels, gen,
                                          num_steps=DIT_TWO_STEP_STEPS,
                                          device=dev))
        if lat.shape != (DIT_IMAGES, 4, 32, 32) or \
                not torch.isfinite(lat).all():
            fail(f"DiT fused opt-ins two_step {contract}: latents not finite "
                 "/ wrong shape")
        print(f"[slice] DiT-XL/2 fused opt-ins two_step {contract}: latent "
              f"std {lat.float().std().item():.4g}")

    # 7. DiT-XL/2 in each other predictor of the TPU kernels' qkv entry
    # through the entry point, 2 steps per tier: K2 in every block (block
    # 27 dense), as JAX routes them; per forward K1 114, K2 28
    for mode in ta.QKV_PRED_MODES[1:]:
        for contract in ("serving", "exact"):
            qc = dataclasses.replace(dit_q, pred_mode=mode, contract=contract)
            lat = run_path(f"DiT-XL/2 {mode}", contract, 2,
                           {K1: 4 * depth + 2, K2: depth}, DIT_IMAGES,
                           lambda: sample_dit(model, qc, labels, gen,
                                              num_steps=2, device=dev))
            if lat.shape != (DIT_IMAGES, 4, 32, 32) or \
                    not torch.isfinite(lat).all():
                fail(f"DiT {mode} {contract}: latents not finite / wrong "
                     "shape")

    # 7. DiT-XL/2 with ELSA through the entry point, 2 steps per tier, the
    # structured projection: ELSA is the split entry's, as in JAX, so every
    # top-k block's attention takes K3, and block 27 (dense) K2; per
    # forward K1 114, K3 27, K2 1
    for contract in ("serving", "exact"):
        qc = dataclasses.replace(dit_q, pred_mode="ELSA", contract=contract)
        lat = run_path("DiT-XL/2 ELSA", contract, 2,
                       {K1: 4 * depth + 2, K2: 1, K3: depth - 1}, DIT_IMAGES,
                       lambda: sample_dit(model, qc, labels, gen,
                                          num_steps=2, device=dev,
                                          orthogonal_matrix=proj))
        if lat.shape != (DIT_IMAGES, 4, 32, 32) or \
                not torch.isfinite(lat).all():
            fail(f"DiT ELSA {contract}: latents not finite / wrong shape")
    del model

    # 7. DiT-XL/2 512^2 (tools/workload_probe.py dit512_probe): N = 1024
    # tokens, so every block's attention leaves the fused qkv entry for the
    # split entry and K4 (block 27 dense); per forward K1 114 and K4 28
    cfg512 = DiT_models["DiT-XL/2"](input_size=64)
    t0 = time.perf_counter()
    model = init_dit(cfg512, torch.Generator().manual_seed(0), dev,
                     randomize_all=True)
    model, specs = prequantize_weights(model, dit_mx_specs(),
                                       serve_dtype=torch.bfloat16)
    print(f"[slice] DiT-XL/2 512^2 random weights, prequantized bf16, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    dit512_q = dataclasses.replace(dit_q, mx_specs=specs)
    labels512 = list(range(DIT512_IMAGES))
    for contract in ("serving", "exact"):
        qc = dataclasses.replace(dit512_q, contract=contract)
        sample_dit(model, qc, labels512, gen, num_steps=2, device=dev)  # warm
        lat = run_path("DiT-XL/2 512^2", contract, DIT512_STEPS,
                       {K1: 4 * cfg512.depth + 2, K4: cfg512.depth},
                       DIT512_IMAGES,
                       lambda: sample_dit(model, qc, labels512, gen,
                                          num_steps=DIT512_STEPS, device=dev))
        if lat.shape != (DIT512_IMAGES, 4, 64, 64) or \
                not torch.isfinite(lat).all():
            fail(f"DiT 512 {contract}: latents not finite / wrong shape")
        print(f"[slice] DiT-XL/2 512^2 {contract}: latent std "
              f"{lat.float().std().item():.4g}")
    qc = dataclasses.replace(dit512_q, contract="serving")
    profile("DiT-XL/2 512^2", lambda: sample_dit(
        model, qc, labels512, gen, num_steps=2, device=dev), 2)
    del model

    # ---- 7b. the MX block sizes other than 32: K2 and K7 on the int grids
    # launch their source built for the block (ta.qkv_route's "qkv_bs", each
    # launch's route checked), K3, K4 and an MXFP K2 the blocks kernel
    # (csrc/topk_attention_blocks.cu), K1, K5 and K6 their own with the
    # block a launch argument.  Each against its plain version,
    # bit for bit, at real sites (timed at TIMED_BLOCKS); then the paths end
    # to end, with their sites and launches kept apart from the block-32
    # paths', and each of their sites held to the plain version
    stamp("block sizes phase starts")
    block_sites = {n: collections.Counter() for n in wrappers}
    block_launches = {n: 0 for n in wrappers}
    block_err = collections.defaultdict(float)
    block_timed = collections.defaultdict(list)

    def served(name, fn):
        """fn's result and, for K2 and K7, the routes (``ta.qkv_route``)
        of the launches it made."""
        routes = getattr(wrappers[name], "routes", None)
        before = collections.Counter(routes or {})
        got = fn()
        return got, None if routes is None else \
            ",".join(sorted(routes - before))

    def check_block(name, bs, site, fn, ref, bound, expect=ta.ROUTE_QKV_BS,
                    entry=True):
        """fn (the kernel) against ref (its plain version) bit for bit; at
        TIMED_BLOCKS also the kernel's time, the plain version's (one call)
        and the bound (attention_bound's or elementwise_bound's triple),
        kept for the kernel's entry of the ``kernels`` line where ``entry``.
        K2 and K7 must take the route ``expect``."""
        got, route = served(name, fn)
        want, pms = event_ms(ref)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        block_err[name] = max(block_err[name], err)
        if not torch.equal(got, want) or not torch.isfinite(got).all():
            fail(f"{name} at block {bs}, {site}, differs from its plain "
                 "version")
        if route is not None and route != expect:
            fail(f"{name} at block {bs}, {site}: route {route}, not {expect}")
        del got, want
        line = f"[block] {name} block {bs} {site}: bit-equal"
        if route is not None:
            line += f", route {route}"
        if bs in TIMED_BLOCKS:
            ms, queued = time_ms(fn, 5, warmup=1)
            bnd, by, terms = bound
            if entry:
                block_timed[name].append(dict(
                    site=site, block_size=bs, ms=ms, plain_ms=pms,
                    bound_ms=bnd, bound_by=by, queued=queued, route=route))
            line += (f"; {ms:.4f} ms (plain {pms:.2f} ms, bound {bnd:.4f} "
                     f"ms by {by}: { {t: round(v, 4) for t, v in terms.items()} })")
        print(line, flush=True)

    B, N, H, D = 2 * DIT_IMAGES, 256, 16, 72
    qkv = randn(B, N, 3 * H * D, dtype=torch.bfloat16)
    deit_qkv = randn(DEIT_BATCH, DEIT_TOKENS, 3 * 6 * 64)
    pq, pk, pv = (randn(8, H, 256, D, scale=sc) for sc in (4.0, 4.0, 1.0))
    ck, cv = randn(8, H, CAPTION_TOKENS, D, scale=4.0), \
        randn(8, H, CAPTION_TOKENS, D)
    cbias = caption_bias(8, CAPTION_TOKENS, dev)[0]
    lq, lk, lv = (randn(2 * DIT512_IMAGES, H, 1024, D, scale=sc,
                        dtype=torch.bfloat16) for sc in (4.0, 4.0, 1.0))
    xq, xk, xv = (randn(2, H, 4096, D, scale=sc) for sc in (4.0, 4.0, 1.0))
    eq, ek, ev = (randn(B, H, N, D, scale=sc, dtype=torch.bfloat16)
                  for sc in (4.0, 4.0, 1.0))
    k5x = randn(B, N, 1152, scale=3.0, dtype=torch.bfloat16)
    k5s, k5h = (randn(B, 1152, scale=0.3, dtype=torch.bfloat16)
                for _ in range(2))
    fc2 = randn(B, N, 4608, scale=2.0, dtype=torch.bfloat16)
    ada = randn(B, 1152)
    dit_kw = dict(k=154, scale=D ** -0.5, key_bits=8, bfloat=16,
                  out_dtype=torch.bfloat16)
    fp8 = format_params("fp8_e4m3")
    for bs in OTHER_BLOCKS:
        for contract in ("serving", "exact"):
            kw = dict(dit_kw, contract=contract, block_size=bs)
            check_block(K2, bs, f"DiT {(B, N, 3 * H * D)} bf16 ex_pred "
                        f"k=154 {contract}",
                        lambda: ta.fused_topk_attention_qkv(qkv, H, **kw),
                        lambda: ta.fused_topk_attention_qkv_ref(qkv, H, **kw),
                        attention_bound(B * H, N, N, D, 2, 2, 154, 8, True))
        for contract in ("serving", "exact"):
            kw = dict(k=60, scale=64 ** -0.5, key_bits=32, contract=contract,
                      block_size=bs)
            check_block(K2, bs, f"DeiT-small {tuple(deit_qkv.shape)} f32 "
                        f"ex_pred k=60 {contract}",
                        lambda: ta.fused_topk_attention_qkv(deit_qkv, 6,
                                                            **kw),
                        lambda: ta.fused_topk_attention_qkv_ref(deit_qkv, 6,
                                                                **kw),
                        attention_bound(DEIT_BATCH * 6, DEIT_TOKENS,
                                        DEIT_TOKENS, 64, 4, 4, 60, 32, True))
        # the MXFP grids stay on the blocks kernel (CUDA cores)
        kw = dict(dit_kw, contract="serving", block_size=bs, ebits=fp8[0],
                  mbits=fp8[1], emax=fp8[2], max_norm=fp8[3])
        check_block(K2, bs, f"DiT {(B, N, 3 * H * D)} bf16 fp8_e4m3 ex_pred "
                    "k=154 serving",
                    lambda: ta.fused_topk_attention_qkv(qkv, H, **kw),
                    lambda: ta.fused_topk_attention_qkv_ref(qkv, H, **kw),
                    attention_bound(B * H, N, N, D, 2, 2, 154, 8, True),
                    expect=ta.ROUTE_BLOCKS, entry=False)
        Dp = -(-D // bs) * bs
        qk = torch.nn.functional.pad(
            qkv[..., :2 * H * D].reshape(B, N, 2, H, D), (0, Dp - D))
        qk_t = qk.permute(2, 3, 4, 0, 1).reshape(2 * H * Dp, B, N).contiguous()
        v7 = qkv[..., 2 * H * D:].contiguous()
        kw = dict(dit_kw, contract="serving", block_size=bs, n_valid=N)
        check_block(K7, bs, f"DiT split-emission {tuple(qk_t.shape)} serving",
                    lambda: ta.fused_topk_attention_qkv_t(qk_t, v7, H, **kw),
                    lambda: ta.fused_topk_attention_qkv_t_ref(qk_t, v7, H,
                                                              **kw),
                    attention_bound(B * H, N, N, D, 2, 2, 154, 8, True))
        del qk, qk_t, v7
        kw = dict(k=77, scale=D ** -0.5, key_bits=32, flush=True,
                  pred_mode="two_step_leading_ones", contract="exact",
                  block_size=bs)
        check_block(K3, bs, "PixArt 256 self (8, 16, 256, 72) f32 two_step "
                    "k=77 exact",
                    lambda: ta.fused_topk_attention(pq, pk, pv, **kw),
                    lambda: ta.fused_topk_attention_ref(pq, pk, pv, **kw),
                    attention_bound(8 * H, 256, 256, D, 4, 4, 77, 32, True,
                                    pred="two_step_leading_ones"))
        kw = dict(k=CAPTION_TOKENS, scale=D ** -0.5, key_bits=32, flush=True,
                  contract="serving", block_size=bs)
        check_block(K3, bs, f"PixArt 256 cross S={CAPTION_TOKENS} bias "
                    "dense serving",
                    lambda: ta.fused_topk_attention(pq, ck, cv, cbias, **kw),
                    lambda: ta.fused_topk_attention_ref(pq, ck, cv, cbias,
                                                        **kw),
                    attention_bound(8 * H, 256, CAPTION_TOKENS, D, 4, 4,
                                    CAPTION_TOKENS, 32, False,
                                    extra_bytes=8 * CAPTION_TOKENS * 4))
        for contract in ("serving", "exact"):
            kw = dict(dit_kw, contract=contract, block_size=bs,
                      pred_mode="ELSA", proj=proj, max_norm=int8_norm)
            check_block(K3, bs, f"DiT-256 ELSA {(B, H, N, D)} bf16 k=154 "
                        f"{contract}",
                        lambda: ta.fused_topk_attention(eq, ek, ev, **kw),
                        lambda: ta.fused_topk_attention_ref(eq, ek, ev, **kw),
                        attention_bound(B * H, N, N, D, 2, 2, 154, 8, True,
                                        pred="ELSA"))
        kw = dict(dit_kw, contract="serving", block_size=bs)
        check_block(K4, bs, f"DiT-512 {tuple(lq.shape)} bf16 ex_pred k=154 "
                    "serving",
                    lambda: ta.fused_topk_attention_tiled(lq, lk, lv, **kw),
                    lambda: ta.fused_topk_attention_ref(lq, lk, lv, **kw),
                    attention_bound(lq.shape[0] * H, 1024, 1024, D, 2, 2,
                                    154, 8, True))
        if bs in TIMED_BLOCKS:
            # the plain version on 4 of the 16 heads (its score tensors for
            # all 16 would take ~30 GB); its time scaled by 4
            kw = dict(k=77, scale=D ** -0.5, key_bits=32, flush=True,
                      pred_mode="two_step_leading_ones", contract="exact",
                      block_size=bs)
            hq, hk, hv = (t[:, :4].contiguous() for t in (xq, xk, xv))
            check_block(K4, bs, "PixArt 1024 self (2, 16, 4096, 72) f32 "
                        "two_step k=77 exact (plain on 4 heads)",
                        lambda: ta.fused_topk_attention_tiled(
                            xq, xk, xv, **kw)[:, :4],
                        lambda: ta.fused_topk_attention_ref(hq, hk, hv, **kw),
                        attention_bound(2 * H, 4096, 4096, D, 4, 4, 77, 32,
                                        True, pred="two_step_leading_ones"))
            block_timed[K4][-1]["plain_ms"] *= 4
            del hq, hk, hv
        # K1 at DiT's sites (the linears' bf16 inputs, the adaLN's f32
        # condition), K6 at its fc2 site (tanh), at DiT's specs
        args1 = ("int8", bs, 8, torch.bfloat16, False, 16)
        for x in (k5x, fc2, ada):
            in_bf16 = x.dtype == torch.bfloat16
            check_block(K1, bs, f"DiT {tuple(x.shape)} {x.dtype} bfloat=16",
                        lambda: mx_quantize(x, *args1),
                        lambda: mx_quantize_ref(x, *args1),
                        elementwise_bound(
                            x.numel() * (x.element_size() + 2),
                            x.numel() * mx_ops("int8", False, not in_bf16,
                                               in_bf16)))
        args6 = args1 + (True,)
        check_block(K6, bs, f"DiT fc2 {tuple(fc2.shape)} bf16 tanh bfloat=16",
                    lambda: gelu_quantize(fc2, *args6),
                    lambda: gelu_quantize_ref(fc2, *args6),
                    elementwise_bound(fc2.numel() * 4, fc2.numel() * (
                        9 + mx_ops("int8", False, True, True))))
        args5 = ("int8", bs, 8, 1e-6, torch.bfloat16, False, 16)
        check_block(K5, bs, f"DiT {tuple(k5x.shape)} bf16 serving",
                    lambda: lnq.ln_modulate_quantize(k5x, k5h, k5s, *args5),
                    lambda: lnq.ln_modulate_quantize_ref(k5x, k5h, k5s,
                                                         *args5),
                    elementwise_bound(
                        k5x.numel() * 4 + 2 * k5h.numel() * 2,
                        k5x.numel() * (7 + mx_ops("int8", False, True, True))
                        + 5 * B * N + 3 * k5h.numel()))
    del qkv, deit_qkv, pq, pk, pv, ck, cv, lq, lk, lv, xq, xk, xv, eq, ek, ev
    del k5x, fc2, ada
    stamp("block sizes: kernel checks done")

    sinks = (block_sites, block_launches)
    qkv_routes = {n: collections.Counter(wrappers[n].routes) for n in (K2, K7)}
    base = init_dit(cfg, torch.Generator().manual_seed(0), dev,
                    randomize_all=True)
    for bs in TIMED_BLOCKS:
        model, specs = prequantize_weights(
            copy.deepcopy(base), dataclasses.replace(dit_mx_specs(),
                                                     block_size=bs),
            serve_dtype=torch.bfloat16)
        bq = dataclasses.replace(dit_q, mx_specs=specs)
        for contract in ("serving", "exact"):
            qc = dataclasses.replace(bq, contract=contract)
            sample_dit(model, qc, labels, gen, num_steps=2, device=dev)
            lat = run_path(f"DiT-XL/2 block {bs}", contract, BLOCK_STEPS,
                           dit_per_fwd, DIT_IMAGES,
                           lambda: sample_dit(model, qc, labels, gen,
                                              num_steps=BLOCK_STEPS,
                                              device=dev), sinks=sinks)
            if lat.shape != (DIT_IMAGES, 4, 32, 32) or \
                    not torch.isfinite(lat).all():
                fail(f"DiT block {bs} {contract}: latents not finite / "
                     "wrong shape")
            print(f"[block] DiT-XL/2 block {bs} {contract}: latent std "
                  f"{lat.float().std().item():.4g}", flush=True)
        if bs == 16:  # the fused opt-ins: K5, K6 and K7 at block 16
            qc = dataclasses.replace(bq, fuse_ln_modulate=True,
                                     fuse_gelu=True, qkv_layout="split_t",
                                     contract="serving")
            sample_dit(model, qc, labels, gen, num_steps=2, device=dev)
            lat = run_path("DiT-XL/2 fused opt-ins block 16", "serving",
                           BLOCK_STEPS, fused_per_fwd["serving"], DIT_IMAGES,
                           lambda: sample_dit(model, qc, labels, gen,
                                              num_steps=BLOCK_STEPS,
                                              device=dev), sinks=sinks)
        else:  # ELSA at block 64: the split entry, K3
            qc = dataclasses.replace(bq, pred_mode="ELSA", contract="serving")
            lat = run_path("DiT-XL/2 ELSA block 64", "serving",
                           BLOCK_SHORT_STEPS,
                           {K1: 4 * depth + 2, K2: 1, K3: depth - 1},
                           DIT_IMAGES,
                           lambda: sample_dit(model, qc, labels, gen,
                                              num_steps=BLOCK_SHORT_STEPS,
                                              device=dev,
                                              orthogonal_matrix=proj),
                           sinks=sinks)
        if lat.shape != (DIT_IMAGES, 4, 32, 32) or \
                not torch.isfinite(lat).all():
            fail(f"DiT block {bs} opt-ins / ELSA: latents not finite")
        del model
    del base
    # DiT-XL/2 512^2 at block 16: K4 in every block
    model = init_dit(cfg512, torch.Generator().manual_seed(0), dev,
                     randomize_all=True)
    model, specs = prequantize_weights(
        model, dataclasses.replace(dit_mx_specs(), block_size=16),
        serve_dtype=torch.bfloat16)
    qc = dataclasses.replace(dit512_q, mx_specs=specs, contract="serving")
    lat = run_path("DiT-XL/2 512^2 block 16", "serving", BLOCK_SHORT_STEPS,
                   {K1: 4 * cfg512.depth + 2, K4: cfg512.depth},
                   DIT512_IMAGES,
                   lambda: sample_dit(model, qc, labels512, gen,
                                      num_steps=BLOCK_SHORT_STEPS,
                                      device=dev), sinks=sinks)
    if lat.shape != (DIT512_IMAGES, 4, 64, 64) or \
            not torch.isfinite(lat).all():
        fail("DiT 512 block 16: latents not finite / wrong shape")
    del model
    # DeiT-small at block 16: K2 at N = 197, f32, key_bits 32
    vcfg = VIT_CONFIGS["deit_small_patch16_224"]
    vmodel = init_vit(vcfg, torch.Generator().manual_seed(0), dev)
    vmodel, vspecs = prequantize_weights(
        vmodel, dataclasses.replace(default_mx_specs(), block_size=16))
    qc = VitQuantConfig(mx_specs=vspecs, mx_quant=True, top_k=True, k=60,
                        contract="serving")
    vbatches = [(randn(DEIT_BATCH, 3, 224, 224),
                 torch.randint(0, 1000, (DEIT_BATCH,), generator=gen,
                               device=dev))
                for _ in range(BLOCK_DEIT_BATCHES)]
    stats = run_path("deit_small block 16", "serving", BLOCK_DEIT_BATCHES,
                     {K1: 4 * vcfg.depth, K2: vcfg.depth},
                     DEIT_BATCH * BLOCK_DEIT_BATCHES,
                     lambda: evaluate(vmodel, qc, vbatches, log_every=0,
                                      device=dev), sinks=sinks)
    if stats["n"] != DEIT_BATCH * BLOCK_DEIT_BATCHES:
        fail(f"DeiT-small block 16: evaluated {stats['n']} images")
    del vmodel, vbatches
    print(f"[block] launches at the block sizes other than 32: "
          f"{block_launches}", flush=True)
    # launches by route over the paths, their warm-up steps included
    qkv_routes = {n: dict(wrappers[n].routes - c)
                  for n, c in qkv_routes.items()}
    print(f"[block] K2 and K7 routes on the block-size paths (warm-ups "
          f"included): {qkv_routes}", flush=True)
    if any(set(r) != {ta.ROUTE_QKV_BS} for r in qkv_routes.values()):
        fail("K2 or K7 on the block-size paths off the blocks' tensor-core "
             f"builds: {qkv_routes}")

    def site_calls(name, site):
        """The kernel's call and its plain version's on random inputs of a
        call site the wrappers recorded (shapes, dtypes, arguments)."""
        if name in (K1, K5, K6):
            shape, dtype, *args = site
            x = randn(*shape, scale=3.0, dtype=dtype)
            if name == K5:
                sh, sc = (randn(shape[0], shape[2], scale=0.3, dtype=dtype)
                          for _ in range(2))
                return (lambda: lnq.ln_modulate_quantize(x, sh, sc, *args),
                        lambda: lnq.ln_modulate_quantize_ref(x, sh, sc,
                                                             *args))
            fn, ref = (mx_quantize, mx_quantize_ref) if name == K1 else \
                (gelu_quantize, gelu_quantize_ref)
            return lambda: fn(x, *args), lambda: ref(x, *args)
        if name == K2:
            shape, dtype, heads, kw = site
            x, kw = randn(*shape, dtype=dtype), dict(kw)
            return (lambda: ta.fused_topk_attention_qkv(x, heads, **kw),
                    lambda: ta.fused_topk_attention_qkv_ref(x, heads, **kw))
        if name == K7:
            qs, vs, dtype, heads, kw = site
            kw = dict(kw)
            d, dp = vs[2] // heads, qs[0] // (2 * heads)
            qk_t = randn(2 * heads, dp, *qs[1:], dtype=dtype)
            qk_t[:, d:] = 0  # the projection's zero padding
            qk_t = qk_t.reshape(qs)
            v = randn(*vs, dtype=dtype)
            return (lambda: ta.fused_topk_attention_qkv_t(qk_t, v, heads,
                                                          **kw),
                    lambda: ta.fused_topk_attention_qkv_t_ref(qk_t, v, heads,
                                                              **kw))
        qs, ks, dtype, bshape, pshape, kw = site  # K3, K4
        kw = dict(kw)
        q, kx = (randn(*s_, scale=4.0, dtype=dtype) for s_ in (qs, ks))
        vx = randn(*ks, dtype=dtype)
        bias = None if bshape is None else caption_bias(
            bshape[0], bshape[3], dev)[0]
        mp = None if pshape is None else orthogonal_matrix(qs[3], dev)
        fn = ta.fused_topk_attention if name == K3 else \
            ta.fused_topk_attention_tiled
        return (lambda: fn(q, kx, vx, bias, mp, **kw),
                lambda: ta.fused_topk_attention_ref(q, kx, vx, bias, mp,
                                                    **kw))

    # every call site the block-size paths gave a kernel, held bit for bit
    # to its plain version on random inputs of its shapes and arguments
    site_routes = collections.Counter()
    for name, sites in block_sites.items():
        for site in sites:
            fn, ref = site_calls(name, site)
            (got, route), want = served(name, fn), ref()
            torch.cuda.synchronize()
            block_err[name] = max(block_err[name], (
                got.float() - want.float()).abs().max().item())
            if not torch.equal(got, want) or not torch.isfinite(got).all():
                fail(f"{name} at the block-size paths' site {site} differs "
                     "from its plain version")
            if route is not None:
                site_routes[(name, route)] += 1
                if route != ta.ROUTE_QKV_BS:
                    fail(f"{name} at the block-size paths' site {site}: "
                         f"route {route}")
            del got, want, fn, ref
    print(f"[block] K2 and K7 sites of the block-size paths by route: "
          f"{dict(site_routes)}", flush=True)
    print(f"[block] each kernel at every site of the block-size paths "
          f"({ {n: len(s_) for n, s_ in block_sites.items()} } sites): "
          "bit-equal", flush=True)
    stamp("block sizes phase done")

    # 7c. the ablation tools' path (K8): every mode string of the four TPU
    # tools through the port's tools at their point, with every count set
    # to 0 just before and read just after; ``run`` holds each variant bit
    # for bit to its plain version before it times it, and compares its
    # output with the port's K3 in its tier: the modes of
    # ``EQUAL_TO_PROD`` must equal K3 and no other may
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
        w.sites.clear()
    t0 = time.perf_counter()
    ablate_rows = {tool: abc.run(table, "cuda", abc.CELLS)
                   for tool, table in abc.tool_tables().items()}
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {n: w.launches for n, w in wrappers.items()}
    path_launches["ablation tools"] = counts
    rows = [r for rs in ablate_rows.values() for r in rs]
    if counts[K8] != sum(r["launches"] for r in rows) or \
            any(r["launches"] < abc.REPS for r in rows):
        fail(f"ablation tools: K8 launched {counts[K8]} times, "
             f"{[(r['variant'], r['launches']) for r in rows]} by variant")
    if any(c for n, c in counts.items() if n not in (K3, K8)):
        fail(f"ablation tools: launches {counts}: only K8 and K3 (prod)")
    for tool, rs in ablate_rows.items():
        for r in rs:
            print(f"[ablate] {tool} {r['variant']} ({r['passes']}; layout "
                  f"{r['layout']}, {r['key_form']}, group {r['group']}): "
                  f"{r['ms']:.4f} ms x{r['launches']} (plain "
                  f"{r['plain_ms']:.2f} ms, bound {r['bound_ms']:.4f} ms by "
                  f"{r['bound_by']}); bit-equal to its plain version; "
                  f"{'equal to' if r['equal_to_prod'] else 'differs from'}"
                  f" K3 {r['tier']} (max |diff| {r['max_diff']:.4g})",
                  flush=True)
        equal = tuple(r["variant"] for r in rs if r["equal_to_prod"])
        if equal != abc.EQUAL_TO_PROD[tool]:
            fail(f"ablation tools: {tool}'s modes {equal} equal K3, "
                 f"{abc.EQUAL_TO_PROD[tool]} should")
    _, ladder = passprice_deltas(ablate_rows["passprice_bench"])
    print("[ablate] passprice ladder, ms and the delta from the rung before: "
          + ", ".join(f"{n} {t:.4f}" + ("" if d is None else f" ({d:+.4f})")
                      for n, t, d in ladder), flush=True)
    ablate_kernels = []
    for site in sorted({r["site"] for r in rows}):
        rs = [r for r in rows if r["site"] == site]
        ablate_kernels.append(dict(
            name=f"{K8} ({site})", route="cuda",
            source="mx_quantization_tpu_torch/csrc/topk_attention_ablate.cu",
            replaces=site, launches=sum(r["launches"] for r in rs),
            max_abs_err=max(r["max_abs_err"] for r in rs),
            **{key: sum(r[key] for r in rs) / len(rs)
               for key in ("ms", "plain_ms", "bound_ms")},
            bound_by=collections.Counter(
                r["bound_by"] for r in rs).most_common(1)[0][0],
            library_ms=None,
            variants=[{key: r[key] for key in (
                "variant", "word", "layout", "key_form", "group", "ms",
                "plain_ms", "bound_ms", "bound_by", "launches",
                "equal_to_prod", "max_diff")} for r in rs]))
    print(f"[ablate] {len(rows)} variants over {len(ablate_kernels)} TPU "
          f"sites in {dt:.1f} s, launches {counts}", flush=True)
    stamp("ablation tools phase done")

    # 7d. the measurement tools' path (K9, K10, K11): the three port tools
    # at their points, with every count set to 0 just before and read just
    # after; each ``run`` holds every variant bit for bit to its plain
    # version before it times it
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
        w.sites.clear()
    t0 = time.perf_counter()
    try:
        mm_rows = mm_tool.run("cuda")
        kth_rows = kth_tool.run("cuda")
        lane_rows = lane_tool.run("cuda")
    except AssertionError as e:
        fail(f"measurement tools: {e}")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {n: w.launches for n, w in wrappers.items()}
    path_launches["measurement tools"] = counts
    kth_strats = [r for r in kth_rows if r["variant"] != "kthvalue"]
    own = {K9: (mm_rows, mm_tool.REPS), K10: (kth_strats, kth_tool.REPS),
           K11: (lane_rows, lane_tool.REPS)}
    for n, (rows_, reps) in own.items():
        if counts[n] != sum(r["launches"] for r in rows_) or \
                any(r["launches"] < reps for r in rows_):
            fail(f"measurement tools: {n} launched {counts[n]} times, "
                 f"{[r['launches'] for r in rows_]} by variant")
    if any(c for n, c in counts.items() if n not in (K1, K9, K10, K11)):
        fail(f"measurement tools: launches {counts}: only K9, K10, K11 and "
             "K1 (the tools' comparisons)")
    for r in mm_rows:
        print(f"[measure] K9 {r['linear']} {tuple(r['shape'])}: "
              f"{r['ms']:.4f} ms x{r['launches']} (unfused {r['unfused_ms']:.4f}"
              f" ms, plain {r['plain_ms']:.2f} ms, bound {r['bound_ms']:.4f} "
              f"ms by {r['bound_by']}); bit-equal to its plain version; max "
              f"|K9 - unfused| {r['max_diff_unfused']:.4g} (largest summation "
              f"bound {r['max_sum_bound']:.4g}, bit-equal share "
              f"{r['bit_equal_share']:.4f})", flush=True)
        if not r["within_sum_bound"]:
            fail(f"K9 at {r['linear']} is farther from the unfused path than "
                 "the summation bound")
    lib_ms = kth_rows[-1]["ms"]
    for r in kth_strats:
        print(f"[measure] K10 {r['variant']}: {r['ms']:.4f} ms "
              f"x{r['launches']} (plain {r['plain_ms']:.2f} ms, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}, {r['steps']} "
              f"steps; torch.kthvalue {lib_ms:.4f} ms); bit-equal to its "
              f"plain version; equal to kthvalue: {r['equal_to_kthvalue']}",
              flush=True)
        if not r["equal_to_kthvalue"]:
            fail(f"K10 {r['variant']} differs from torch.kthvalue")
    for r in lane_rows:
        print(f"[measure] K11 {tuple(r['site'])} {r['format']} bfloat "
              f"{r['bfloat']}: {r['ms']:.4f} ms x{r['launches']} (K1 "
              f"{r['k1_ms']:.4f} ms, plain {r['plain_ms']:.2f} ms, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}); bit-equal to its "
              f"plain version; equal to K1: {r['equal_to_k1']}", flush=True)
        if not r["equal_to_k1"]:
            fail(f"K11 at {r['site']} {r['format']} differs from K1")

    def tool_kernel(name, source, rows_, library_ms, **extra):
        return dict(
            name=name, route="cuda",
            source=f"mx_quantization_tpu_torch/csrc/{source}",
            replaces=tpu_site(name), launches=counts[name],
            max_abs_err=max(r["max_abs_err"] for r in rows_),
            **{key: sum(r[key] for r in rows_) / len(rows_)
               for key in ("ms", "plain_ms", "bound_ms")},
            bound_by=collections.Counter(
                r["bound_by"] for r in rows_).most_common(1)[0][0],
            library_ms=library_ms, **extra, variants=rows_)
    measure_kernels = [
        tool_kernel(K9, mxmm.SOURCE, mm_rows, None, unfused_ms=sum(
            r["unfused_ms"] for r in mm_rows) / len(mm_rows)),
        tool_kernel(K10, kthsel.SOURCE, kth_strats, lib_ms),
        tool_kernel(K11, laneq.SOURCE, lane_rows, None, k1_ms=sum(
            r["k1_ms"] for r in lane_rows) / len(lane_rows))]
    print(f"[measure] {len(mm_rows) + len(kth_strats) + len(lane_rows)} "
          f"variants in {dt:.1f} s, launches {counts}", flush=True)
    stamp("measurement tools phase done")

    # 7. DiT-XL/2 256^2 on the emulation engine (dit_mx_specs("ref"), the
    # JAX CLI's --engine ref: f32 activations, weights quantized on the
    # fly), EMULATION_DIT_IMAGES images with CFG, exact tier: no kernel
    # may launch
    model = init_dit(cfg, torch.Generator().manual_seed(0), dev,
                     randomize_all=True)
    qc = DiTQuantConfig(mx_specs=dit_mx_specs("ref"), mx_quant=True,
                        top_k=True, k=154, ex_pred=True,
                        exclude_blocks=(27,))
    lat = run_path("DiT-XL/2 ref", "exact", EMULATION_STEPS, {},
                   EMULATION_DIT_IMAGES,
                   lambda: sample_dit(model, qc,
                                      labels[:EMULATION_DIT_IMAGES], gen,
                                      num_steps=EMULATION_STEPS, device=dev))
    if lat.shape != (EMULATION_DIT_IMAGES, 4, 32, 32) or \
            not torch.isfinite(lat).all():
        fail("DiT ref: latents not finite / wrong shape")
    print(f"[slice] DiT-XL/2 ref exact: latent std "
          f"{lat.float().std().item():.4g}", flush=True)
    del model

    # 8. PixArt-alpha 256^2
    pcfg = PixArtConfig()  # 256^2: latent 32, 28 layers, 16 heads of 72
    t0 = time.perf_counter()
    pmodel = init_pixart(pcfg, torch.Generator().manual_seed(0), dev)
    print(f"[slice] PixArt-alpha 256^2 random weights in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    embeds = randn(PIXART_PROMPTS, CAPTION_TOKENS, pcfg.caption_channels)
    _, mask = caption_bias(PIXART_PROMPTS, CAPTION_TOKENS, dev)
    null = randn(1, CAPTION_TOKENS, pcfg.caption_channels)
    pix_q = PixArtQuantConfig(
        mx_specs=pixart_mx_specs(), mx_quant=True, self_top_k=True, self_k=77,
        ex_pred=True, pred_mode="two_step_leading_ones", exclude_blocks=(27,))
    noise = randn(PIXART_PROMPTS, 4, 32, 32)
    pix_per_fwd = {K1: 10 * pcfg.num_layers, K3: 2 * pcfg.num_layers}
    for contract in ("serving", "exact"):
        qc = dataclasses.replace(pix_q, contract=contract)

        def sample(steps, qc=qc):
            return sample_pixart(pmodel, qc, embeds, mask, null,
                                 num_steps=steps, latents=noise, device=dev)

        sample(1)  # warm
        lat = run_path("PixArt-alpha-256", contract, PIXART_STEPS,
                       pix_per_fwd, PIXART_PROMPTS,
                       lambda: sample(PIXART_STEPS))
        if lat.shape != (PIXART_PROMPTS, 4, 32, 32) or \
                not torch.isfinite(lat).all():
            fail(f"PixArt {contract}: latents not finite / wrong shape")
        print(f"[slice] PixArt-alpha-256 {contract}: latent std "
              f"{lat.float().std().item():.4g}")
    qc = dataclasses.replace(pix_q, contract="serving")
    profile("PixArt-alpha-256", lambda: sample_pixart(
        pmodel, qc, embeds, mask, null, num_steps=2, latents=noise,
        device=dev), 2)

    # 8. each other predictor mode through the entry points: PixArt-alpha
    # 256^2 at full width, 8 prompts, 2 steps per tier, self top-k k = 77
    # and cross top-k k = 60 (ELSA without: JAX sends non-square ELSA to its
    # XLA path); K3 56 per forward
    for mode in NEW_MODES:
        mq = dataclasses.replace(pix_q, pred_mode=mode,
                                 cross_top_k=mode != "ELSA", cross_k=60)
        for contract in ("serving", "exact"):
            qc = dataclasses.replace(mq, contract=contract)
            lat = run_path(f"PixArt-alpha-256 {mode}", contract, 2,
                           pix_per_fwd, MODE_PROMPTS,
                           lambda: sample_pixart(
                               pmodel, qc, embeds[:MODE_PROMPTS],
                               mask[:MODE_PROMPTS], null, num_steps=2,
                               latents=noise[:MODE_PROMPTS], device=dev))
            if lat.shape != (MODE_PROMPTS, 4, 32, 32) or \
                    not torch.isfinite(lat).all():
                fail(f"PixArt {mode} {contract}: latents not finite / wrong "
                     "shape")

    # 8. PixArt-alpha 256^2 on the emulation engine (pixart_mx_specs("ref")),
    # 8 prompts with CFG (16 rows), exact tier: no kernel may launch
    qc = dataclasses.replace(pix_q, mx_specs=pixart_mx_specs("ref"))
    lat = run_path("PixArt-alpha-256 ref", "exact", EMULATION_STEPS, {},
                   MODE_PROMPTS, lambda: sample_pixart(
                       pmodel, qc, embeds[:MODE_PROMPTS], mask[:MODE_PROMPTS],
                       null, num_steps=EMULATION_STEPS,
                       latents=noise[:MODE_PROMPTS], device=dev))
    if lat.shape != (MODE_PROMPTS, 4, 32, 32) or not torch.isfinite(lat).all():
        fail("PixArt ref: latents not finite / wrong shape")
    print(f"[slice] PixArt-alpha-256 ref exact: latent std "
          f"{lat.float().std().item():.4g}", flush=True)
    del embeds, null

    # 8e. the end-task path at full width: T5-XXL, the VAE, Inception, CLIP
    # and workloads/accuracy.py
    stamp("end-task phase starts")
    endtask_stats = endtask(dev, smi, pmodel,
                            dataclasses.replace(pix_q, contract="serving"),
                            pix_per_fwd, dit_latents, dit_per_fwd, run_path,
                            check_k1)
    del dit_latents
    stamp("end-task phase done")

    # 8t. quantization-aware training: the trajectory golden, DiT-XL/2
    # 256^2 and DeiT-small at full width, a tiny step against the CPU, one
    # DiT step profiled
    training_stats = training(dev, smi, run_path, profile, stamp)
    stamp("training phase done")

    # 8s. the PixArt server at its operating point: the same weights
    # prequantized to bf16, bf16 activations at 64 model rows, key_bits 8,
    # DPM-Solver++ 20 steps, CFG 4.5, a staggered stream of synthetic
    # captions with mask lengths from 8 to 120.  First K1 and K3 at the
    # server's sites (bf16, 64 rows; the cross bias from per-row masks)
    # against their plain versions, bit for bit
    pmodel, pspecs = prequantize_weights(pmodel, pixart_mx_specs(),
                                         serve_dtype=torch.bfloat16)
    rows = 2 * SERVER_SLOTS
    for shape in ((rows, 256, 1152), (rows, CAPTION_TOKENS, 1152),
                  (rows, 256, 4608)):
        x = randn(*shape, dtype=torch.bfloat16)
        for bfloat in (0, 32):
            check_k1(x, flush=True, bfloat=bfloat)
    print(f"[k1] the PixArt server's sites ({rows} rows, bf16, flush, bfloat "
          "0/32): bit-equal", flush=True)
    q, kx, kc = (randn(rows, H, n, D, scale=4.0, dtype=torch.bfloat16)
                 for n in (256, 256, CAPTION_TOKENS))
    vx, vc = (randn(rows, H, n, D, dtype=torch.bfloat16)
              for n in (256, CAPTION_TOKENS))
    bias, _ = caption_bias(rows, CAPTION_TOKENS, dev)
    for contract in ("serving", "exact"):
        kw = dict(scale=D ** -0.5, key_bits=8, flush=True, contract=contract,
                  out_dtype=torch.bfloat16)
        check_k3("server self top-k two_step k=77", q, kx, vx, None, k=77,
                 pred_mode="two_step_leading_ones", **kw)
        check_k3("server self dense", q, kx, vx, None, k=256, approx=False,
                 **kw)
        check_k3("server cross dense S=120 bias", q, kc, vc, bias,
                 k=CAPTION_TOKENS, approx=False, **kw)
    del q, kx, vx, kc, vc, bias

    # the static sampler on the same captions and initial latents (the
    # server's refill draws, replayed), for the printed differences; and
    # on the first SERVER_SLOTS of them alone, for the spread that the
    # batch's shape alone makes (cuBLAS picks its kernels by shape)
    replay = torch.Generator(device=dev).manual_seed(SERVER_SEED)
    z = torch.stack([torch.randn((4, 32, 32), generator=replay, device=dev)
                     for _ in range(STAGGERED_REQS)])
    conds = [sb.pixart_request(0, i).condition
             for i in range(STAGGERED_REQS)]
    embeds = torch.from_numpy(np.stack([c["embeds"] for c in conds]))
    mask = torch.from_numpy(np.stack([c["mask"] for c in conds]))
    null = torch.from_numpy(sb.pixart_null()["embeds"])[None]

    def static(n):
        return sample_pixart(pmodel, sb.pixart_qcfg(pspecs, "serving"),
                             embeds[:n], mask[:n], null,
                             num_steps=PIXART_STEPS, latents=z[:n],
                             device=dev).cpu()
    ref = static(STAGGERED_REQS)
    spread = (static(SERVER_SLOTS) - ref[:SERVER_SLOTS]).abs().amax(
        dim=(1, 2, 3))
    print(f"[server] sample_pixart alone, {SERVER_SLOTS} prompts against "
          f"the same in a batch of {STAGGERED_REQS}: max |diff| "
          f"{spread.max().item():.3e}, median {spread.median().item():.3e} "
          f"(latent std {ref.std().item():.4g})", flush=True)
    del z, conds, embeds, mask, null
    srv = sb.pixart_server(pmodel, pspecs, "serving", SERVER_SLOTS,
                           PIXART_STEPS, dev)
    run = run_server("PixArt-alpha-256 server staggered", "serving", srv,
                     sb.pixart_request, STAGGERED_REQS, pix_per_fwd,
                     (4, 32, 32), period=1)
    diffs = [(torch.from_numpy(run["results"][10000 + i].latent) - ref[i]
              ).abs().max().item() for i in range(STAGGERED_REQS)]
    print(f"[server] PixArt-alpha-256 staggered: each result's max |diff| "
          f"from sample_pixart (same caption and initial latent, 96 rows, "
          f"not gated): max {max(diffs):.3e}, median "
          f"{float(np.median(diffs)):.3e}: "
          f"{[float(f'{d:.3g}') for d in diffs]}", flush=True)
    profile_server("PixArt-alpha-256 server", srv, sb.pixart_request)
    del pmodel, srv, ref

    # 8. PixArt-alpha 1024^2 (tools/workload_probe.py pixart1024_probe):
    # sample_size 128 (N = 4096 latent tokens) with micro-conditioning, 1
    # prompt with CFG (2 rows), weights prequantized to bf16, bf16
    # activations, self top-k two_step k = 77 and cross top-k k = 60 at
    # key_bits 8, block 27 dense; every attention is K4 (28 self, 28 cross
    # per forward), every quantized linear K1
    p1cfg = PixArtConfig(sample_size=128)
    t0 = time.perf_counter()
    pmodel = init_pixart(p1cfg, torch.Generator().manual_seed(0), dev)
    pmodel, p1specs = prequantize_weights(pmodel, pixart_mx_specs(),
                                          serve_dtype=torch.bfloat16)
    print(f"[slice] PixArt-alpha 1024^2 random weights, prequantized bf16, "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    embeds = randn(1, CAPTION_TOKENS, p1cfg.caption_channels)
    _, mask = caption_bias(1, CAPTION_TOKENS, dev, shortest=77)
    null = randn(1, CAPTION_TOKENS, p1cfg.caption_channels)
    noise = randn(1, 4, 128, 128)
    pix1_q = PixArtQuantConfig(
        mx_specs=p1specs, mx_quant=True, self_top_k=True, self_k=77,
        cross_top_k=True, cross_k=60, ex_pred=True,
        pred_mode="two_step_leading_ones", exclude_blocks=(27,),
        topk_key_bits=8, activation_dtype="bfloat16")
    pix1_per_fwd = {K1: 10 * p1cfg.num_layers, K4: 2 * p1cfg.num_layers}
    for contract in ("serving", "exact"):
        qc = dataclasses.replace(pix1_q, contract=contract)

        def sample(steps, qc=qc):
            return sample_pixart(pmodel, qc, embeds, mask, null,
                                 num_steps=steps, latents=noise, device=dev)

        sample(1)  # warm
        lat = run_path("PixArt-alpha-1024", contract, PIXART1024_STEPS,
                       pix1_per_fwd, 1, lambda: sample(PIXART1024_STEPS))
        if lat.shape != (1, 4, 128, 128) or not torch.isfinite(lat).all():
            fail(f"PixArt-1024 {contract}: latents not finite / wrong shape")
        print(f"[slice] PixArt-alpha-1024 {contract}: latent std "
              f"{lat.float().std().item():.4g}")
    qc = dataclasses.replace(pix1_q, contract="serving")
    profile("PixArt-alpha-1024", lambda: sample_pixart(
        pmodel, qc, embeds, mask, null, num_steps=2, latents=noise,
        device=dev), 2)
    del pmodel, embeds, null

    stamp("DiT and PixArt paths done")
    # 8. the DeiT slice (tools/workload_probe.py deit_probe): each model at
    # full width and depth, weights prequantized (f32), batches of 100
    # synthetic 224^2 images with labels, through evaluate; per forward K1
    # 48 (qkv, proj, fc1 and fc2 of 12 blocks) and K2 12 (11 top-k, in
    # ex_pred or, DeiT-base, two_step; block 11 dense); with fuse_gelu
    # (serving) K6 12 and K1 36
    images = [randn(DEIT_BATCH, 3, 224, 224) for _ in range(DEIT_BATCHES)]
    batches = [(x, torch.randint(0, 1000, (DEIT_BATCH,), generator=gen,
                                 device=dev)) for x in images]

    def deit_emulation(name, vcfg, vmodel, vspecs, pred, k):
        """The emulation path at DeiT-small and -base: the ref engine
        (weights prequantized through its branch, which at DeiT's specs
        gives the fast branch's grid points), no kernel; at DeiT-small also
        sparse_impl="gather" on the fused engine (K1 in front of the four
        linears and of the true score product's q in every block, no K2)
        and block 0's attention on the ref engine against K2's exact tier."""
        depth, short = vcfg.depth, name.split("_patch")[0]
        rmodel = init_vit(vcfg, torch.Generator().manual_seed(0), dev)
        rmodel, rspecs = prequantize_weights(rmodel, default_mx_specs("ref"))
        for (pname, pr), (_, pf) in zip(rmodel.named_parameters(),
                                        vmodel.named_parameters()):
            if not torch.equal(pr, pf):
                fail(f"{short}: the ref and fused prequantize differ at "
                     f"{pname}")
        exact = VitQuantConfig(mx_specs=vspecs, mx_quant=True, top_k=True,
                               k=k, pred_mode=pred, contract="exact")
        qr = dataclasses.replace(exact, mx_specs=rspecs)
        with torch.inference_mode():  # warm, and the same batch both ways
            lf = vit_forward(vmodel, images[0], exact)
            lr = vit_forward(rmodel, images[0], qr)
        if lr.shape != (DEIT_BATCH, 1000) or not torch.isfinite(lr).all():
            fail(f"{short} ref: logits not finite / wrong shape")
        top1 = (lr.argmax(-1) == lf.argmax(-1)).float().mean().item()
        print(f"[emulation] {short} logits, ref against fused exact on one "
              f"batch: max |diff| {(lr - lf).abs().max().item():.4e} (logit "
              f"std {lf.std().item():.4g}), top-1 agreement {top1:.4f}",
              flush=True)
        n = DEIT_BATCH * EMULATION_BATCHES
        stats = run_path(f"{short} {pred} k={k} ref", "exact",
                         EMULATION_BATCHES, {}, n,
                         lambda: evaluate(rmodel, qr,
                                          batches[:EMULATION_BATCHES],
                                          log_every=0, device=dev))
        if stats["n"] != n:
            fail(f"{short} ref: evaluated {stats['n']} images")
        del rmodel
        if name != "deit_small_patch16_224":
            return
        qg = dataclasses.replace(exact, sparse_impl="gather")
        with torch.inference_mode():  # warm
            lg = vit_forward(vmodel, images[0], qg)
        if lg.shape != (DEIT_BATCH, 1000) or not torch.isfinite(lg).all():
            fail(f"{short} gather: logits not finite / wrong shape")
        stats = run_path(f"{short} {pred} k={k} gather", "exact",
                         EMULATION_BATCHES, {K1: 5 * depth}, n,
                         lambda: evaluate(vmodel, qg,
                                          batches[:EMULATION_BATCHES],
                                          log_every=0, device=dev))
        if stats["n"] != n:
            fail(f"{short} gather: evaluated {stats['n']} images")
        # block 0's attention inputs of one batch: the ref engine's
        # topk_attention against K2's exact tier on the same q, k, v, held
        # on the query rows whose top-k selections agree (K2's selection is
        # the fused engine's masked selection of its predictor scores)
        H, D = vcfg.num_heads, vcfg.head_dim
        with torch.inference_mode():
            blk = vmodel.blocks[0]
            h = layer_norm(vit_embed(vmodel, images[0]), blk.norm1, vcfg.eps)
            qkv = linear(h, blk.attn.qkv.weight, blk.attn.qkv.bias,
                         mx_specs=vspecs)
            B, N, _ = qkv.shape
            q, kx, v = (t.contiguous() for t in qkv.reshape(
                B, N, 3, H, D).permute(2, 0, 3, 1, 4))
            acfg = TopKAttentionConfig(k=k, pred_mode=pred, contract="exact")
            out_ref, idx = topk_attention(q, kx, v, D ** -0.5, rspecs, acfg)
            out_k2 = fused_qkv_topk_attention(qkv, H, D ** -0.5, vspecs,
                                              acfg).reshape(
                B, N, H, D).permute(0, 2, 1, 3)
            sel_ref = torch.zeros(B, H, N, N, dtype=torch.bool,
                                  device=dev).scatter(-1, idx, True)
            sel_k2 = _topk_mask(predict_scores(q, kx, vspecs, pred), k)
            same = (sel_ref == sel_k2).all(-1)
            close = torch.isclose(out_ref, out_k2, rtol=2e-4,
                                  atol=2e-5).all(-1)
            share = close[same].float().mean().item()
        print(f"[emulation] {short} block 0 attention, ref against K2 exact: "
              f"{same.float().mean().item():.4f} of query rows select the "
              f"same keys; {share:.4f} of those within 2e-4 / 2e-5 "
              f"(bound 0.99); max |diff| on them "
              f"{(out_ref - out_k2).abs().amax(-1)[same].max().item():.3e}",
              flush=True)
        if share < 0.99:
            fail(f"{short}: the ref engine's attention differs from K2's")
    for name, pred, k in DEIT_POINTS:
        t0 = time.perf_counter()
        vcfg = VIT_CONFIGS[name]
        vmodel = init_vit(vcfg, torch.Generator().manual_seed(0), dev)
        vmodel, vspecs = prequantize_weights(vmodel, default_mx_specs())
        print(f"[slice] {name} random weights, prequantized, in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        depth, short = vcfg.depth, name.split("_patch")[0]
        plans = [("serving", False), ("exact", False)]
        if name == "deit_small_patch16_224":
            plans.append(("serving", True))
        for contract, fuse in plans:
            qc = VitQuantConfig(mx_specs=vspecs, mx_quant=True, top_k=True,
                                k=k, pred_mode=pred, contract=contract,
                                fuse_gelu=fuse)
            if fuse:
                per = {K1: 3 * depth, K6: depth, K2: depth}
            else:
                per = {K1: 4 * depth, K2: depth}
            with torch.inference_mode():  # warm
                logits = vit_forward(vmodel, images[0], qc)
            if logits.shape != (DEIT_BATCH, 1000) or \
                    not torch.isfinite(logits).all():
                fail(f"{name} {contract}: logits not finite / wrong shape")
            label = f"{short} {pred} k={k}" + (" fuse_gelu" if fuse else "")
            stats = run_path(label, contract, DEIT_BATCHES, per,
                             DEIT_BATCH * DEIT_BATCHES,
                             lambda: evaluate(vmodel, qc, batches,
                                              log_every=0, device=dev))
            if stats["n"] != DEIT_BATCH * DEIT_BATCHES:
                fail(f"{label} {contract}: evaluated {stats['n']} images")
            print(f"[slice] {label} {contract}: {stats}; logits std "
                  f"{logits.std().item():.4g}", flush=True)
        if name != "deit_tiny_patch16_224":
            qc = VitQuantConfig(mx_specs=vspecs, mx_quant=True, top_k=True,
                                k=k, pred_mode=pred, contract="serving")
            profile(f"{short} (one batch)", lambda: evaluate(
                vmodel, qc, batches[:1], log_every=0, device=dev), 1)
            deit_emulation(name, vcfg, vmodel, vspecs, pred, k)
        del vmodel
    del images, batches

    stamp("DeiT paths done")
    # ---- 10. kernel times at every call site the paths launched, weighted
    # by their launches there, each site first held bit for bit to its plain
    # version
    k1_sites = []
    for (shape, dtype, *args), n in sorted(main_sites[K1].items(),
                                           key=lambda kv: -kv[1]):
        x = randn(*shape, dtype=dtype)
        if not torch.equal(mx_quantize(x, *args), mx_quantize_ref(x, *args)):
            fail(f"K1 at {(shape, dtype, *args)} differs from its plain "
                 "version")
        (ms, queued), (pms, _) = (time_ms(lambda: mx_quantize(x, *args), 200),
                                  time_ms(lambda: mx_quantize_ref(x, *args),
                                          10))
        in_bf16 = dtype == torch.bfloat16
        bound, by, terms = elementwise_bound(
            x.numel() * (x.element_size() + args[3].itemsize),
            x.numel() * mx_ops(args[0], args[4], args[5] == 16 and not in_bf16,
                               in_bf16))
        k1_sites.append(dict(shape=list(shape), dtype=str(dtype),
                             format=args[0], flush=args[4], bfloat=args[5],
                             launches=n, ms=ms, plain_ms=pms, bound_ms=bound,
                             bound_by=by, **terms, queued=queued))
        print(f"[time] K1 {tuple(shape)} {dtype} flush={args[4]} x{n}: "
              f"{ms:.4f} ms (plain {pms:.3f} ms, bound {bound:.4f} ms by {by}: "
              f"{ {t: round(v, 4) for t, v in terms.items()} }; launches "
              f"queued ahead: {queued})", flush=True)

    k2_sites = []
    for (shape, dtype, heads, kw), n in sorted(main_sites[K2].items(),
                                               key=lambda kv: -kv[1]):
        kw = dict(kw)
        x = randn(*shape, dtype=dtype)
        if not torch.equal(ta.fused_topk_attention_qkv(x, heads, **kw),
                           ta.fused_topk_attention_qkv_ref(x, heads, **kw)):
            fail(f"K2 at {(shape, dtype, heads, kw)} differs from its plain "
                 "version")
        (ms, queued), (pms, _) = (
            time_ms(lambda: ta.fused_topk_attention_qkv(x, heads, **kw), 20),
            time_ms(lambda: ta.fused_topk_attention_qkv_ref(x, heads, **kw),
                    2, warmup=1))
        b, t, f = shape
        pred = kw["pred_mode"] if kw["k"] < t and kw["approx"] else None
        bound, by, terms = attention_bound(
            b * heads, t, t, f // (3 * heads), x.element_size(),
            kw["out_dtype"].itemsize, kw["k"], kw["key_bits"], kw["k"] < t,
            pred=pred)
        k2_sites.append(dict(contract=kw["contract"], k=kw["k"],
                             shape=list(shape), dtype=str(dtype),
                             pred_mode=pred, launches=n, ms=ms, plain_ms=pms,
                             bound_ms=bound, bound_by=by, queued=queued))
        print(f"[time] K2 {tuple(shape)} {pred} {kw['contract']} "
              f"k={kw['k']} x{n}: {ms:.4f} ms "
              f"(plain {pms:.2f} ms, bound {bound:.4f} ms by {by}: "
              f"{ {t: round(v, 4) for t, v in terms.items()} }; launches "
              f"queued ahead: {queued})", flush=True)

    def split_sites(label, kernel):
        """Times of K3 or K4 at each call site of the paths, each site's
        output held bit for bit to the plain version's.  Where a site has
        over 2^28 (query, key) pairs, the plain version takes half the heads
        and its time is doubled (its score tensors would not fit)."""
        nonlocal k3_err, k4_err
        out = []
        for (qs, ks, dtype, bshape, pshape, kw), n in sorted(
                main_sites[kernel.__name__].items(), key=lambda kv: -kv[1]):
            kw = dict(kw)
            q = randn(*qs, scale=4.0, dtype=dtype)
            kx = randn(*ks, scale=4.0, dtype=dtype)
            vx = randn(*ks, dtype=dtype)
            bias = None if bshape is None else caption_bias(
                bshape[0], bshape[3], dev)[0]
            mp = None if pshape is None else orthogonal_matrix(qs[3], dev)
            b, h, nq, d = qs
            s = ks[2]
            ms, queued = time_ms(lambda: kernel(q, kx, vx, bias, mp, **kw),
                                 20)
            hp = h if b * h * nq * s <= 2 ** 28 else h // 2
            hq, hk, hv = (t[:, :hp].contiguous() for t in (q, kx, vx))
            pms, _ = time_ms(lambda: ta.fused_topk_attention_ref(
                hq, hk, hv, bias, mp, **kw), 2, warmup=1)
            pms *= h / hp
            got = kernel(q, kx, vx, bias, mp, **kw)[:, :hp]
            want = ta.fused_topk_attention_ref(hq, hk, hv, bias, mp, **kw)
            err = (got.float() - want.float()).abs().max().item()
            if kernel is ta.fused_topk_attention:
                k3_err = max(k3_err, err)
            else:
                k4_err = max(k4_err, err)
            if not torch.equal(got, want) or not torch.isfinite(got).all():
                fail(f"{label} at {(qs, ks, bshape, kw)} differs from its "
                     "plain version")
            del got, want
            topk = kw["k"] < s
            pred = kw["pred_mode"] if topk and kw["approx"] else None
            bound, by, terms = attention_bound(
                b * h, nq, s, d, q.element_size(), kw["out_dtype"].itemsize,
                kw["k"], kw["key_bits"], topk,
                extra_bytes=0 if bias is None else b * s * 4, pred=pred)
            out.append(dict(contract=kw["contract"], k=kw["k"],
                            q_shape=list(qs), k_shape=list(ks),
                            dtype=str(dtype), bias=bshape is not None,
                            pred_mode=pred, launches=n, ms=ms, plain_ms=pms,
                            bound_ms=bound, bound_by=by, queued=queued))
            print(f"[time] {label} {kw['contract']} k={kw['k']} N={nq} S={s} "
                  f"pred={pred} bias={bshape is not None} {dtype} x{n}: "
                  f"bit-equal to the plain version; {ms:.4f} ms (plain {pms:.2f} ms, bound {bound:.4f} ms by "
                  f"{by}: { {t: round(v, 4) for t, v in terms.items()} }; "
                  f"launches queued ahead: {queued})", flush=True)
            del q, kx, vx, hq, hk, hv
        return out

    def mode_table(name):
        """K3's or K4's times per mode at phase 5's sites, beside their
        bounds and the plain version's time."""
        out = {}
        for t in mode_times:
            if t["kernel"] != name:
                continue
            b, h, n, s, d, nbytes, has_bias = t["shape"]
            bound, by, _ = attention_bound(
                b * h, n, s, d, nbytes, nbytes, 77 if s > 120 else 60,
                32 if name == K3 else 8, True,
                extra_bytes=b * s * 4 if has_bias else 0, pred=t["mode"])
            out.setdefault(t["mode"], []).append(dict(
                site=f"{t['site']} {(b, h, n, s, d)}",
                contract=t["contract"], ms=t["ms"], plain_ms=t["plain_ms"],
                bound_ms=bound, bound_by=by))
            print(f"[time] {name} mode {t['mode']} {t['site']} "
                  f"{(b, h, n, s, d)} {t['contract']}: {t['ms']:.3f} ms "
                  f"(plain {t['plain_ms']:.1f} ms, bound {bound:.4f} ms by "
                  f"{by})", flush=True)
        return out

    k3_sites = split_sites("K3", ta.fused_topk_attention)
    k4_sites = split_sites("K4", ta.fused_topk_attention_tiled)
    k3_modes, k4_modes = mode_table(K3), mode_table(K4)

    k5_sites = []
    for (shape, dtype, *args), n in sorted(main_sites[K5].items(),
                                           key=lambda kv: -kv[1]):
        x = randn(*shape, scale=3.0, dtype=dtype)
        sh = randn(shape[0], shape[2], scale=0.3, dtype=dtype)
        sc = randn(shape[0], shape[2], scale=0.3, dtype=dtype)
        (ms, queued), (pms, _) = (
            time_ms(lambda: lnq.ln_modulate_quantize(x, sh, sc, *args), 200),
            time_ms(lambda: lnq.ln_modulate_quantize_ref(x, sh, sc, *args),
                    10))
        # operations: per element the quantize and LN's 7 (the mean's add,
        # the centring, the square and its add, the products by rs and by
        # 1 + scale, the add of shift); per row 5 (two products by 1/C, the
        # add of eps, the root, the division); per (batch element, channel)
        # of shift and scale 3 (their f32 casts, 1 + scale)
        rows = shape[0] * shape[1]
        bound, by, terms = elementwise_bound(
            x.numel() * (x.element_size() + args[4].itemsize)
            + 2 * sh.numel() * sh.element_size(),
            x.numel() * (7 + mx_ops(args[0], args[5], args[6] == 16,
                                    dtype == torch.bfloat16))
            + 5 * rows + 3 * sh.numel())
        k5_sites.append(dict(shape=list(shape), dtype=str(dtype),
                             format=args[0], flush=args[5], bfloat=args[6],
                             launches=n, ms=ms, plain_ms=pms, bound_ms=bound,
                             bound_by=by, **terms, queued=queued))
        print(f"[time] K5 {tuple(shape)} {dtype} x{n}: {ms:.4f} ms (plain "
              f"{pms:.3f} ms, bound {bound:.4f} ms by {by}: "
              f"{ {t: round(v, 4) for t, v in terms.items()} }; launches "
              f"queued ahead: {queued})", flush=True)

    k6_sites = []
    for (shape, dtype, *args), n in sorted(main_sites[K6].items(),
                                           key=lambda kv: -kv[1]):
        x = randn(*shape, scale=2.0, dtype=dtype)
        if not torch.equal(gelu_quantize(x, *args),
                           gelu_quantize_ref(x, *args)):
            fail(f"K6 at {(shape, dtype, *args)} differs from its plain "
                 "version")
        (ms, queued), (pms, _) = (
            time_ms(lambda: gelu_quantize(x, *args), 200),
            time_ms(lambda: gelu_quantize_ref(x, *args), 10))
        # GELU as _gelu_f32 spells it: tanh form 9 (x * x * x, two
        # products and an add inside, the product by sqrt(2/pi), tanh, the
        # add of 1, two products), erf form 5 (three products, a negation,
        # erfc)
        bound, by, terms = elementwise_bound(
            x.numel() * (x.element_size() + args[3].itemsize),
            x.numel() * ((9 if args[6] else 5)
                         + mx_ops(args[0], args[4], args[5] == 16,
                                  dtype == torch.bfloat16)))
        k6_sites.append(dict(shape=list(shape), dtype=str(dtype),
                             format=args[0], flush=args[4], bfloat=args[5],
                             approximate=args[6], launches=n, ms=ms,
                             plain_ms=pms, bound_ms=bound, bound_by=by,
                             **terms, queued=queued))
        print(f"[time] K6 {tuple(shape)} {dtype} x{n}: {ms:.4f} ms (plain "
              f"{pms:.3f} ms, bound {bound:.4f} ms by {by}: "
              f"{ {t: round(v, 4) for t, v in terms.items()} }; launches "
              f"queued ahead: {queued})", flush=True)

    k7_sites = []
    for (qs, vs, dtype, heads, kw), n in sorted(main_sites[K7].items(),
                                                key=lambda kv: -kv[1]):
        kw = dict(kw)
        fh, b, t = qs
        d, dp = vs[2] // heads, fh // (2 * heads)
        qk_t = randn(2 * heads, dp, b, t, dtype=dtype)
        qk_t[:, d:] = 0  # the projection's zero padding
        qk_t = qk_t.reshape(qs)
        v = randn(*vs, dtype=dtype)
        if not torch.equal(
                ta.fused_topk_attention_qkv_t(qk_t, v, heads, **kw),
                ta.fused_topk_attention_qkv_t_ref(qk_t, v, heads, **kw)):
            fail(f"K7 at {(qs, vs, dtype, heads, kw)} differs from its plain "
                 "version")
        (ms, queued), (pms, _) = (
            time_ms(lambda: ta.fused_topk_attention_qkv_t(qk_t, v, heads,
                                                          **kw), 20),
            time_ms(lambda: ta.fused_topk_attention_qkv_t_ref(qk_t, v, heads,
                                                              **kw),
                    2, warmup=1))
        pred = kw["pred_mode"] if kw["k"] < t and kw["approx"] else None
        bound, by, terms = attention_bound(
            b * heads, t, t, d, qk_t.element_size(), kw["out_dtype"].itemsize,
            kw["k"], kw["key_bits"], kw["k"] < t, pred=pred)
        k7_sites.append(dict(contract=kw["contract"], k=kw["k"],
                             qk_t_shape=list(qs), v_shape=list(vs),
                             dtype=str(dtype), pred_mode=pred, launches=n,
                             ms=ms, plain_ms=pms, bound_ms=bound, bound_by=by,
                             queued=queued))
        print(f"[time] K7 {pred} {kw['contract']} k={kw['k']} x{n}: "
              f"{ms:.4f} ms "
              f"(plain {pms:.2f} ms, bound {bound:.4f} ms by {by}: "
              f"{ {t: round(v, 4) for t, v in terms.items()} }; launches "
              f"queued ahead: {queued})", flush=True)

    k1, k2, k3, k4 = (mix(k1_sites), mix(k2_sites), mix(k3_sites),
                      mix(k4_sites))
    k5, k6, k7 = mix(k5_sites), mix(k6_sites), mix(k7_sites)
    kernels = [
        dict(name=K1, route="triton",
             source="mx_quantization_tpu_torch/ops/kernels/quantize.py",
             replaces=tpu_site(K1),
             launches=main_launches[K1], max_abs_err=k1_err,
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], bytes_ms=k1["bytes_ms"],
             cuda_core_ms=k1["cuda_core_ms"], library_ms=None,
             sites=k1_sites),
        dict(name=K2, route="cuda",
             source="mx_quantization_tpu_torch/csrc/topk_attention_qkv.cu",
             replaces=tpu_site(K2),
             launches=main_launches[K2], max_abs_err=k2_err, ms=k2["ms"],
             plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None, sites=k2_sites),
        dict(name=K3, route="cuda",
             source="mx_quantization_tpu_torch/csrc/topk_attention_split.cu",
             replaces=tpu_site(K3),
             launches=main_launches[K3], max_abs_err=k3_err, ms=k3["ms"],
             plain_ms=k3["plain_ms"], bound_ms=k3["bound_ms"],
             bound_by=k3["bound_by"], library_ms=None, sites=k3_sites,
             modes=k3_modes),
        dict(name=K4, route="cuda",
             source="mx_quantization_tpu_torch/csrc/topk_attention_split.cu",
             replaces=tpu_site(K4),
             launches=main_launches[K4], max_abs_err=k4_err, ms=k4["ms"],
             plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"],
             bound_by=k4["bound_by"], library_ms=None, sites=k4_sites,
             modes=k4_modes),
        dict(name=K5, route="cuda",
             source="mx_quantization_tpu_torch/csrc/ln_modulate_quantize.cu",
             replaces=tpu_site(K5),
             launches=main_launches[K5], max_abs_err=errs[K5], ms=k5["ms"],
             plain_ms=k5["plain_ms"], bound_ms=k5["bound_ms"],
             bound_by=k5["bound_by"], bytes_ms=k5["bytes_ms"],
             cuda_core_ms=k5["cuda_core_ms"], library_ms=None,
             sites=k5_sites),
        dict(name=K6, route="triton",
             source="mx_quantization_tpu_torch/ops/kernels/quantize.py",
             replaces=tpu_site(K6),
             launches=main_launches[K6], max_abs_err=errs[K6], ms=k6["ms"],
             plain_ms=k6["plain_ms"], bound_ms=k6["bound_ms"],
             bound_by=k6["bound_by"], bytes_ms=k6["bytes_ms"],
             cuda_core_ms=k6["cuda_core_ms"], library_ms=None,
             sites=k6_sites),
        dict(name=K7, route="cuda",
             source="mx_quantization_tpu_torch/csrc/topk_attention_qkv.cu",
             replaces=tpu_site(K7),
             launches=main_launches[K7], max_abs_err=errs[K7], ms=k7["ms"],
             plain_ms=k7["plain_ms"], bound_ms=k7["bound_ms"],
             bound_by=k7["bound_by"], library_ms=None, sites=k7_sites),
    ]
    blocks_src = "mx_quantization_tpu_torch/csrc/topk_attention_blocks.cu"
    for entry in list(kernels):
        name = entry["name"]
        if name not in block_timed:
            continue
        sites = block_timed[name]
        # the mean over the sites timed at TIMED_BLOCKS
        mean = {key: sum(st[key] for st in sites) / len(sites)
                for key in ("ms", "plain_ms", "bound_ms")}
        # K1, K5, K6: the block a launch argument; K2 and K7 on the int
        # grids: their source built for the block; K3 and K4: the blocks
        # kernel
        own = name in (K1, K5, K6) or all(
            st["route"] == ta.ROUTE_QKV_BS for st in sites)
        kernels.append(dict(
            name=f"{name} (blocks {', '.join(map(str, OTHER_BLOCKS))})",
            route=entry["route"] if own else "cuda",
            source=entry["source"] if own else blocks_src,
            replaces=entry["replaces"], launches=block_launches[name],
            max_abs_err=block_err[name], **mean,
            bound_by=collections.Counter(
                st["bound_by"] for st in sites).most_common(1)[0][0],
            library_ms=None, sites=sites,
            **({"qkv_routes": qkv_routes[name]} if name in qkv_routes
               else {})))
    kernels += ablate_kernels + measure_kernels
    stamp("kernel times done")
    print(json.dumps({"tiers": tiers, "servers": servers,
                      "endtask": endtask_stats, "training": training_stats,
                      "launches_by_path": path_launches}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
