#!/usr/bin/env python3
"""Ladder of switched-off phases of kernels K3 and K4
(``csrc/topk_attention_split.cu``: the first design, with f32 CUDA-core
products and the K side quantized per query tile, or the int8 tensor-core
redesign, told apart by their anchors), timed at the K3 and K4 sites of
``time_split_sites.py``.

    git archive <rev> mx_quantization_tpu_torch | tar -x -C _ab/parent
    python3 mx_quantization_tpu_torch/tools/split_ladder.py --repo _ab/parent

``--repo`` is the checkout whose package (wrapper and source) is used
(default: the one this file lies in).  The tool writes copies of its
``csrc/topk_attention_split.cu`` into ``--out`` (default ``_ab/split_ladder``,
listed in ``.gitignore``) with guards at five or six points, builds each
copy with ``-DLADDER_STOP=n`` (all ``nvcc`` started together) and times
each through that checkout's wrapper, with the library swapped.  A stop
writes what it has to shared memory or the output, so that nothing before
it is dead code.  The first design:
  1. staging: q and the K side MX-quantized into shared memory, per tile;
  2. + the true score (f32 CUDA cores; K4: written to its global scratch);
  3. + the predictor (two_step's d-order sum, ex_pred's block sums);
  4. + selection (the k-th key by bisection, the tie rank);
  5. + the softmax and the probabilities' requantize;
  6. the whole kernel (+ PV).
The redesign: 1 staging (the pre-pass and the copies of the K side into
shared memory, q into registers); 2 + the predictor and selection (the
keys, the radix levels and the marking pass); 3 + the softmax's max and
sum passes over the true scores; 4 + the probabilities (exact: their grid
points; serving: stored); 5 the whole kernel (+ PV).
The copies are never built by the package's wrappers.
"""

import argparse
import concurrent.futures
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


# (anchor, replacement); each anchor must occur exactly once
OLD_PATCHES = (
    # K3: the true score and the two_step products of the d loop
    ("""#pragma unroll
          for (int r = 0; r < ROWS; ++r) st[r][j] = __fmaf_rn(qd[r], kd, st[r][j]);
          if (PRED == kTwoStep) {
            const float akd = __bfloat162float(akrow[32 * (j - jlo)]);""",
     """if (LADDER_STOP >= 2) {
#pragma unroll
          for (int r = 0; r < ROWS; ++r) st[r][j] = __fmaf_rn(qd[r], kd, st[r][j]);
          }
          if (LADDER_STOP >= 3 && PRED == kTwoStep) {
            const float akd = __bfloat162float(akrow[32 * (j - jlo)]);"""),
    ("    if (PRED == kExPred && !dense) {\n      // per block,",
     "    if (LADDER_STOP >= 3 && PRED == kExPred && !dense) {\n      // per block,"),
    ("  const bool dense = p.topk >= p.S;\n  float st[ROWS][NJ], pr[ROWS][NJ];",
     "  float ladder_sink = 0.f;\n"
     "  const bool dense = p.topk >= p.S;\n  float st[ROWS][NJ], pr[ROWS][NJ];"),
    ("  bool sel[ROWS][NJ];\n  select_rows<NJ, ROWS, PRED>(p, st, pr, biasS, dense, lane, sel);\n",
     """  bool sel[ROWS][NJ];
#if LADDER_STOP >= 4
  select_rows<NJ, ROWS, PRED>(p, st, pr, biasS, dense, lane, sel);
#else
  ladder_sink = __bfloat162float(qs[lane]) + __bfloat162float(kT[lane]);
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) ladder_sink += st[r][j] + pr[r][j];
#endif
"""),
    ("""#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    __nv_bfloat16* prow = probs + (r0 + r) * p.Sp;
    softmax_row<NJ>(""",
     """#if LADDER_STOP == 4
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) ladder_sink += sel[r][j] ? st[r][j] : 0.f;
#endif
#pragma unroll
  for (int r = 0; r < (LADDER_STOP >= 5 ? ROWS : 0); ++r) {
    __nv_bfloat16* prow = probs + (r0 + r) * p.Sp;
    softmax_row<NJ>("""),
    ("""    const __nv_bfloat16* prow = probs + r0 * p.Sp + s0;
#pragma unroll 4
    for (int sl = 0; sl < ck; ++sl) {""",
     """    const __nv_bfloat16* prow = probs + r0 * p.Sp + s0;
    if (LADDER_STOP == 5) ladder_sink += __bfloat162float(prow[lane]);
#pragma unroll 4
    for (int sl = 0; sl < (LADDER_STOP >= 6 ? ck : 0); ++sl) {"""),
    ("#pragma unroll\n  for (int r = 0; r < ROWS; ++r) {\n    const int n = row0 + r0 + r;",
     "  acc[0][0] += ladder_sink;\n"
     "#pragma unroll\n  for (int r = 0; r < ROWS; ++r) {\n    const int n = row0 + r0 + r;"),
    # K4
    ("""#pragma unroll
        for (int r = 0; r < ROWS; ++r) st[r][j] = __fmaf_rn(qd[r], kd, st[r][j]);
        if (PRED == kTwoStep) {
          const float akd = __bfloat162float(akrow[32 * j]);""",
     """if (LADDER_STOP >= 2) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) st[r][j] = __fmaf_rn(qd[r], kd, st[r][j]);
        }
        if (LADDER_STOP >= 3 && PRED == kTwoStep) {
          const float akd = __bfloat162float(akrow[32 * j]);"""),
    ("  if (PRED == kExPred) {\n    // per block,",
     "  if (LADDER_STOP >= 3 && PRED == kExPred) {\n    // per block,"),
    ("    const int jc = ck / kBlock;\n",
     "    const int jc = LADDER_STOP >= 2 ? ck / kBlock : 0;\n"),
    ("  if (!dense)\n    select_topk<0, ROWS>(",
     "  if (LADDER_STOP >= 4 && !dense)\n    select_topk<0, ROWS>("),
    ("#pragma unroll 1\n  for (int r = 0; r < ROWS; ++r) {\n    const float* xrow",
     "#pragma unroll 1\n  for (int r = 0; r < (LADDER_STOP >= 5 ? ROWS : 0); ++r) {\n"
     "    const float* xrow"),
    ("    pv_chunk<ROWS>(p, probs", "    if (LADDER_STOP >= 6) pv_chunk<ROWS>(p, probs"),
    ("  store_rows<ROWS>(p, g, row0 + r0, acc, lane);",
     "  if (LADDER_STOP < 6) acc[0][0] += __bfloat162float(tm.qs[lane]) + float(slots[lane]);\n"
     "  store_rows<ROWS>(p, g, row0 + r0, acc, lane);"),
)
OLD_STOPS = {1: "staging (q and the K side, per tile)", 2: "+ true score",
             3: "+ predictor", 4: "+ selection",
             5: "+ softmax and requantize", 6: "whole kernel (+ PV)"}

_SINK = """
#define LADDER_SINK(VAL)                                                        \\
  do {                                                                          \\
    const float lv_ = (VAL);                                                    \\
    for (int r_ = 0; r_ < 2; ++r_)                                              \\
      if (rt.row[r_] < p.N && t < p.D) {                                        \\
        const size_t o_ = (size_t(cell) * p.N + rt.row[r_]) * p.D + t;          \\
        if (p.out_bf16) static_cast<__nv_bfloat16*>(p.out)[o_] = __float2bfloat16_rn(lv_); \\
        else static_cast<float*>(p.out)[o_] = lv_;                              \\
      }                                                                         \\
  } while (0)
"""
NEW_PATCHES = (
    ('#include "mx_common.cuh"\n', '#include "mx_common.cuh"\n' + _SINK),
    ("""  unsigned* selw = reinterpret_cast<unsigned*>(wa + L.w_sel);
  if (!p.dense)
    select_tile<kInt, PRED>(p, L, smem, ws, b, wa + L.w_q, rt, lane, selw,
                            reinterpret_cast<unsigned*>(wa + L.w_u), nullptr);
""", """  unsigned* selw = reinterpret_cast<unsigned*>(wa + L.w_sel);
  const int t = lane & 3;
#if LADDER_STOP == 1
  for_chunks(p, L, smem, ws, b, score_mask(p) | select_mask(p) | pv_mask(p),
             [&](int, int) {});
  LADDER_SINK(float(smem[L.kq + lane]) + rt.pq[0][0]);
  return;
#endif
  if (!p.dense)
    select_tile<kInt, PRED>(p, L, smem, ws, b, wa + L.w_q, rt, lane, selw,
                            reinterpret_cast<unsigned*>(wa + L.w_u), nullptr);
#if LADDER_STOP == 2
  LADDER_SINK(float(selw[lane]));
  return;
#endif
"""),
    # the cached mode's two phases
    ("      select_tile<kInt, PRED>(p, L, smem, ws, b, nullptr, rt, lane, ",
     "      if (LADDER_STOP >= 2)\n"
     "      select_tile<kInt, PRED>(p, L, smem, ws, b, nullptr, rt, lane, "),
    ("""      softmax_pv<kInt, PRED>(p, L, smem, ws, wa, cell, b, rt, tile * kRows,
                             selp + tile * sel_words);""",
     """#if LADDER_STOP >= 3
      softmax_pv<kInt, PRED>(p, L, smem, ws, wa, cell, b, rt, tile * kRows,
                             selp + tile * sel_words);
#else
      const int t = lane & 3;
      LADDER_SINK(float(selp[tile * sel_words + lane]) + float(smem[L.kq + lane]));
#endif"""),
    ("  // ---- by 32-key block: the probabilities, then PV of the chunk.",
     """#if LADDER_STOP == 3
  LADDER_SINK(sum[0] + sum[1] + mx[0] + mx[1]);
  return;
#endif
  // ---- by 32-key block: the probabilities, then PV of the chunk."""),
    ("    __syncwarp();\n    if (exact_mma) pv_mma(",
     """    __syncwarp();
#if LADDER_STOP == 4
    if (s0 + ck == p.Sp)
      LADDER_SINK(float(reinterpret_cast<const unsigned*>(wa + L.w_u)[lane]));
    return;
#endif
    if (exact_mma) pv_mma("""),
)
NEW_STOPS = {1: "staging (pre-pass, K side into shared memory, q)",
             2: "+ predictor and selection (radix passes, marking pass)",
             3: "+ the softmax's max and sum passes",
             4: "+ the probabilities (exact: grid points; serving: stored)",
             5: "whole kernel (+ PV)"}


def patched(text):
    """The source with the stops of its design inserted, and the stops."""
    for patches, stops in ((OLD_PATCHES, OLD_STOPS), (NEW_PATCHES, NEW_STOPS)):
        if all(text.count(anchor) == 1 for anchor, _ in patches):
            for anchor, insert in patches:
                text = text.replace(anchor, insert)
            return text, stops
    raise SystemExit("the source matches neither design's anchors")


def _tool(name):
    """This tree's tool module ``name`` (the package may be another tree's)."""
    spec = importlib.util.spec_from_file_location(
        f"_ladder_{name}", os.path.join(HERE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=ROOT)
    ap.add_argument("--out", default=os.path.join(ROOT, "_ab", "split_ladder"))
    ap.add_argument("--kernels", default="K3,K4")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--stops", default="",
                    help="comma-separated stops to build (default: all)")
    ap.add_argument("--build-only", action="store_true",
                    help="build the copies (all at once) and stop; a later "
                         "run with the same --out times them without "
                         "building")
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    import torch
    from mx_quantization_tpu_torch.ops.kernels import build
    from mx_quantization_tpu_torch.ops.kernels import topk_attention as ta
    if not os.path.abspath(ta.__file__).startswith(repo + os.sep):
        raise SystemExit(f"imported {ta.__file__}, not from {repo}")
    tss = _tool("time_split_sites")
    if not torch.cuda.is_available():
        print("split_ladder: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    src = os.path.join(args.out, "ladder.cu")
    with open(build.CSRC_DIR / ta.SPLIT_SOURCE) as f:
        text, stops = patched(f.read())
    if args.stops:
        stops = {int(k): stops[int(k)] for k in args.stops.split(",")}
    with open(src, "w") as f:
        f.write(text)

    def nvcc(stop):
        lib = os.path.join(args.out, f"ladder{stop}.so")
        if os.path.exists(lib):
            return lib
        cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC_DIR}",
               *build._define_flags(ta.SPLIT_DEFINES),
               f"-DLADDER_STOP={stop}", "-o", lib, src]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode:
            raise SystemExit(f"nvcc failed at stop {stop}:\n{res.stderr}")
        return lib

    with concurrent.futures.ThreadPoolExecutor(len(stops)) as pool:
        libs = dict(zip(stops, pool.map(nvcc, stops)))
    if args.build_only:
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}", flush=True)
    dev = torch.device("cuda")
    real_load = build.load
    out = {}
    for stop, lib in libs.items():
        build.load = lambda *a, lib=lib, **k: ctypes.CDLL(lib)
        ta._split_library.cache_clear()
        print(f"[ladder] stop {stop}: {stops[stop]}", flush=True)
        out[stop] = tss.time_split(ta, set(args.kernels.split(",")), dev,
                                   args.reps)
    build.load = real_load
    ta._split_library.cache_clear()
    print(json.dumps({"repo": repo, "device": smi, "stops": stops,
                      "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
