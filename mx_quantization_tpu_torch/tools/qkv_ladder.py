#!/usr/bin/env python3
"""Ladder of switched-off phases of kernel K2/K7's source
(``csrc/topk_attention_qkv.cu``: the first design, with f32 CUDA-core
products, or the int8 tensor-core redesign, told apart by their
anchors), timed at K2's DiT-XL/2 256^2 sites.

    git show <rev>:mx_quantization_tpu_torch/csrc/topk_attention_qkv.cu \\
        > _ab/k2_old.cu
    python3 mx_quantization_tpu_torch/tools/qkv_ladder.py --source _ab/k2_old.cu

The tool writes copies of ``--source`` into ``--out`` (default
``_ab/ladder``, listed in ``.gitignore``) with guards at four or five points,
builds each copy with ``-DLADDER_STOP=n`` (all ``nvcc`` started together)
and times each at the K2 sites of ``time_split_sites.py`` through this
tree's wrapper, with the library swapped.  A stop writes what it has to
the output, so that nothing before it is dead code.  The first design:
  1. staging only (MX quantize of q, k, v into shared memory);
  2. + the true score (the scaled scores are the row's probabilities);
  3. + the predictor (top-k calls: the monotone keys);
  4. + selection (the selected scores);
  5. + softmax and the probability requantize (the probabilities go to
     the output instead of PV);
  6. the whole kernel.
The redesign: 1 staging; 2 + q's fragments, the predictor and selection;
3 + the softmax's max and sum passes over the true scores; 4 + the
probabilities (exact: their int8 grid points; serving: stored); 5 the
whole kernel (+ PV).
The copies are never built by the package's wrappers.
"""

import argparse
import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

# (anchor, text inserted before it); each anchor must occur exactly once
_OUT_ROW = """
      for (int c = 0; c < kMaxDc; ++c) {
        const int d = lane + 32 * c;
        if (d < p.D) {
          const size_t o = (size_t(b) * p.Nq + i) * p.H * p.D + size_t(h) * p.D + d;
          if (p.out_bf16) static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(VAL);
          else static_cast<float*>(p.out)[o] = VAL;
        }
      }"""
PATCHES = (
    ("  bool sel[kMaxNj];\n", """#if LADDER_STOP == 2
#pragma unroll
  for (int j = 0; j < kMaxNj; ++j) if (j < p.nj) prow[lane + 32 * j] = st[j];
  return;
#endif
"""),
    ("    // k-th largest key by bisection", """#if LADDER_STOP == 3
#pragma unroll
    for (int j = 0; j < kMaxNj; ++j) if (j < p.nj) prow[lane + 32 * j] = float(key[j]);
    return;
#endif
"""),
    ("  // masked softmax: unselected", """#if LADDER_STOP == 3 || LADDER_STOP == 4
#pragma unroll
  for (int j = 0; j < kMaxNj; ++j) if (j < p.nj) prow[lane + 32 * j] = sel[j] ? st[j] : 0.f;
  return;
#endif
"""),
    ("  // ---- each warp takes kRows query rows", """#if LADDER_STOP == 1
  for (int i = warp; i < p.Nq; i += kWarps) {""" + _OUT_ROW.replace(
        "VAL", "(__bfloat162float(qs[i * p.Dp + d]) + __bfloat162float("
        "kT[d * p.kstr + i]) + __bfloat162float(vs[i * p.D + d]) + "
        "qpw[i * p.nb] + float(ksgn[i * p.nb]))") + """
  }
  return;
#endif
"""),
    ("    // PV: lanes own output columns", """#if LADDER_STOP >= 2 && LADDER_STOP <= 5
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      if (i >= p.Nq) break;""" + _OUT_ROW.replace(
        "VAL", "probs[(warp * kRows + r) * p.Np + lane + 32 * c]") + """
    }
    __syncwarp();
    continue;
#endif
"""),
)
STOPS = {1: "staging", 2: "+ true score", 3: "+ predictor keys",
         4: "+ selection", 5: "+ softmax and requantize", 6: "whole kernel"}

# The redesign (int8 staging, tensor-core products, selection and
# softmax on the mma accumulator layout): each stop writes one value per
# row to the output and leaves the row tile
_OUT_ROWS = """
    for (int r = 0; r < 2; ++r)
      if (row[r] < p.Nq && t < p.D) {
        const size_t o = (size_t(b) * p.Nq + row[r]) * p.H * p.D + size_t(h) * p.D + t;
        if (p.out_bf16) static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(VAL);
        else static_cast<float*>(p.out)[o] = VAL;
      }"""
NEW_PATCHES = (
    ("  const short* qe = reinterpret_cast<const short*>(smem + L.qe);\n",
     """#if LADDER_STOP == 1
  {
    const int row[2] = {warp * 16 + g, warp * 16 + g + 8};
    const float VAL0 = float((smem + L.k)[threadIdx.x]) + float((smem + L.v)[threadIdx.x]);"""
     + _OUT_ROWS.replace("VAL", "VAL0") + """
  }
  return;
#endif
"""),
    ("    // ---- masked softmax over the true scores", """#if LADDER_STOP == 2
    {
      const int row[2] = {rt.row[0], rt.row[1]};
      const float VAL2 = float(__popcll(selm[0]) + __popcll(selm[1]));"""
     + _OUT_ROWS.replace("VAL", "VAL2") + """
    }
    continue;
#endif
"""),
    ("    // ---- by 32-key block: the probabilities", """#if LADDER_STOP == 3
    {
      const int row[2] = {rt.row[0], rt.row[1]};
      const float VAL3 = sum[0] + sum[1] + mx[0] + mx[1];"""
     + _OUT_ROWS.replace("VAL", "VAL3") + """
    }
    continue;
#endif
"""),
    ("      // PV: one mma per (8-column tile, 32-key block)", """#if LADDER_STOP == 4
      {
        const int row[2] = {rt.row[0], rt.row[1]};
        const uint4 w4 = pgw[lane];
        const float VAL4 = float(w4.x ^ w4.y ^ w4.z ^ w4.w) + pgs[lane].x;"""
     + _OUT_ROWS.replace("VAL", "VAL4") + """
      }
      continue;
#endif
"""),
    ("    __syncwarp();\n    // ---- PV on the CUDA cores", """#if LADDER_STOP == 4
    __syncwarp();
    {
      const int row[2] = {rt.row[0], rt.row[1]};
      const float VAL4 = __bfloat162float(pb[lane]) + __bfloat162float(pb[8 * p.Np + lane]);"""
     + _OUT_ROWS.replace("VAL", "VAL4") + """
    }
    __syncwarp();
    continue;
#endif
"""),
)
NEW_STOPS = {1: "staging", 2: "+ q fragments, predictor and selection",
             3: "+ the softmax's max and sum passes",
             4: "+ the probabilities (exact: their grid points; serving: "
                "stored)",
             5: "whole kernel (+ PV)"}


def patched(text):
    """The source with the stops of its design inserted, and the stops."""
    for patches, stops in ((PATCHES, STOPS), (NEW_PATCHES, NEW_STOPS)):
        if all(text.count(anchor) == 1 for anchor, _ in patches):
            for anchor, insert in patches:
                text = text.replace(anchor, insert + anchor)
            return text, stops
    raise SystemExit("the source matches neither design's anchors")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", required=True)
    ap.add_argument("--out", default=os.path.join(ROOT, "_ab", "ladder"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--stops", default="",
                    help="comma-separated stops to build (default: all)")
    ap.add_argument("--build-only", action="store_true",
                    help="build the copies (all at once) and stop; a later "
                         "run with the same --out times them without "
                         "building")
    args = ap.parse_args()
    import torch
    from mx_quantization_tpu_torch.ops.kernels import build
    from mx_quantization_tpu_torch.ops.kernels import topk_attention as ta
    from mx_quantization_tpu_torch.tools import time_split_sites as tss
    if not torch.cuda.is_available():
        print("qkv_ladder: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    src = os.path.join(args.out, "ladder.cu")
    with open(args.source) as f:
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
               *build._define_flags(ta.K2_DEFINES),
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
    out = {}
    for stop, lib in libs.items():
        bound = ta.bind_qkv_library(ctypes.CDLL(lib))
        ta._library = lambda bound=bound: bound
        print(f"[ladder] stop {stop}: {stops[stop]}", flush=True)
        out[stop] = tss.time_qkv_sites(ta, {"K2"}, dev, args.reps)
    print(json.dumps({"device": smi, "stops": stops, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
