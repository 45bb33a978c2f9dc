#!/usr/bin/env python3
"""Ladder of switched-off phases of kernel K2/K7's source
(``csrc/topk_attention_qkv.cu``, the design of this tree: int8 tensor-core
products, the radix select, every predictor), timed at K2's sites of
``time_split_sites.py`` (DiT-XL/2 256^2, DeiT).

    python3 mx_quantization_tpu_torch/tools/qkv_ladder.py \\
        --source mx_quantization_tpu_torch/csrc/topk_attention_qkv.cu

The tool writes a copy of ``--source`` into ``--out`` (default
``_ab/ladder``, listed in ``.gitignore``) with guards at four points,
builds it once per stop with ``-DLADDER_STOP=n`` and ``-DQKV_PART=p`` (all
``nvcc`` started together; ``--part``, default 0) and times each at the K2
sites whose label holds ``--sites`` (default the DiT-256 sites, part 0's)
through this tree's wrapper, with the library swapped.  A stop writes what
it has to the output, so that nothing before it is dead code:
  1. staging; 2. + q's fragments, the predictor and selection; 3. + the
  softmax's max and sum passes over the true scores; 4. + the
  probabilities (exact: their int8 grid points; serving: stored); 5. the
  whole kernel (+ PV).
Earlier designs (PERF.md's ladders of PRs 1-6) have another C interface:
run the tool of their own tree (``git show <rev>:`` this file and the
wrapper).  The copies are never built by the package's wrappers.
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

# (anchor, text inserted before it); each anchor must occur exactly once.
# Each stop writes one value per row to the output and leaves the row tile.
_OUT_ROWS = """
    for (int r = 0; r < 2; ++r)
      if (row[r] < p.Nq && t < p.D) {
        const size_t o = (size_t(b) * p.Nq + row[r]) * p.H * p.D + size_t(h) * p.D + t;
        if (p.out_bf16) static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(VAL);
        else static_cast<float*>(p.out)[o] = VAL;
      }"""
PATCHES = (
    ("""    unsigned char* wa = smem + L.warp0 + size_t(warp) * L.warp_bytes;
    for (int tile = warp; tile < p.ntq; tile += p.W) {""", """#if LADDER_STOP == 1
    {
      const int g = lane >> 2, t = lane & 3;
      const int row[2] = {warp * 16 + g, warp * 16 + g + 8};
      const float VAL1 = float((smem + L.k)[threadIdx.x]) + float((smem + L.v)[threadIdx.x]);"""
     + _OUT_ROWS.replace("VAL", "VAL1") + """
    }
    return;
#endif
"""),
    ("  // unselected entries are -3e38 and exp gives +0; the sum takes sixteen\n",
     """#if LADDER_STOP == 2
  {
    const int row[2] = {rt.row[0], rt.row[1]};
    const float VAL2 = float(__popcll(selm[0][0]) + __popcll(selm[1][0]) +
                             __popcll(selm[0][kSelWords - 1]) + __popcll(selm[1][kSelWords - 1]));"""
     + _OUT_ROWS.replace("VAL", "VAL2") + """
  }
  return;
#endif
"""),
    ("  // ---- by 32-key block: the probabilities.", """#if LADDER_STOP == 3
  {
    const int row[2] = {rt.row[0], rt.row[1]};
    const float VAL3 = sum[0] + sum[1] + mx[0] + mx[1];"""
     + _OUT_ROWS.replace("VAL", "VAL3") + """
  }
  return;
#endif
"""),
    ("    // PV: one mma per (8-column tile, 32-key block)", """#if LADDER_STOP == 4
    {
      const int row[2] = {rt.row[0], rt.row[1]};
      const uint4 w4 = pgw[lane];
      const float VAL4 = float(w4.x ^ w4.y ^ w4.z ^ w4.w) + pgs[lane].x;"""
     + _OUT_ROWS.replace("VAL", "VAL4") + """
    }
    __syncwarp();
    return;
#endif
"""),
    ("  __syncwarp();\n  // ---- PV on the CUDA cores", """#if LADDER_STOP == 4
  __syncwarp();
  {
    const int row[2] = {rt.row[0], rt.row[1]};
    const float VAL4 = __bfloat162float(pb[lane]) + __bfloat162float(pb[8 * p.Np + lane]);"""
     + _OUT_ROWS.replace("VAL", "VAL4") + """
  }
  __syncwarp();
  return;
#endif
"""),
)
STOPS = {1: "staging", 2: "+ q fragments, predictor and selection",
         3: "+ the softmax's max and sum passes",
         4: "+ the probabilities (exact: their grid points; serving: "
            "stored)",
         5: "whole kernel (+ PV)"}


def patched(text):
    """The source with the stops inserted, and the stops."""
    for anchor, _ in PATCHES:
        if text.count(anchor) != 1:
            raise SystemExit(f"the source lacks the anchor {anchor[:60]!r} "
                             "(an earlier design: run the tool of its tree)")
    for anchor, insert in PATCHES:
        text = text.replace(anchor, insert + anchor)
    return text, STOPS


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", required=True)
    ap.add_argument("--out", default=os.path.join(ROOT, "_ab", "ladder"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--stops", default="",
                    help="comma-separated stops to build (default: all)")
    ap.add_argument("--part", type=int, default=0,
                    help="the build part (QKV_PART) whose kernels the copies "
                         "hold (default 0: the packed-register selection's, "
                         "DiT's sites)")
    ap.add_argument("--sites", default="DiT-256",
                    help="time the K2 sites whose label holds this")
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
               f"-DQKV_PART={args.part}", f"-DLADDER_STOP={stop}", "-o", lib,
               src]
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
        ta._qkv_library = lambda part, block_size=32, bound=bound: bound
        print(f"[ladder] stop {stop}: {stops[stop]}", flush=True)
        out[stop] = tss.time_qkv_sites(ta, {"K2"}, dev, args.reps,
                                       args.sites)
    print(json.dumps({"device": smi, "stops": stops, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
