#!/usr/bin/env python3
"""Ladder of switched-off phases of kernel K5
(``csrc/ln_modulate_quantize.cu``: the warp-per-row design with one
channel per lane, or the vector redesign, told apart by their anchors),
timed at the DiT-XL/2 site: x (64, 256, 1152) bf16, shift and scale
(64, 1152) bf16, int8, bfloat 16, bf16 out.

    git archive <rev> mx_quantization_tpu_torch | tar -x -C _ab/parent
    python3 mx_quantization_tpu_torch/tools/k5_ladder.py --repo _ab/parent

``--repo`` is the checkout whose package (wrapper and source) is used
(default: the one this file lies in).  The tool writes a copy of its
``csrc/ln_modulate_quantize.cu`` into ``--out`` (default ``_ab/k5_ladder``,
listed in ``.gitignore``) with guards at three points, builds the copy
with ``-DLADDER_STOP=n`` for each stop of ``--stops`` (default all four;
all ``nvcc`` started together) and times each through that checkout's
wrapper, with the library swapped.  A
stop writes one value per lane and row, a sum of what it has, so that
nothing before it is dead code.  Stops:
  1. loads only (the row of x);
  2. + the statistics (mean, variance, 1/sqrt(var + eps));
  3. + modulate and the bf16 round (scale and shift read);
  4. + quantize and store: the whole kernel.
For each stop it prints ptxas's registers and spills and the static SASS
of each kernel (``cuobjdump -sass``): its instruction count, that count
per element of a lane's row at the site, and the counts by opcode.  The
times are ``chip_smoke.time_ms``'s: calls queued behind a GPU sleep.  The
copies are never built by the package's wrappers.
"""

import argparse
import collections
import concurrent.futures
import ctypes
import hashlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
SITE = (64, 256, 1152)  # DiT-XL/2 256^2: 2 x 32 images, 256 tokens

_SINK = """
#define LADDER_SINK(VAL, IDX)                                                  \\
  do {                                                                          \\
    const float lv_ = (VAL);                                                    \\
    if (p.out_bf16) static_cast<__nv_bfloat16*>(p.out)[IDX] = __float2bfloat16_rn(lv_); \\
    else static_cast<float*>(p.out)[IDX] = lv_;                                 \\
  } while (0)
"""

# (anchor, replacement); each anchor must occur exactly once
V2_PATCHES = (
    ('#include "mx_common.cuh"\n', '#include "mx_common.cuh"\n' + _SINK),
    ("  // mean and variance: per lane in j order, then the lanes\n",
     """#if LADDER_STOP == 1
  {
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j)
      if (j < p.nj) ls += x[j];
    LADDER_SINK(ls, base);
    return;
  }
#endif
  // mean and variance: per lane in j order, then the lanes
"""),
    ("  // modulate (and round) every channel first",
     "#if LADDER_STOP == 2\n  LADDER_SINK(rs, base);\n  return;\n#endif\n"
     "  // modulate (and round) every channel first"),
    ("""#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    if (j < p.nj) {
      const float y = x[j];""",
     """#if LADDER_STOP == 3
  {
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j)
      if (j < p.nj) ls += x[j];
    LADDER_SINK(ls, base);
    return;
  }
#endif
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    if (j < p.nj) {
      const float y = x[j];"""),
)
V2_LANE_ELEMS = SITE[2] // 32  # one channel per lane per 32 channels

V3_PATCHES = (
    ('#include "mx_common.cuh"\n', '#include "mx_common.cuh"\n' + _SINK),
    ("    // mean: the chunks' trees in round order, then the lanes\n",
     """#if LADDER_STOP == 1
    {
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < kRegRounds; ++j)
        if (j < p.nr) ls += tree8(v[j]);
      LADDER_SINK(ls, row * p.C + lane);
      continue;
    }
#endif
    // mean: the chunks' trees in round order, then the lanes
"""),
    ("    // modulate, round, quantize and store each round\n",
     """#if LADDER_STOP == 2
    LADDER_SINK(rs, row * p.C + lane);
    continue;
#endif
#if LADDER_STOP == 3
    {
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < kRegRounds; ++j) {
        if (j < p.nr) {
          const int k = lane + 32 * j;
          float sa[kVec], sb[kVec];
          stage_read(a, b, k < p.nchunks ? k : 0, sa, sb);
#pragma unroll
          for (int i = 0; i < kVec; ++i) ls += modulate<kBf16Round>(v[j][i], rs, sa[i], sb[i]);
        }
      }
      LADDER_SINK(ls, row * p.C + lane);
      continue;
    }
#endif
    // modulate, round, quantize and store each round
"""),
)
V3_LANE_ELEMS = SITE[2] / 32  # 8 channels a chunk, 4.5 rounds at 1152

STOPS = {1: "loads only", 2: "+ statistics (mean, variance, rs)",
         3: "+ modulate and bf16 round (scale, shift)",
         4: "+ quantize and store: the whole kernel"}


def patched(text):
    """The source with the stops inserted, and a lane's elements per row
    at the site."""
    for patches, elems in ((V2_PATCHES, V2_LANE_ELEMS),
                           (V3_PATCHES, V3_LANE_ELEMS)):
        if all(text.count(anchor) == 1 for anchor, _ in patches):
            for anchor, insert in patches:
                text = text.replace(anchor, insert)
            return text, elems
    raise SystemExit("the source matches neither design's anchors")


def sass_counts(lib, cuobjdump):
    """{kernel: Counter of opcodes} of the static SASS in ``lib``."""
    res = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                         text=True, check=True)
    out, cur = {}, None
    for line in res.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), collections.Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if m and cur is not None:
            op = m.group(1).split(".")[0]
            if op != "NOP":
                cur[op] += 1
    return out


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "_ladder_chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=ROOT)
    ap.add_argument("--out", default=os.path.join(ROOT, "_ab", "k5_ladder"))
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--stops", default="1,2,3,4",
                    help="comma-separated stops to build and time (4: the "
                         "whole kernel)")
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    import torch
    from mx_quantization_tpu_torch.ops.kernels import build
    from mx_quantization_tpu_torch.ops.kernels import \
        ln_modulate_quantize as lnq
    if not os.path.abspath(lnq.__file__).startswith(repo + os.sep):
        raise SystemExit(f"imported {lnq.__file__}, not from {repo}")
    if not torch.cuda.is_available():
        print("k5_ladder: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    src = os.path.join(args.out, "ladder.cu")
    with open(build.CSRC_DIR / lnq.SOURCE) as f:
        text, lane_elems = patched(f.read())
    with open(src, "w") as f:
        f.write(text)

    tag = hashlib.sha256(text.encode()).hexdigest()[:12]

    def nvcc(stop):  # a copy built from this very text is reused
        lib = os.path.join(args.out, f"ladder-{tag}-{stop}.so")
        log = lib + ".log"
        if not os.path.exists(lib):
            cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC_DIR}",
                   *build._define_flags(lnq.DEFINES),
                   f"-DLADDER_STOP={stop}", "-o", lib, src]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode:
                raise SystemExit(f"nvcc failed at stop {stop}:\n{res.stderr}")
            with open(log, "w") as f:
                f.write(res.stdout + res.stderr)
        return lib

    stops = [int(k) for k in args.stops.split(",")]
    with concurrent.futures.ThreadPoolExecutor(len(stops)) as pool:
        libs = dict(zip(stops, pool.map(nvcc, stops)))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}", flush=True)
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(build._nvcc()), "cuobjdump")
    time_ms = _chip_smoke().time_ms
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, N, C = SITE
    x = (3.0 * torch.randn(B, N, C, generator=gen, device=dev)).to(
        torch.bfloat16)
    sh, sc = ((0.3 * torch.randn(B, C, generator=gen, device=dev)).to(
        torch.bfloat16) for _ in range(2))
    kw = dict(elem_format="int8", bfloat=16, out_dtype=torch.bfloat16)
    conv_ms, _ = time_ms(lambda: (sh.to(torch.float32).contiguous(),
                                  sc.to(torch.float32).contiguous()),
                         args.reps)
    print(f"[ladder] shift and scale to f32 alone: {conv_ms:.4f} ms",
          flush=True)
    real_load = build.load
    out = {}
    for stop, lib in libs.items():
        with open(lib + ".log") as f:
            ptxas = [ln.strip()[:150] for ln in f.read().splitlines()
                     if "registers" in ln or "spill" in ln]
        sass = sass_counts(lib, cuobjdump)
        build.load = lambda *a, lib=lib, **k: ctypes.CDLL(lib)
        lnq._library.cache_clear()
        ms, queued = time_ms(lambda: lnq.ln_modulate_quantize(x, sh, sc, **kw),
                             args.reps)
        print(f"[ladder] stop {stop} ({STOPS[stop]}): {ms:.4f} ms "
              f"(launches queued ahead: {queued})", flush=True)
        for line in ptxas:
            print(f"[ladder]   ptxas {line}")
        counts = {}
        for name, ops in sass.items():
            total = sum(ops.values())
            counts[name] = dict(total=total, per_elem=total / lane_elems,
                                ops=dict(ops.most_common()))
            print(f"[ladder]   sass {name[:70]}: {total} instructions, "
                  f"{total / lane_elems:.1f} per element of a lane's row; "
                  f"{dict(ops.most_common(14))}")
        out[stop] = dict(label=STOPS[stop], ms=ms, queued=queued,
                         ptxas=ptxas, sass=counts)
    build.load = real_load
    lnq._library.cache_clear()
    print(json.dumps({"repo": repo, "device": smi, "site": SITE,
                      "f32_conversions_ms": conv_ms, "stops": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
