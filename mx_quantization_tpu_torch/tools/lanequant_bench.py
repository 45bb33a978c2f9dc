#!/usr/bin/env python3
"""The port of ``tools/lanequant_bench.py``: K1's MX quantize with each
block maximum taken across a warp's lanes (kernel K11,
``ops/kernels/lane_quantize.py``) against K1 itself, at the TPU probe's
point.

    python3 -m mx_quantization_tpu_torch.tools.lanequant_bench
        [--device cpu] [--rows 16384] [--formats int8,fp8_e4m3] [--nomax]

The point: DiT-XL/2's fc2 and qkv inputs at the main path's 64 rows x 256
tokens, (16384, 4608) and (16384, 1152) bf16 from a seeded N(0, 1), MX
blocks of 32, scale bits 8, bf16 out, bfloat 16 and 0.  A row per (site,
format, bfloat): K11's device ms per call and K1's at the same site (CUDA
events behind a GPU sleep), the plain version's device ms, the bound (the
bytes read and written over the HBM rate, or the quantizer's operations
over the CUDA cores' rate, the larger), and whether K11 equals K1.  On the
card each call is first held bit for bit to its plain version.  ``--nomax``
runs the TPU probe's ``NOMAX`` diagnostic (every element its own block
maximum: wrong values on purpose, so unequal to K1).  On the CPU
(``--device cpu``) only the plain versions run: their host ms stand in
``cpu_ms`` and no device time is given.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..ops.kernels.lane_quantize import lane_quantize, lane_quantize_ref
from ..ops.kernels.quantize import mx_quantize, mx_quantize_ref
from .ablate_common import (F32_INSTR_PER_S, HBM_BYTES_PER_S, _cpu_ms,
                            _device_ms, card)
from .time_split_sites import time_ms

ROWS = 16384
WIDTHS = (4608, 1152)  # fc2's and qkv's inputs
FORMATS = ("int8", "fp8_e4m3")
BFLOATS = (16, 0)
BLOCK = 32
REPS = 20


def ops_per_element(fmt, in_bf16=True, bf16_round=False, flush=False):
    """The quantizer's f32 and integer operations an element as the plain
    version spells it, counted as ``chip_smoke.py``'s ``mx_ops`` counts
    K1's: the f32 cast of a bf16 input 1, the half-away bf16 round 4, the
    block maximum 2, the flush 1, the int grids 11 or the MXFP grids 23,
    the cast out 1."""
    return (int(in_bf16) + 4 * int(bf16_round) + 2 + int(flush)
            + (11 if fmt.startswith("int") else 23) + 1)


def bound_ms(numel, fmt):
    """(ms, "bytes" or "operations"): the least time for one call of a
    bf16-in, bf16-out quantize, the larger of its bytes over the HBM rate
    and its operations over the CUDA cores' rate."""
    by_bytes = 1e3 * numel * (2 + 2) / HBM_BYTES_PER_S
    by_ops = 1e3 * numel * ops_per_element(fmt) / F32_INSTR_PER_S
    return max((by_bytes, "bytes"), (by_ops, "operations"))


def run(device="cuda", rows=ROWS, formats=FORMATS, nomax=False):
    """One row per (width, format, bfloat); AssertionError where K11
    differs from its plain version on the card."""
    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain "
                           "versions")
    out_rows = []
    for width in WIDTHS:
        g = torch.Generator().manual_seed(0)
        x = torch.randn(rows, width, generator=g).to(torch.bfloat16).to(
            device)
        for fmt in formats:
            for bfloat in BFLOATS:
                args = (fmt, BLOCK, 8, torch.bfloat16, False, bfloat)
                row = dict(site=[rows, width], format=fmt, bfloat=bfloat,
                           nomax=nomax, ms=None, k1_ms=None, plain_ms=None,
                           cpu_ms=None, launches=0, max_abs_err=None)
                if cuda:
                    before = lane_quantize.launches
                    out = lane_quantize(x, *args, nomax=nomax)
                    ref, row["plain_ms"] = _device_ms(
                        lambda: lane_quantize_ref(x, *args, nomax=nomax))
                    row["max_abs_err"] = float(
                        (out.float() - ref.float()).abs().max())
                    if not torch.equal(out, ref):
                        raise AssertionError(
                            f"K11 {width} {fmt} bfloat {bfloat} differs from "
                            f"its plain version by {row['max_abs_err']}")
                    k1 = mx_quantize(x, *args)
                    row["ms"] = time_ms(
                        lambda: lane_quantize(x, *args, nomax=nomax), REPS)
                    row["k1_ms"] = time_ms(lambda: mx_quantize(x, *args),
                                           REPS)
                    row["launches"] = lane_quantize.launches - before
                else:
                    out, row["cpu_ms"] = _cpu_ms(
                        lambda: lane_quantize(x, *args, nomax=nomax))
                    k1 = mx_quantize_ref(x, *args)
                row["equal_to_k1"] = bool(torch.equal(out, k1))
                row["bound_ms"], row["bound_by"] = bound_ms(x.numel(), fmt)
                out_rows.append(row)
    return out_rows


def _fmt(x):
    return "-" if x is None else f"{x:.4f}"


def main(argv=None):
    p = argparse.ArgumentParser(prog="lanequant_bench",
                                description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--rows", type=int, default=ROWS)
    p.add_argument("--formats", default=",".join(FORMATS))
    p.add_argument("--nomax", action="store_true")
    args = p.parse_args(argv)
    dev = "not measured (CPU)"
    if args.device != "cpu":
        if not torch.cuda.is_available():
            print("lanequant_bench: no CUDA device (--device cpu runs the "
                  "plain versions)", file=sys.stderr)
            return 2
        dev = card()
        print(f"[device] {dev}", flush=True)
    rows = run(args.device, args.rows, args.formats.split(","), args.nomax)
    for r in rows:
        print(f"{tuple(r['site'])} {r['format']} bfloat={r['bfloat']}"
              f"{' nomax' if r['nomax'] else ''}: K11 {_fmt(r['ms'])} ms, "
              f"K1 {_fmt(r['k1_ms'])} ms, plain {_fmt(r['plain_ms'])} ms, "
              f"cpu {_fmt(r['cpu_ms'])} ms, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}, equal to K1 {r['equal_to_k1']}", flush=True)
    print(json.dumps({"tool": "lanequant_bench", "device": dev,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
