#!/usr/bin/env python3
"""The port of ``tools/mx_matmul_ablation.py`` (timed as ``tools/mm_bench.py``
times it): the fused MX matmul C = Q(A) Q(B) (kernel K9,
``ops/kernels/mx_matmul.py``) against the unfused path, at DiT-XL/2's four
linears.

    python3 -m mx_quantization_tpu_torch.tools.mx_matmul_ablation
        [--device cpu] [--rows 16384]

The point: the main path's 64 rows x 256 tokens = 16384 rows of A from a
seeded N(0, 1), B = 0.02 N(0, 1) (K, N) for qkv (1152, 3456), proj (1152,
1152), fc1 (1152, 4608) and fc2 (4608, 1152), MXINT8 in blocks of 32,
scale bits 8.  The unfused path is ``mm_bench``'s ``xla_path``: K1 on A,
then one cuBLAS bf16 GEMM with f32 output against B prequantized along K
(``torch.mm(..., out_dtype=torch.float32)``).  A row per linear: K9's
device ms per call (CUDA events behind a GPU sleep), the unfused path's,
the plain version's, the bound (the f32 bytes of A, B and C over the HBM
rate, or the multiply-adds at the int8 tensor cores' rate, the larger),
and K9's largest distance from the unfused output beside the summation
bound K 2^-24 sum |Q(A) Q(B)| that two f32 orders may differ by.  On the
card K9 is first held bit for bit to its plain version.  On the CPU
(``--device cpu``) only the plain versions run (the unfused product as an
f32 matmul of the bf16 operands): their host ms stand in ``cpu_ms`` and no
device time is given.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..ops.kernels.mx_matmul import (mx_matmul, mx_matmul_ref,
                                     quantize_operands, summation_bound)
from ..ops.kernels.quantize import mx_quantize
from .ablate_common import (HBM_BYTES_PER_S, INT8_OPS_PER_S, _cpu_ms,
                            _device_ms, card)
from .time_split_sites import time_ms

ROWS = 16384
LINEARS = {"qkv": (1152, 3456), "proj": (1152, 1152), "fc1": (1152, 4608),
           "fc2": (4608, 1152)}
FORMAT, BLOCK, SCALE_BITS = "int8", 32, 8
REPS = 10


def inputs(rows, K, N, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(rows, K, generator=g)
    b = 0.02 * torch.randn(K, N, generator=g)
    return a.to(device), b.to(device)


def bound_ms(M, K, N):
    """(ms, "bytes" or "operations"): the least time for one MXINT8 call,
    the larger of A, B and C as f32 read or written once over the HBM rate
    and the M N K multiply-adds (2 operations each) at the int8 tensor
    cores' rate."""
    by_bytes = 1e3 * (M * K + K * N + M * N) * 4 / HBM_BYTES_PER_S
    by_ops = 1e3 * 2 * M * N * K / INT8_OPS_PER_S
    return max((by_bytes, "bytes"), (by_ops, "operations"))


def unfused(a, qb):
    """mm_bench's xla_path: K1 on A, then one bf16 GEMM with f32 output
    against the prequantized B (on the CPU an f32 matmul of the bf16
    values: the same products)."""
    qa = mx_quantize(a, FORMAT, BLOCK, SCALE_BITS, torch.bfloat16)
    if a.device.type == "cuda":
        return torch.mm(qa, qb, out_dtype=torch.float32)
    return qa.float() @ qb.float()


def run(device="cuda", rows=ROWS):
    """One row per linear; AssertionError where K9 differs from its plain
    version on the card."""
    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain "
                           "versions")
    out_rows = []
    for name, (K, N) in LINEARS.items():
        a, b = inputs(rows, K, N, device)
        args = (FORMAT, FORMAT, BLOCK, SCALE_BITS)
        qa, qb = quantize_operands(a, b, *args)
        row = dict(linear=name, shape=[rows, K, N], ms=None, unfused_ms=None,
                   plain_ms=None, cpu_ms=None, launches=0, max_abs_err=None)
        if cuda:
            before = mx_matmul.launches
            out = mx_matmul(a, b, *args)
            ref, row["plain_ms"] = _device_ms(lambda: mx_matmul_ref(a, b,
                                                                    *args))
            row["max_abs_err"] = float((out - ref).abs().max())
            if not torch.equal(out, ref):
                raise AssertionError(f"K9 {name} differs from its plain "
                                     f"version by {row['max_abs_err']}")
            del ref
            row["ms"] = time_ms(lambda: mx_matmul(a, b, *args), REPS)
            row["unfused_ms"] = time_ms(lambda: unfused(a, qb), REPS)
            row["launches"] = mx_matmul.launches - before
        else:
            out, row["cpu_ms"] = _cpu_ms(lambda: mx_matmul(a, b, *args))
        dist = (out - unfused(a, qb)).abs()
        bound = summation_bound(qa, qb)
        row["max_diff_unfused"] = float(dist.max())
        row["max_sum_bound"] = float(bound.max())
        row["within_sum_bound"] = bool((dist <= bound).all())
        row["bit_equal_share"] = float((dist == 0).float().mean())
        row["bound_ms"], row["bound_by"] = bound_ms(rows, K, N)
        out_rows.append(row)
        del a, b, qa, qb, out, dist, bound
    return out_rows


def _fmt(x):
    return "-" if x is None else f"{x:.4f}"


def main(argv=None):
    p = argparse.ArgumentParser(prog="mx_matmul_ablation",
                                description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--rows", type=int, default=ROWS)
    args = p.parse_args(argv)
    dev = "not measured (CPU)"
    if args.device != "cpu":
        if not torch.cuda.is_available():
            print("mx_matmul_ablation: no CUDA device (--device cpu runs the "
                  "plain versions)", file=sys.stderr)
            return 2
        dev = card()
        print(f"[device] {dev}", flush=True)
    rows = run(args.device, args.rows)
    for r in rows:
        print(f"{r['linear']} {tuple(r['shape'])}: K9 {_fmt(r['ms'])} ms, "
              f"unfused {_fmt(r['unfused_ms'])} ms, plain "
              f"{_fmt(r['plain_ms'])} ms, cpu {_fmt(r['cpu_ms'])} ms, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}; max |K9 - "
              f"unfused| {r['max_diff_unfused']:.3g} (within the summation "
              f"bound: {r['within_sum_bound']}, bit-equal share "
              f"{r['bit_equal_share']:.4f})", flush=True)
    print(json.dumps({"tool": "mx_matmul_ablation", "device": dev,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
