#!/usr/bin/env python3
"""The port of ``tools/kth_bench.py``: the k-th largest key selection
strategies of the fused top-k attention's count loop (kernel K10,
``ops/kernels/kth_select.py``) against ``torch.kthvalue``, at the TPU
probe's point.

    python3 -m mx_quantization_tpu_torch.tools.kth_bench [--device cpu]
        [--cells 256]

The point: G = 256 cells of (256, 256) f32 from a seeded N(0, 1), 16-bit
keys (the f32's bits >> 16), k = 154.  A row per strategy: K10's device ms
per call (CUDA events behind a GPU sleep), the plain version's device ms,
the bound (the bytes read and written over the HBM rate, or the search's
compares over the CUDA cores' rate, the larger), and whether its output
equals the other strategies' and ``torch.kthvalue``'s; a last row times
``torch.kthvalue`` on the keys (one PyTorch call that computes the same
k-th key; the kernel does not use it).  On the card each strategy is first
held bit for bit to its plain version.  The TPU tool cannot be imported:
it runs its benchmark when it is loaded.  On the CPU (``--device cpu``)
only the plain versions run: their host ms stand in ``cpu_ms`` and no
device time is given.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..ops.kernels.kth_select import (ITERS, N, STRATEGIES, keys_of,
                                      kth_select, kth_select_ref,
                                      search_steps)
from .ablate_common import (F32_INSTR_PER_S, HBM_BYTES_PER_S, _cpu_ms,
                            _device_ms, card)
from .time_split_sites import time_ms

CELLS = 256
K = 154
REPS = 20


def inputs(cells, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(cells, N, N, generator=g).to(device)


def library(x):
    """``torch.kthvalue`` on the keys: each row's K-th largest, broadcast
    as K10 writes it."""
    keys = keys_of(x)
    return torch.kthvalue(keys, N - K + 1, dim=-1).values.to(
        torch.float32)[..., None].expand(x.shape)


def bound_ms(cells, steps):
    """(ms, "bytes" or "operations"): the least time for one call, the
    larger of the f32 cells read and written once over the HBM rate and
    ``steps`` compare-and-count passes over every key (2 operations a key)
    over the CUDA cores' rate.  ``steps`` is what the data needs: 17 a
    cell for vpu and mxu, each cell's until every row has converged for
    while."""
    by_bytes = 1e3 * cells * N * N * 4 * 2 / HBM_BYTES_PER_S
    by_ops = 1e3 * steps * N * N * 2 / F32_INSTR_PER_S
    return max((by_bytes, "bytes"), (by_ops, "operations"))


def run(device="cuda", cells=CELLS):
    """One row per strategy and one for ``torch.kthvalue``; AssertionError
    where K10 differs from its plain version on the card."""
    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain "
                           "versions")
    x = inputs(cells, device)
    lib = library(x)
    rows = []
    for strategy in STRATEGIES:
        row = dict(variant=strategy, ms=None, plain_ms=None, cpu_ms=None,
                   launches=0, max_abs_err=None)
        if cuda:
            before = kth_select.launches
            out = kth_select(x, K, strategy)
            ref, row["plain_ms"] = _device_ms(
                lambda: kth_select_ref(x, K, strategy))
            row["max_abs_err"] = float((out - ref).abs().max())
            if not torch.equal(out, ref):
                raise AssertionError(f"K10 {strategy} differs from its plain "
                                     f"version by {row['max_abs_err']}")
            row["ms"] = time_ms(lambda: kth_select(x, K, strategy), REPS)
            row["launches"] = kth_select.launches - before
        else:
            out, row["cpu_ms"] = _cpu_ms(lambda: kth_select(x, K, strategy))
        steps = (int(search_steps(x, K).sum()) if strategy == "while"
                 else ITERS * cells)
        row["steps"] = steps
        row["bound_ms"], row["bound_by"] = bound_ms(cells, steps)
        row["equal_to_kthvalue"] = bool(torch.equal(out, lib))
        rows.append(row)
    row = dict(variant="kthvalue", ms=None, cpu_ms=None)
    keys = keys_of(x)
    if cuda:
        row["ms"] = time_ms(
            lambda: torch.kthvalue(keys, N - K + 1, dim=-1), REPS)
    else:
        _, row["cpu_ms"] = _cpu_ms(
            lambda: torch.kthvalue(keys, N - K + 1, dim=-1))
    rows.append(row)
    return rows


def _fmt(x):
    return "-" if x is None else f"{x:.4f}"


def main(argv=None):
    p = argparse.ArgumentParser(prog="kth_bench",
                                description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--cells", type=int, default=CELLS)
    args = p.parse_args(argv)
    dev = "not measured (CPU)"
    if args.device != "cpu":
        if not torch.cuda.is_available():
            print("kth_bench: no CUDA device (--device cpu runs the plain "
                  "versions)", file=sys.stderr)
            return 2
        dev = card()
        print(f"[device] {dev}", flush=True)
    rows = run(args.device, args.cells)
    for r in rows:
        extra = "" if r["variant"] == "kthvalue" else (
            f", plain {_fmt(r['plain_ms'])} ms, bound {r['bound_ms']:.4f} ms"
            f" by {r['bound_by']} ({r['steps']} steps), equal to kthvalue "
            f"{r['equal_to_kthvalue']}")
        print(f"{r['variant']}: {_fmt(r['ms'])} ms, cpu {_fmt(r['cpu_ms'])} "
              f"ms{extra}", flush=True)
    print(json.dumps({"tool": "kth_bench", "device": dev,
                      "cells": args.cells, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
