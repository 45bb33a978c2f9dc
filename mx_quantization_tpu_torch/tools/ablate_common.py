"""What the port's attention-ablation tools share (``attnk_bench.py``,
``attnk3_bench.py``, ``servingk_bench.py``, ``passprice_bench.py``): the
variant table's entries, the seeded inputs, the bound, the run over a
table and the command line.

Each tool maps its TPU counterpart's mode strings (``tools/<name>.py`` at
the root of the repository) to a ``Variant`` of kernel K8
(``ops/kernels/topk_ablate.py``) and runs them at the TPU tools' point:
DiT-XL/2's attention, 16 rows x 16 heads = 256 cells of N = S = 256
tokens, head dim 72 (padded to 96 for the MX blocks), k = 154, MXINT8
in blocks of 32, ex_pred with 8-bit keys, bf16 q, k and v drawn from a
seeded N(0, 1).  A row per variant: its device ms per call (K8, CUDA
events behind a GPU sleep), the plain version's device ms, the least time
the card could take (``bound``), and whether its output equals "prod", the
port's K3 (``fused_topk_attention``) at the same point in the variant's
tier, with the largest difference.  On the CPU (``--device cpu``) only the
plain versions run: their host ms stand in ``cpu_ms`` and no device time
is given.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from typing import NamedTuple

import torch

from ..ops.kernels import topk_ablate as ab
from ..ops.kernels.topk_attention import fused_topk_attention
from .time_split_sites import time_ms

# the TPU tools' point
CELLS, N, D = 256, 256, 72
K = 154
SCALE = D ** -0.5
D_PRET = 96  # servingk_bench probe_pretransposed: q and k (G, 96, N) live

# timed calls of K8 per variant, and of K3 per tier
REPS = 10

# H100 SXM published peaks (as chip_smoke.py reads them): HBM bytes/s,
# dense bf16 and int8 tensor-core op/s, non-tensor f32 instructions/s
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
F32_INSTR_PER_S = 33.5e12

# the modes whose output equals prod bit for bit, in table order (held on
# the CPU by the tools' tests and on the card by chip_smoke.py): the
# all-on words, with the value-neutral bits (``topk_ablate.NEUTRAL``),
# ``v4``'s folded constants and the pretransposed operands
EQUAL_TO_PROD = {
    "attnk_bench": (),
    "attnk3_bench": ("base", "vm+unroll", "v4", "vm+unroll+v4", "v1", "v3",
                     "mxc"),
    "servingk_bench": ("base", "mxc", "pretransposed"),
    "passprice_bench": ("L12", "L15"),
}


class Variant(NamedTuple):
    """One TPU mode string as K8 computes it: the pass word, the operand
    layout, the key form, the cells whose rows share a key column's
    threshold (``col16``: ``make_batched``'s 4), the tier of production
    it is held against, and the TPU site it replaces."""
    word: int
    layout: int
    key_form: str
    tier: str
    site: str
    group: int = 1
    bfloat: int = 16


def inputs(cells, device, seed=0, layout=0):
    """q, k, v bf16 from a seeded N(0, 1): (cells, N, D) each, or q and k
    (cells, D_PRET, N) (layout 1)."""
    g = torch.Generator().manual_seed(seed)
    qk_shape = (cells, N, D) if layout == 0 else (cells, D_PRET, N)
    q, k_ = (torch.randn(*qk_shape, generator=g) for _ in range(2))
    v = torch.randn(cells, N, D, generator=g)
    return tuple(t.to(torch.bfloat16).to(device) for t in (q, k_, v))


def group_of(var: Variant, cells: int) -> int:
    """The cells a column threshold spans at this cell count: the
    variant's group where it divides the cells (``make_batched`` with
    CELLS cells per grid step), else their common divisor."""
    return math.gcd(var.group, cells)


def call(var: Variant, q, k_, v, plain=False, k=K, scale=SCALE):
    fn = ab.ablate_attention_ref if plain else ab.ablate_attention
    return fn(q, k_, v, passes=var.word, k=k, scale=scale,
              layout=var.layout, bfloat=var.bfloat, key_form=var.key_form,
              group=group_of(var, q.shape[0]))


def prod(tier, q, k_, v, layout=0, k=K, scale=SCALE):
    """The port's K3 at the point: q, k, v as cells of one head each; at
    layout 1 q and k transposed back and v padded to their head dim (the
    padded columns quantize to 0 and are cut)."""
    if layout == 1:
        q, k_ = q.transpose(1, 2), k_.transpose(1, 2)
        v = torch.nn.functional.pad(v, (0, q.shape[-1] - v.shape[-1]))
    G, n, dv = q.shape[0], q.shape[1], v.shape[-1]
    out = fused_topk_attention(
        *(t.contiguous().reshape(G, 1, n, -1) for t in (q, k_, v)), k=k,
        scale=scale, approx=True, pred_mode="ex_pred", key_bits=8,
        out_dtype=torch.bfloat16, bfloat=16, contract=tier)
    return out.reshape(G, n, dv)[..., :D]


def bound_ms(word, cells, n=N, dqk=None, dv=D, k=K, key_form="row8"):
    """The least time (ms) and its term for one K8 call with this word:
    bytes (q, k and v read once and the output written once; v and the
    output alone without MM) over the HBM rate, or the operations over
    their peak rate: on the tensor cores the true scores (MM) and the
    predictor (PRED) over every (query, key) pair at the padded head dim
    and PV over the keys a row keeps (k with SEL, else all), each at the
    int8 peak where its operands are MXINT8 grid points (QKQ for the
    scores, AQ and VQ for PV) and at bf16's elsewhere; on the CUDA
    cores, per pair, one operation for each 8 key bits of the search
    (SEARCH), one for the keys (KEYS) and one for each softmax pass (MAX,
    EXP or LINEXP, DIV), the quantizes of the probabilities (AQ, 11 per
    element as K1's int grid) and of q, k, v (QKQ, VQ) per element.
    Memory traffic and both kinds of operations overlap, so the bound is
    the largest of the three."""
    dqk = D if dqk is None else dqk
    dp = -(-dqk // ab.BLOCK) * ab.BLOCK
    rows = cells * n
    pairs = rows * n
    if not word & ab.MM:
        nbytes = cells * n * dv * 2 * 2
        return 1e3 * nbytes / HBM_BYTES_PER_S, "bytes", {}
    nbytes = cells * n * (2 * dqk + 2 * dv) * 2
    kk = k if word & ab.SEL else n
    score_rate = INT8_OPS_PER_S if word & ab.QKQ else BF16_OPS_PER_S
    pv_rate = (INT8_OPS_PER_S if word & ab.AQ and word & ab.VQ
               else BF16_OPS_PER_S)
    tc_s = (2 * pairs * dp * (2 if word & ab.PRED else 1) / score_rate
            + 2 * rows * kk * dv / pv_rate)
    bits = ab.KEY_FORMS[key_form][1]
    cc = pairs * (bits // 8 * bool(word & ab.SEARCH) + bool(word & ab.KEYS)
                  + bool(word & ab.MAX) + bool(word & (ab.EXP | ab.LINEXP))
                  + bool(word & ab.DIV) + 11 * bool(word & ab.AQ))
    cc += 11 * cells * n * ((2 * dp) * bool(word & ab.QKQ)
                            + dv * bool(word & ab.VQ))
    terms = dict(bytes=1e3 * nbytes / HBM_BYTES_PER_S,
                 tensor_core=1e3 * tc_s,
                 cuda_core=1e3 * cc / F32_INSTR_PER_S)
    by = max(terms, key=terms.get)
    return terms[by], "bytes" if by == "bytes" else "operations", terms


def _cpu_ms(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, 1e3 * (time.perf_counter() - t0)


def _device_ms(fn):
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def run(table, device="cuda", cells=CELLS, modes=None):
    """One row per mode of ``table`` (all by default): variant, ms (K8,
    device, per call), plain_ms (the plain version, device), cpu_ms (the
    plain version's host ms on the CPU), bound_ms and bound_by, equal to
    prod and the largest difference from it, K8's launches and its largest
    difference from the plain version.  On the card each variant is first
    held bit for bit to its plain version (AssertionError where not)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain "
                           "versions")
    rows = []
    cache = {}
    for mode in (modes or list(table)):
        var = table[mode]
        if var.layout not in cache:
            q, k_, v = inputs(cells, device, layout=var.layout)
            cache[var.layout] = (q, k_, v, {})
        q, k_, v, prods = cache[var.layout]
        if var.tier not in prods:
            prods[var.tier] = prod(var.tier, q, k_, v, var.layout)
        row = dict(variant=mode, site=var.site, word=var.word,
                   passes="|".join(ab.pass_names(var.word)),
                   layout=var.layout, key_form=var.key_form,
                   group=group_of(var, cells), tier=var.tier,
                   ms=None, plain_ms=None, cpu_ms=None, launches=0,
                   max_abs_err=None)
        if cuda:
            before = ab.ablate_attention.launches
            out = call(var, q, k_, v)
            ref = call(var, q, k_, v, plain=True)
            _, row["plain_ms"] = _device_ms(  # a second, warm call
                lambda: call(var, q, k_, v, plain=True))
            row["max_abs_err"] = float((out.float() - ref.float()).abs().max())
            if not torch.equal(out, ref):
                raise AssertionError(f"{mode}: K8 differs from its plain "
                                     f"version by {row['max_abs_err']}")
            row["ms"] = time_ms(lambda: call(var, q, k_, v), REPS)
            row["launches"] = ab.ablate_attention.launches - before
        else:
            out, row["cpu_ms"] = _cpu_ms(lambda: call(var, q, k_, v))
        dqk = D_PRET if var.layout else D
        row["bound_ms"], row["bound_by"], _ = bound_ms(
            var.word, cells, N, dqk, D, K, var.key_form)
        diff = (out.float() - prods[var.tier].float()).abs()
        row["equal_to_prod"] = bool(torch.equal(out, prods[var.tier]))
        row["max_diff"] = float(diff.max())
        rows.append(row)
    return rows


def prod_rows(device="cuda", cells=CELLS):
    """Rows of the port's K3 in each tier at the point (the TPU tools'
    ``prod_exact`` and ``prod_serving``)."""
    device = torch.device(device)
    q, k_, v = inputs(cells, device)
    rows = []
    for tier in ("exact", "serving"):
        row = dict(variant=f"prod_{tier}", tier=tier, ms=None, cpu_ms=None)
        if device.type == "cuda":
            row["ms"] = time_ms(lambda: prod(tier, q, k_, v), REPS)
        else:
            _, row["cpu_ms"] = _cpu_ms(lambda: prod(tier, q, k_, v))
        rows.append(row)
    return rows


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _fmt(x):
    return "-" if x is None else f"{x:.4f}"


def print_rows(rows):
    for r in rows:
        print(f"{r['variant']:34s} ms {_fmt(r['ms'])} plain_ms "
              f"{_fmt(r.get('plain_ms'))} cpu_ms {_fmt(r['cpu_ms'])} "
              f"bound_ms {_fmt(r.get('bound_ms'))} ({r.get('bound_by', '-')})"
              f" equal_to_prod {r.get('equal_to_prod', '-')} max_diff "
              f"{_fmt(r.get('max_diff'))}", flush=True)


def main(name, table, argv=None, extra=None):
    """The tools' command line: ``--device``, ``--cells``, ``--modes`` (a
    comma list, default all).  ``extra(rows, args)`` prints what a tool
    adds.  Prints the rows and last one JSON
    object with them."""
    p = argparse.ArgumentParser(prog=name, description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--cells", type=int, default=CELLS)
    p.add_argument("--modes", default=None)
    args = p.parse_args(argv)
    modes = args.modes.split(",") if args.modes else None
    dev = "not measured (CPU)"
    if args.device != "cpu":
        if not torch.cuda.is_available():
            print(f"{name}: no CUDA device (--device cpu runs the plain "
                  "versions)", file=sys.stderr)
            return 2
        dev = card()
        print(f"[device] {dev}", flush=True)
    rows = run(table, args.device, args.cells, modes)
    print_rows(rows)
    if extra is not None:
        extra(rows, args)
    print(json.dumps({"tool": name, "device": dev, "cells": args.cells,
                      "rows": rows}))
    return 0


def tool_tables():
    """Each port tool's name and its table of variants."""
    from . import attnk3_bench, attnk_bench, passprice_bench, servingk_bench
    return dict(attnk_bench=attnk_bench.TABLE, attnk3_bench=attnk3_bench.TABLE,
                servingk_bench=servingk_bench.TABLE,
                passprice_bench=passprice_bench.TABLE)


def distinct_variants():
    """The tools' variants, each K8 call once: {variant: [(tool, mode),
    ...]} (the TPU site and tier aside, which do not change the call)."""
    out = {}
    for tool, table in tool_tables().items():
        for mode, var in table.items():
            key = var._replace(tier="", site="")
            out.setdefault(key, []).append((tool, mode))
    return out
