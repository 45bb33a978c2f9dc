#!/usr/bin/env python3
"""The port of ``tools/passprice_bench.py``: the additive ladder L00-L15
of the fused top-k attention cell, each rung the previous one plus one
pass group, through the serving tier (L12) to the exact one (L15), on
kernel K8, with the port's K3 in each tier ("prod").

    python3 -m mx_quantization_tpu_torch.tools.passprice_bench \
        [--device cpu] [--cells 256] [--modes L00,L12,...]

Each rung's stage flags (the TPU tool's ``LADDER``, :59; ``make(st)``,
the ``pallas_call`` at :182) map to K8's pass bits
(``ops/kernels/topk_ablate.py``): prep PREP, mm MM, vq VQ, qkq QKQ, pred
PRED, scl SCL, max MAX, exp EXP, div DIV, keys KEYS, search SEARCH, sel
SEL, sround SROUND, aq AROUND and AQ, rank RANK, oround OROUND.  Prints
the rungs, ``prod_exact`` and ``prod_serving``, and the rung-to-rung
deltas of the device ms (of the host ms on the CPU).  Rows, timing and
the CPU mode: ``ablate_common.py``.
"""

import sys

from ..ops.kernels import topk_ablate as ab
from .ablate_common import Variant, main as _main, print_rows, prod_rows

SITE = "tools/passprice_bench.py:182"
STAGE_BITS = {"prep": ab.PREP, "mm": ab.MM, "vq": ab.VQ, "qkq": ab.QKQ,
              "pred": ab.PRED, "scl": ab.SCL, "max": ab.MAX, "exp": ab.EXP,
              "div": ab.DIV, "keys": ab.KEYS, "search": ab.SEARCH,
              "sel": ab.SEL, "sround": ab.SROUND, "aq": ab.AROUND | ab.AQ,
              "rank": ab.RANK, "oround": ab.OROUND}
# (name, the stage each rung adds), as the TPU tool's LADDER
RUNGS = (("L00_dma_only", ()), ("L01_+transpose_pad", ("prep",)),
         ("L02_+score_matmul_pv", ("mm",)), ("L03_+v_quant", ("vq",)),
         ("L04_+qk_quant", ("qkq",)), ("L05_+predictor", ("pred",)),
         ("L06_+scale_mul", ("scl",)), ("L07_+mask_max", ("max",)),
         ("L08_+exp", ("exp",)), ("L09_+sum_div", ("div",)),
         ("L10_+keys", ("keys",)), ("L11_+search8", ("search",)),
         ("L12_+gt_select=SERVING", ("sel",)),
         ("L13_+score_bf16_round", ("sround",)),
         ("L14_+attn_round+mxquant", ("aq",)),
         ("L15_+tie_rank=EXACT", ("rank", "oround")))


def _ladder():
    table, word = {}, 0
    for name, stages in RUNGS:
        for s in stages:
            word |= STAGE_BITS[s]
        tier = "exact" if word & ab.SROUND else "serving"
        table[name.split("_")[0]] = Variant(word, 0, "row8", tier, SITE)
    return table


TABLE = _ladder()
PRODS = ("prod_exact", "prod_serving")


def deltas(rows):
    """(rung, ms, ms less the previous rung's) on the device's ms, or the
    host's on the CPU."""
    key = "ms" if rows and rows[0]["ms"] is not None else "cpu_ms"
    out, prev = [], None
    for r in rows:
        t = r[key]
        out.append((r["variant"], t, None if prev is None else t - prev))
        prev = t
    return key, out


def _extra(rows, args):
    key, d = deltas(rows)
    print(f"[ladder] rung-to-rung deltas of {key}:")
    for name, t, dt in d:
        print(f"  {name:6s} {t:10.4f}" +
              ("" if dt is None else f"  ({dt:+.4f})"))
    print_rows(prod_rows(args.device, args.cells))


def main(argv=None):
    return _main("passprice_bench", TABLE, argv, extra=_extra)


if __name__ == "__main__":
    sys.exit(main())
