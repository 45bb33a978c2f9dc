#!/usr/bin/env python3
"""The port of ``tools/attnk_bench.py``: the pre-bfloat ablation sweep of
the fused top-k attention cell (straight (N, S) layout, no bf16 rounds),
its i16-key, row-batched and transposed variants, on kernel K8.

    python3 -m mx_quantization_tpu_torch.tools.attnk_bench [--device cpu]
        [--cells 256] [--modes full,noat,...]

Each TPU mode string maps to K8's pass word (``ops/kernels/topk_ablate.py``);
the TPU tool's ``make(mode)`` (:119), ``make_i16()`` (:258),
``make_batched()`` (:341) and ``make_trans(mode)`` (:464) are four
``pallas_call`` sites, named in each variant.  As in the TPU tool, ``make``
reduces its 8-bit keys' k-th over each key COLUMN (its ``_kth_keys`` runs
over the queries of the straight layout), ``make_batched`` over the rows
of 4 cells stacked, and ``make_i16`` and ``make_trans`` over each query
row.  Rows, timing and the CPU mode: ``ablate_common.py``.
"""

import sys

from ..ops.kernels import topk_ablate as ab
from .ablate_common import Variant, main as _main

# the pre-bfloat pipeline: no bf16 rounds (bfloat 0)
FULL = (ab.PREP | ab.MM | ab.VQ | ab.QKQ | ab.PRED | ab.SCL | ab.KEYS |
        ab.SEARCH | ab.SEL | ab.RANK | ab.MAX | ab.EXP | ab.DIV | ab.AQ)
SELECTION = ab.KEYS | ab.SEARCH | ab.SEL | ab.RANK
MAKE = "tools/attnk_bench.py:119"
TRANS = "tools/attnk_bench.py:464"


def _v(word, key_form, site, group=1):
    return Variant(word, 0, key_form, "exact", site, group, bfloat=0)


TABLE = {
    "full": _v(FULL, "col8", MAKE),
    "nopred": _v(FULL & ~ab.PRED, "col8", MAKE),
    "nosel": _v(FULL & ~SELECTION, "col8", MAKE),
    "norank": _v(FULL & ~ab.RANK, "col8", MAKE),
    # noaq: the probabilities and v both cast to bf16
    "noaq": _v(FULL & ~(ab.AQ | ab.VQ), "col8", MAKE),
    # noat: the probabilities quantized along the queries
    "noat": _v(FULL | ab.NOAT, "col8", MAKE),
    "noquant+nosel+noaq": _v(
        FULL & ~(ab.QKQ | ab.PRED | SELECTION | ab.AQ | ab.VQ), "col8", MAKE),
    "i16": _v(FULL, "row16_bf16", "tools/attnk_bench.py:258"),
    "batched": _v(FULL, "col16", "tools/attnk_bench.py:341", group=4),
    "trans-full": _v(FULL, "row8_9step", TRANS),
    "trans-nosel": _v(FULL & ~SELECTION, "row8_9step", TRANS),
    "trans-norank": _v(FULL & ~ab.RANK, "row8_9step", TRANS),
    "trans-noaq": _v(FULL & ~(ab.AQ | ab.VQ), "row8_9step", TRANS),
}


def main(argv=None):
    return _main("attnk_bench", TABLE, argv)


if __name__ == "__main__":
    sys.exit(main())
