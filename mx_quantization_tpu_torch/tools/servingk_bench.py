#!/usr/bin/env python3
"""The port of ``tools/servingk_bench.py``: the serving tier's pipeline
and its variants, and the pretransposed-operand probe, on kernel K8.

    python3 -m mx_quantization_tpu_torch.tools.servingk_bench [--device cpu]
        [--cells 256] [--modes base,bfsm,...]

Each TPU mode string of ``make(mode)`` (the ``pallas_call`` at :136) maps
to K8's pass word (``ops/kernels/topk_ablate.py``): ``mxc`` counts the
search as float sums, unrolled (values unchanged); ``fscale`` moves the
scale into the exp argument; ``bfsm`` takes the softmax in bf16
arithmetic as JAX compiles it on the CPU.  ``pretransposed`` is
``probe_pretransposed`` (the ``pallas_call`` at :250): q and k arrive (G,
96, N) with all 96 rows live (operand layout 1), v (G, N, 72).  Rows,
timing and the CPU mode: ``ablate_common.py``.
"""

import sys

from ..ops.kernels import topk_ablate as ab
from .ablate_common import Variant, main as _main

SITE = "tools/servingk_bench.py:136"
FSCALE = ab.SERVING & ~ab.SCL | ab.FSCALE


def _v(word, layout=0, site=SITE):
    return Variant(word, layout, "row8", "serving", site)


TABLE = {
    "base": _v(ab.SERVING),
    "mxc": _v(ab.SERVING | ab.MXC | ab.UNROLL),
    "fscale": _v(FSCALE),
    "bfsm": _v(ab.SERVING | ab.BFSM),
    "fscale+bfsm": _v(FSCALE | ab.BFSM),
    "pretransposed": _v(ab.SERVING, 1, "tools/servingk_bench.py:250"),
}


def main(argv=None):
    return _main("servingk_bench", TABLE, argv)


if __name__ == "__main__":
    sys.exit(main())
