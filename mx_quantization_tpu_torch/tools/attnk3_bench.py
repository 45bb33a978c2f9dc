#!/usr/bin/env python3
"""The port of ``tools/attnk3_bench.py``: the production exact pipeline
(transposed layout, bfloat 16) with its selection-cost switches, on kernel
K8.

    python3 -m mx_quantization_tpu_torch.tools.attnk3_bench [--device cpu]
        [--cells 256] [--modes base,v4,...]

Each TPU mode string of ``make(mode)`` (the ``pallas_call`` at :264) maps
to K8's pass word (``ops/kernels/topk_ablate.py``).  As in the TPU tool,
``vm``, ``unroll``, ``mxc`` (inside ``vm``), ``v1`` and ``v3`` change how
the search counts and the rank is taken, not the values; ``v4`` folds the
probabilities' quantize constants; ``nocount`` skips the search (k-th key
0), ``norank`` the rank (every key >= the k-th), ``nosel`` the selection,
``noaq`` the probabilities' quantize, ``noexp`` exp (x * 1.0009765625),
``nopred`` the predictor, ``noprep`` the q, k and v quantizes.  ``mxc``
alone reaches none of its code (it is read only under ``vm``): it is
``base``.  Rows, timing and the CPU mode: ``ablate_common.py``.
"""

import sys

from ..ops.kernels import topk_ablate as ab
from .ablate_common import Variant, main as _main

SITE = "tools/attnk3_bench.py:264"
SELECTION = ab.KEYS | ab.SEARCH | ab.SEL | ab.RANK
NOSEL = ab.EXACT & ~SELECTION


def _v(word):
    return Variant(word, 0, "row8", "exact", SITE)


TABLE = {
    "base": _v(ab.EXACT),
    "vm+unroll": _v(ab.EXACT | ab.VM | ab.UNROLL),
    "v4": _v(ab.EXACT | ab.FOLD),
    "vm+unroll+v4": _v(ab.EXACT | ab.VM | ab.UNROLL | ab.FOLD),
    "nosel": _v(NOSEL),
    "nosel+noaq": _v(NOSEL & ~ab.AQ),
    "nosel+noexp": _v(NOSEL & ~ab.EXP | ab.LINEXP),
    "nosel+nopred": _v(NOSEL & ~ab.PRED),
    "nosel+noprep+nopred+noaq+noexp": _v(
        NOSEL & ~(ab.QKQ | ab.VQ | ab.PRED | ab.AQ | ab.EXP) | ab.LINEXP),
    "v1": _v(ab.EXACT | ab.V1),
    "v3": _v(ab.EXACT | ab.V3),
    "nocount": _v(ab.EXACT & ~ab.SEARCH | ab.VM),
    "norank": _v(ab.EXACT & ~ab.RANK),
    "mxc": _v(ab.EXACT),
}
# the TPU tool's default MODES
DEFAULT_MODES = ("base", "vm+unroll", "v4", "vm+unroll+v4", "nosel",
                 "nosel+noaq", "nosel+noexp", "nosel+nopred",
                 "nosel+noprep+nopred+noaq+noexp")


def main(argv=None):
    return _main("attnk3_bench", TABLE, argv)


if __name__ == "__main__":
    sys.exit(main())
