"""The reference-torch quantizer goldens (``tests/golden/{elemwise,mx}.npz``,
made by tests/make_golden.py) as cases for the port's emulation
quantizers, on any device.  Imports no JAX: the CPU tests, the card's GPU
tests and ``chip_smoke.py`` share it.

Key families (tests/test_quantize_parity.py): ``elem_{tensor}_{fmt}_
{round}_{sat|inf}``, ``bfloat_{tensor}_{bits}_{round}``,
``fp_{tensor}_{bits}_{round}``, ``mx_{tensor}_{fmt}_bs{bs}_ax{axis}_
fl{flush}_sb{scale_bits}`` and ``mxnone_{tensor}_int8``.
"""

import os

import numpy as np
import torch

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
ELEM_FORMATS = ("int8", "int4", "fp8_e4m3", "fp8_e5m2", "fp6_e3m2",
                "fp6_e2m3", "fp4_e2m1", "fp16", "bf16")
MX_FORMATS = ("int8", "int4", "int2", "fp8_e4m3", "fp8_e5m2", "fp6_e3m2",
              "fp6_e2m3", "fp4_e2m1")


def load(golden_dir=GOLDEN):
    return (np.load(os.path.join(golden_dir, "elemwise.npz")),
            np.load(os.path.join(golden_dir, "mx.npz")))


def _elem_key(key):
    body = key[len("elem_"):]
    parts = body.split("_")
    for fmt in ELEM_FORMATS:
        suffix = f"_{fmt}_{parts[-2]}_{parts[-1]}"
        if body.endswith(suffix):
            return body[:-len(suffix)], fmt, parts[-2], parts[-1]
    raise ValueError(key)


def _mx_key(key):
    body = key[len("mx_"):]
    parts = body.split("_")
    sb, fl = int(parts[-1][2:]), int(parts[-2][2:])
    ax, bs = int(parts[-3][2:]), int(parts[-4][2:])
    for fmt in MX_FORMATS:
        suffix = f"_{fmt}_bs{bs}_ax{ax}_fl{fl}_sb{sb}"
        if body.endswith(suffix):
            return body[:-len(suffix)], fmt, bs, ax, bool(fl), sb
    raise ValueError(key)


def golden_cases(elem, mx_npz):
    """Yield (family, format, key, input array, call), where ``call(x)``
    runs the port's quantizer at the key's settings on tensor x."""
    from mx_quantization_tpu_torch.ops import elemwise, mx

    for key in elem.files:
        if key.startswith("elem_"):
            tname, fmt, rnd, mode = _elem_key(key)
            yield ("elem", fmt, key, elem[f"in_{tname}"],
                   lambda x, fmt=fmt, rnd=rnd, sat=mode == "sat":
                   elemwise.quantize_elemwise(x, fmt, round=rnd,
                                              saturate_normals=sat,
                                              allow_denorm=sat))
        for family in ("bfloat", "fp"):
            if key.startswith(family + "_"):
                parts = key[len(family) + 1:].split("_")
                bits, rnd = int(parts[-2]), parts[-1]
                fn = (elemwise.quantize_bfloat if family == "bfloat"
                      else elemwise.quantize_fp)
                yield (family, family, key,
                       elem[f"in_{'_'.join(parts[:-2])}"],
                       lambda x, fn=fn, bits=bits, rnd=rnd:
                       fn(x, bits, round=rnd))
    for key in mx_npz.files:
        if key.startswith("mxnone_"):
            yield ("mxnone", "int8", key,
                   mx_npz[f"in_{key[len('mxnone_'):-len('_int8')]}"],
                   lambda x: mx.quantize_mx(x, 8, "int8", axes=[-1],
                                            block_size=32,
                                            shared_exp_method="none",
                                            round="nearest"))
        elif key.startswith("mx_"):
            tname, fmt, bs, ax, fl, sb = _mx_key(key)
            yield ("mx", fmt, key, mx_npz[f"in_{tname}"],
                   lambda x, fmt=fmt, bs=bs, ax=ax, fl=fl, sb=sb:
                   mx.quantize_mx(x, sb, fmt, axes=[ax], block_size=bs,
                                  round="nearest", flush_fp32_subnorms=fl))


def golden_mismatches(got, want):
    """tests/test_quantize_parity.py's rule: the same NaN mask and equal
    values elsewhere; returns the number of entries that break it."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    if got.shape != want.shape:
        return max(got.size, want.size)
    return int((nan_g != nan_w).sum() + (got[~nan_g & ~nan_w]
                                         != want[~nan_g & ~nan_w]).sum())


def check_all(elem, mx_npz, device, family=None, fmt=None):
    """Run every golden case (or those of one family and format) on
    ``device``; returns (cases run, [keys that break the rule])."""
    n, bad = 0, []
    for fam, f, key, x, call in golden_cases(elem, mx_npz):
        if (family is not None and fam != family) or \
                (fmt is not None and f != fmt):
            continue
        got = call(torch.from_numpy(np.ascontiguousarray(x)).to(device))
        n += 1
        if golden_mismatches(got.cpu(), (elem if fam in ("elem", "bfloat",
                                                          "fp")
                                         else mx_npz)[key]):
            bad.append(key)
    return n, bad
