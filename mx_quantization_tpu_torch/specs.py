"""Typed MX quantization config: the port's copy of the JAX package's
``specs.py``, with the same knob names and defaults.

``custom_tpu`` names the execution engine, as in the JAX package:
``"ref"`` (the default) is the emulation engine, plain PyTorch that is
bit-faithful to the reference quantizers (``ops/{bitmath,elemwise,mx}.py``);
``"fused"`` takes the hand-written kernels on the card (their plain versions
on the CPU) where JAX takes its Pallas kernels, and the emulation ops where
JAX falls back to XLA.  Any other name raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

from .formats import ElemFormat, FormatLike

# the execution engines: the emulation engine and the kernels
ENGINES = ("ref", "fused")


def _canon_format(f: FormatLike) -> Optional[str]:
    if f is None:
        return None
    if isinstance(f, ElemFormat):
        return f.name
    return ElemFormat.from_str(f).name  # validates


@dataclasses.dataclass(frozen=True)
class MxSpecs:
    """All quantization knobs.  Defaults = no quantization.

    scale_bits       : bits of the per-block shared exponent (0 = default 8)
    w_elem_format    : weight MX element format (int8/int4/fp8_e4m3/...)
    a_elem_format    : activation MX element format
    block_size       : elements sharing one exponent
    shared_exp_method: "max" | "none"
    mx_flush_fp32_subnorms : zero blocks whose max |x| is fp32-subnormal
    bfloat / fp      : elementwise format between ops (bfloat=16 rounds to
                       the bf16 grid half away from zero); 0 disables
    """

    scale_bits: int = 0

    w_elem_format: Optional[str] = None
    a_elem_format: Optional[str] = None
    w_elem_format_bp: Optional[str] = None
    a_elem_format_bp: Optional[str] = None
    a_elem_format_bp_ex: Optional[str] = None
    a_elem_format_bp_os: Optional[str] = None
    mx_flush_fp32_subnorms: bool = False

    shared_exp_method: str = "max"
    block_size: int = 0

    bfloat: int = 0
    fp: int = 0
    bfloat_subnorms: bool = True

    quantize_backprop: bool = True

    round: str = "nearest"
    round_m: Optional[str] = None
    round_weight: Optional[str] = None
    round_output: Optional[str] = None
    round_grad_weight: Optional[str] = None
    round_grad_input: Optional[str] = None
    round_mx_output: Optional[str] = None
    round_mx_input_grad_input: Optional[str] = None
    round_mx_weight_grad_input: Optional[str] = None
    round_mx_grad_output_grad_input: Optional[str] = None
    round_mx_input_grad_weight: Optional[str] = None
    round_mx_grad_output_grad_weight: Optional[str] = None

    softmax_exp2: bool = False
    vec_use_exp2: bool = False
    vec_use_recip: bool = False

    custom_tpu: str = "ref"
    prequantized_weights: bool = False
    prequantized_activations: bool = False

    def __post_init__(self):
        for f in ("w_elem_format", "a_elem_format", "w_elem_format_bp",
                  "a_elem_format_bp", "a_elem_format_bp_ex",
                  "a_elem_format_bp_os"):
            object.__setattr__(self, f, _canon_format(getattr(self, f)))
        if self.bfloat and self.fp:
            raise ValueError("Cannot set both bfloat and fp in MxSpecs")
        if 0 < self.bfloat <= 9:
            raise ValueError("bfloat must be 0 or > 9")
        if 0 < self.fp <= 6:
            raise ValueError("fp must be 0 or > 6")
        if self.shared_exp_method not in ("max", "none"):
            raise ValueError(
                f"Unknown shared_exp_method {self.shared_exp_method}")
        if self.custom_tpu not in ENGINES:
            raise ValueError(f"Unknown engine custom_tpu={self.custom_tpu!r}; "
                             f"the engines are {ENGINES}")

    def finalize(self) -> "MxSpecs":
        """Resolve dependent defaults (bp formats <- fwd, round_* <- round)."""
        upd = {}

        def dflt(field, src):
            if getattr(self, field) is None:
                upd[field] = upd.get(src, getattr(self, src))

        dflt("w_elem_format_bp", "w_elem_format")
        dflt("a_elem_format_bp", "a_elem_format")
        dflt("a_elem_format_bp_os", "a_elem_format")
        dflt("a_elem_format_bp_ex", "a_elem_format")
        for f in ("round_m", "round_output", "round_grad_weight",
                  "round_grad_input", "round_weight", "round_mx_output"):
            dflt(f, "round")
        base_gi = self.round_grad_input if self.round_grad_input is not None \
            else self.round
        for f in ("round_mx_input_grad_input", "round_mx_weight_grad_input",
                  "round_mx_grad_output_grad_input",
                  "round_mx_input_grad_weight",
                  "round_mx_grad_output_grad_weight"):
            if getattr(self, f) is None:
                upd[f] = base_gi
        return dataclasses.replace(self, **upd) if upd else self

    def backwards(self) -> "MxSpecs":
        """Specs for the backward pass: unquantized when quantize_backprop
        is False."""
        if self.quantize_backprop:
            return self
        return dataclasses.replace(
            self,
            w_elem_format=None, a_elem_format=None,
            w_elem_format_bp=None, a_elem_format_bp=None,
            a_elem_format_bp_os=None, a_elem_format_bp_ex=None,
            block_size=0, bfloat=0, fp=0,
        )

    @property
    def is_noop(self) -> bool:
        """True if these specs perform no quantization anywhere."""
        return not any((
            self.w_elem_format, self.a_elem_format, self.w_elem_format_bp,
            self.a_elem_format_bp, self.a_elem_format_bp_os,
            self.a_elem_format_bp_ex, self.bfloat, self.fp,
        ))

    def effective_scale_bits(self) -> int:
        return 8 if self.scale_bits == 0 else self.scale_bits

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def json(self, indent=None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def replace(self, **kw) -> "MxSpecs":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: dict, finalize: bool = True) -> "MxSpecs":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise KeyError(f"Unknown MxSpecs keys: {sorted(unknown)}")
        s = cls(**d)
        return s.finalize() if finalize else s


def finalize_mx_specs(specs, early_exit: bool = True) -> Optional[MxSpecs]:
    """dict/MxSpecs -> finalized MxSpecs, or None if nothing is quantized."""
    if specs is None:
        return None
    if isinstance(specs, dict):
        specs = MxSpecs.from_dict(specs, finalize=False)
    if early_exit and specs.is_noop:
        return None
    return specs.finalize()


_ASSERT_MODE = os.environ.get("MX_ASSERT", "False")


def mx_assert_test(mx_specs) -> None:
    """Raise if MX_ASSERT=True and an MX op is called with specs=None
    (reference specs.py:351-363): it catches paths that silently fall back
    to the unquantized op during quantization experiments."""
    if _ASSERT_MODE == "True" and mx_specs is None:
        import traceback
        stack = traceback.extract_stack()
        f1, f2 = stack[-2], stack[-3]
        raise ValueError(
            "MX assert test failed!\n"
            f"mx_specs is None in function {f1.name}\n"
            f"Called from {f2.filename}, line {f2.lineno}\n"
            f"  {f2.line}")
