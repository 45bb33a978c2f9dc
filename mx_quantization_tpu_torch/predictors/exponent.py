"""Exponent-based Q·K^T approximation predictors of the emulation path
(port of the JAX package's ``predictors/exponent.py``).

All modes share one prelude: Q and K are MX-quantized along the head dim
(the fast quantizer where the fused engine takes it, else the emulation
quantizers), viewed as blocks of ``block_size``, and their per-block shared
exponents taken.  Modes:
  ex_pred      : element -> sign(+-1) * 2**shared_exp
  partial_Q    : Q stays MX, K -> exp-sign
  partial_K    : Q -> exp-sign, K stays MX
  two_step_leading_ones : the int8 mantissa -> the sum of its first and
                 second leading-one powers, times the shared exponent VALUE
                 (the reference's scaling, not 2**exp)
  MXINT4       : Q, K re-quantized to MXINT4
  true_ex      : sign * 2**floor(log2|elem|)
  threshold_ex : each element's exponent clamped to >= shared_exp - 1
Kernels K2, K3, K4 and K7 compute the same operands inside their tiles.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.elemwise import floor_log2_int, pow2, quantize_elemwise_op
from ..ops.fastquant import bf_fast, fused_eligible, quantize_mx_fast
from ..ops.mx import block_view, quantize_mx_op, shared_exponents, \
    unblock_view
from ..specs import MxSpecs


def _pow2f(e: torch.Tensor) -> torch.Tensor:
    """2**e for float e holding integers (possibly large-negative), exact,
    subnormals kept (``ops/bitmath.scalbn``)."""
    return pow2(e.to(torch.int32))


def _sign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: -1, +1, and x itself at +-0 and NaN (``torch.sign``
    gives +0 for -0 and for NaN)."""
    return torch.where((x == 0) | x.isnan(), x, torch.sign(x))


def _true_exponents(x: torch.Tensor) -> torch.Tensor:
    """floor(log2|x|) with zeros mapped to 0 (reference
    get_true_exponents)."""
    e = floor_log2_int(x).to(torch.float32)
    return torch.where(x == 0, 0.0, e)


def _exp_sign(blk, se):
    signs = torch.where(blk < 0, -1.0, 1.0)
    return signs * _pow2f(se.expand(blk.shape))


class ExponentApproximation:
    """The reference class layout; every method is pure."""

    def __init__(self, Q: torch.Tensor, K: torch.Tensor, mx_specs: MxSpecs):
        self.specs = mx_specs
        self.Q, self.K = Q, K
        bs = mx_specs.block_size
        self.MX_Q = self._mxq(Q)
        self.MX_K = self._mxq(K)
        self.blk_Q, self.len_Q = block_view(self.MX_Q, -1, bs)
        self.blk_K, self.len_K = block_view(self.MX_K, -1, bs)
        method = mx_specs.shared_exp_method
        self.se_Q = shared_exponents(self.blk_Q, method=method, axes=[-1])
        self.se_K = shared_exponents(self.blk_K, method=method, axes=[-1])

    def _mxq(self, x, fmt=None):
        specs = self.specs
        fmt = fmt or specs.a_elem_format
        if fused_eligible(specs, fmt):
            return quantize_mx_fast(
                bf_fast(x, specs), fmt, specs.block_size,
                specs.effective_scale_bits(), axis=-1,
                flush=specs.mx_flush_fp32_subnorms).to(torch.float32)
        return quantize_mx_op(
            quantize_elemwise_op(x, specs, round=specs.round_output),
            specs, elem_format=fmt, axes=[-1], round=specs.round_mx_output)

    def _unblock(self, q, k):
        ax = self.blk_Q.dim() - 2
        return (unblock_view(q, ax, self.len_Q),
                unblock_view(k, ax, self.len_K))

    def exponent_based_sign(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._unblock(_exp_sign(self.blk_Q, self.se_Q),
                             _exp_sign(self.blk_K, self.se_K))

    def partial_K(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._unblock(_exp_sign(self.blk_Q, self.se_Q), self.blk_K)

    def partial_Q(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._unblock(self.blk_Q, _exp_sign(self.blk_K, self.se_K))

    def two_step_leading_ones(self, exact_scale: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        def approx(blk, se):
            se_x = se.expand(blk.shape)
            raw = blk / _pow2f(se_x) * 64.0
            # first leading one (zeros -> -126, as method "none" gives)
            l1 = shared_exponents(raw, method="none")
            resid = raw - _pow2f(l1)
            resid = torch.where(resid < 0, 0.0, resid)
            l2 = shared_exponents(resid, method="none")
            mag = (_pow2f(l1) + _pow2f(l2)) / 64.0
            scale = _pow2f(se_x) if exact_scale else se_x
            return _sign(blk) * scale * mag
        return self._unblock(approx(self.blk_Q, self.se_Q),
                             approx(self.blk_K, self.se_K))

    def MXINT4(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._mxq(self.Q, "int4"), self._mxq(self.K, "int4")

    def exponent_based_sign_leading_ones(self
                                         ) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
        """true_ex: each element's leading one."""
        def approx(blk):
            signs = torch.where(blk < 0, -1.0, 1.0)
            return signs * _pow2f(_true_exponents(blk))
        return self._unblock(approx(self.blk_Q), approx(self.blk_K))

    def exponent_based_threshold_exponent(self
                                          ) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
        def approx(blk, se):
            se_x = se.expand(blk.shape)
            te = _true_exponents(blk)
            th = torch.where(te < se_x - 1, se_x - 1, te)
            return _sign(blk) * _pow2f(th)
        return self._unblock(approx(self.blk_Q, self.se_Q),
                             approx(self.blk_K, self.se_K))


def exponent_predict(Q: torch.Tensor, K: torch.Tensor, mx_specs: MxSpecs,
                     pred_mode: str = "ex_pred"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The approximated (Q, K) operands of ``pred_mode``."""
    obj = ExponentApproximation(Q, K, mx_specs)
    modes = {"ex_pred": obj.exponent_based_sign,
             "partial_Q": obj.partial_Q,
             "partial_K": obj.partial_K,
             "two_step_leading_ones": obj.two_step_leading_ones,
             "MXINT4": obj.MXINT4,
             "true_ex": obj.exponent_based_sign_leading_ones,
             "threshold_ex": obj.exponent_based_threshold_exponent}
    if pred_mode not in modes:
        raise ValueError(f"Unknown pred_mode {pred_mode!r}")
    return modes[pred_mode]()
