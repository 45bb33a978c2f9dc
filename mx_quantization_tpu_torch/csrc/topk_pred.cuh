// The predictors of the attention kernels K2 and K7 (topk_attention_qkv.cu)
// and K3 and K4 (topk_attention_split.cu), per element of the quantized q
// and k (JAX _prep_side, _two_step_approx, _true_ex_approx,
// _threshold_ex_approx): the predictor kinds the kernels are built for, the
// modes as the wrapper numbers them, and each mode's operand or integer code.
#pragma once

#include "mx_common.cuh"

namespace mx {

// How a kernel computes the predictor: kBlockInt is MXINT4, partial_Q,
// partial_K and threshold_ex on the int grids (codes in int8 mma); kOperand
// every predictor but ex_pred and ELSA on the CUDA-core kernel (bf16
// operands)
enum Pred { kNone = 0, kExPred = 1, kTwoStep = 2, kBlockInt = 3, kOperand = 4, kElsa = 5 };

// The predictor modes, numbered as the wrapper numbers them (SPLIT_PRED_MODES)
enum Mode {
  mExPred = 0, mTwoStep = 1, mMxint4 = 2, mPartialQ = 3, mPartialK = 4, mTrueEx = 5,
  mThreshold = 6, mElsa = 7
};

// The two_step_leading_ones operand of one quantized value (as stored, bf16)
// in a block with exponent e: sign(m) * e * (2^l1 + 2^l2) / 64, where
// m = val * 2^-e * 64 is the integer mantissa, 2^l1 its leading power of two
// and 2^l2 that of m - 2^l1 (clamped at zero; zero maps to 2^-126).  The f32
// operations of _two_step_approx, in its order, then the bf16 cast.
__device__ __forceinline__ float two_step_operand(float val, int e) {
  const int ec = min(max(e, -127), 127);
  const float inv = __int_as_float((127 - ec) << 23);  // 0.0 at ec = 127
  const float m = __fmul_rn(__fmul_rn(val, inv), 64.0f);
  auto lead_pow = [](float x) {
    const int l = x == 0.f ? -126 : (__float_as_int(x) >> 23) - 127;
    return __int_as_float((l + 127) << 23);
  };
  const float p1 = lead_pow(fabsf(m));
  float resid = __fsub_rn(m, p1);
  if (resid < 0.f) resid = 0.f;
  const float p2 = lead_pow(resid);
  const float mag = __fdiv_rn(__fadd_rn(p1, p2), 64.0f);
  const float s = m < 0.f ? -1.f : (m == 0.f ? 0.f : 1.f);
  return bf16_rne(__fmul_rn(__fmul_rn(s, float(e)), mag));
}

// The integer n = 64 * operand of an int-grid value (exact: |n| <= 12288)
__device__ __forceinline__ int two_step_n(float val, int e) {
  return __float2int_rn(__fmul_rn(two_step_operand(val, e), 64.0f));
}

// MX-quantize one 32-element block held one element per lane (x, already
// rounded to bf16 where bfloat=16); returns the stored (bf16) value, the
// block's predictor exponent (the shared exponent for the int grids, the
// quantized block's own exponent for the MXFP grids) and its magnitude-bit
// maximum mb.
__device__ __forceinline__ float quant_lane_block(float x, const Fmt& f, int& pexp,
                                                  unsigned& mb) {
  mb = __reduce_max_sync(kFull, mag_bits(x));
  const int e = shared_exp(mb, f);
  const float val = quant_val(x, mb, e, f, false);
  pexp = f.ebits ? int(__reduce_max_sync(kFull, mag_bits(val)) >> 23) - 127 : e;
  return bf16_rne(val);
}

// floor(log2 |v|) from the bits of v (0 at v == 0): the predictors' te
__device__ __forceinline__ int own_exp(float v) {
  return v == 0.f ? 0 : int(mag_bits(v) >> 23) - 127;
}

// The block-grid predictors (kBlockInt: MXINT4, partial_Q, partial_K,
// threshold_ex on the int grids) of one element of the q side (q_side) or
// the k side: an integer code, |code| <= 127, that times the block's scale
// (block_int_scale) is the TPU kernel's operand exactly.  x is the element
// after the bf16 round, mb and e its block's magnitude maximum and shared
// exponent, valid: d < D.  MXINT4: the int4 grid point from the same
// maximum; partial: the int8 grid point on the named side, +-1 (zeros +,
// padded d 0) on the other; threshold_ex: sign * 2^(th - base), th =
// max(te, e - 1) and base = e - 1, each clamped to [-126, 127] (te <= e on
// the int grids, so the code is 0, +-1 or +-2).
__device__ __forceinline__ int block_int_code(int mode, const Fmt& f, const Fmt& f4, bool q_side,
                                              float x, unsigned mb, int e, bool valid) {
  if (mode == mMxint4) return quant_int(x, mb, shared_exp(mb, f4), f4, false);
  if (mode == mThreshold) {
    const float v = bf16_rne(quant_val(x, mb, e, f, false));
    if (v == 0.f) return 0;
    const int th = min(max(max(own_exp(v), e - 1), -126), 127);
    const int base = min(max(e - 1, -126), 127);
    return (v < 0.f ? -1 : 1) * (1 << (th - base));
  }
  const int n = quant_int(x, mb, e, f, false);
  if ((mode == mPartialQ) == q_side) return n;
  return valid ? (n < 0 ? -1 : 1) : 0;
}

__device__ __forceinline__ float block_int_scale(int mode, const Fmt& f4, int shift, bool q_side,
                                                 unsigned mb, int e) {
  if (mode == mMxint4) return pow2_sub(shared_exp(mb, f4) - (f4.mbits - 2));
  if (mode == mThreshold) return pow2f(min(max(e - 1, -126), 127));
  if ((mode == mPartialQ) == q_side) return pow2_sub(e - shift);
  return pow2f(min(max(e, -126), 127));
}

// The predictor operand on the CUDA-core kernel (every predictor but
// ex_pred and ELSA on the MXFP grids, true_ex on every grid), exact in
// bf16: from an element's quantized value val (as stored), its block's
// predictor exponent pe, the element after the bf16 round x with its
// block's magnitude maximum mb (MXINT4 re-quantizes the original side) and
// valid: d < D (exp-sign operands mask the padded d; true_ex maps a zero
// element to +1)
__device__ __forceinline__ float fp_operand(int mode, const Fmt& f4, bool q_side, float val,
                                            int pe, float x, unsigned mb, bool valid) {
  switch (mode) {
    case mTwoStep: return two_step_operand(val, pe);
    case mMxint4: return bf16_rne(quant_val(x, mb, shared_exp(mb, f4), f4, false));
    case mThreshold: {
      if (val == 0.f) return 0.f;
      const float pw = pow2f(min(max(max(own_exp(val), pe - 1), -126), 127));
      return val < 0.f ? -pw : pw;
    }
    case mTrueEx: {
      const float pw = pow2f(min(max(own_exp(val), -126), 127));
      return valid ? (val < 0.f ? -pw : pw) : 0.f;
    }
    default: {  // partial_Q, partial_K
      if ((mode == mPartialQ) == q_side) return val;
      const float pw = pow2f(min(max(pe, -126), 127));
      return valid ? (val < 0.f ? -pw : pw) : 0.f;
    }
  }
}

}  // namespace mx
