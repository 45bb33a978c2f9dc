// Kernel K5: LayerNorm (no affine), adaLN modulate and MX quantize in one
// pass: quantize_mx(LN(x) * (1 + scale) + shift) along C, (B, N, C) ->
// (B, N, C) values on the MX grid (bf16 holds every grid point it serves).
//
// Replaces the TPU kernel mx_quantization_tpu/ops/kernels/quantize.py
// ln_modulate_quantize_pallas (body _ln_mod_quant_kernel, with
// _quantize_block_values_axis0 and _bf16_round_f32).
//
// What bounds it on the card: bytes.  At the DiT-XL/2 sites (64, 256,
// 1152) bf16 in and out it moves 75.5 MB (22.5 us at 3.35 TB/s) and does
// about forty f32 and integer operations per element, far below the card's
// operations-per-byte balance.  The design reads each row once and writes
// it once, with nothing in between in device memory: one warp per token
// row, lane l holding channels c = l + 32 j (j < C/32) in registers.  Each
// j is a coalesced 32-channel segment of the row, the LN sums are each
// lane's channels added in j order and then the lanes by an xor butterfly
// (the plain version's lane_sum), and each 32-channel MX block is one j, so
// its maximum is one warp reduction.  Eight rows (warps) per block.  The
// modulate pass, which loads scale and shift, runs over every j before the
// first block reduction: interleaved, each j's loads would wait behind the
// previous j's warp reduction, one exposed L2 latency per j.
//
// Numerics follow the TPU kernel's operations, each rounded on its own:
// mean = sum * (1/C), var = sum((x - mean)^2) * (1/C), 1/sqrt(var + eps)
// correctly rounded (as the plain version's 1 / torch.sqrt), then
// xn * (1 + scale) + shift as a multiply and an add (JAX rounds both), the
// optional half-away bf16 round, and K1's quantizer (the int grids rescale
// as q * scale * (1/half)).  Every multiply and add, here and in
// mx_common.cuh, is an explicit __fmul_rn/__fadd_rn/__fsub_rn, which the
// compiler never contracts into a fused multiply-add.

#include "mx_common.cuh"

// The widest row the kernel holds in registers comes from the wrapper
// (MAX_CHANNELS in ops/kernels/ln_modulate_quantize.py) through nvcc -D.
#ifndef K5_MAX_CHANNELS
#error "build with -DK5_MAX_CHANNELS=<n> (ops/kernels/build.py passes it)"
#endif

namespace {

using namespace mx;

constexpr int kWarps = 8;                          // rows per block
constexpr int kMaxJ = K5_MAX_CHANNELS / kBlock;    // channels per lane

struct Params {
  const void* x;
  const float* shift;
  const float* scale;
  void* out;
  long long rows;
  int N, C, nj, in_bf16, out_bf16, bfloat16;
  float inv_c, eps;
  Fmt fmt;
};

// One element of an MX block in K1's order (the TPU quantize kernel's
// _quantize_block_values_axis0): the int grids rescale as q * scale *
// (1/half); the MXFP grids as quant_val does.
__device__ __forceinline__ float quant_k1(float x, unsigned mb, int e, const Fmt& f) {
  if (f.ebits) return quant_val(x, mb, e, f, false);
  if (f.flush && mb < 0x00800000u) x = 0.f;
  const float s = __fmul_rn(__fmul_rn(x, pow2f(-e)), f.half);
  const float q = fminf(fmaxf(round_half_away(s), -f.qmax), f.qmax);
  return __fmul_rn(__fmul_rn(q, pow2f(e)), f.inv_half);
}

__device__ __forceinline__ float lane_butterfly_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
  return s;
}

__global__ void __launch_bounds__(kWarps * 32)
ln_modulate_quantize_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= p.rows) return;  // the whole warp leaves together
  const size_t base = size_t(row) * p.C + lane;

  float x[kMaxJ];
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    if (j < p.nj) {
      const size_t i = base + size_t(kBlock) * j;
      x[j] = p.in_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.x)[i])
                       : static_cast<const float*>(p.x)[i];
    }
  }

  // mean and variance: per lane in j order, then the lanes
  float s = x[0];
#pragma unroll
  for (int j = 1; j < kMaxJ; ++j)
    if (j < p.nj) s = __fadd_rn(s, x[j]);
  const float mu = __fmul_rn(lane_butterfly_sum(s), p.inv_c);
  float v = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    if (j < p.nj) {
      x[j] = __fsub_rn(x[j], mu);
      const float sq = __fmul_rn(x[j], x[j]);
      v = j == 0 ? sq : __fadd_rn(v, sq);
    }
  }
  const float var = __fmul_rn(lane_butterfly_sum(v), p.inv_c);
  const float rs = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, p.eps)));

  // modulate (and round) every channel first: no warp reduction between
  // the scale and shift loads
  const size_t brow = size_t(row / p.N) * p.C + lane;
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    if (j < p.nj) {
      const size_t c = brow + size_t(kBlock) * j;
      x[j] = __fadd_rn(__fmul_rn(__fmul_rn(x[j], rs), __fadd_rn(1.0f, p.scale[c])),
                       p.shift[c]);
      if (p.bfloat16) x[j] = bf16_round_away(x[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    if (j < p.nj) {
      const float y = x[j];
      const unsigned mb = __reduce_max_sync(kFull, __float_as_uint(y) & 0x7fffffffu);
      const float q = quant_k1(y, mb, shared_exp(mb, p.fmt), p.fmt);
      const size_t i = base + size_t(kBlock) * j;
      if (p.out_bf16) static_cast<__nv_bfloat16*>(p.out)[i] = __float2bfloat16_rn(q);
      else static_cast<float*>(p.out)[i] = q;
    }
  }
}

}  // namespace

// Launch K5 on `stream` over `rows` = B * N rows of C channels (shift and
// scale are (B, C) f32); returns the cudaError_t of the launch (0 = ok).
extern "C" int ln_modulate_quantize(const void* x, const float* shift, const float* scale,
                                    void* out, long long rows, int N, int C, int in_bf16,
                                    int out_bf16, float inv_c, float eps, int bfloat16,
                                    int flush, int ebits, int mbits, int emax,
                                    float max_norm, int scale_bits, void* stream) {
  if (rows < 1 || N < 1 || C < kBlock || C % kBlock || C > K5_MAX_CHANNELS || rows % N)
    return int(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.shift = shift;
  p.scale = scale;
  p.out = out;
  p.rows = rows;
  p.N = N; p.C = C; p.nj = C / kBlock;
  p.in_bf16 = in_bf16; p.out_bf16 = out_bf16; p.bfloat16 = bfloat16;
  p.inv_c = inv_c; p.eps = eps;
  p.fmt = make_fmt(ebits, mbits, emax, max_norm, scale_bits, flush);
  const long long blocks = (rows + kWarps - 1) / kWarps;
  ln_modulate_quantize_kernel<<<unsigned(blocks), kWarps * 32, 0,
                                static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}
