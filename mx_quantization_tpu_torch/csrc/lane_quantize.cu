// Kernel K11: MX block fake-quantization along the last axis with each
// block maximum taken across the lanes of a warp, (..., K) -> (..., K)
// values on the MX grid.
//
// Replaces the TPU kernel tools/lanequant_bench.py mx_quantize_lanes (body
// _lane_quant_kernel, its block maximum _block_max_bits_lanes): the TPU
// probe that keeps the tile in its natural layout and takes the per-block
// max of |bits| as an XOR butterfly of lane rolls, instead of transposing
// the blocks onto sublanes as mx_quantize_pallas (K1) does.  The max is
// exact, so the function is K1's, bit for bit.
//
// What bounds it on the card: bytes.  At the probe's widest site, (16384,
// 4608) bf16 in and out, it moves 302 MB, 90 us at 3.35 TB/s; the
// quantizer's 15 f32 and integer operations an element on the int grids
// (27 on the MXFP grids, counted as the port's tool counts them) take 34 us
// (61 us) at 33.5 T instructions/s.
//
// Design.  The tensor is a run of whole MX blocks (K % block == 0), so the
// rows do not matter: a warp takes strips of 32 E elements, lane l holding
// the E neighbouring elements l E .. l E + E - 1 (E = 1 up to block 32, 2 at
// block 64, 4 at block 128).  A block is then L = block / E neighbouring
// lanes, and its maximum of the magnitude bits is a __shfl_xor_sync
// butterfly over log2(L) steps, after the lane's own maximum over its E
// elements: log2(block) steps in all, the lane exchange the TPU probe
// measures.  Each warp takes kStrips strips per round for memory-level
// parallelism.  nomax skips the maximum (each element its own block
// maximum): the TPU probe's NOMAX diagnostic, wrong on purpose.
//
// Numerics are the TPU probe's, each operation rounded on its own: the
// optional half-away bf16 round (f32 input only: a bf16 value is on that
// grid), flush, the shared exponent clipped to the scale bits, powers of two
// built from bits, and the int grids rescaled as q * scale * (1/half).

#include "mx_common.cuh"

using namespace mx;

namespace {

constexpr int kThreads = 256;
constexpr int kStrips = 4;

// One element of an MX block whose magnitude-bit maximum is mb, in the TPU
// probe's order (the int grids: q * scale * (1/half)).
__device__ __forceinline__ float quant_lane(float x, unsigned mb, const Fmt& f) {
  if (f.flush && mb < 0x00800000u) x = 0.f;
  const int e = min(max(int(mb >> 23) - 127 - f.emax, -f.scale_emax), f.scale_emax);
  const float inv_scale = pow2f(-e), scale = pow2f(e);
  if (f.ebits == 0) {
    const float s = __fmul_rn(__fmul_rn(x, inv_scale), f.half);
    const float q = fminf(fmaxf(round_half_away(s), -f.qmax), f.qmax);
    return __fmul_rn(__fmul_rn(q, scale), f.inv_half);
  }
  const float s = __fmul_rn(x, inv_scale);
  const int pe = max(int((__float_as_uint(s) & 0x7fffffffu) >> 23) - 127, f.min_exp);
  const int sp = min(max(pe - (f.mbits - 2), -126), 127);
  const float q = round_half_away(__fmul_rn(s, pow2f(-sp)));
  const float o = fminf(fmaxf(__fmul_rn(q, pow2f(sp)), -f.max_norm), f.max_norm);
  return __fmul_rn(o, scale);
}

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __uint_as_float(unsigned(__ldg(reinterpret_cast<const unsigned short*>(p))) << 16);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename Tin, typename Tout, int BS>
__global__ void __launch_bounds__(kThreads)
    lane_quantize_kernel(const Tin* __restrict__ x, Tout* __restrict__ out, long long n, Fmt f,
                         int nomax, int bf16_round) {
  constexpr int E = BS > 32 ? BS / 32 : 1;  // elements a lane holds
  constexpr int L = BS / E;                 // lanes a block spans
  constexpr int kStrip = 32 * E;
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long warps = (static_cast<long long>(gridDim.x) * kThreads) >> 5;
  for (long long s0 = warp * kStrips * kStrip; s0 < n; s0 += warps * kStrips * kStrip) {
    float v[kStrips][E];
#pragma unroll
    for (int u = 0; u < kStrips; ++u) {
      // n is a multiple of the block, so a lane's E elements are all in or
      // all out; a strip past the end reads zeros, which no block shares
      const long long i0 = s0 + u * kStrip + lane * E;
#pragma unroll
      for (int j = 0; j < E; ++j) v[u][j] = i0 < n ? load_f(x + i0 + j) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kStrips; ++u) {
      unsigned mb[E];
      unsigned m = 0;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        if (sizeof(Tin) == 4 && bf16_round) v[u][j] = bf16_round_away(v[u][j]);
        mb[j] = mag_bits(v[u][j]);
        m = max(m, mb[j]);
      }
      if (!nomax) {
#pragma unroll
        for (int s = 1; s < L; s <<= 1) m = max(m, __shfl_xor_sync(kFull, m, s));
#pragma unroll
        for (int j = 0; j < E; ++j) mb[j] = m;
      }
      const long long i0 = s0 + u * kStrip + lane * E;
      if (i0 < n)
#pragma unroll
        for (int j = 0; j < E; ++j) store_f(out + i0 + j, quant_lane(v[u][j], mb[j], f));
    }
  }
}

template <typename Tin, typename Tout>
cudaError_t launch_typed(const void* x, void* out, long long n, int block, const Fmt& f, int nomax,
                         int bf16_round, cudaStream_t st) {
  const long long per_cta = (long long)(kThreads / 32) * kStrips * 32;
  long long ctas = (n + per_cta - 1) / per_cta;
  if (ctas > 132LL * 16) ctas = 132LL * 16;  // a grid-stride loop past that
  const Tin* xi = static_cast<const Tin*>(x);
  Tout* o = static_cast<Tout*>(out);
  switch (block) {
    case 8: lane_quantize_kernel<Tin, Tout, 8><<<unsigned(ctas), kThreads, 0, st>>>(xi, o, n, f, nomax, bf16_round); break;
    case 16: lane_quantize_kernel<Tin, Tout, 16><<<unsigned(ctas), kThreads, 0, st>>>(xi, o, n, f, nomax, bf16_round); break;
    case 32: lane_quantize_kernel<Tin, Tout, 32><<<unsigned(ctas), kThreads, 0, st>>>(xi, o, n, f, nomax, bf16_round); break;
    case 64: lane_quantize_kernel<Tin, Tout, 64><<<unsigned(ctas), kThreads, 0, st>>>(xi, o, n, f, nomax, bf16_round); break;
    case 128: lane_quantize_kernel<Tin, Tout, 128><<<unsigned(ctas), kThreads, 0, st>>>(xi, o, n, f, nomax, bf16_round); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Quantize n elements of x (float32 if in_f32, else bfloat16; n a multiple
// of block) into out (float32 if out_f32, else bfloat16) on `stream`;
// returns the cudaError_t of the launch (0 = ok).
extern "C" int lane_quantize(const void* x, void* out, long long n, int in_f32, int out_f32,
                             int block, int ebits, int mbits, int emax, float max_norm,
                             int scale_bits, int flush, int bf16_round, int nomax, void* stream) {
  if (x == nullptr || out == nullptr || n <= 0 || block <= 0 || n % block || scale_bits < 1 ||
      scale_bits > 16)
    return int(cudaErrorInvalidValue);
  const Fmt f = make_fmt(ebits, mbits, emax, max_norm, scale_bits, flush);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_f32)
    return out_f32 ? int(launch_typed<float, float>(x, out, n, block, f, nomax, bf16_round, st))
                   : int(launch_typed<float, __nv_bfloat16>(x, out, n, block, f, nomax, bf16_round, st));
  return out_f32
             ? int(launch_typed<__nv_bfloat16, float>(x, out, n, block, f, nomax, bf16_round, st))
             : int(launch_typed<__nv_bfloat16, __nv_bfloat16>(x, out, n, block, f, nomax, bf16_round, st));
}
