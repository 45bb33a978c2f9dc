// Kernel K10: the k-th largest 16-bit key of every row of (G, 256, 256) f32
// cells by a binary search over the key range, each row's key broadcast
// over the row, (G, 256, 256) -> (G, 256, 256) f32.
//
// Replaces the TPU kernel tools/kth_bench.py make(body_fn) (its kern, with
// body_vpu, body_mxu or body_while): the probe of the count loop inside the
// fused top-k attention kernel.  A key is the top 16 bits of the f32's bits
// (an arithmetic shift), so keys lie in [-32768, 32767]; the search keeps
// [lo, hi] with lo = -32769, hi = 32768 at the start, and at each step
// counts the keys above mid = lo + (hi - lo) / 2: lo = mid + 1 where that
// count is at least k, else hi = mid.  17 steps cover the 65,537 values, so
// every strategy ends at lo = hi = the k-th largest key.
//
// What bounds it on the card: bytes.  At the probe's point, G = 256 cells,
// it reads 67 MB and writes 67 MB, 40 us at 3.35 TB/s; the search's 17
// compare-and-count passes over every key (2 operations a key, as the port's
// tool counts them) take 17 us at 33.5 T instructions/s.
//
// Design.  One block of 16 warps per cell (the while strategy's vote spans
// the cell).  A warp owns 16 rows in the m16n8k16 layout of the tensor
// cores: lane (g, t) holds rows g and g + 8 of the warp's 16, keys 16 kk +
// 2 t, +1, +8, +9 of each 16-key step kk, two int16 keys a register (64
// registers), so that one packed compare (__vcmpges2 against the row's
// mid + 1) gives two 0/1 flags, and masked with bf16 1.0 (0x3f80) it is the
// A fragment of a bf16 mma.  Strategies:
//   vpu   (0): the counts on the CUDA cores, popcounts of the compare masks
//              summed over the lane's registers and then the 4 lanes of a
//              row by two xor shuffles, 17 steps
//   mxu   (1): the count as a tensor-core product of the 0/1 matrix with a
//              matrix of ones (16 bf16 m16n8k16 mma a step, f32 sums, exact
//              to 256), 17 steps
//   while (2): vpu's step until every row of the cell has lo = hi, checked
//              by a block-wide vote (__syncthreads_or) before each step
// Every lane of a row group ends with its rows' keys and writes them as f32
// with 16-byte stores, 64 columns a lane.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 256;  // keys a row, rows a cell
constexpr int kWarps = kN / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kLo = -32769, kHi = 32768, kIters = 17;
constexpr unsigned kOnes = 0x3f803f80u;  // two bf16 1.0
constexpr unsigned kFull = 0xffffffffu;

// the A fragment of the 0/1 flags keys >= thr (packed int16 pairs)
__device__ __forceinline__ unsigned flags(unsigned keys, unsigned thr2, unsigned live) {
  return __vcmpges2(keys, thr2) & live;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(kOnes), "r"(kOnes));
}

// the count of keys > mid of each of the lane's two rows
template <int STRAT>
__device__ __forceinline__ void count_rows(const unsigned (&kp)[2][32], const int (&mid)[2],
                                           int (&cnt)[2]) {
  unsigned thr2[2], live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // keys > mid  <=>  keys >= mid + 1; mid + 1 = 32768 holds no key
    const int thr = mid[r] + 1;
    thr2[r] = (unsigned(thr) & 0xffffu) * 0x10001u;
    live[r] = thr <= 32767 ? (STRAT == 1 ? kOnes : kFull) : 0u;
  }
  if constexpr (STRAT == 1) {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < 16; ++kk)
      mma_bf16(c, flags(kp[0][2 * kk], thr2[0], live[0]), flags(kp[1][2 * kk], thr2[1], live[1]),
               flags(kp[0][2 * kk + 1], thr2[0], live[0]),
               flags(kp[1][2 * kk + 1], thr2[1], live[1]));
    cnt[0] = int(c[0]);
    cnt[1] = int(c[2]);
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int bits = 0;
#pragma unroll
      for (int i = 0; i < 32; ++i) bits += __popc(flags(kp[r][i], thr2[r], live[r]));
      int c = bits >> 4;
      c += __shfl_xor_sync(kFull, c, 1);
      c += __shfl_xor_sync(kFull, c, 2);
      cnt[r] = c;
    }
  }
}

template <int STRAT>
__device__ __forceinline__ void step(const unsigned (&kp)[2][32], int k, int (&lo)[2],
                                     int (&hi)[2]) {
  int mid[2], cnt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) mid[r] = lo[r] + ((hi[r] - lo[r]) >> 1);
  count_rows<STRAT>(kp, mid, cnt);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool up = cnt[r] >= k;
    lo[r] = up ? mid[r] + 1 : lo[r];
    hi[r] = up ? hi[r] : mid[r];
  }
}

template <int STRAT>
__global__ void __launch_bounds__(kThreads, 1)
    kth_select_kernel(const float* __restrict__ x, float* __restrict__ out, int k) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t cell = size_t(blockIdx.x) * kN * kN;
  const int rows[2] = {warp * 16 + g, warp * 16 + g + 8};
  unsigned kp[2][32];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float* xr = x + cell + size_t(rows[r]) * kN;
#pragma unroll
    for (int kk = 0; kk < 16; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = __ldg(reinterpret_cast<const float2*>(xr + 16 * kk + 8 * h + 2 * t));
        // the two keys (bits >> 16, arithmetic) as one packed int16 pair
        kp[r][2 * kk + h] = __byte_perm(__float_as_uint(v.x), __float_as_uint(v.y), 0x7632);
      }
  }
  int lo[2] = {kLo, kLo}, hi[2] = {kHi, kHi};
  if constexpr (STRAT == 2) {
    while (__syncthreads_or(lo[0] != hi[0] || lo[1] != hi[1])) step<0>(kp, k, lo, hi);
  } else {
#pragma unroll 1
    for (int it = 0; it < kIters; ++it) step<STRAT>(kp, k, lo, hi);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float v = float(lo[r]);
    const float4 w = make_float4(v, v, v, v);
    float* orow = out + cell + size_t(rows[r]) * kN;
#pragma unroll
    for (int j = 0; j < 16; ++j) *reinterpret_cast<float4*>(orow + 16 * j + 4 * t) = w;
  }
}

}  // namespace

// The k-th largest key of each row of G cells of x (G, 256, 256) f32 into
// out (the same shape), by strategy 0 (vpu), 1 (mxu) or 2 (while), on
// `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int kth_select(const void* x, void* out, int G, int k, int strategy, void* stream) {
  if (x == nullptr || out == nullptr || G <= 0 || k < 1 || k > kN) return int(cudaErrorInvalidValue);
  const float* xi = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (strategy) {
    case 0: kth_select_kernel<0><<<G, kThreads, 0, st>>>(xi, o, k); break;
    case 1: kth_select_kernel<1><<<G, kThreads, 0, st>>>(xi, o, k); break;
    case 2: kth_select_kernel<2><<<G, kThreads, 0, st>>>(xi, o, k); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
