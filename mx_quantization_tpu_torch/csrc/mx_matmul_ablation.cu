// Kernel K9: the fused MX matmul C = Q(A) Q(B), A (M, K) and B (K, N) f32,
// both quantized along K in MX blocks inside the product, C (M, N) f32.
//
// Replaces the TPU kernel tools/mx_matmul_ablation.py mx_matmul_pallas (body
// _mm_kernel, quantizing each tile with _quantize_block_values_axis0): the
// retired ablation that fused the activation quantize into the matmul.
//
// The function, as the TPU kernel computes it.  Q quantizes each block of
// `block` values along K on an integer grid whatever the element format:
// _mm_kernel passes only the format's mbits, so ebits = emax = 0 (fp8_e4m3
// lands on a 5-bit integer grid, not the MXFP8 grid).  With s = mbits - 2,
// e the block's shared exponent (the top of the magnitude bits less 127,
// clipped to the scale bits), q = clip(round_half_away(x 2^-e 2^s), +-(2^(
// mbits-1) - 1)) and the operand is bf16(q 2^e 2^-s) (round to nearest
// even: at mbits 12, float16, q up to 2047 rounds to 8 significant bits).
// A block with e = -127 (its maximum f32-subnormal) has scale 0 and values
// 0; one with e = 127 has 2^-e = 0 and values 0.  Every live operand is an
// integer code times 2^(e - s): q itself for mbits <= 9, q rounded to bf16
// for float16, at most 2048 in magnitude.  The product: each pair of
// blocks' codes summed exactly as integers (128 x 2048^2 < 2^31), that sum
// converted to f32 once and scaled by 2^(ea - sa) 2^(eb - sb) (one
// rounding: f32 of the exact value, a double where the scaled value could
// leave f32's normal range), and the blocks added in K order in f32 from
// +0.  The TPU kernel sums a 512-wide K tile in the MXU's order, so beyond
// one block the two differ by the order of f32 sums (K 2^-24 sum|Q(A)Q(B)|
// at most); at one block they agree bit for bit.
//
// What bounds it on the card: bytes, at each of DiT-XL/2's linears.  At
// qkv, M = 16384 rows, K = 1152, N = 3456, A, B and C move 318 MB of f32,
// 95 us at 3.35 TB/s, against 66 us for the 65 G multiply-adds at the int8
// tensor cores' 1979 T op/s (two a multiply-add).  The work beyond the
// function's is the quantize, redone for every tile that reads an operand,
// as on the TPU: A N/128 times, B M/128 times, some 20 operations an
// element each time, and one scaling of every output per MX block.
//
// Design (a first kernel: right, and simple before fast).  A block of 8
// warps owns a 128 x 128 tile of C and walks K in chunks of 64 values (128
// at block 128): it stages the chunk of A (128 x 64) and B (64 x 128) as f32
// in shared memory with 16-byte loads, quantizes every (row, block) of A
// and (column, block) of B there into codes, the powers of two 2^(e - s)
// and the exponents, then per MX block:
//   mbits <= 8 on both sides: int8 codes, the block's integer sums on the
//     tensor cores (mma.sync m16n8k32 s8, int32 sums; blocks 8 and 16 zero-
//     padded to one k-step, 64 and 128 two and four k-steps); a warp owns
//     64 rows x 32 columns and scales each 16 x 8 tile's sums as it ends
//   otherwise (bfloat16, float16 on either side): int16 codes, the sums as
//     int32 multiply-adds on the CUDA cores; a thread owns 8 x 8 outputs
// and each output adds f32(sum) 2^(Ea + Eb) to its f32 accumulator: as
// f32(sum) 2^Ea 2^Eb (two exact multiplies) where every exponent of the
// chunk lies in [-60, 48], one test a chunk, else through block_term.

#include "mx_common.cuh"

using namespace mx;

namespace {

constexpr int kBM = 128, kBN = 128, kThreads = 256;
constexpr int kFastLo = -60, kFastHi = 48;

struct Params {
  const float* a;
  const float* b;
  float* c;
  int M, N, K, nb;
  int sa, sb;                // mbits - 2 of A and B
  float ha, hb;              // 2^sa, 2^sb
  float qa, qb;              // the largest code before the bf16 cast
  int scale_emax;
};

// The integer code of x in a live block of shared exponent e (-126 <= e <=
// 126): bf16(q 2^e 2^-s) / 2^(e - s), the TPU kernel's arithmetic.  For
// mbits <= 9 (q of at most 8 significant bits, which bf16 holds) that is q
// itself, and `wide` (mbits 12) takes the round trip through bf16.
__device__ __forceinline__ int code_of(float x, int e, float half, float qmax, bool wide) {
  const float sv = __fmul_rn(__fmul_rn(x, pow2f(-e)), half);
  const float q = fminf(fmaxf(round_half_away(sv), -qmax), qmax);
  if (!wide) return __float2int_rn(q);
  const float v = bf16_rne(__fmul_rn(__fmul_rn(q, pow2f(e)), 1.f / half));
  return __float2int_rn(__fmul_rn(__fmul_rn(v, pow2f(-e)), half));
}

// f32 of s 2^E, rounded once
__device__ __forceinline__ float block_term(int s, int E) {
  if (s == 0) return 0.f;
  if (E >= -126 && E <= 96) return __fmul_rn(__int2float_rn(s), pow2f(E));
  return __double2float_rn(scalbn(static_cast<double>(s), E));
}


template <int BS, bool MMA>
struct Smem {
  static constexpr int kKC = BS < 64 ? 64 : BS;        // K values a chunk
  static constexpr int kCB = kKC / BS;                 // blocks a chunk
  static constexpr int kRawA = kKC + 1;                // rawA row stride (floats)
  static constexpr int kPB = BS < 32 ? 32 : BS;        // a block's k slots (int8)
  static constexpr int kStr8 = kCB * kPB + 16;         // int8 row stride (bytes)
  static constexpr int kKS = kPB / 32;                 // mma k-steps a block
  static constexpr size_t kRawABytes = size_t(kBM) * kRawA * 4;
  static constexpr size_t kRawBBytes = size_t(kKC) * kBN * 4;
  static constexpr size_t kCodeBytes =
      MMA ? size_t(kBM + kBN) * kStr8 : size_t(kKC) * (kBM + kBN) * 2;
  static constexpr size_t kExpBytes = size_t(kCB) * (kBM + kBN) * 8;
  static constexpr size_t kBytes = kRawABytes + kRawBBytes + kCodeBytes + kExpBytes;
};

template <int BS, bool MMA>
__global__ void __launch_bounds__(kThreads, 1) mx_matmul_kernel(Params p) {
  using S = Smem<BS, MMA>;
  constexpr int kKC = S::kKC;
  extern __shared__ __align__(16) unsigned char smem[];
  float* rawA = reinterpret_cast<float*>(smem);
  float* rawB = reinterpret_cast<float*>(smem + S::kRawABytes);
  unsigned char* codes = smem + S::kRawABytes + S::kRawBBytes;
  int* expA = reinterpret_cast<int*>(codes + S::kCodeBytes);  // [block][row]
  int* expB = expA + S::kCB * kBM;                            // [block][col]
  float* powA = reinterpret_cast<float*>(expB + S::kCB * kBN);  // 2^Ea
  float* powB = powA + S::kCB * kBM;                            // 2^Eb
  unsigned char* c8A = codes;                                   // [row][k slot]
  unsigned char* c8B = c8A + kBM * S::kStr8;                    // [col][k slot]
  short* c16A = reinterpret_cast<short*>(codes);                // [k][row]
  short* c16B = c16A + kKC * kBM;                               // [k][col]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int wm = warp & 1, wn = warp >> 1;  // MMA: 64 rows x 32 columns a warp
  const int ty = tid >> 4, tx = tid & 15;   // CUDA cores: rows ty + 16 i, cols tx + 16 j
  // MMA: acc[16 mt + 4 nt + i], the mma's c[i] of tile (mt, nt); CUDA
  // cores: acc[8 j + i], row ty + 16 i and column tx + 16 j
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const bool vecB = (p.N & 3) == 0;

  for (int b0 = 0; b0 < p.nb; b0 += S::kCB) {
    const int nbk = min(S::kCB, p.nb - b0), kw = nbk * BS;
    const long long k0 = static_cast<long long>(b0) * BS;
    // stage the chunk: rows (columns) past M (N) and values past the last
    // block as zeros
    for (int i = tid; i < kBM * (kKC / 4); i += kThreads) {
      const int r = i / (kKC / 4), kk = 4 * (i % (kKC / 4));
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < p.M && kk < kw)
        v = __ldg(reinterpret_cast<const float4*>(p.a + (long long)(m0 + r) * p.K + k0 + kk));
      float* d = rawA + r * S::kRawA + kk;
      d[0] = v.x;
      d[1] = v.y;
      d[2] = v.z;
      d[3] = v.w;
    }
    if (vecB) {
      for (int i = tid; i < kKC * (kBN / 4); i += kThreads) {
        const int kk = i / (kBN / 4), c = 4 * (i % (kBN / 4));
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kk < kw && n0 + c < p.N)
          v = __ldg(reinterpret_cast<const float4*>(p.b + (k0 + kk) * p.N + n0 + c));
        *reinterpret_cast<float4*>(rawB + kk * kBN + c) = v;
      }
    } else {
      for (int i = tid; i < kKC * kBN; i += kThreads) {
        const int kk = i / kBN, c = i % kBN;
        rawB[kk * kBN + c] = kk < kw && n0 + c < p.N ? __ldg(p.b + (k0 + kk) * p.N + n0 + c) : 0.f;
      }
    }
    __syncthreads();
    // quantize: (row, block) pairs of A, then (column, block) pairs of B
    bool fast = true;
    for (int i = tid; i < (kBM + kBN) * nbk; i += kThreads) {
      const bool isA = i < kBM * nbk;
      const int j = isA ? i : i - kBM * nbk;
      const int rc = j % kBM, blk = j / kBM;
      const float* src = isA ? rawA + rc * S::kRawA + blk * BS : rawB + blk * BS * kBN + rc;
      const int step = isA ? 1 : kBN;
      unsigned mb = 0;
#pragma unroll 8
      for (int k = 0; k < BS; ++k) mb = max(mb, mag_bits(src[k * step]));
      const int e = min(max(int(mb >> 23) - 127, -p.scale_emax), p.scale_emax);
      const bool live = e >= -126 && e <= 126;
      const float half = isA ? p.ha : p.hb, qmax = isA ? p.qa : p.qb;
      const int E = live ? e - (isA ? p.sa : p.sb) : 0;
      fast = fast && E >= kFastLo && E <= kFastHi;
      (isA ? expA : expB)[blk * kBM + rc] = E;
      (isA ? powA : powB)[blk * kBM + rc] = pow2f(E);
      if constexpr (MMA) {
        unsigned* dst = reinterpret_cast<unsigned*>((isA ? c8A : c8B) + rc * S::kStr8 + blk * S::kPB);
#pragma unroll 4
        for (int w = 0; w < S::kPB / 4; ++w) {
          unsigned word = 0;
          if (live && 4 * w < BS)
#pragma unroll
            for (int b = 0; b < 4; ++b)
              word |= unsigned(code_of(src[(4 * w + b) * step], e, half, qmax, false) & 0xff)
                      << (8 * b);
          dst[w] = word;
        }
      } else {
        short* dst = (isA ? c16A : c16B) + blk * BS * kBM + rc;
        const bool wide = (isA ? p.sa : p.sb) > 7;
#pragma unroll 8
        for (int k = 0; k < BS; ++k)
          dst[k * kBM] = live ? static_cast<short>(code_of(src[k * step], e, half, qmax, wide)) : 0;
      }
    }
    fast = __syncthreads_and(fast);
    for (int blk = 0; blk < nbk; ++blk) {
      if constexpr (MMA) {
        unsigned bw[4][S::kKS][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const unsigned char* br = c8B + (wn * 32 + 8 * nt + g) * S::kStr8 + blk * S::kPB + 4 * t;
#pragma unroll
          for (int ks = 0; ks < S::kKS; ++ks) {
            bw[nt][ks][0] = *reinterpret_cast<const unsigned*>(br + 32 * ks);
            bw[nt][ks][1] = *reinterpret_cast<const unsigned*>(br + 32 * ks + 16);
          }
        }
        float pb[4][2];
        int eb[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = wn * 32 + 8 * nt + 2 * t + h;
            pb[nt][h] = powB[blk * kBN + c];
            eb[nt][h] = expB[blk * kBN + c];
          }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const int r0 = wm * 64 + 16 * mt + g;
          const unsigned char* ar = c8A + r0 * S::kStr8 + blk * S::kPB + 4 * t;
          unsigned aw[S::kKS][4];
#pragma unroll
          for (int ks = 0; ks < S::kKS; ++ks) {
            aw[ks][0] = *reinterpret_cast<const unsigned*>(ar + 32 * ks);
            aw[ks][1] = *reinterpret_cast<const unsigned*>(ar + 8 * S::kStr8 + 32 * ks);
            aw[ks][2] = *reinterpret_cast<const unsigned*>(ar + 32 * ks + 16);
            aw[ks][3] = *reinterpret_cast<const unsigned*>(ar + 8 * S::kStr8 + 32 * ks + 16);
          }
          const float pa[2] = {powA[blk * kBM + r0], powA[blk * kBM + r0 + 8]};
          const int ea[2] = {expA[blk * kBM + r0], expA[blk * kBM + r0 + 8]};
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            int s[4];
            mma_s8(s, aw[0], bw[nt][0][0], bw[nt][0][1]);
#pragma unroll
            for (int ks = 1; ks < S::kKS; ++ks) mma_acc_ss(s, aw[ks], bw[nt][ks][0], bw[nt][ks][1]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float term =
                  fast ? __fmul_rn(__fmul_rn(__int2float_rn(s[i]), pa[i >> 1]), pb[nt][i & 1])
                       : block_term(s[i], ea[i >> 1] + eb[nt][i & 1]);
              acc[16 * mt + 4 * nt + i] = __fadd_rn(acc[16 * mt + 4 * nt + i], term);
            }
          }
        }
      } else {
        int s[8][8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 8; ++i) s[j][i] = 0;
        const short* ak = c16A + blk * BS * kBM;
        const short* bk = c16B + blk * BS * kBN;
#pragma unroll 2
        for (int k = 0; k < BS; ++k) {
          int av[8], bv[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            av[i] = ak[k * kBM + ty + 16 * i];
            bv[i] = bk[k * kBN + tx + 16 * i];
          }
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int i = 0; i < 8; ++i) s[j][i] += av[i] * bv[j];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = ty + 16 * i, c = tx + 16 * j;
            const float term =
                fast ? __fmul_rn(__fmul_rn(__int2float_rn(s[j][i]), powA[blk * kBM + r]),
                                 powB[blk * kBN + c])
                     : block_term(s[j][i], expA[blk * kBM + r] + expB[blk * kBN + c]);
            acc[8 * j + i] = __fadd_rn(acc[8 * j + i], term);
          }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int x = 0; x < 64; ++x) {
    int r, c;
    if constexpr (MMA) {
      r = wm * 64 + 16 * (x >> 4) + g + (x & 2 ? 8 : 0);
      c = wn * 32 + 8 * ((x >> 2) & 3) + 2 * t + (x & 1);
    } else {
      r = ty + 16 * (x & 7);
      c = tx + 16 * (x >> 3);
    }
    if (m0 + r < p.M && n0 + c < p.N) p.c[(long long)(m0 + r) * p.N + n0 + c] = acc[x];
  }
}

template <int BS, bool MMA>
cudaError_t launch(const Params& p, cudaStream_t st) {
  const size_t smem = Smem<BS, MMA>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(mx_matmul_kernel<BS, MMA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + kBM - 1) / kBM);
  mx_matmul_kernel<BS, MMA><<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <bool MMA>
cudaError_t launch_block(const Params& p, int block, cudaStream_t st) {
  switch (block) {
    case 8: return launch<8, MMA>(p, st);
    case 16: return launch<16, MMA>(p, st);
    case 32: return launch<32, MMA>(p, st);
    case 64: return launch<64, MMA>(p, st);
    case 128: return launch<128, MMA>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C (M, N) f32 = Q(A) Q(B) for A (M, K) and B (K, N) f32 contiguous, both
// quantized along K in MX blocks of `block` on the integer grids of mbits_a
// and mbits_b, on `stream`; returns the cudaError_t of the launches (0 =
// ok).
extern "C" int mx_matmul(const void* a, const void* b, void* c, int M, int N, int K, int block,
                         int mbits_a, int mbits_b, int scale_bits, void* stream) {
  if (a == nullptr || b == nullptr || c == nullptr || M <= 0 || N <= 0 || K <= 0 || block <= 0 ||
      K % block || mbits_a < 2 || mbits_a > 12 || mbits_b < 2 || mbits_b > 12 || scale_bits < 1 ||
      scale_bits > 16)
    return int(cudaErrorInvalidValue);
  Params p;
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.c = static_cast<float*>(c);
  p.M = M;
  p.N = N;
  p.K = K;
  p.nb = K / block;
  p.sa = mbits_a - 2;
  p.sb = mbits_b - 2;
  p.ha = float(1 << p.sa);
  p.hb = float(1 << p.sb);
  p.qa = float((1 << (mbits_a - 1)) - 1);
  p.qb = float((1 << (mbits_b - 1)) - 1);
  p.scale_emax = (1 << (scale_bits - 1)) - 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool mma = mbits_a <= 8 && mbits_b <= 8;
  return int(mma ? launch_block<true>(p, block, st) : launch_block<false>(p, block, st));
}
