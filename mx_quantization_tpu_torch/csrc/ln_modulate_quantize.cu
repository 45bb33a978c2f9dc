// Kernel K5: LayerNorm (no affine), adaLN modulate and MX quantize in one
// pass: quantize_mx(LN(x) * (1 + scale) + shift) along C, (B, N, C) ->
// (B, N, C) values on the MX grid (bf16 holds every grid point it serves).
//
// Replaces the TPU kernel mx_quantization_tpu/ops/kernels/quantize.py
// ln_modulate_quantize_pallas (body _ln_mod_quant_kernel, with
// _quantize_block_values_axis0 and _bf16_round_f32).
//
// What bounds it on the card: bytes and instructions about equally.  At the
// DiT-XL/2 site, (64, 256, 1152) bf16 in and out, it moves 75.5 MB, 22.5 us
// at 3.35 TB/s.  The function as the plain version spells it takes 26
// f32 and integer operations per element there (chip_smoke.py counts
// them), 14.7 us at 33.5 T instructions/s.  The card's balance is 10
// operations per byte, 40 per element at 4 bytes an element, so the two
// terms are of one size: a design that spends twice the operations the
// function needs is held by its instructions, not by its bytes, and this
// one is (tools/k5_ladder.py counts its SASS; PERF.md has the ladder).
//
// Design.  One warp per token row.  Lane l holds the 8-channel chunks
// k = l + 32 j of the row (round j), read and written with 16-byte accesses
// (two for f32), so a 32-channel MX block is 4 neighbouring lanes of one
// round: its maximum takes two xor shuffles, and the shared exponent and
// its powers of two are computed once per lane per block.  Rows of up to
// 5 rounds (1280 channels) stay in registers.  A block of 8 warps owns a
// tile of 32 rows of one batch element and stages 1 + scale and shift of
// that element once, as f32, in shared memory (8 C bytes), where every row
// reads them (2 float4 each per chunk).  Wider rows, up to K5_MAX_CHANNELS,
// keep each lane's raw chunks in shared memory between the three passes
// (sum, centred squares, output) and read scale and shift from global
// memory.  shift and scale come as f32 or bf16 with a row stride, so the
// adaLN output's chunks need no copy.
//
// Summation order (the plain version's fastquant.k5_row_sum): each chunk's
// 8 values as the tree ((c0 + c1) + (c2 + c3)) + ((c4 + c5) + (c6 + c7)),
// a lane's chunk sums in round order (a chunk past the row's end counts as
// zeros), then the 32 lanes by an xor butterfly.  The centred squares of a
// chunk past the row's end are zeros too.
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

// The widest row comes from the wrapper (MAX_CHANNELS in
// ops/kernels/ln_modulate_quantize.py) through nvcc -D.
#ifndef K5_MAX_CHANNELS
#error "build with -DK5_MAX_CHANNELS=<n> (ops/kernels/build.py passes it)"
#endif

namespace {

using namespace mx;

constexpr int kWarps = 8;                   // warps per block
constexpr int kVec = 8;                     // channels per lane per round
constexpr int kRoundChannels = 32 * kVec;   // channels per round
constexpr int kRegRounds = 5;               // rows of up to 1280 channels in registers
constexpr int kTileRows = 32;               // rows per block in the register kernel
constexpr int kSmemMax = 232448;            // shared memory a block may opt into
static_assert(K5_MAX_CHANNELS % kBlock == 0, "K5_MAX_CHANNELS: a multiple of 32");
static_assert(size_t(K5_MAX_CHANNELS + kRoundChannels - 1) / kRoundChannels * 32 * 32 <=
                  kSmemMax,
              "an f32 row of K5_MAX_CHANNELS must fit one warp's shared memory");

struct Params {
  const void* x;
  const void* shift;
  const void* scale;
  void* out;
  long long rows;
  int N, C, nr, nchunks, tiles, shift_stride, scale_stride;
  int ss_bf16, out_bf16, bfloat16;  // bfloat16 picks the kBf16Round kernels
  float inv_c, eps;
  Fmt fmt;
};

// 8 channels in their input type: one 16-byte word of bf16, two of f32
template <typename T>
struct Raw {
  static constexpr int kWords = int(sizeof(T)) / 2;
  uint4 w[kWords];
};

template <typename T>
__device__ __forceinline__ Raw<T> load_raw(const T* src) {
  Raw<T> r;
#pragma unroll
  for (int i = 0; i < Raw<T>::kWords; ++i) r.w[i] = __ldg(reinterpret_cast<const uint4*>(src) + i);
  return r;
}

template <typename T>
__device__ __forceinline__ Raw<T> zero_raw() {
  Raw<T> r;
#pragma unroll
  for (int i = 0; i < Raw<T>::kWords; ++i) r.w[i] = make_uint4(0u, 0u, 0u, 0u);
  return r;
}

template <typename T>
__device__ __forceinline__ void unpack(const Raw<T>& r, float (&v)[kVec]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      const uint4 w = r.w[i >> 1];
      const unsigned u[2] = {(i & 1) ? w.z : w.x, (i & 1) ? w.w : w.y};
      v[2 * i] = __uint_as_float(u[0]);
      v[2 * i + 1] = __uint_as_float(u[1]);
    } else {
      const uint4 w = r.w[0];
      const unsigned u = i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
      v[2 * i] = __uint_as_float(u << 16);
      v[2 * i + 1] = __uint_as_float(u & 0xffff0000u);
    }
  }
}

// Channels 8k .. 8k + 7 of a shift or scale row (f32 or bf16) as f32
__device__ __forceinline__ void load_vec(const void* row, int k, bool bf16, float (&v)[kVec]) {
  if (bf16) unpack(load_raw(static_cast<const __nv_bfloat16*>(row) + kVec * k), v);
  else unpack(load_raw(static_cast<const float*>(row) + kVec * k), v);
}

__device__ __forceinline__ float tree8(const float (&v)[kVec]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[1]), __fadd_rn(v[2], v[3])),
                   __fadd_rn(__fadd_rn(v[4], v[5]), __fadd_rn(v[6], v[7])));
}

__device__ __forceinline__ float lane_butterfly_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
  return s;
}

// v -= mean; the tree of the squares (zero for a chunk past the row's end,
// as the tree of its zeros would be)
__device__ __forceinline__ float centre_sq(float (&v)[kVec], float mu, bool ok) {
  float sq[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    v[i] = __fsub_rn(v[i], mu);
    sq[i] = __fmul_rn(v[i], v[i]);
  }
  return ok ? tree8(sq) : 0.f;
}

__device__ __forceinline__ float rsqrt_rn(float var, float eps) {
  return __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
}

// mx_common's bf16_round_away in four operations: 0x8000 added to the whole
// pattern carries into the sign bit only from a NaN pattern (an infinity
// maps to itself), so only NaN needs its own bits back.  The plain
// version's bf16_round_half_away takes the same steps.
__device__ __forceinline__ float bf16_round_away4(float y) {
  const float r = __uint_as_float((__float_as_uint(y) + 0x8000u) & 0xffff0000u);
  return y != y ? y : r;
}

// xn * (1 + scale) + shift, and (kBf16Round) the half-away bf16 round
template <bool kBf16Round>
__device__ __forceinline__ float modulate(float xc, float rs, float a, float b) {
  const float y = __fadd_rn(__fmul_rn(__fmul_rn(xc, rs), a), b);
  return kBf16Round ? bf16_round_away4(y) : y;
}

// One element of an MX block in K1's order (the TPU quantize kernel's
// _quantize_block_values_axis0): the int grids (kInt) rescale as q * scale
// * (1/half); the MXFP grids as quant_val does.
template <bool kInt>
__device__ __forceinline__ float quant_k1(float x, unsigned mb, int e, const Fmt& f) {
  if constexpr (kInt) {
    if (f.flush && mb < 0x00800000u) x = 0.f;
    const float s = __fmul_rn(__fmul_rn(x, pow2f(-e)), f.half);
    const float q = fminf(fmaxf(round_half_away(s), -f.qmax), f.qmax);
    return __fmul_rn(__fmul_rn(q, pow2f(e)), f.inv_half);
  } else {
    return quant_val(x, mb, e, f, false);
  }
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Modulate, round and quantize one chunk of centred values (its 4-lane MX
// block's maximum by two xor shuffles: every lane of the warp takes part)
// and store it at element o of the output where ok.  a = 1 + scale and
// b = shift of the chunk's channels.  The format family (kInt) and the
// bf16 round (kBf16Round) are template arguments, so that no element branches.
template <bool kInt, bool kBf16Round>
__device__ __forceinline__ void emit(const Params& p, float (&v)[kVec], float rs,
                                     const float (&a)[kVec], const float (&b)[kVec], bool ok,
                                     size_t o) {
  unsigned m = 0u;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    v[i] = modulate<kBf16Round>(v[i], rs, a[i], b[i]);
    m = max(m, mag_bits(v[i]));
  }
  m = max(m, __shfl_xor_sync(kFull, m, 1));
  m = max(m, __shfl_xor_sync(kFull, m, 2));
  const int e = shared_exp(m, p.fmt);
#pragma unroll
  for (int i = 0; i < kVec; ++i) v[i] = quant_k1<kInt>(v[i], m, e, p.fmt);
  if (!ok) return;
  if (p.out_bf16) {
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.out) + o) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                   pack_bf16(v[6], v[7]));
  } else {
    float4* dst = reinterpret_cast<float4*>(static_cast<float*>(p.out) + o);
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// 1 + scale and shift of chunk k from the block's shared-memory stage
__device__ __forceinline__ void stage_read(const float* a, const float* b, int k,
                                           float (&sa)[kVec], float (&sb)[kVec]) {
  const float4* a4 = reinterpret_cast<const float4*>(a + kVec * k);
  const float4* b4 = reinterpret_cast<const float4*>(b + kVec * k);
  const float4 a0 = a4[0], a1 = a4[1], b0 = b4[0], b1 = b4[1];
  sa[0] = a0.x; sa[1] = a0.y; sa[2] = a0.z; sa[3] = a0.w;
  sa[4] = a1.x; sa[5] = a1.y; sa[6] = a1.z; sa[7] = a1.w;
  sb[0] = b0.x; sb[1] = b0.y; sb[2] = b0.z; sb[3] = b0.w;
  sb[4] = b1.x; sb[5] = b1.y; sb[6] = b1.z; sb[7] = b1.w;
}

// Rows of up to kRegRounds rounds, held in registers; a block takes a tile
// of kTileRows rows of one batch element.  At most 64 registers: 4 blocks,
// 32 warps, per SM.
template <typename T, bool kInt, bool kBf16Round>
__global__ void __launch_bounds__(kWarps * 32, 4)
k5_rows_in_registers(const Params p) {
  extern __shared__ float4 stage[];  // 1 + scale, then shift: 2 C floats
  float* a = reinterpret_cast<float*>(stage);
  float* b = a + p.C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bi = blockIdx.x / p.tiles;
  const int n0 = (blockIdx.x % p.tiles) * kTileRows;
  const int n1 = min(n0 + kTileRows, p.N);
  const char* srow = static_cast<const char*>(p.scale) +
                     size_t(bi) * p.scale_stride * (p.ss_bf16 ? 2 : 4);
  const char* hrow = static_cast<const char*>(p.shift) +
                     size_t(bi) * p.shift_stride * (p.ss_bf16 ? 2 : 4);
  for (int k = threadIdx.x; k < p.nchunks; k += kWarps * 32) {
    float sa[kVec], sb[kVec];
    load_vec(srow, k, p.ss_bf16, sa);
    load_vec(hrow, k, p.ss_bf16, sb);
    float4* a4 = reinterpret_cast<float4*>(a + kVec * k);
    float4* b4 = reinterpret_cast<float4*>(b + kVec * k);
    a4[0] = make_float4(__fadd_rn(1.f, sa[0]), __fadd_rn(1.f, sa[1]), __fadd_rn(1.f, sa[2]),
                        __fadd_rn(1.f, sa[3]));
    a4[1] = make_float4(__fadd_rn(1.f, sa[4]), __fadd_rn(1.f, sa[5]), __fadd_rn(1.f, sa[6]),
                        __fadd_rn(1.f, sa[7]));
    b4[0] = make_float4(sb[0], sb[1], sb[2], sb[3]);
    b4[1] = make_float4(sb[4], sb[5], sb[6], sb[7]);
  }
  __syncthreads();
  for (int n = n0 + warp; n < n1; n += kWarps) {
    const size_t row = size_t(bi) * p.N + n;
    const T* xr = static_cast<const T*>(p.x) + row * p.C;
    float v[kRegRounds][kVec];
#pragma unroll
    for (int j = 0; j < kRegRounds; ++j) {
      const int k = lane + 32 * j;
      if (j < p.nr) unpack(k < p.nchunks ? load_raw(xr + kVec * k) : zero_raw<T>(), v[j]);
    }
    // mean: the chunks' trees in round order, then the lanes
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kRegRounds; ++j) {
      if (j < p.nr) {
        const float c = tree8(v[j]);
        s = j ? __fadd_rn(s, c) : c;
      }
    }
    const float mu = __fmul_rn(lane_butterfly_sum(s), p.inv_c);
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < kRegRounds; ++j) {
      if (j < p.nr) {
        const float c = centre_sq(v[j], mu, lane + 32 * j < p.nchunks);
        q = j ? __fadd_rn(q, c) : c;
      }
    }
    const float rs = rsqrt_rn(__fmul_rn(lane_butterfly_sum(q), p.inv_c), p.eps);
    // modulate, round, quantize and store each round
#pragma unroll
    for (int j = 0; j < kRegRounds; ++j) {
      if (j < p.nr) {
        const int k = lane + 32 * j;
        const bool ok = k < p.nchunks;
        float sa[kVec], sb[kVec];
        stage_read(a, b, ok ? k : 0, sa, sb);
        emit<kInt, kBf16Round>(p, v[j], rs, sa, sb, ok, row * p.C + size_t(kVec) * k);
      }
    }
  }
}

// Rows wider than kRegRounds rounds: one row per warp, each lane's raw
// chunks kept in shared memory between the passes, laid out [round][word]
// [lane] so that a warp's 16-byte accesses are conflict-free.
template <typename T, bool kInt, bool kBf16Round>
__global__ void __launch_bounds__(kWarps * 32)
k5_rows_in_shared(const Params p) {
  extern __shared__ uint4 held[];
  constexpr int W = Raw<T>::kWords;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= p.rows) return;  // the whole warp leaves together
  uint4* mine = held + size_t(warp) * p.nr * W * 32 + lane;
  const T* xr = static_cast<const T*>(p.x) + size_t(row) * p.C;
  float s = 0.f;
#pragma unroll 4
  for (int j = 0; j < p.nr; ++j) {
    const int k = lane + 32 * j;
    const Raw<T> r = k < p.nchunks ? load_raw(xr + kVec * k) : zero_raw<T>();
#pragma unroll
    for (int i = 0; i < W; ++i) mine[(j * W + i) * 32] = r.w[i];
    float v[kVec];
    unpack(r, v);
    const float c = tree8(v);
    s = j ? __fadd_rn(s, c) : c;
  }
  const float mu = __fmul_rn(lane_butterfly_sum(s), p.inv_c);
  float q = 0.f;
  for (int j = 0; j < p.nr; ++j) {
    Raw<T> r;
#pragma unroll
    for (int i = 0; i < W; ++i) r.w[i] = mine[(j * W + i) * 32];
    float v[kVec];
    unpack(r, v);
    const float c = centre_sq(v, mu, lane + 32 * j < p.nchunks);
    q = j ? __fadd_rn(q, c) : c;
  }
  const float rs = rsqrt_rn(__fmul_rn(lane_butterfly_sum(q), p.inv_c), p.eps);
  const long long bi = row / p.N;
  const char* srow = static_cast<const char*>(p.scale) +
                     size_t(bi) * p.scale_stride * (p.ss_bf16 ? 2 : 4);
  const char* hrow = static_cast<const char*>(p.shift) +
                     size_t(bi) * p.shift_stride * (p.ss_bf16 ? 2 : 4);
  for (int j = 0; j < p.nr; ++j) {
    const int k = lane + 32 * j;
    const bool ok = k < p.nchunks;
    Raw<T> r;
#pragma unroll
    for (int i = 0; i < W; ++i) r.w[i] = mine[(j * W + i) * 32];
    float v[kVec], sa[kVec], sb[kVec];
    unpack(r, v);
    centre_sq(v, mu, false);
    load_vec(srow, ok ? k : 0, p.ss_bf16, sa);
    load_vec(hrow, ok ? k : 0, p.ss_bf16, sb);
#pragma unroll
    for (int i = 0; i < kVec; ++i) sa[i] = __fadd_rn(1.f, sa[i]);
    emit<kInt, kBf16Round>(p, v, rs, sa, sb, ok, size_t(row) * p.C + size_t(kVec) * k);
  }
}

template <typename T, bool kInt, bool kBf16Round>
int launch(const Params& p, cudaStream_t stream) {
  if (p.nr <= kRegRounds) {
    const long long blocks = p.rows / p.N * p.tiles;
    k5_rows_in_registers<T, kInt, kBf16Round>
        <<<unsigned(blocks), kWarps * 32, 2 * p.C * sizeof(float), stream>>>(p);
    return int(cudaGetLastError());
  }
  const size_t per_warp = size_t(p.nr) * 32 * sizeof(Raw<T>);
  const int warps = kSmemMax / per_warp < kWarps ? int(kSmemMax / per_warp) : kWarps;
  const size_t smem = warps * per_warp;
  const cudaError_t err = cudaFuncSetAttribute(
      k5_rows_in_shared<T, kInt, kBf16Round>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const long long blocks = (p.rows + warps - 1) / warps;
  k5_rows_in_shared<T, kInt, kBf16Round><<<unsigned(blocks), warps * 32, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <typename T, bool kInt>
int launch_round(const Params& p, cudaStream_t stream) {
  return p.bfloat16 ? launch<T, kInt, true>(p, stream) : launch<T, kInt, false>(p, stream);
}

template <typename T>
int launch_format(const Params& p, cudaStream_t stream) {
  return p.fmt.ebits ? launch_round<T, false>(p, stream) : launch_round<T, true>(p, stream);
}

}  // namespace

// Launch K5 on `stream` over `rows` = B * N rows of C channels.  shift and
// scale are (B, C) rows of f32 or (ss_bf16) bf16, `shift_stride` and
// `scale_stride` elements apart; every pointer and row is 16-byte aligned.
// Returns the cudaError_t of the launch (0 = ok).
extern "C" int ln_modulate_quantize(const void* x, const void* shift, const void* scale,
                                    void* out, long long rows, int N, int C,
                                    int shift_stride, int scale_stride, int in_bf16,
                                    int ss_bf16, int out_bf16, float inv_c, float eps,
                                    int bfloat16, int flush, int ebits, int mbits, int emax,
                                    float max_norm, int scale_bits, void* stream) {
  if (rows < 1 || N < 1 || C < kBlock || C % kBlock || C > K5_MAX_CHANNELS || rows % N)
    return int(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.shift = shift;
  p.scale = scale;
  p.out = out;
  p.rows = rows;
  p.N = N;
  p.C = C;
  p.nr = (C + kRoundChannels - 1) / kRoundChannels;
  p.nchunks = C / kVec;
  p.tiles = (N + kTileRows - 1) / kTileRows;
  p.shift_stride = shift_stride;
  p.scale_stride = scale_stride;
  p.ss_bf16 = ss_bf16;
  p.out_bf16 = out_bf16;
  p.bfloat16 = bfloat16;
  p.inv_c = inv_c;
  p.eps = eps;
  p.fmt = make_fmt(ebits, mbits, emax, max_norm, scale_bits, flush);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return in_bf16 ? launch_format<__nv_bfloat16>(p, s) : launch_format<float>(p, s);
}
