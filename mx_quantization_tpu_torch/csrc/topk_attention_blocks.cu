// Kernels K3 and K4 at the MX block sizes other than 32, and K2 and K7 there
// on the MXFP grids and with true_ex's top-k (on the int grids K2 and K7
// take topk_attention_qkv.cu built for the block, on the int8 tensor cores;
// ops/kernels/topk_attention.py qkv_route): fused MX top-k attention in
// blocks of bs = 8, 16, 64 or 128 elements, with the function, the
// summation orders and the C layouts of the block-32 kernels
// (topk_attention_qkv.cu: K2 from the fused qkv output, K7 from the
// split-emission q/k and v; topk_attention_split.cu: K3 and K4 from split
// q, k, v with an optional key bias).  The TPU kernels it replaces at these
// block sizes are the same as theirs:
// mx_quantization_tpu/ops/kernels/topk_attention.py fused_topk_attention_qkv
// (K2), fused_topk_attention_qkv_t (K7) and fused_topk_attention's
// _split_impl short and query-tiled paths (K3, K4), whose block_size is a
// static argument; they pad tokens to a multiple of 128, so bs divides 128.
//
// What bounds it on the card: as the block-32 kernels, bytes (q, k, v read
// and the output written once) set the least time; this kernel does not
// come near it.  It is the simple design: right first, fast later.
//   * A pre-pass quantizes each (row, head) cell once into a workspace the
//     wrapper allocates, per token and bs-block: q and k as f32 values
//     (their integer grid points on the int route, the bf16-stored values
//     otherwise), the block's power of two, the predictor's operands, and
//     for ELSA each token's hash words and key norm; v per (bs-key block,
//     column).  K's arrays are stored d-major, so that lanes reading
//     consecutive keys read consecutive words.
//   * The attention kernel gives each query row to one warp: lane l takes
//     keys l + 32 i for the scores (the q row's arrays in the warp's shared
//     memory), the k-th key by bisection on counts over the row as the
//     plain version finds it, the tie rank by ballots in key order, the
//     softmax with the entry's summation order, the probabilities'
//     quantize per bs-key block, and PV with lanes over output columns.
//   * Every MX block sum is taken per bs-element block, exactly where the
//     block-32 kernels' int8 mma is exact (integer grid points in f32 or
//     f64, whose sums stay exact), in index order on the CUDA-core route,
//     and the blocks are added in order: the plain version
//     (ops/kernels/topk_attention.py _attention_ref) sums in these orders,
//     so the two agree bit for bit.  No tensor core is used, so a zero-
//     padded block costs nothing extra; each block is a short sequential
//     loop instead.
// Products that feed a sum are explicit __fmul_rn/__fadd_rn (or exact), so
// the compiler contracts nothing.  Build without --use_fast_math.

#include "topk_pred.cuh"

// The MX block sizes it takes (BLOCK_SIZES in ops/kernels/__init__.py), as
// the sum of their powers of two.
#ifndef MX_BLOCK_MASK
#error "build with -DMX_BLOCK_MASK=<n> (ops/kernels/build.py passes it)"
#endif

namespace {

using namespace mx;

constexpr int kMaxKeys = 4096;   // K4's limit (MAX_TILED_KEYS)
constexpr int kMaxDp = 128;      // MAX_HEAD_DIM
constexpr int kMaxWarps = 8;
constexpr int kRowsPerWarp = 4;  // query rows a warp takes in turn
constexpr int kHashWords = 4;    // ELSA: at most 128 bits
constexpr long long kMaxSmem = 232448;

enum Entry { kQkv = 0, kQkvT = 1, kSplit = 2 };

struct Params {
  const void* a;  // K2: qkv (B, Nin, 3*H*D); K7: qk_t (2*H*DpIn, B, Nin); K3/K4: q
  const void* b;  // K7: v (B, Nin, H*D); K3/K4: k (B, H, S, D)
  const void* c;  // K3/K4: v (B, H, S, D)
  const float* bias;     // (B, S) or null
  const float* proj;     // ELSA (bits, D)
  const float* cos_tab;  // ELSA (bits + 1)
  void* out;
  int entry, B, H, N, S, D, Nin, DpIn;
  int bs, Dp, nb, Sp, nkb, cells;
  int in_bf16, out_bf16, k, key_bits, relaxed, bfloat16;
  int pred;       // the predictor's mode (topk_pred.cuh Mode), -1: select by the true score
  int int_route;  // the true score and PV on the integer grid points
  int shift, bits, W;
  float scale;
  Fmt fmt, fmt4;
  // the workspace: q side [cells][N][...], k side d-major [cells][...][Sp]
  float *qx, *qa, *qsc, *qpw, *kx, *ka, *ksc, *kpw, *knorm, *vq, *vm, *vsc;
  unsigned *qh, *kh;
};

__device__ __forceinline__ float load_elem(const void* base, size_t i, bool bf16) {
  if (bf16)
    return __uint_as_float(unsigned(__ldg(static_cast<const unsigned short*>(base) + i)) << 16);
  return __ldg(static_cast<const float*>(base) + i);
}

// Element d of token t of side s (0 q, 1 k, 2 v) of cell (bi, h), after the
// half-away bf16 round (bfloat=16, f32 input); 0 past the side's tokens
// (N for q, S for k and v) or past D.
__device__ __forceinline__ float side_elem(const Params& p, int s, int bi, int h, int t, int d) {
  const int ntok = s == 0 ? p.N : p.S;
  if (t >= ntok || d >= p.D) return 0.f;
  size_t i;
  const void* base;
  if (p.entry == kQkv) {
    base = p.a;
    i = (size_t(bi) * p.Nin + t) * (3 * size_t(p.H) * p.D) + (size_t(s) * p.H + h) * p.D + d;
  } else if (p.entry == kQkvT) {
    if (s < 2) {
      base = p.a;
      i = ((size_t(s) * p.H + h) * p.DpIn + d) * (size_t(p.B) * p.Nin) + size_t(bi) * p.Nin + t;
    } else {
      base = p.b;
      i = (size_t(bi) * p.Nin + t) * (size_t(p.H) * p.D) + size_t(h) * p.D + d;
    }
  } else {
    base = s == 0 ? p.a : (s == 1 ? p.b : p.c);
    i = ((size_t(bi) * p.H + h) * ntok + t) * p.D + d;
  }
  float x = load_elem(base, i, p.in_bf16);
  if (p.bfloat16 && !p.in_bf16) x = bf16_round_away(x);
  return x;
}

// ---- the pre-pass of q (rows 0 .. cells*N) and k (the next cells*Sp
// rows): one warp per token row, lane j the bs-block j, then (ELSA) lanes
// over the hash bits.  The row's values wait in the warp's shared memory.
__global__ void __launch_bounds__(kMaxWarps * 32) blocks_side_kernel(const Params p) {
  __shared__ float vals[kMaxWarps][kMaxDp];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kMaxWarps + warp;
  const long long qrows = (long long)p.cells * p.N;
  if (row >= qrows + (long long)p.cells * p.Sp) return;  // the whole warp
  const bool qside = row < qrows;
  const int ntok = qside ? p.N : p.Sp;
  const long long r = qside ? row : row - qrows;
  const int cell = int(r / ntok), t = int(r % ntok);
  const int bi = cell / p.H, h = cell % p.H;
  const bool pred_on = p.pred >= 0 && p.pred != mElsa;
  for (int blk = lane; blk < p.nb; blk += 32) {
    const int d0 = blk * p.bs;
    unsigned mb = 0u;
    for (int i = 0; i < p.bs; ++i) mb = max(mb, mag_bits(side_elem(p, qside ? 0 : 1, bi, h, t, d0 + i)));
    const int e = shared_exp(mb, p.fmt);
    unsigned vmb = 0u;
    for (int i = 0; i < p.bs; ++i) {
      const float x = side_elem(p, qside ? 0 : 1, bi, h, t, d0 + i);
      vmb = max(vmb, mag_bits(quant_val(x, mb, e, p.fmt, false)));
    }
    // the predictor's block exponent: the shared one on the int grids, the
    // quantized block's own on the MXFP grids (quantize_blocks' exps)
    const int pe = p.fmt.ebits ? int(vmb >> 23) - 127 : e;
    for (int i = 0; i < p.bs; ++i) {
      const int d = d0 + i;
      const float x = side_elem(p, qside ? 0 : 1, bi, h, t, d);
      const float val = bf16_rne(quant_val(x, mb, e, p.fmt, false));
      vals[warp][d] = val;
      const float xv = p.int_route ? float(quant_int(x, mb, e, p.fmt, false)) : val;
      float a = 0.f;
      if (pred_on) {
        const bool valid = d < p.D;
        if (p.pred == mExPred) a = valid ? (val < 0.f ? -1.f : 1.f) : 0.f;
        else if (p.pred == mMxint4) a = quant_val(x, mb, shared_exp(mb, p.fmt4), p.fmt4, false);
        else a = fp_operand(p.pred, p.fmt4, qside, val, pe, x, mb, valid);
      }
      if (qside) {
        const size_t o = size_t(r) * p.Dp + d;
        p.qx[o] = xv;
        if (pred_on) p.qa[o] = a;
      } else {
        const size_t o = (size_t(cell) * p.Dp + d) * p.Sp + t;
        p.kx[o] = xv;
        if (pred_on) p.ka[o] = a;
      }
    }
    const float sc = pow2_sub(e - p.shift);
    const float pw = pow2f(min(max(pe, -126), 127));
    if (qside) {
      const size_t o = size_t(r) * p.nb + blk;
      if (p.int_route) p.qsc[o] = sc;
      if (p.pred == mExPred) p.qpw[o] = pw;
    } else {
      const size_t o = (size_t(cell) * p.nb + blk) * p.Sp + t;
      if (p.int_route) p.ksc[o] = sc;
      if (p.pred == mExPred) p.kpw[o] = pw;
    }
  }
  if (p.pred != mElsa) return;
  __syncwarp();
  // ELSA: the sign of each projection row times the values, the products
  // rounded in f32 and added in d order; the key norm in d order
  unsigned words[kHashWords];
  for (int w = 0; w < kHashWords; ++w) {
    const int bit = 32 * w + lane;
    float acc = 0.f;
    if (bit < p.bits)
      for (int d = 0; d < p.D; ++d)
        acc = __fadd_rn(acc, __fmul_rn(vals[warp][d], __ldg(p.proj + size_t(bit) * p.D + d)));
    words[w] = __ballot_sync(kFull, bit < p.bits && acc >= 0.f);
  }
  if (lane == 0) {
    for (int w = 0; w < kHashWords; ++w) {
      if (qside) p.qh[size_t(r) * kHashWords + w] = words[w];
      else p.kh[(size_t(cell) * kHashWords + w) * p.Sp + t] = words[w];
    }
    if (!qside) {
      float nsum = 0.f;
      for (int d = 0; d < p.D; ++d) nsum = __fadd_rn(nsum, __fmul_rn(vals[warp][d], vals[warp][d]));
      p.knorm[size_t(cell) * p.Sp + t] = __fsqrt_rn(nsum);
    }
  }
}

// ---- v: one thread per (cell, bs-key block, column): the block along the
// keys, stored [cells][Sp][D] (values; the int route also its grid points)
// and its power of two [cells][nkb][D]
__global__ void blocks_v_kernel(const Params p) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)p.cells * p.nkb * p.D) return;
  const int col = int(tid % p.D);
  const int kb = int((tid / p.D) % p.nkb);
  const int cell = int(tid / ((long long)p.D * p.nkb));
  const int bi = cell / p.H, h = cell % p.H;
  unsigned mb = 0u;
  for (int j = 0; j < p.bs; ++j) mb = max(mb, mag_bits(side_elem(p, 2, bi, h, kb * p.bs + j, col)));
  const int e = shared_exp(mb, p.fmt);
  const float sc = pow2_sub(e - p.shift);
  for (int j = 0; j < p.bs; ++j) {
    const int t = kb * p.bs + j;
    const float x = side_elem(p, 2, bi, h, t, col);
    const size_t o = (size_t(cell) * p.Sp + t) * p.D + col;
    if (p.int_route) {
      const float m = float(quant_int(x, mb, e, p.fmt, false));
      p.vm[o] = m;
      p.vq[o] = __fmul_rn(m, sc);
    } else {
      p.vq[o] = bf16_rne(quant_val(x, mb, e, p.fmt, false));
    }
  }
  if (p.int_route) p.vsc[(size_t(cell) * p.nkb + kb) * p.D + col] = sc;
}

// A warp's shared memory: the row's scores (then its probabilities) and
// its selection keys (then the probabilities' block scales), the q row's
// arrays and block scalars
__host__ __device__ inline size_t warp_floats(int Sp, int Dp, int nb) {
  return size_t(2) * Sp + 2 * size_t(Dp) + 2 * size_t(nb) + kHashWords;
}

// The score of key j against the q row held in shared memory (qx, qsc):
// each bs-block summed exactly (int route: grid points, an integer below
// 2^24, times q's then k's power of two) or in index order from +0 (the
// bf16-stored values), the blocks added in order
__device__ __forceinline__ float true_score(const Params& p, const float* qx, const float* qsc,
                                            int cell, int j) {
  float acc = 0.f;
  for (int blk = 0; blk < p.nb; ++blk) {
    float s = 0.f;
    for (int i = 0; i < p.bs; ++i) {
      const int d = blk * p.bs + i;
      s = __fadd_rn(s, __fmul_rn(qx[d], __ldg(p.kx + (size_t(cell) * p.Dp + d) * p.Sp + j)));
    }
    if (p.int_route)
      s = __fmul_rn(__fmul_rn(s, qsc[blk]), __ldg(p.ksc + (size_t(cell) * p.nb + blk) * p.Sp + j));
    acc = blk ? __fadd_rn(acc, s) : s;
  }
  return acc;
}

// The predictor's score of key j (ELSA aside): ex_pred the count of equal
// signs less unequal ones per block times 2^eq * 2^ek; on the int route
// two_step one float64 dot over every d rounded once, MXINT4, partial and
// threshold_ex each block in float64 rounded once; on the CUDA-core route
// (MXFP, true_ex) each block in index order from +0; blocks in order
__device__ __forceinline__ float pred_score(const Params& p, const float* qa, const float* qpw,
                                            int cell, int j) {
  const float* ka = p.ka + size_t(cell) * p.Dp * p.Sp + j;
  if (p.int_route && p.pred == mTwoStep) {
    double acc = 0.0;
    for (int d = 0; d < p.Dp; ++d) acc += double(qa[d]) * double(__ldg(ka + size_t(d) * p.Sp));
    return __double2float_rn(acc);
  }
  float acc = 0.f;
  for (int blk = 0; blk < p.nb; ++blk) {
    float s;
    if (p.pred == mExPred || (p.int_route && p.pred != mTrueEx)) {
      double t = 0.0;
      for (int i = 0; i < p.bs; ++i) {
        const int d = blk * p.bs + i;
        t += double(qa[d]) * double(__ldg(ka + size_t(d) * p.Sp));
      }
      s = __double2float_rn(t);
      if (p.pred == mExPred)
        s = __fmul_rn(s, __fmul_rn(qpw[blk],
                                   __ldg(p.kpw + (size_t(cell) * p.nb + blk) * p.Sp + j)));
    } else {
      s = 0.f;
      for (int i = 0; i < p.bs; ++i) {
        const int d = blk * p.bs + i;
        s = __fadd_rn(s, __fmul_rn(qa[d], __ldg(ka + size_t(d) * p.Sp)));
      }
    }
    acc = blk ? __fadd_rn(acc, s) : s;
  }
  return acc;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// ---- attention: one warp per query row
__global__ void __launch_bounds__(kMaxWarps * 32) blocks_attention_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* mine = reinterpret_cast<float*>(smem4) + size_t(warp) * warp_floats(p.Sp, p.Dp, p.nb);
  float* st = mine;                                      // [Sp] scores, then probabilities
  int* keys = reinterpret_cast<int*>(mine + p.Sp);       // [Sp] keys, then block scales
  float* qx = mine + 2 * p.Sp;                           // [Dp]
  float* qa = qx + p.Dp;                                 // [Dp]
  float* qsc = qa + p.Dp;                                // [nb]
  float* qpw = qsc + p.nb;                               // [nb]
  unsigned* qh = reinterpret_cast<unsigned*>(qpw + p.nb);  // [4]
  const long long rows = (long long)p.cells * p.N;
  const bool pred_on = p.pred >= 0;
  const bool dense = p.k >= p.S;
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const long long row = ((long long)blockIdx.x * p.W + warp) * kRowsPerWarp + rr;
    if (row >= rows) return;  // uniform over the warp
    const int cell = int(row / p.N), n = int(row % p.N);
    const int bi = cell / p.H, h = cell % p.H;
    for (int d = lane; d < p.Dp; d += 32) {
      qx[d] = p.qx[size_t(row) * p.Dp + d];
      if (pred_on && p.pred != mElsa) qa[d] = p.qa[size_t(row) * p.Dp + d];
    }
    for (int blk = lane; blk < p.nb; blk += 32) {
      if (p.int_route) qsc[blk] = p.qsc[size_t(row) * p.nb + blk];
      if (p.pred == mExPred) qpw[blk] = p.qpw[size_t(row) * p.nb + blk];
    }
    if (p.pred == mElsa && lane < kHashWords) qh[lane] = p.qh[size_t(row) * kHashWords + lane];
    __syncwarp();
    // scores and selection keys
    const float norm_n = p.pred == mElsa && n < p.Sp ? p.knorm[size_t(cell) * p.Sp + n] : 0.f;
    for (int j = lane; j < p.Sp; j += 32) {
      float s = true_score(p, qx, qsc, cell, j);
      float sel = 0.f;
      if (pred_on) {
        if (p.pred == mElsa) {
          int ham = 0;
          for (int w = 0; w < kHashWords; ++w)
            ham += __popc(qh[w] ^ p.kh[(size_t(cell) * kHashWords + w) * p.Sp + j]);
          sel = __fmul_rn(norm_n, __ldg(p.cos_tab + ham));
        } else {
          sel = pred_score(p, qa, qpw, cell, j);
        }
      }
      if (p.bfloat16 && !p.relaxed) s = bf16_round_away(s);
      s = __fmul_rn(s, p.scale);
      if (p.bias != nullptr) {
        const float bj = j < p.S ? __ldg(p.bias + size_t(bi) * p.S + j) : 0.f;
        s = __fadd_rn(s, bj);
        if (pred_on) sel = __fadd_rn(sel, bj);
      }
      st[j] = s;
      if (!dense) keys[j] = mono_key(j < p.S ? (pred_on ? sel : s) : kNeg, p.key_bits);
    }
    __syncwarp();
    // the k-th key by bisection on counts, and the count of greater keys
    long long kth = 0;
    int n_gt = 0;
    if (!dense) {
      long long lo = -(1ll << (p.key_bits - 1)), hi = (1ll << (p.key_bits - 1)) - 1;
      for (int it = 0; it < p.key_bits; ++it) {
        const long long mid = lo + ((hi - lo) >> 1);
        int c = 0;
        for (int j = lane; j < p.Sp; j += 32) c += (long long)keys[j] > mid;
        c = warp_sum(c);
        if (c >= p.k) lo = mid + 1;
        else { hi = mid; n_gt = c; }
      }
      kth = lo;
    }
    // the selection (exact tier: ties lowest index first up to k), the
    // masked scores and their maximum
    float m = kNeg;
    int ties = 0;  // ties of lower keys, in key order
    for (int j0 = 0; j0 < p.Sp; j0 += 32) {
      const int j = j0 + lane;
      bool sel = j < p.S;
      if (!dense) {
        const long long key = keys[j];
        if (p.relaxed) {
          sel = key >= kth;
        } else {
          const bool eq = key == kth;
          const unsigned eqb = __ballot_sync(kFull, eq);
          const int rank = ties + __popc(eqb & (0xffffffffu >> (31 - lane)));
          ties += __popc(eqb);
          sel = key > kth || (eq && rank <= p.k - n_gt);
        }
      }
      const float ms = sel ? st[j] : kNeg;
      st[j] = ms;
      m = fmaxf(m, ms);
    }
    m = warp_max(m);
    __syncwarp();
    // exp, the sum in the entry's order, the probabilities
    for (int j = lane; j < p.Sp; j += 32) st[j] = expf(__fsub_rn(st[j], m));
    __syncwarp();
    float sum;
    if (p.entry == kSplit) {  // lane_sum: lane l adds keys l + 32 i, then a tree
      sum = st[lane];
      for (int j = lane + 32; j < p.Sp; j += 32) sum = __fadd_rn(sum, st[j]);
      for (int o = 16; o > 0; o >>= 1) sum = __fadd_rn(sum, __shfl_down_sync(kFull, sum, o));
    } else {  // _fragment_sum: sixteen sums of keys m + 16 i, then a tree
      sum = 0.f;
      if (lane < 16) {
        sum = st[lane];
        for (int j = lane + 16; j < p.Sp; j += 16) sum = __fadd_rn(sum, st[j]);
      }
      for (int o = 8; o > 0; o >>= 1) sum = __fadd_rn(sum, __shfl_down_sync(kFull, sum, o));
    }
    sum = __shfl_sync(kFull, sum, 0);
    __syncwarp();
    for (int j = lane; j < p.Sp; j += 32) {
      const float a = __fdiv_rn(st[j], sum);
      st[j] = p.relaxed ? bf16_rne(a) : (p.bfloat16 ? bf16_round_away(a) : a);
    }
    __syncwarp();
    float* psc = reinterpret_cast<float*>(keys);
    if (!p.relaxed) {  // the exact tier's quantize per bs-key block
      for (int kb = lane; kb < p.nkb; kb += 32) {
        unsigned mb = 0u;
        for (int i = 0; i < p.bs; ++i) mb = max(mb, mag_bits(st[kb * p.bs + i]));
        const int e = shared_exp(mb, p.fmt);
        for (int i = 0; i < p.bs; ++i) {
          const float a = st[kb * p.bs + i];
          st[kb * p.bs + i] = p.int_route ? float(quant_int(a, mb, e, p.fmt, true))
                                          : bf16_rne(quant_val(a, mb, e, p.fmt, true));
        }
        psc[kb] = pow2_sub(e - p.shift);
      }
      __syncwarp();
    }
    // PV, lanes over the output columns
    for (int col = lane; col < p.D; col += 32) {
      const float* vcol = p.vq + size_t(cell) * p.Sp * p.D + col;
      float o = 0.f;
      if (p.relaxed) {
        for (int j = 0; j < p.Sp; ++j) o = __fadd_rn(o, __fmul_rn(st[j], __ldg(vcol + size_t(j) * p.D)));
      } else {
        const float* src = p.int_route ? p.vm + size_t(cell) * p.Sp * p.D + col : vcol;
        for (int kb = 0; kb < p.nkb; ++kb) {
          float s = 0.f;
          for (int i = 0; i < p.bs; ++i) {
            const int j = kb * p.bs + i;
            s = __fadd_rn(s, __fmul_rn(st[j], __ldg(src + size_t(j) * p.D)));
          }
          if (p.int_route)
            s = __fmul_rn(__fmul_rn(s, psc[kb]),
                          __ldg(p.vsc + (size_t(cell) * p.nkb + kb) * p.D + col));
          o = kb ? __fadd_rn(o, s) : s;
        }
        if (p.bfloat16) o = bf16_round_away(o);
      }
      const size_t oi = p.entry == kSplit
                            ? ((size_t(bi) * p.H + h) * p.N + n) * p.D + col
                            : (size_t(bi) * p.N + n) * (size_t(p.H) * p.D) + size_t(h) * p.D + col;
      if (p.out_bf16) static_cast<__nv_bfloat16*>(p.out)[oi] = __float2bfloat16_rn(o);
      else static_cast<float*>(p.out)[oi] = o;
    }
    __syncwarp();
  }
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

bool block_ok(int bs) { return bs > 0 && (bs & (bs - 1)) == 0 && (bs & MX_BLOCK_MASK) != 0; }

Params make_params(int entry, int B, int H, int N, int S, int D, int bs, int topk, int approx,
                   int pred_mode, int ebits, int bits) {
  Params p = {};
  p.entry = entry;
  p.B = B;
  p.H = H;
  p.N = N;
  p.S = S;
  p.D = D;
  p.bs = bs;
  p.Dp = round_up(D > 8 ? D : 8, bs);
  p.nb = p.Dp / bs;
  p.Sp = round_up(S, bs > 32 ? bs : 32);
  p.nkb = p.Sp / bs;
  p.cells = B * H;
  p.k = topk;
  p.pred = approx && topk < S ? pred_mode : -1;
  p.int_route = ebits == 0 && p.pred != mTrueEx;
  p.bits = bits;
  const size_t per_warp = warp_floats(p.Sp, p.Dp, p.nb) * 4;
  p.W = int(kMaxSmem / per_warp < kMaxWarps ? kMaxSmem / per_warp : kMaxWarps);
  return p;
}

bool shapes_ok(const Params& p) {
  return p.B >= 1 && p.H >= 1 && p.N >= 1 && p.S >= 1 && p.D >= 1 && p.D <= kMaxDp &&
         p.Dp <= kMaxDp && p.Sp <= kMaxKeys && block_ok(p.bs) && p.k >= 1 && p.W >= 1;
}

// The workspace's arrays in order: their size in floats, and (base not
// null) their pointers into the workspace at base
size_t workspace_floats(Params& p, float* base) {
  const bool pred_on = p.pred >= 0 && p.pred != mElsa;
  const size_t cells = p.cells;
  size_t o = 0;
  auto take = [&](float*& ptr, size_t n, bool on) {
    ptr = on && base != nullptr ? base + o : nullptr;
    if (on) o += (n + 3) & ~size_t(3);
  };
  take(p.qx, cells * p.N * p.Dp, true);
  take(p.qa, cells * p.N * p.Dp, pred_on);
  take(p.qsc, cells * p.N * p.nb, p.int_route);
  take(p.qpw, cells * p.N * p.nb, p.pred == mExPred);
  take(p.kx, cells * p.Sp * p.Dp, true);
  take(p.ka, cells * p.Sp * p.Dp, pred_on);
  take(p.ksc, cells * p.Sp * p.nb, p.int_route);
  take(p.kpw, cells * p.Sp * p.nb, p.pred == mExPred);
  float* qh = nullptr;
  float* kh = nullptr;
  take(qh, cells * p.N * kHashWords, p.pred == mElsa);
  take(kh, cells * p.Sp * kHashWords, p.pred == mElsa);
  p.qh = reinterpret_cast<unsigned*>(qh);
  p.kh = reinterpret_cast<unsigned*>(kh);
  take(p.knorm, cells * p.Sp, p.pred == mElsa);
  take(p.vq, cells * p.Sp * p.D, true);
  take(p.vm, cells * p.Sp * p.D, p.int_route);
  take(p.vsc, cells * p.nkb * p.D, p.int_route);
  return o;
}

}  // namespace

// Bytes of the workspace a call needs (entry: 0 K2, 1 K7, 2 K3/K4); 0 for
// a call the kernel does not take (bs, D, S, k or warps).
extern "C" long long topk_attention_blocks_workspace_bytes(int entry, int B, int H, int N, int S,
                                                           int D, int bs, int topk, int approx,
                                                           int pred_mode, int ebits, int bits) {
  if (!block_ok(bs)) return 0;
  Params p = make_params(entry, B, H, N, S, D, bs, topk, approx, pred_mode, ebits, bits);
  if (!shapes_ok(p)) return 0;
  return (long long)workspace_floats(p, nullptr) * 4;
}

// Launch the pre-pass and the attention kernel on `stream`; returns the
// cudaError_t of the launches (0 = ok).  a, b, c: the entry's inputs (K2:
// qkv, -, -; K7: qk_t, v, -; K3/K4: q, k, v); Nin: tokens in the input
// (K2, K7), DpIn: K7's rows per head; S: valid keys (K7: n_valid); bias:
// (B, S) float32 or null; ELSA: proj (bits, D), cos_tab (bits + 1); ws:
// topk_attention_blocks_workspace_bytes, 16-byte aligned.
extern "C" int topk_attention_blocks(int entry, const void* a, const void* b, const void* c,
                                     const float* bias, const float* proj, const float* cos_tab,
                                     void* ws, void* out, int B, int H, int N, int S, int D,
                                     int Nin, int DpIn, int bs, int in_bf16, int out_bf16,
                                     int topk, float scale, int approx, int pred_mode,
                                     int key_bits, int relaxed, int bfloat16, int flush,
                                     int ebits, int mbits, int emax, float max_norm,
                                     int scale_bits, int bits, void* stream) {
  if (entry < kQkv || entry > kSplit || !block_ok(bs) || ws == nullptr ||
      (key_bits != 8 && key_bits != 16 && key_bits != 32) || pred_mode < 0 || pred_mode > mElsa)
    return int(cudaErrorInvalidValue);
  Params p = make_params(entry, B, H, N, S, D, bs, topk, approx, pred_mode, ebits, bits);
  if (!shapes_ok(p) || (p.pred == mElsa && (entry != kSplit || proj == nullptr ||
                                            cos_tab == nullptr || bits < 1 || bits > 128)))
    return int(cudaErrorInvalidValue);
  p.a = a;
  p.b = b;
  p.c = c;
  p.bias = bias;
  p.proj = proj;
  p.cos_tab = cos_tab;
  p.out = out;
  p.Nin = Nin;
  p.DpIn = DpIn;
  p.in_bf16 = in_bf16;
  p.out_bf16 = out_bf16;
  p.key_bits = key_bits;
  p.relaxed = relaxed;
  p.bfloat16 = bfloat16;
  p.shift = mbits - 2;
  p.scale = scale;
  p.fmt = make_fmt(ebits, mbits, emax, max_norm, scale_bits, flush);
  p.fmt4 = make_fmt(0, 4, 0, 0.f, scale_bits, flush);
  workspace_floats(p, static_cast<float*>(ws));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long side_rows = (long long)p.cells * (p.N + p.Sp);
  blocks_side_kernel<<<unsigned((side_rows + kMaxWarps - 1) / kMaxWarps), kMaxWarps * 32, 0,
                       st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const long long vthreads = (long long)p.cells * p.nkb * p.D;
  blocks_v_kernel<<<unsigned((vthreads + 255) / 256), 256, 0, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const size_t smem = size_t(p.W) * warp_floats(p.Sp, p.Dp, p.nb) * 4;
  err = cudaFuncSetAttribute(blocks_attention_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const long long rows = (long long)p.cells * p.N;
  const long long per_block = (long long)p.W * kRowsPerWarp;
  blocks_attention_kernel<<<unsigned((rows + per_block - 1) / per_block), p.W * 32, smem,
                            st>>>(p);
  return int(cudaGetLastError());
}
