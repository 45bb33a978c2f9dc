// Kernel K8: the TPU attention-ablation tools' cell functions, one kernel
// switched by a pass word.  It replaces the eight pl.pallas_call sites of
// the repository's ablation tools, each a copy of the DiT top-k attention
// cell with static pass switches: tools/attnk_bench.py make (:119),
// make_i16 (:258), make_batched (:341) and make_trans (:464);
// tools/attnk3_bench.py make (:264); tools/servingk_bench.py make (:136)
// and probe_pretransposed (:250); tools/passprice_bench.py make (:182).
// The switches arrive as one 32-bit word at launch (the bits of
// ops/kernels/topk_ablate.py), the operand layout and the key form as two
// more arguments, so one nvcc build serves every variant.  The function,
// bit by bit, is the wrapper module's docstring; its plain version
// (ablate_attention_ref) sums in this kernel's orders, so the two agree bit
// for bit.
//
// What bounds it on the card: at the tools' point (256 cells of 256 x 256
// pairs, D = 72) the least time is set by the products on the tensor cores
// and the per-pair CUDA-core passes (a few microseconds; bytes ~0.01 ms).
// This kernel does not come near it: it is the simple design, right first
// and fast later (as the blocks kernel of K2/K3 at other MX blocks).
//   * A pre-pass quantizes each cell's q and k rows once into a workspace
//     (the q side row-major, the k side d-major so that lanes reading
//     consecutive keys read consecutive words), a second one v's 32-token
//     blocks per column.
//   * Where the k-th key is taken per key COLUMN (key forms col8 and
//     col16), a warp per (group of cells, key) computes that column's keys
//     over the group's query rows (from d-major copies of the q side that
//     the pre-pass writes for these forms) and bisects them first.
//   * The attention kernel gives each query row to one warp: lane l takes
//     keys l + 32 i for the scores, the k-th key by bisection on counts
//     over the row (or the column thresholds), the tie rank by ballots (or
//     a shuffle scan) in key order, the softmax (the sum as 32 strided sums
//     in a tree, K3's order), the probabilities' quantize per 32-key block
//     (a chunk of 32 keys is one block, one element per lane), and PV with
//     lanes over output columns.
//   * NOAT (quantized along the queries) is the one pass whose blocks cross
//     query rows: the attention kernel writes the probabilities to the
//     workspace and a last kernel, a warp per (cell, key column), takes
//     each 32-query block (one element per lane) and the transposed PV.
// Every block sum of integer grid points is exact in f32 in any order;
// every other sum is in the order above, with explicit __fmul_rn/__fadd_rn
// so that the compiler contracts nothing.  Build without --use_fast_math.

#include "mx_common.cuh"

namespace {

using namespace mx;

// the pass bits (ops/kernels/topk_ablate.py)
enum : unsigned {
  PREP = 1u << 0, MM = 1u << 1, VQ = 1u << 2, QKQ = 1u << 3, PRED = 1u << 4,
  SROUND = 1u << 5, SCL = 1u << 6, KEYS = 1u << 7, SEARCH = 1u << 8, SEL = 1u << 9,
  RANK = 1u << 10, MAX = 1u << 11, EXP = 1u << 12, DIV = 1u << 13, AROUND = 1u << 14,
  AQ = 1u << 15, OROUND = 1u << 16, LINEXP = 1u << 17, FSCALE = 1u << 18,
  BFSM = 1u << 19, NOAT = 1u << 20, FOLD = 1u << 21, VM = 1u << 22, MXC = 1u << 23,
  UNROLL = 1u << 24, V1 = 1u << 25, V3 = 1u << 26
};
constexpr unsigned kAllPasses = (1u << 27) - 1;

// the key forms (KEY_FORMS), numbered: 0 row8, 1 row8_9step, 2 row16_bf16,
// 3 col8, 4 col16; each one's key bits, bisection bracket and steps, and
// whether its k-th key is taken per key column
constexpr int kForms = 5;
__host__ __device__ inline int form_bits(int f) { return f == 2 || f == 4 ? 16 : 8; }
__host__ __device__ inline int form_lo(int f) {
  return f == 1 ? -129 : (form_bits(f) == 16 ? -32768 : -128);
}
__host__ __device__ inline int form_hi(int f) {
  return f == 1 ? 128 : (form_bits(f) == 16 ? 32767 : 127);
}
__host__ __device__ inline int form_steps(int f) { return f == 1 ? 9 : form_bits(f); }
__host__ __device__ inline bool form_column(int f) { return f >= 3; }

constexpr int kBlk = 32;
constexpr int kMaxTokens = 512;  // MAX_TOKENS
constexpr int kMaxDp = 128;      // MAX_HEAD_DIM
constexpr int kMaxGroup = 4;     // MAX_GROUP: make_batched's 4 cells
constexpr int kWarps = 8;        // warps a block of the attention kernel
constexpr int kRowsPerWarp = 4;  // query rows a warp takes in turn
constexpr int kColWarps = 4;     // warps a block of the column kernel
constexpr int kShift = 6;        // mbits - 2 of MXINT8
constexpr float kLin = 1.0009765625f;

struct Params {
  const unsigned short *q, *k, *v;  // bf16 bits
  unsigned short* out;              // bf16 bits (G, N, Dv)
  int G, N, Dqk, Dv, Dp, nb, nkb, layout, form, group, topk;
  unsigned w;
  float scale;
  Fmt fmt;
  // the workspace
  float *qx, *qsc, *qsg, *qpw;  // [G][N][Dp], [G][N][nb], [G][N][Dp], [G][N][nb]
  float *qxt, *qsct, *qsgt, *qpwt;  // the column forms' d-major copies [G][Dp or nb][N]
  float *kx, *ksc, *ksg, *kpw;  // [G][Dp][N], [G][nb][N], [G][Dp][N], [G][nb][N]
  float *vq, *vm, *vsc;         // [G][N][Dv] values, grid points; [G][nkb][Dv]
  int* colkth;                  // [G / group][N]
  float* probs;                 // NOAT: [G][N][N]
};

__device__ __forceinline__ float bf16_bits(unsigned short b) { return __uint_as_float(unsigned(b) << 16); }

__device__ __forceinline__ unsigned short bf16_out(float x) {
  const __nv_bfloat16 b = __float2bfloat16_rn(x);
  return *reinterpret_cast<const unsigned short*>(&b);
}

// element d of token t of q (s = 0) or k (s = 1) of a cell; 0 past Dqk
__device__ __forceinline__ float side_x(const Params& p, int s, int cell, int t, int d) {
  if (d >= p.Dqk) return 0.f;
  const unsigned short* base = s == 0 ? p.q : p.k;
  const size_t i = p.layout == 0 ? (size_t(cell) * p.N + t) * p.Dqk + d
                                 : (size_t(cell) * p.Dqk + d) * p.N + t;
  return bf16_bits(__ldg(base + i));
}

// ---- the q and k pre-pass: one thread per (side, cell, token, 32-d block)
__global__ void ablate_side_kernel(const Params p) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per_side = (long long)p.G * p.N * p.nb;
  if (tid >= 2 * per_side) return;
  const int s = int(tid / per_side);
  const long long r = tid % per_side;
  const int blk = int(r % p.nb);
  const int t = int((r / p.nb) % p.N);
  const int cell = int(r / ((long long)p.nb * p.N));
  const bool quant = p.w & QKQ, pred = (p.w & PRED) && quant;
  unsigned mb = 0u;
  if (quant)
    for (int i = 0; i < kBlk; ++i) mb = max(mb, mag_bits(side_x(p, s, cell, t, blk * kBlk + i)));
  const int e = shared_exp(mb, p.fmt);
  for (int i = 0; i < kBlk; ++i) {
    const int d = blk * kBlk + i;
    const float x = side_x(p, s, cell, t, d);
    float xv = x, sg = 0.f;
    if (quant) {
      const int n = quant_int(x, mb, e, p.fmt, false);
      xv = float(n);
      sg = d < p.Dqk ? (n < 0 ? -1.f : 1.f) : 0.f;
    }
    if (s == 0) {
      const size_t o = (size_t(cell) * p.N + t) * p.Dp + d;
      p.qx[o] = xv;
      if (pred) p.qsg[o] = sg;
      if (form_column(p.form)) {
        const size_t ot = (size_t(cell) * p.Dp + d) * p.N + t;
        p.qxt[ot] = xv;
        if (pred) p.qsgt[ot] = sg;
      }
    } else {
      const size_t o = (size_t(cell) * p.Dp + d) * p.N + t;
      p.kx[o] = xv;
      if (pred) p.ksg[o] = sg;
    }
  }
  if (!quant) return;
  const float sc = pow2_sub(e - kShift), pw = pow2f(min(max(e, -126), 127));
  if (s == 0) {
    const size_t o = (size_t(cell) * p.N + t) * p.nb + blk;
    p.qsc[o] = sc;
    if (pred) p.qpw[o] = pw;
    if (form_column(p.form)) {
      const size_t ot = (size_t(cell) * p.nb + blk) * p.N + t;
      p.qsct[ot] = sc;
      if (pred) p.qpwt[ot] = pw;
    }
  } else {
    const size_t o = (size_t(cell) * p.nb + blk) * p.N + t;
    p.ksc[o] = sc;
    if (pred) p.kpw[o] = pw;
  }
}

// ---- v: one thread per (cell, 32-token block, column)
__global__ void ablate_v_kernel(const Params p) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)p.G * p.nkb * p.Dv) return;
  const int col = int(tid % p.Dv);
  const int kb = int((tid / p.Dv) % p.nkb);
  const int cell = int(tid / ((long long)p.Dv * p.nkb));
  const unsigned short* vc = p.v + size_t(cell) * p.N * p.Dv + col;
  unsigned mb = 0u;
  for (int j = 0; j < kBlk; ++j) mb = max(mb, mag_bits(bf16_bits(__ldg(vc + size_t(kb * kBlk + j) * p.Dv))));
  const int e = shared_exp(mb, p.fmt);
  const float sc = pow2_sub(e - kShift);
  for (int j = 0; j < kBlk; ++j) {
    const int t = kb * kBlk + j;
    const float x = bf16_bits(__ldg(vc + size_t(t) * p.Dv));
    const size_t o = (size_t(cell) * p.N + t) * p.Dv + col;
    if (p.w & VQ) {
      const float m = float(quant_int(x, mb, e, p.fmt, false));
      p.vm[o] = m;
      p.vq[o] = __fmul_rn(m, sc);
    } else {
      p.vq[o] = x;
    }
  }
  if (p.w & VQ) p.vsc[(size_t(cell) * p.nkb + kb) * p.Dv + col] = sc;
}

// The true score of key j against a q row (qx, qsc: the row's arrays in
// shared memory, qs = 1, or a column of the d-major copies, qs = N): each
// 32-d block's products in d order from +0 (exact for the grid points,
// then times q's and k's powers of two), the blocks in order
__device__ __forceinline__ float raw_score(const Params& p, const float* qx, const float* qsc,
                                           int qs, int cell, int j) {
  float acc = 0.f;
  for (int blk = 0; blk < p.nb; ++blk) {
    float s = 0.f;
    for (int i = 0; i < kBlk; ++i) {
      const int d = blk * kBlk + i;
      s = __fadd_rn(s, __fmul_rn(qx[d * qs], __ldg(p.kx + (size_t(cell) * p.Dp + d) * p.N + j)));
    }
    if (p.w & QKQ)
      s = __fmul_rn(__fmul_rn(s, qsc[blk * qs]),
                    __ldg(p.ksc + (size_t(cell) * p.nb + blk) * p.N + j));
    acc = blk ? __fadd_rn(acc, s) : s;
  }
  return acc;
}

// ex_pred: per block the count of equal signs less unequal ones (padded d
// 0) times 2^eq * 2^ek, the blocks in order
__device__ __forceinline__ float pred_score(const Params& p, const float* qsg, const float* qpw,
                                            int qs, int cell, int j) {
  float acc = 0.f;
  for (int blk = 0; blk < p.nb; ++blk) {
    float c = 0.f;  // an integer of at most 32
    for (int i = 0; i < kBlk; ++i) {
      const int d = blk * kBlk + i;
      c = __fadd_rn(c, __fmul_rn(qsg[d * qs], __ldg(p.ksg + (size_t(cell) * p.Dp + d) * p.N + j)));
    }
    const float s = __fmul_rn(
        c, __fmul_rn(qpw[blk * qs], __ldg(p.kpw + (size_t(cell) * p.nb + blk) * p.N + j)));
    acc = blk ? __fadd_rn(acc, s) : s;
  }
  return acc;
}

// The scaled true score (st) and the selection score of key j
__device__ __forceinline__ void scores(const Params& p, const float* qx, const float* qsc,
                                       const float* qsg, const float* qpw, int qs, int cell,
                                       int j, float& st, float& ssel) {
  const float raw = raw_score(p, qx, qsc, qs, cell, j);
  st = (p.w & SROUND) ? bf16_round_away(raw) : raw;
  if (p.w & SCL) st = __fmul_rn(st, p.scale);
  ssel = !(p.w & PRED) ? st : ((p.w & QKQ) ? pred_score(p, qsg, qpw, qs, cell, j) : raw);
}

// The selection key of a score in the key form (VM: the 8-bit h-form
// spelled with constants)
__device__ __forceinline__ int sel_key(const Params& p, float s) {
  if (p.form == 2) return mono_key(bf16_rne(s), 16);
  if (form_bits(p.form) == 16) return mono_key(s, 16);
  if (p.w & VM) {
    const int h = __float_as_int(s) >> 24;
    return h >= 0 ? h : -129 - h;
  }
  return mono_key(s, 8);
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

__device__ __forceinline__ float warp_fsum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// Keys of a warp's array (int, or float with V1) greater than mid
__device__ __forceinline__ int count_gt(const Params& p, const int* keys, const float* fkeys,
                                        int n, int mid) {
  const int lane = threadIdx.x & 31;
  if (p.w & MXC) {  // float sums of indicators
    float c = 0.f;
    for (int j = lane; j < n; j += 32)
      c = __fadd_rn(c, ((p.w & V1) ? fkeys[j] > float(mid) : keys[j] > mid) ? 1.f : 0.f);
    return int(warp_fsum(c));
  }
  int c = 0;
  for (int j = lane; j < n; j += 32) c += (p.w & V1) ? fkeys[j] > float(mid) : keys[j] > mid;
  return warp_sum(c);
}

// The k-th largest of n keys by the form's bisection; n_gt the count of
// greater keys (the search's carry)
template <int STEPS>
__device__ __forceinline__ int bisect_fixed(const Params& p, const int* keys, const float* fkeys,
                                            int n, int& n_gt) {
  int lo = form_lo(p.form), hi = form_hi(p.form);
  n_gt = 0;
#pragma unroll
  for (int it = 0; it < STEPS; ++it) {
    const int mid = lo + ((hi - lo) >> 1);
    const int c = count_gt(p, keys, fkeys, n, mid);
    if (c >= p.topk) lo = mid + 1;
    else { hi = mid; n_gt = c; }
  }
  return lo;
}

__device__ int bisect(const Params& p, const int* keys, const float* fkeys, int n, int& n_gt) {
  if (p.w & UNROLL) {
    const int steps = form_steps(p.form);
    if (steps == 8) return bisect_fixed<8>(p, keys, fkeys, n, n_gt);
    if (steps == 9) return bisect_fixed<9>(p, keys, fkeys, n, n_gt);
    return bisect_fixed<16>(p, keys, fkeys, n, n_gt);
  }
  int lo = form_lo(p.form), hi = form_hi(p.form);
  n_gt = 0;
#pragma unroll 1
  for (int it = 0; it < form_steps(p.form); ++it) {
    const int mid = lo + ((hi - lo) >> 1);
    const int c = count_gt(p, keys, fkeys, n, mid);
    if (c >= p.topk) lo = mid + 1;
    else { hi = mid; n_gt = c; }
  }
  return lo;
}

// ---- the column thresholds (col8, col16): a warp per (group, key j)
// bisects key j's keys over the group's query rows
__global__ void __launch_bounds__(kColWarps * 32) ablate_column_kernel(Params p) {
  extern __shared__ float4 csm4[];
  p.w &= ~V1;  // int keys here (V1 changes the rows' compares only)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int R = p.group * p.N;
  int* keys = reinterpret_cast<int*>(csm4) + size_t(warp) * R;
  const long long col = (long long)blockIdx.x * kColWarps + warp;
  if (col >= (long long)(p.G / p.group) * p.N) return;
  const int g = int(col / p.N), j = int(col % p.N);
  for (int r = lane; r < R; r += 32) {
    const int cell = g * p.group + r / p.N, i = r % p.N;
    const size_t dcol = size_t(cell) * p.Dp * p.N + i, bcol = size_t(cell) * p.nb * p.N + i;
    float st, ssel;
    scores(p, p.qxt + dcol, p.qsct + bcol, p.qsgt + dcol, p.qpwt + bcol, p.N, cell, j, st,
           ssel);
    keys[r] = sel_key(p, ssel);
  }
  __syncwarp();
  int n_gt;
  const int kth = bisect(p, keys, reinterpret_cast<const float*>(keys), R, n_gt);
  if (lane == 0) p.colkth[size_t(g) * p.N + j] = kth;
}

// A warp's shared memory in floats: the row's scores (then probabilities),
// keys (int), keys as floats (V1), the selection bits, the q row's arrays
// and the probabilities' block multipliers
__host__ __device__ inline size_t warp_floats(int N, int Dp, int nb) {
  return size_t(3) * N + N / 32 + 2 * size_t(Dp) + 2 * size_t(nb) + N / 32;
}

// ---- attention: a warp per query row
__global__ void __launch_bounds__(kWarps * 32) ablate_attention_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* st = reinterpret_cast<float*>(smem4) + size_t(warp) * warp_floats(p.N, p.Dp, p.nb);
  int* keys = reinterpret_cast<int*>(st + p.N);
  float* fkeys = st + 2 * p.N;
  unsigned* selb = reinterpret_cast<unsigned*>(st + 3 * p.N);
  float* qx = st + 3 * p.N + p.N / 32;
  float* qsg = qx + p.Dp;
  float* qsc = qsg + p.Dp;
  float* qpw = qsc + p.nb;
  float* psc = qpw + p.nb;
  const unsigned w = p.w;
  const long long rows = (long long)p.G * p.N;
  const int form = p.form;
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const long long row = ((long long)blockIdx.x * kWarps + warp) * kRowsPerWarp + rr;
    if (row >= rows) return;  // uniform over the warp
    const int cell = int(row / p.N);
    unsigned short* orow = p.out + size_t(row) * p.Dv;
    if (!(w & MM)) {  // the output is v
      for (int col = lane; col < p.Dv; col += 32) orow[col] = __ldg(p.v + size_t(row) * p.Dv + col);
      continue;
    }
    for (int d = lane; d < p.Dp; d += 32) {
      qx[d] = p.qx[size_t(row) * p.Dp + d];
      if ((w & PRED) && (w & QKQ)) qsg[d] = p.qsg[size_t(row) * p.Dp + d];
    }
    for (int b = lane; b < p.nb; b += 32) {
      if (w & QKQ) qsc[b] = p.qsc[size_t(row) * p.nb + b];
      if ((w & PRED) && (w & QKQ)) qpw[b] = p.qpw[size_t(row) * p.nb + b];
    }
    __syncwarp();
    // scores and keys
    for (int j = lane; j < p.N; j += 32) {
      float s, ssel;
      scores(p, qx, qsc, qsg, qpw, 1, cell, j, s, ssel);
      st[j] = s;
      if (w & KEYS) {
        const int key = sel_key(p, ssel);
        keys[j] = key;
        if (w & V1) fkeys[j] = float(key);
      }
    }
    __syncwarp();
    // the k-th key (per row or per key column) and the count of greater keys
    int kth = 0, n_gt = 0;
    const int* ckth = nullptr;
    if ((w & KEYS) && (w & SEARCH)) {
      if (form_column(form)) {
        ckth = p.colkth + size_t(cell / p.group) * p.N;
        int c = 0;
        for (int j = lane; j < p.N; j += 32) c += keys[j] > __ldg(ckth + j);
        n_gt = warp_sum(c);
      } else {
        kth = bisect(p, keys, fkeys, p.N, n_gt);
      }
    }
    // the selection, the masked scores and their maximum
    const bool bfsm = w & BFSM;
    const float neg = bfsm ? bf16_rne(kNeg) : kNeg;
    float m = kNeg;
    int ties = 0;  // ties of lower keys, in key order
    for (int j0 = 0; j0 < p.N; j0 += 32) {
      const int j = j0 + lane;
      bool sel = true;
      if (w & SEL) {
        const int kj = ckth != nullptr ? __ldg(ckth + j) : kth;
        const bool v1 = w & V1;
        const bool gt = v1 ? fkeys[j] > float(kj) : keys[j] > kj;
        const bool eq = v1 ? fkeys[j] == float(kj) : keys[j] == kj;
        if (w & RANK) {
          int rank;
          if (w & V3) {  // inclusive scan of eq by shuffles
            int x = eq;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
              const int y = __shfl_up_sync(kFull, x, o);
              if (lane >= o) x += y;
            }
            rank = ties + x;
            ties += __shfl_sync(kFull, x, 31);
          } else {  // ballots
            const unsigned eqb = __ballot_sync(kFull, eq);
            rank = ties + __popc(eqb & (0xffffffffu >> (31 - lane)));
            ties += __popc(eqb);
          }
          sel = gt || (eq && rank <= p.topk - n_gt);
        } else {
          sel = gt || eq;
        }
      }
      const unsigned sb = __ballot_sync(kFull, sel);
      if (lane == 0) selb[j0 >> 5] = sb;
      if (w & MAX) {
        const float ms = sel ? (bfsm ? bf16_rne(st[j]) : st[j]) : neg;
        st[j] = ms;
        m = fmaxf(m, ms);
      }
    }
    if (w & MAX) m = warp_max(m);
    __syncwarp();
    // the softmax's elementwise steps
    const float bscale = bf16_rne(p.scale);
    for (int j = lane; j < p.N; j += 32) {
      const bool sel = selb[j >> 5] >> (j & 31) & 1u;
      float x = st[j];
      if (bfsm) {
        x = bf16_rne(__fsub_rn(x, m));
        if (w & FSCALE) x = bf16_rne(__fmul_rn(x, bscale));
        x = expf(x);
      } else {
        if (w & MAX) x = __fsub_rn(x, m);
        if (w & FSCALE) x = __fmul_rn(x, p.scale);
        if (w & EXP) x = expf(x);
        else if (w & LINEXP) x = sel ? __fmul_rn(x, kLin) : 0.f;
      }
      st[j] = x;
    }
    __syncwarp();
    if (w & DIV) {  // lane_sum: lane l adds keys l + 32 i, then a tree
      float sum = st[lane];
      for (int j = lane + 32; j < p.N; j += 32) sum = __fadd_rn(sum, st[j]);
      for (int o = 16; o > 0; o >>= 1) sum = __fadd_rn(sum, __shfl_down_sync(kFull, sum, o));
      sum = __shfl_sync(kFull, sum, 0);
      if (bfsm) sum = bf16_rne(sum);
      __syncwarp();
      for (int j = lane; j < p.N; j += 32)
        st[j] = __fdiv_rn(bfsm ? bf16_rne(st[j]) : st[j], sum);
    }
    if (w & AROUND)
      for (int j = lane; j < p.N; j += 32) st[j] = bf16_round_away(st[j]);
    __syncwarp();
    if (w & NOAT) {  // the probabilities wait for the transposed PV
      for (int j = lane; j < p.N; j += 32) p.probs[size_t(row) * p.N + j] = st[j];
      continue;
    }
    // the probabilities as PV takes them: per 32-key block (a chunk, one
    // element per lane) their grid points and the block's multiplier, or
    // the bf16 cast (BFSM: the f32 quotient)
    for (int kb = 0; kb < p.nkb; ++kb) {
      const int j = kb * kBlk + lane;
      const float x = st[j];
      if (w & AQ) {
        if (w & FOLD) {  // attnk3 v4: int max of the bits, folded constants
          const int mb = __reduce_max_sync(kFull, __float_as_int(x));
          const int e8 = min(max((mb >> 23) - 127, -127), 127);
          const float c1 = __uint_as_float(unsigned(133 - e8) << 23);
          const float c2 = __uint_as_float(unsigned(e8 + 121) << 23);
          const float t = floorf(__fadd_rn(__fmul_rn(x, c1), 0.5f));
          st[j] = isnan(t) ? t : fminf(t, 127.f);
          if (lane == 0) psc[kb] = c2;
        } else {
          const unsigned mb = __reduce_max_sync(kFull, mag_bits(x));
          const int e = shared_exp(mb, p.fmt);
          st[j] = float(quant_int(x, mb, e, p.fmt, true));
          if (lane == 0) psc[kb] = pow2_sub(e - kShift);
        }
      } else if (!bfsm) {
        st[j] = bf16_rne(x);
      }
    }
    __syncwarp();
    // PV, lanes over the output columns
    for (int col = lane; col < p.Dv; col += 32) {
      float o = 0.f;
      if (w & AQ) {
        const float* vm = p.vm + size_t(cell) * p.N * p.Dv + col;
        for (int kb = 0; kb < p.nkb; ++kb) {
          float s = 0.f;
          for (int i = 0; i < kBlk; ++i) {
            const int j = kb * kBlk + i;
            s = __fadd_rn(s, __fmul_rn(st[j], __ldg(vm + size_t(j) * p.Dv)));
          }
          s = __fmul_rn(__fmul_rn(s, psc[kb]), __ldg(p.vsc + (size_t(cell) * p.nkb + kb) * p.Dv + col));
          o = kb ? __fadd_rn(o, s) : s;
        }
      } else {
        const float* vq = p.vq + size_t(cell) * p.N * p.Dv + col;
        for (int j = 0; j < p.N; ++j) o = __fadd_rn(o, __fmul_rn(st[j], __ldg(vq + size_t(j) * p.Dv)));
      }
      if (w & OROUND) o = bf16_round_away(o);
      orow[col] = bf16_out(o);
    }
    __syncwarp();
  }
}

// ---- NOAT: a warp per (cell, key column j): each 32-query block of
// column j quantized (one element per lane), times v's block per output
// column (an exact sum of grid points), the blocks in order
__global__ void __launch_bounds__(kWarps * 32) ablate_noat_kernel(const Params p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long colid = (long long)blockIdx.x * kWarps + warp;
  if (colid >= (long long)p.G * p.N) return;
  const int cell = int(colid / p.N), j = int(colid % p.N);
  float acc[kMaxDp / 32];
  for (int c = 0; c < kMaxDp / 32; ++c) acc[c] = 0.f;
  for (int ib = 0; ib < p.nkb; ++ib) {
    const int i = ib * kBlk + lane;
    const float a = p.probs[(size_t(cell) * p.N + i) * p.N + j];
    const unsigned mb = __reduce_max_sync(kFull, mag_bits(a));
    const int e = shared_exp(mb, p.fmt);
    const float pm = float(quant_int(a, mb, e, p.fmt, true));
    const float sc = pow2_sub(e - kShift);
    const float* vm = p.vm + (size_t(cell) * p.N + i) * p.Dv;
    for (int col = 0; col < p.Dv; ++col) {
      const float s = warp_fsum(__fmul_rn(pm, __ldg(vm + col)));  // exact
      if ((col & 31) == lane) {
        const float t = __fmul_rn(__fmul_rn(s, sc), __ldg(p.vsc + (size_t(cell) * p.nkb + ib) * p.Dv + col));
        acc[col >> 5] = ib ? __fadd_rn(acc[col >> 5], t) : t;
      }
    }
  }
  for (int col = lane; col < p.Dv; col += 32) {
    float o = acc[col >> 5];
    if (p.w & OROUND) o = bf16_round_away(o);
    p.out[(size_t(cell) * p.N + j) * p.Dv + col] = bf16_out(o);
  }
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

Params make_params(int G, int N, int Dqk, int Dv, int layout, unsigned passes, int form,
                   int group, int topk) {
  Params p = {};
  p.G = G;
  p.N = N;
  p.Dqk = Dqk;
  p.Dv = Dv;
  p.Dp = round_up(Dqk, kBlk);
  p.nb = p.Dp / kBlk;
  p.nkb = N / kBlk;
  p.layout = layout;
  p.w = passes;
  p.form = form;
  p.group = group;
  p.topk = topk;
  return p;
}

bool shapes_ok(const Params& p) {
  return p.G >= 1 && p.N >= kBlk && p.N <= kMaxTokens && p.N % kBlk == 0 && p.Dqk >= 1 &&
         p.Dp <= kMaxDp && p.Dv >= 1 && p.Dv <= kMaxDp && (p.layout == 0 || p.layout == 1) &&
         (p.layout == 1 || p.Dqk == p.Dv) && p.form >= 0 && p.form < kForms &&
         p.group >= 1 && p.group <= kMaxGroup && p.G % p.group == 0 &&
         (p.group == 1 || form_column(p.form)) && p.topk >= 1 && p.topk <= p.N &&
         (p.w & ~kAllPasses) == 0;
}

// the workspace's arrays in order: their size in floats, and (base not
// null) their pointers at base
size_t workspace_floats(Params& p, float* base) {
  size_t o = 0;
  auto take = [&](float*& ptr, size_t n) {
    ptr = base != nullptr ? base + o : nullptr;
    o += (n + 3) & ~size_t(3);
  };
  const size_t G = p.G, N = p.N, Dp = p.Dp, nb = p.nb;
  take(p.qx, G * N * Dp);
  take(p.qsc, G * N * nb);
  take(p.qsg, G * N * Dp);
  take(p.qpw, G * N * nb);
  take(p.qxt, G * Dp * N);
  take(p.qsct, G * nb * N);
  take(p.qsgt, G * Dp * N);
  take(p.qpwt, G * nb * N);
  take(p.kx, G * Dp * N);
  take(p.ksc, G * nb * N);
  take(p.ksg, G * Dp * N);
  take(p.kpw, G * nb * N);
  take(p.vq, G * N * p.Dv);
  take(p.vm, G * N * p.Dv);
  take(p.vsc, G * p.nkb * p.Dv);
  float* ck = nullptr;
  take(ck, (G / p.group) * N);
  p.colkth = reinterpret_cast<int*>(ck);
  if (p.w & NOAT) take(p.probs, G * N * N);
  else p.probs = nullptr;
  return o;
}

}  // namespace

// Bytes of the workspace a call needs; 0 for a call the kernel does not
// take (shapes, key form, group, k or pass bits).
extern "C" long long topk_ablate_workspace_bytes(int G, int N, int Dqk, int Dv, int layout,
                                                 unsigned passes, int form, int group, int topk) {
  Params p = make_params(G, N, Dqk, Dv, layout, passes, form, group, topk);
  if (!shapes_ok(p)) return 0;
  return (long long)workspace_floats(p, nullptr) * 4;
}

// Launch the pre-passes, the column thresholds (column key forms), the
// attention kernel and (NOAT) the transposed PV on `stream`; returns the
// cudaError_t of the launches (0 = ok).  q, k: bf16 (G, N, Dqk) (layout 0)
// or (G, Dqk, N) (layout 1); v bf16 (G, N, Dv); out bf16 (G, N, Dv); ws:
// topk_ablate_workspace_bytes, 16-byte aligned.
extern "C" int topk_ablate(const void* q, const void* k, const void* v, void* ws, void* out, int G,
                           int N, int Dqk, int Dv, int layout, unsigned passes, int form,
                           int group, int topk, float scale, void* stream) {
  Params p = make_params(G, N, Dqk, Dv, layout, passes, form, group, topk);
  if (!shapes_ok(p) || ws == nullptr || q == nullptr || k == nullptr || v == nullptr ||
      out == nullptr)
    return int(cudaErrorInvalidValue);
  p.q = static_cast<const unsigned short*>(q);
  p.k = static_cast<const unsigned short*>(k);
  p.v = static_cast<const unsigned short*>(v);
  p.out = static_cast<unsigned short*>(out);
  p.scale = scale;
  p.fmt = make_fmt(0, 8, 0, 0.f, 8, 0);
  workspace_floats(p, static_cast<float*>(ws));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p.w & PREP) {
    const long long n = 2ll * p.G * p.N * p.nb;
    ablate_side_kernel<<<unsigned((n + 255) / 256), 256, 0, st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  }
  if (p.w & MM) {
    const long long n = (long long)p.G * p.nkb * p.Dv;
    ablate_v_kernel<<<unsigned((n + 255) / 256), 256, 0, st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  }
  if ((p.w & MM) && (p.w & KEYS) && (p.w & SEARCH) && form_column(p.form)) {
    const size_t smem = size_t(kColWarps) * p.group * p.N * 4;
    err = cudaFuncSetAttribute(ablate_column_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
    if (err != cudaSuccess) return int(err);
    const long long cols = (long long)(p.G / p.group) * p.N;
    ablate_column_kernel<<<unsigned((cols + kColWarps - 1) / kColWarps), kColWarps * 32, smem,
                           st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  }
  const size_t smem = size_t(kWarps) * warp_floats(p.N, p.Dp, p.nb) * 4;
  err = cudaFuncSetAttribute(ablate_attention_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const long long rows = (long long)p.G * p.N;
  const long long per_block = (long long)kWarps * kRowsPerWarp;
  ablate_attention_kernel<<<unsigned((rows + per_block - 1) / per_block), kWarps * 32, smem,
                            st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  if (p.w & NOAT) {
    const long long cols = (long long)p.G * p.N;
    ablate_noat_kernel<<<unsigned((cols + kWarps - 1) / kWarps), kWarps * 32, 0, st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  }
  return 0;
}
