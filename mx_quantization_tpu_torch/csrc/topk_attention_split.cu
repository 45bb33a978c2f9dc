// Kernel K3: MX top-k attention from split q (B, H, N, D) and k, v
// (B, H, S, D), with an optional key bias (B, S) -> (B, H, N, D).
//
// Replaces the TPU kernel mx_quantization_tpu/ops/kernels/topk_attention.py
// fused_topk_attention -> _split_impl, short path (N, S <= 512; body
// _topk_attn_kernel -> _one_cell, with _prep_side, _quant_axis0,
// _quant_axis0_pos, _exp_sign_approx, _two_step_approx, _kth_keys,
// _mono_keys(_top), _score_select_output, _bf16_round).  Predictors: none
// (selection by the true scores), ex_pred and two_step_leading_ones.
//
// What bounds it on the card: at PixArt-alpha 256^2's self-attention
// (200 rows x 16 heads, N = S = 256, D = 72, f32 in and out) it reads q, k,
// v and writes the output once, 944 MB, about 0.28 ms at 3.35 TB/s; the
// score, predictor and PV products come to about 70 GFLOP (0.07 ms on the
// bf16 tensor cores), so bytes set the bound, as they do for the
// cross-attention (S = 120).  Between the products sits per-element work
// over the (N, S) scores: bisection for the k-th key, tie rank, softmax,
// requantize.  This first design does its products on the CUDA cores in
// f32, in a fixed order, and so stays far from either bound; tensor cores
// are later work.
//
// Design.  One block of 16 warps per (batch row, head, query tile of
// 16 * ROWS rows): rows are independent, so tiling queries puts enough
// blocks on the card for any batch.  The block MX-quantizes its q rows
// along D into shared memory as bf16 (exact for every grid the kernel
// serves).  The K side does not fit whole: at S = 512, D = 96 the
// quantized k, its predictor operand and v would take 264 KB, over the
// 227 KB a block may use.  So the keys are staged in chunks of up to 256:
// each chunk's k (transposed, bf16) and predictor data go to shared memory,
// every warp scores its rows against the chunk into registers, and the next
// chunk replaces it; after the selection the v chunks are staged the same
// way (in the same space) for the PV product.  Lane l owns keys l + 32 j,
// as in K2, so
//   * a bisection count is a __ballot_sync plus __popc per j (a warp runs
//     its rows' bisections side by side, so their chains overlap),
//   * the exact tier's lowest-index-first tie rank is a popcount of the
//     lower lanes plus a running total over j,
//   * each 32-key block of the probability requantize is one warp
//     reduction.
// The two_step operand sign * e * (2^l1 + 2^l2) / 64 (e the block exponent
// itself) is per element, so it is staged beside k as bf16 and its scores
// are an f32 dot over d in index order.  ex_pred's operand is sign * 2^e,
// so its scores are exact per MX block: (equal - unequal signs) * 2^eq *
// 2^ek, the blocks added in order.
//
// The bias goes onto the scaled true scores and onto the predictor scores,
// before the padded keys are masked to -3e38.  Flush zeroes q, k, v and
// probability blocks whose maximum is f32-subnormal.
//
// Summation orders are fixed so that the plain version
// (ops/kernels/topk_attention.py fused_topk_attention_ref) reproduces them:
// the true score, the two_step score and the PV product sum in index order
// by fused multiply-adds (a product of two bf16 values is exact in f32, so
// each rounds like a separate add), and the softmax sum adds each lane's
// keys in j order and then the lanes by an xor butterfly.  Build without
// --use_fast_math: subnormals are kept and expf is the precise one.
//
// Kernel K4, the long-sequence path of the same function (N or S over
// K3_MAX_TOKENS, S <= K4_MAX_KEYS), is the second kernel of this file.  It
// replaces _split_impl's query-tiled path (pallas_call of
// _topk_attn_kernel_tiled), which caches the quantized K side of a
// (row, head) cell in VMEM and walks query tiles of 256 rows over it.
//
// What bounds it on the card: at DiT-XL/2 512^2 (8 rows x 16 heads,
// N = S = 1024, D = 72, bf16 in and out) q, k, v and the output are 75 MB,
// 0.022 ms at 3.35 TB/s; the score and predictor products over the 134 M
// (query, key) pairs and PV are 42 GFLOP, 0.042 ms on the bf16 tensor
// cores, which sets the bound at the top-k sites (operations); finding
// each row's k-th key (one radix pass per pair at key_bits 8) and the
// softmax over the 154 keys a row keeps take about 0.006 ms on the CUDA
// cores.  Like K3 this first design runs its products on the CUDA cores in
// f32 in a fixed order, and bisects and normalizes over every key, so it
// stays far from the bound.
//
// Design.  Two things of K3's do not carry over.  (1) K3 keeps every
// row's scores for all keys in registers (S / 32 per lane per row); at
// S = 4096 that would be 256 per row.  (2) A (row, head) cell's quantized
// K side does not fit a block either (at S = 1024, D = 96 the bf16 k, its
// two_step operand and v are 528 KB).  So one block of 16 warps (8 where a
// tile of 8 rows is all that fits) takes a query tile of up to 64 rows and
// streams the keys in chunks of 128, re-quantizing each chunk as K3 does
// (chunks start on 32-key boundaries, so v's MX blocks are unchanged);
// per (row, key) it keeps
//   * the scaled (rounded, biased) true score in a global scratch that the
//     wrapper allocates, (B*H, N padded to 64, S padded to 32) f32: a
//     block writes its rows once and reads them back while they are still
//     in L2;
//   * a slot in shared memory of 2 bytes (key_bits 8 and 16) or 4 (key_bits
//     32), which holds in turn the selection key, the selected flag and the
//     bf16 probability.
// Lane l owns keys l + 32 j throughout, as in K3, and reads back only what
// it wrote itself: the bisection is a ballot per j over the slots, the tie
// rank a popcount of the lower lanes plus a running total over j, and the
// selected set, of any size, is one flag per key.  The exact tier's dense
// branch needs each row's max and sum complete before any probability is
// formed (they are rounded and requantized after the normalization), so
// the softmax is three passes over the row (max, sum, probability) and
// never an online one.  The summation orders are K3's (scores in d order,
// the softmax sum per lane in j order then an xor butterfly, PV in key
// order), so K4 equals K3 bit for bit on shapes both take and shares its
// plain version.  Both kernels run one copy of the selection (select_topk)
// and of the softmax with the probabilities' requantize (softmax_row), over
// registers in K3 and over the slots and the scratch in K4.  K4 stages and
// scores its chunks and forms PV through device functions (score_chunk,
// stage_v_chunk, pv_chunk, store_rows) that repeat K3's inline code: K3
// through them ran 1-3% slower at PixArt-alpha 256^2's sites
// (mx_quantization_tpu_torch/tools/time_split_sites.py), so K3 keeps its
// own.

#include "mx_common.cuh"

// The longest key sequence and widest head the kernel takes come from the
// wrapper (MAX_SPLIT_TOKENS and MAX_HEAD_DIM in
// ops/kernels/topk_attention.py), which passes them to nvcc.
#ifndef K3_MAX_TOKENS
#error "build with -DK3_MAX_TOKENS=<n> (ops/kernels/build.py passes it)"
#endif
#ifndef K4_MAX_KEYS
#error "build with -DK4_MAX_KEYS=<n> (ops/kernels/build.py passes it)"
#endif
#ifndef MAX_HEAD_DIM
#error "build with -DMAX_HEAD_DIM=<n> (ops/kernels/build.py passes it)"
#endif

namespace {

using namespace mx;

constexpr int kWarps = 16;
constexpr int kChunk = 256;                    // keys staged at once
constexpr int kPrefetch = 8;                   // staging loads a warp keeps in flight
constexpr int kMaxDc = MAX_HEAD_DIM / kBlock;  // output columns per lane
static_assert(K3_MAX_TOKENS <= 16 * kBlock, "tile_shape covers at most 512 keys");

enum Pred { kNone = 0, kExPred = 1, kTwoStep = 2 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // (B, S) or null
  void* out;
  int B, H, N, S, D, Dp, nb, Sp, nj, kc, kstr, nchunks;
  float* scratch;  // K4: (B * H, Np, Sp) scaled true scores
  int Np, slot;    // K4: scratch rows per cell, bytes per (row, key) slot
  int in_bf16, out_bf16, topk, key_bits, relaxed, bfloat16;
  float scale;
  Fmt fmt;
};

struct Layout {  // byte offsets into the dynamic shared memory
  size_t qs, aq, qsgn, qpw, kT, akT, ksgn, kpw, bias, probs, total;
};

// K3 stages the bias row (Sp floats) and keeps each row's probabilities
// (slot = 2 bytes per key); K4 reads the bias from global memory and keeps
// a slot of `slot` bytes per (row, key): the key, then the flag, then the
// probability (see the K4 note below).
__host__ __device__ inline Layout make_layout(int qt, int Dp, int nb, int Sp, int kc,
                                              int kstr, int pred, int slot = 2,
                                              bool stage_bias = true) {
  Layout l;
  size_t o = 0;
  const bool two = pred == kTwoStep, ex = pred == kExPred;
  l.qs = o;    o = align16(o + size_t(qt) * Dp * 2);
  l.aq = o;    o = align16(o + (two ? size_t(qt) * Dp * 2 : 0));
  l.qsgn = o;  o = align16(o + (ex ? size_t(qt) * nb * 4 : 0));
  l.qpw = o;   o = align16(o + (ex ? size_t(qt) * nb * 4 : 0));
  l.kT = o;    o = align16(o + size_t(Dp) * kstr * 2);  // also the v chunk
  l.akT = o;   o = align16(o + (two ? size_t(Dp) * kstr * 2 : 0));
  l.ksgn = o;  o = align16(o + (ex ? size_t(kc) * nb * 4 : 0));
  l.kpw = o;   o = align16(o + (ex ? size_t(kc) * nb * 4 : 0));
  l.bias = o;  o = align16(o + (stage_bias ? size_t(Sp) * 4 : 0));
  l.probs = o; o = align16(o + size_t(qt) * Sp * slot);
  l.total = o;
  return l;
}

__device__ __forceinline__ float load_in(const void* base, int bf16, size_t idx) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(base)[idx])
              : static_cast<const float*>(base)[idx];
}

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

// MX-quantize one 32-element block held one element per lane (x, already
// rounded to bf16 where bfloat=16); returns the stored (bf16) value and the
// block's predictor exponent: the shared exponent for the int grids, the
// quantized block's own exponent for the MXFP grids.
__device__ __forceinline__ float quant_lane_block(float x, const Fmt& f, int& pexp) {
  const unsigned mb = __reduce_max_sync(kFull, __float_as_uint(x) & 0x7fffffffu);
  const int e = shared_exp(mb, f);
  const float val = quant_val(x, mb, e, f, false);
  pexp = f.ebits ? int(__reduce_max_sync(kFull, __float_as_uint(val) & 0x7fffffffu) >> 23) - 127
                 : e;
  return bf16_rne(val);
}

// MX-quantize `rows` rows (first .. first + rows, zero at and past `valid`)
// of a (rows, D) side along D into shared memory, one warp per (row, block):
// the values as bf16 at vals[r * rstride + d * dstride], and the predictor
// data (the two_step operands beside them, or ex_pred's sign masks and
// powers of two per block).  Each warp keeps kPrefetch loads in flight, so
// the loads' latency is paid once per kPrefetch blocks.
template <int PRED, int NW = kWarps>
__device__ __forceinline__ void stage_side(const Params& p, const void* src, size_t base,
                                           int first, int valid, int rows, int rstride,
                                           int dstride, __nv_bfloat16* vals,
                                           __nv_bfloat16* ops, unsigned* sgn, float* pw,
                                           int warp, int lane) {
  const int tasks = rows * p.nb;
  const bool round = p.bfloat16 && !p.in_bf16;
  for (int t0 = warp; t0 < tasks; t0 += NW * kPrefetch) {
    float xs[kPrefetch];
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const int t = t0 + u * NW;
      const int r = t / p.nb, d = (t - r * p.nb) * kBlock + lane;
      xs[u] = t < tasks && first + r < valid && d < p.D
                  ? load_in(src, p.in_bf16, base + size_t(first + r) * p.D + d)
                  : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const int t = t0 + u * NW;
      if (t >= tasks) break;  // warp-uniform
      const int r = t / p.nb, blk = t - r * p.nb, d = blk * kBlock + lane;
      int e;
      const float val = quant_lane_block(round ? bf16_round_away(xs[u]) : xs[u], p.fmt, e);
      const int at = r * rstride + d * dstride;
      vals[at] = __float2bfloat16_rn(val);
      if (PRED == kTwoStep) ops[at] = __float2bfloat16_rn(two_step_operand(val, e));
      if (PRED == kExPred) {
        const unsigned neg = __ballot_sync(kFull, val < 0.f);  // zeros count as +
        if (lane == 0) {
          sgn[r * p.nb + blk] = neg;
          pw[r * p.nb + blk] = pow2f(min(max(e, -126), 127));
        }
      }
    }
  }
}

// Calls f(j) for a lane's key columns j (keys lane + 32 j): a plain loop
// over j < p.nj where NJ is 0 (K4: the keys sit in shared memory); where
// they sit in registers (K3), unrolled over j < NJ, which passes the
// columns past p.nj too unless kGuard (their keys are the lowest, their
// scores masked).
template <int NJ, bool kGuard = true, class F>
__device__ __forceinline__ void each_key(const Params& p, const F& f) {
  if constexpr (NJ > 0) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (!kGuard || j < p.nj) f(j);
  } else {
    for (int j = 0; j < p.nj; ++j) f(j);
  }
}

// Select the keys of a warp's ROWS rows: key_at(r, j) is row r's selection
// key of key lane + 32 j, and put(r, j, sel) takes whether the key is kept.
// The k-th largest key by bisection, the rows side by side so that their
// chains of dependent ballots overlap (cnt_hi carries count(keys > hi));
// then the serving tier keeps every key >= the k-th, the exact tier the
// keys above it and then ties lowest index first up to k.
template <int NJ, int ROWS, class KeyAt, class Put>
__device__ __forceinline__ void select_topk(const Params& p, const KeyAt& key_at,
                                            const Put& put, int lane) {
  int lo0, hi0, iters;
  if (p.key_bits == 8) { lo0 = -128; hi0 = 127; iters = 8; }
  else if (p.key_bits == 16) { lo0 = -32768; hi0 = 32767; iters = 16; }
  else { lo0 = int(0x80000000); hi0 = 0x7fffffff; iters = 32; }
  int lo[ROWS], hi[ROWS], cnt_hi[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) { lo[r] = lo0; hi[r] = hi0; cnt_hi[r] = 0; }
  for (int it = 0; it < iters; ++it) {
    int mid[ROWS], c[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      mid[r] = lo[r] + int((unsigned(hi[r]) - unsigned(lo[r])) >> 1);
      c[r] = 0;
    }
    each_key<NJ>(p, [&](int j) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) c[r] += __popc(__ballot_sync(kFull, key_at(r, j) > mid[r]));
    });
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (c[r] >= p.topk) lo[r] = mid[r] + 1;
      else { hi[r] = mid[r]; cnt_hi[r] = c[r]; }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int kth = lo[r];
    if (p.relaxed) {
      each_key<NJ, false>(p, [&](int j) { put(r, j, key_at(r, j) >= kth); });
    } else {
      const int room = p.topk - cnt_hi[r];
      const unsigned le = (2u << lane) - 1u;
      int before = 0;
      each_key<NJ>(p, [&](int j) {
        const int key = key_at(r, j);
        const unsigned eqm = __ballot_sync(kFull, key == kth);
        const int rank = before + __popc(eqm & le);
        put(r, j, key > kth || (key == kth && rank <= room));
        before += __popc(eqm);
      });
    }
  }
}

// Scale (round, bias) the true scores st of a warp's ROWS query rows, and
// select each row's keys by its predictor scores pr (or its true scores).
template <int NJ, int ROWS, int PRED>
__device__ __forceinline__ void select_rows(const Params& p, float (&st)[ROWS][NJ],
                                            const float (&pr)[ROWS][NJ],
                                            const float* biasS, bool dense, int lane,
                                            bool (&sel)[ROWS][NJ]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < p.nj) {
        float s = st[r][j];
        if (p.bfloat16 && !p.relaxed) s = bf16_round_away(s);
        s = __fmul_rn(s, p.scale);
        if (p.bias) s = __fadd_rn(s, biasS[lane + 32 * j]);
        st[r][j] = s;
      }
    }

  if (dense) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int j = 0; j < NJ; ++j) sel[r][j] = lane + 32 * j < p.S;
    return;
  }
  int key[ROWS][NJ];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int s = lane + 32 * j;
      float v = kNeg;
      if (j < p.nj && s < p.S) {
        if (PRED != kNone) {
          v = pr[r][j];
          if (p.bias) v = __fadd_rn(v, biasS[s]);
        } else {
          v = st[r][j];
        }
      }
      key[r][j] = mono_key(v, p.key_bits);
    }
  select_topk<NJ, ROWS>(
      p, [&](int r, int j) { return key[r][j]; },
      [&](int r, int j, bool s) { sel[r][j] = s; }, lane);
}

// One probability as stored (bf16): in the exact tier rounded to bf16
// (bfloat 16) and MX-requantized in its 32-key block, one block per warp
// (all lanes call it together); in the serving tier the RNE cast.
__device__ __forceinline__ __nv_bfloat16 stored_prob(const Params& p, float a) {
  if (!p.relaxed) {
    if (p.bfloat16) a = bf16_round_away(a);
    const unsigned mb = __reduce_max_sync(kFull, __float_as_uint(a) & 0x7fffffffu);
    a = quant_val(a, mb, shared_exp(mb, p.fmt), p.fmt, true);
  }
  return __float2bfloat16_rn(a);
}

// The masked softmax of one query row: score_at(j) is the scaled score of
// key lane + 32 j, -3e38 where the key is not selected or past the row
// (exp gives +0 there); put(j, a) takes its stored probability.  The max
// and the sum are complete before any probability is formed; the sum adds
// each lane's keys in j order, then the lanes by an xor butterfly.  With
// the keys in registers (NJ > 0) the exps are kept for the division;
// otherwise they are formed again.
template <int NJ, class ScoreAt, class Put>
__device__ __forceinline__ void softmax_row(const Params& p, const ScoreAt& score_at,
                                            const Put& put) {
  float ev[NJ > 0 ? NJ : 1];
  float m = kNeg;
  each_key<NJ, false>(p, [&](int j) {
    const float x = score_at(j);
    if constexpr (NJ > 0) ev[j] = x;
    m = fmaxf(m, x);
  });
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  float sum = 0.f;
  each_key<NJ>(p, [&](int j) {
    float e;
    if constexpr (NJ > 0) e = ev[j] = expf(__fsub_rn(ev[j], m));
    else e = expf(__fsub_rn(score_at(j), m));
    sum = j == 0 ? e : __fadd_rn(sum, e);
  });
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(kFull, sum, off));
  each_key<NJ>(p, [&](int j) {
    float e;
    if constexpr (NJ > 0) e = ev[j];
    else e = expf(__fsub_rn(score_at(j), m));
    put(j, stored_prob(p, __fdiv_rn(e, sum)));
  });
}

// Short key sequences (NJ = 4) leave room in shared memory for two blocks
// per SM; the launch bound then caps the registers so that both fit.
template <int NJ, int ROWS, int PRED>
__global__ void __launch_bounds__(kWarps * 32, NJ <= 4 ? 2 : 1)
split_topk_attention_kernel(const Params p) {
  constexpr int QT = kWarps * ROWS;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(QT, p.Dp, p.nb, p.Sp, p.kc, p.kstr, PRED);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L.qs);    // [QT][Dp]
  __nv_bfloat16* aq = reinterpret_cast<__nv_bfloat16*>(smem + L.aq);    // [QT][Dp]
  unsigned* qsgn = reinterpret_cast<unsigned*>(smem + L.qsgn);          // [QT][nb]
  float* qpw = reinterpret_cast<float*>(smem + L.qpw);                  // [QT][nb]
  __nv_bfloat16* kT = reinterpret_cast<__nv_bfloat16*>(smem + L.kT);    // [Dp][kstr]
  __nv_bfloat16* vs = kT;                                               // [kc][D]
  __nv_bfloat16* akT = reinterpret_cast<__nv_bfloat16*>(smem + L.akT);  // [Dp][kstr]
  unsigned* ksgn = reinterpret_cast<unsigned*>(smem + L.ksgn);          // [kc][nb]
  float* kpw = reinterpret_cast<float*>(smem + L.kpw);                  // [kc][nb]
  float* biasS = reinterpret_cast<float*>(smem + L.bias);               // [Sp]
  __nv_bfloat16* probs = reinterpret_cast<__nv_bfloat16*>(smem + L.probs);  // [QT][Sp]

  const int tiles = (p.N + QT - 1) / QT;
  const int g = blockIdx.x / tiles, row0 = (blockIdx.x % tiles) * QT;
  const int b = g / p.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool round_inputs = p.bfloat16 && !p.in_bf16;  // for v
  const size_t qbase = size_t(g) * p.N * p.D, kbase = size_t(g) * p.S * p.D;

  for (int s = threadIdx.x; s < p.Sp; s += kWarps * 32)
    biasS[s] = (p.bias && s < p.S) ? p.bias[size_t(b) * p.S + s] : 0.f;

  // ---- q tile: MX-quantize along D, one warp per (row, block)
  stage_side<PRED>(p, p.q, qbase, row0, p.N, QT, p.Dp, 1, qs, aq, qsgn, qpw, warp, lane);

  // ---- scores, one key chunk at a time; each warp holds its ROWS rows
  const bool dense = p.topk >= p.S;
  float st[ROWS][NJ], pr[ROWS][NJ];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) { st[r][j] = 0.f; pr[r][j] = 0.f; }
  const int r0 = warp * ROWS;  // the warp's first row in the tile

  for (int c = 0; c < p.nchunks; ++c) {
    const int s0 = c * p.kc;
    const int ck = min(p.kc, p.Sp - s0);  // keys in this chunk (a multiple of 32)
    __syncthreads();  // the previous chunk is scored (and the q tile is in)
    stage_side<PRED>(p, p.k, kbase, s0, p.S, ck, 1, p.kstr, kT, akT, ksgn, kpw, warp, lane);
    __syncthreads();

    const int jlo = s0 / kBlock, jhi = jlo + ck / kBlock;
    // true (and two_step) scores, summed over d in index order
    for (int d = 0; d < p.D; ++d) {
      float qd[ROWS], ad[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        qd[r] = __bfloat162float(qs[(r0 + r) * p.Dp + d]);
        ad[r] = 0.f;
        if (PRED == kTwoStep) ad[r] = __bfloat162float(aq[(r0 + r) * p.Dp + d]);
      }
      const __nv_bfloat16* krow = kT + d * p.kstr + lane;
      const __nv_bfloat16* akrow = akT + d * p.kstr + lane;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j >= jlo && j < jhi) {
          const float kd = __bfloat162float(krow[32 * (j - jlo)]);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) st[r][j] = __fmaf_rn(qd[r], kd, st[r][j]);
          if (PRED == kTwoStep) {
            const float akd = __bfloat162float(akrow[32 * (j - jlo)]);
#pragma unroll
            for (int r = 0; r < ROWS; ++r) pr[r][j] = __fmaf_rn(ad[r], akd, pr[r][j]);
          }
        }
      }
    }
    if (PRED == kExPred && !dense) {
      // per block, (count of equal signs - unequal signs) * 2^eq * 2^ek;
      // blocks summed in order
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j >= jlo && j < jhi) {
          const int sl = lane + 32 * (j - jlo);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const int i = r0 + r;
            float v = 0.f;
            for (int blk = 0; blk < p.nb; ++blk) {
              const int nv = min(kBlock, p.D - kBlock * blk);
              const int cnt = nv - 2 * __popc(qsgn[i * p.nb + blk] ^ ksgn[sl * p.nb + blk]);
              const float term =
                  __fmul_rn(float(cnt), __fmul_rn(qpw[i * p.nb + blk], kpw[sl * p.nb + blk]));
              v = blk == 0 ? term : __fadd_rn(v, term);
            }
            pr[r][j] = v;
          }
        }
      }
    }
  }

  bool sel[ROWS][NJ];
  select_rows<NJ, ROWS, PRED>(p, st, pr, biasS, dense, lane, sel);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    __nv_bfloat16* prow = probs + (r0 + r) * p.Sp;
    softmax_row<NJ>(
        p, [&](int j) { return j < p.nj && sel[r][j] ? st[r][j] : kNeg; },
        [&](int j, __nv_bfloat16 a) { prow[lane + 32 * j] = a; });
  }

  // ---- PV, one v chunk at a time: lanes own output columns d = lane + 32 c
  float acc[ROWS][kMaxDc];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < kMaxDc; ++c) acc[r][c] = 0.f;
  const int groups = (p.D + kBlock - 1) / kBlock;
  for (int c = 0; c < p.nchunks; ++c) {
    const int s0 = c * p.kc;
    const int ck = min(p.kc, p.Sp - s0);
    __syncthreads();  // every warp is done with kT (or the previous v chunk)
    // v: MX-quantize along the keys, one lane per column, 32-key blocks
    for (int t = warp; t < (ck / kBlock) * groups; t += kWarps) {
      const int tb = t / groups, d = (t - tb * groups) * kBlock + lane;
      float xs[kBlock];
      unsigned mb = 0;
#pragma unroll
      for (int i = 0; i < kBlock; ++i) {
        const int s = s0 + tb * kBlock + i;
        float x = 0.f;
        if (s < p.S && d < p.D) {
          x = load_in(p.v, p.in_bf16, kbase + size_t(s) * p.D + d);
          if (round_inputs) x = bf16_round_away(x);
        }
        xs[i] = x;
        mb = max(mb, __float_as_uint(x) & 0x7fffffffu);
      }
      if (d < p.D) {
        const int e = shared_exp(mb, p.fmt);
#pragma unroll
        for (int i = 0; i < kBlock; ++i)
          vs[(tb * kBlock + i) * p.D + d] =
              __float2bfloat16_rn(quant_val(xs[i], mb, e, p.fmt, false));
      }
    }
    __syncthreads();
    const __nv_bfloat16* prow = probs + r0 * p.Sp + s0;
#pragma unroll 4
    for (int sl = 0; sl < ck; ++sl) {
      float a[ROWS];
      bool any = false;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        a[r] = __bfloat162float(prow[r * p.Sp + sl]);
        any = any || a[r] != 0.f;
      }
      if (!any) continue;  // adds +-0: skipping leaves every value unchanged
      const __nv_bfloat16* vrow = vs + sl * p.D;
#pragma unroll
      for (int cc = 0; cc < kMaxDc; ++cc) {
        const int d = lane + 32 * cc;
        if (d < p.D) {
          const float vd = __bfloat162float(vrow[d]);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) acc[r][cc] = __fmaf_rn(a[r], vd, acc[r][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int n = row0 + r0 + r;
    if (n >= p.N) break;
    const size_t orow = (size_t(g) * p.N + n) * p.D;
#pragma unroll
    for (int cc = 0; cc < kMaxDc; ++cc) {
      const int d = lane + 32 * cc;
      if (d < p.D) {
        float o = acc[r][cc];
        if (p.bfloat16 && !p.relaxed) o = bf16_round_away(o);
        if (p.out_bf16) static_cast<__nv_bfloat16*>(p.out)[orow + d] = __float2bfloat16_rn(o);
        else static_cast<float*>(p.out)[orow + d] = o;
      }
    }
  }
}

// The kernel's shape for Sp keys: keys per lane (NJ) and rows per warp.
inline void tile_shape(int Sp, int& nj_max, int& rows) {
  if (Sp <= 128) { nj_max = 4; rows = 4; }
  else if (Sp <= 256) { nj_max = 8; rows = 4; }
  else { nj_max = 16; rows = 2; }
}

inline int pred_kind(int approx, int pred_mode, int topk, int S) {
  if (topk >= S || !approx) return kNone;
  return pred_mode == 1 ? kTwoStep : kExPred;
}

// Launch `kern` with one block of `warps` warps per (batch row, head,
// query tile of warps * rows rows).
template <class Kernel>
cudaError_t start(Kernel kern, int warps, int rows, const Params& p, size_t smem,
                  cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (p.N + warps * rows - 1) / (warps * rows);
  kern<<<p.B * p.H * tiles, warps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int NJ, int ROWS>
cudaError_t launch_pred(const Params& p, int pred, size_t smem, cudaStream_t stream) {
  if (pred == kTwoStep)
    return start(split_topk_attention_kernel<NJ, ROWS, kTwoStep>, kWarps, ROWS, p, smem, stream);
  if (pred == kExPred)
    return start(split_topk_attention_kernel<NJ, ROWS, kExPred>, kWarps, ROWS, p, smem, stream);
  return start(split_topk_attention_kernel<NJ, ROWS, kNone>, kWarps, ROWS, p, smem, stream);
}

// ---------------------------------------------------------------------------
// Kernel K4: the query-tiled long-sequence path (N or S over K3_MAX_TOKENS,
// S <= K4_MAX_KEYS).  See the note at the top of the file.

constexpr int kChunk4 = 128;      // keys staged at once
constexpr int kMaxSmem = 232448;  // the dynamic shared memory a block may use
constexpr int kMaxTileRows = 64;  // the largest query tile; the scratch's row padding

// K4's steps over one key chunk: the v staging, the scores and PV are the
// loops K3's kernel runs inline (K3 through these functions ran 1-3%
// slower), over columns of the chunk rather than of the whole row.

// MX-quantize the v chunk of keys s0 .. s0 + ck along the keys (32-key
// blocks per column, one lane per column) into vs[(s - s0) * D + d], bf16.
template <int NW>
__device__ __forceinline__ void stage_v_chunk(const Params& p, size_t kbase, int s0, int ck,
                                              __nv_bfloat16* vs, int warp, int lane) {
  const bool round_inputs = p.bfloat16 && !p.in_bf16;
  const int groups = (p.D + kBlock - 1) / kBlock;
  for (int t = warp; t < (ck / kBlock) * groups; t += NW) {
    const int tb = t / groups, d = (t - tb * groups) * kBlock + lane;
    float xs[kBlock];
    unsigned mb = 0;
#pragma unroll
    for (int i = 0; i < kBlock; ++i) {
      const int s = s0 + tb * kBlock + i;
      float x = 0.f;
      if (s < p.S && d < p.D) {
        x = load_in(p.v, p.in_bf16, kbase + size_t(s) * p.D + d);
        if (round_inputs) x = bf16_round_away(x);
      }
      xs[i] = x;
      mb = max(mb, __float_as_uint(x) & 0x7fffffffu);
    }
    if (d < p.D) {
      const int e = shared_exp(mb, p.fmt);
#pragma unroll
      for (int i = 0; i < kBlock; ++i)
        vs[(tb * kBlock + i) * p.D + d] =
            __float2bfloat16_rn(quant_val(xs[i], mb, e, p.fmt, false));
    }
  }
}

// The shared-memory tiles: the q tile (values, two_step operands, ex_pred
// sign masks and powers of two) and the staged key chunk (transposed).
struct Tiles {
  __nv_bfloat16 *qs, *aq, *kT, *akT;
  unsigned *qsgn, *ksgn;
  float *qpw, *kpw;
};

// The true (and two_step) scores of a warp's ROWS rows r0 .. r0 + ROWS
// against the staged chunk, accumulated into st[r][j] (and pr[r][j]) for
// j < jc, lane l holding chunk key l + 32 j; ex_pred's scores replace
// pr[r][j].
template <int NJ, int ROWS, int PRED>
__device__ __forceinline__ void score_chunk(const Params& p, const Tiles& t, int r0, int jc,
                                            int lane, float (&st)[ROWS][NJ],
                                            float (&pr)[ROWS][NJ]) {
  // true (and two_step) scores, summed over d in index order
  for (int d = 0; d < p.D; ++d) {
    float qd[ROWS], ad[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      qd[r] = __bfloat162float(t.qs[(r0 + r) * p.Dp + d]);
      ad[r] = 0.f;
      if (PRED == kTwoStep) ad[r] = __bfloat162float(t.aq[(r0 + r) * p.Dp + d]);
    }
    const __nv_bfloat16* krow = t.kT + d * p.kstr + lane;
    const __nv_bfloat16* akrow = t.akT + d * p.kstr + lane;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < jc) {
        const float kd = __bfloat162float(krow[32 * j]);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) st[r][j] = __fmaf_rn(qd[r], kd, st[r][j]);
        if (PRED == kTwoStep) {
          const float akd = __bfloat162float(akrow[32 * j]);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) pr[r][j] = __fmaf_rn(ad[r], akd, pr[r][j]);
        }
      }
    }
  }
  if (PRED == kExPred) {
    // per block, (count of equal signs - unequal signs) * 2^eq * 2^ek;
    // blocks summed in order
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < jc) {
        const int sl = lane + 32 * j;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const int i = r0 + r;
          float v = 0.f;
          for (int blk = 0; blk < p.nb; ++blk) {
            const int nv = min(kBlock, p.D - kBlock * blk);
            const int cnt = nv - 2 * __popc(t.qsgn[i * p.nb + blk] ^ t.ksgn[sl * p.nb + blk]);
            const float term =
                __fmul_rn(float(cnt), __fmul_rn(t.qpw[i * p.nb + blk], t.kpw[sl * p.nb + blk]));
            v = blk == 0 ? term : __fadd_rn(v, term);
          }
          pr[r][j] = v;
        }
      }
    }
  }
}

// PV over one staged v chunk of ck keys: acc[r][c] += a * v, lanes owning
// the output columns d = lane + 32 c, the keys in order.  Row r's
// probability of chunk key sl is prow[r * rstep + sl * kstep] (bf16).
template <int ROWS>
__device__ __forceinline__ void pv_chunk(const Params& p, const __nv_bfloat16* prow, int kstep,
                                         int rstep, int ck, const __nv_bfloat16* vs, int lane,
                                         float (&acc)[ROWS][kMaxDc]) {
#pragma unroll 4
  for (int sl = 0; sl < ck; ++sl) {
    float a[ROWS];
    bool any = false;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      a[r] = __bfloat162float(prow[r * rstep + sl * kstep]);
      any = any || a[r] != 0.f;
    }
    if (!any) continue;  // adds +-0: skipping leaves every value unchanged
    const __nv_bfloat16* vrow = vs + sl * p.D;
#pragma unroll
    for (int cc = 0; cc < kMaxDc; ++cc) {
      const int d = lane + 32 * cc;
      if (d < p.D) {
        const float vd = __bfloat162float(vrow[d]);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r][cc] = __fmaf_rn(a[r], vd, acc[r][cc]);
      }
    }
  }
}

// Write the ROWS output rows n0 .. n0 + ROWS of cell g (those below N).
template <int ROWS>
__device__ __forceinline__ void store_rows(const Params& p, int g, int n0,
                                           const float (&acc)[ROWS][kMaxDc], int lane) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int n = n0 + r;
    if (n >= p.N) break;
    const size_t orow = (size_t(g) * p.N + n) * p.D;
#pragma unroll
    for (int cc = 0; cc < kMaxDc; ++cc) {
      const int d = lane + 32 * cc;
      if (d < p.D) {
        float o = acc[r][cc];
        if (p.bfloat16 && !p.relaxed) o = bf16_round_away(o);
        if (p.out_bf16) static_cast<__nv_bfloat16*>(p.out)[orow + d] = __float2bfloat16_rn(o);
        else static_cast<float*>(p.out)[orow + d] = o;
      }
    }
  }
}

__device__ __forceinline__ int slot_get(const unsigned char* slots, int slot, int i) {
  return slot == 2 ? int(reinterpret_cast<const short*>(slots)[i])
                   : reinterpret_cast<const int*>(slots)[i];
}

__device__ __forceinline__ void slot_set(unsigned char* slots, int slot, int i, int v) {
  if (slot == 2) reinterpret_cast<short*>(slots)[i] = short(v);
  else reinterpret_cast<int*>(slots)[i] = v;
}

template <int NW, int ROWS, int PRED>
__global__ void __launch_bounds__(NW * 32, 1) tiled_topk_attention_kernel(const Params p) {
  constexpr int QT = NW * ROWS;
  constexpr int KJ = kChunk4 / kBlock;  // keys per lane per chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(QT, p.Dp, p.nb, p.Sp, p.kc, p.kstr, PRED, p.slot, false);
  const Tiles tm{reinterpret_cast<__nv_bfloat16*>(smem + L.qs),
                 reinterpret_cast<__nv_bfloat16*>(smem + L.aq),
                 reinterpret_cast<__nv_bfloat16*>(smem + L.kT),
                 reinterpret_cast<__nv_bfloat16*>(smem + L.akT),
                 reinterpret_cast<unsigned*>(smem + L.qsgn),
                 reinterpret_cast<unsigned*>(smem + L.ksgn),
                 reinterpret_cast<float*>(smem + L.qpw),
                 reinterpret_cast<float*>(smem + L.kpw)};
  __nv_bfloat16* vs = tm.kT;              // [kc][D], the v chunk
  unsigned char* slots = smem + L.probs;  // [QT][Sp] slots of p.slot bytes

  const int ntiles = (p.N + QT - 1) / QT;
  const int g = blockIdx.x / ntiles, row0 = (blockIdx.x % ntiles) * QT;
  const int b = g / p.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = warp * ROWS;  // the warp's first row in the tile
  const size_t qbase = size_t(g) * p.N * p.D, kbase = size_t(g) * p.S * p.D;
  const float* brow = p.bias ? p.bias + size_t(b) * p.S : nullptr;
  // the warp's rows of the scaled true scores (the scratch pads N to kMaxTileRows)
  float* scr = p.scratch + (size_t(g) * p.Np + row0 + r0) * p.Sp;
  const bool dense = p.topk >= p.S;

  // ---- q tile: MX-quantize along D, one warp per (row, block)
  stage_side<PRED, NW>(p, p.q, qbase, row0, p.N, QT, p.Dp, 1, tm.qs, tm.aq, tm.qsgn,
                       tm.qpw, warp, lane);

  // ---- 1. scores, one key chunk at a time: the scaled true scores go to the
  // scratch, each key's selection key (dense: its validity) to its slot
  for (int c = 0; c < p.nchunks; ++c) {
    const int s0 = c * p.kc;
    const int ck = min(p.kc, p.Sp - s0);
    __syncthreads();  // the previous chunk is scored (and the q tile is in)
    stage_side<PRED, NW>(p, p.k, kbase, s0, p.S, ck, 1, p.kstr, tm.kT, tm.akT,
                         tm.ksgn, tm.kpw, warp, lane);
    __syncthreads();
    float st[ROWS][KJ], pr[ROWS][KJ];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int j = 0; j < KJ; ++j) { st[r][j] = 0.f; pr[r][j] = 0.f; }
    const int jc = ck / kBlock;
    score_chunk<KJ, ROWS, PRED>(p, tm, r0, jc, lane, st, pr);
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        if (j < jc) {
          const int s = s0 + lane + 32 * j;
          const float bs = brow && s < p.S ? brow[s] : 0.f;
          float x = st[r][j];
          if (p.bfloat16 && !p.relaxed) x = bf16_round_away(x);
          x = __fmul_rn(x, p.scale);
          if (brow) x = __fadd_rn(x, bs);
          scr[size_t(r) * p.Sp + s] = x;
          int key = s < p.S;
          if (!dense) {
            float v = kNeg;
            if (s < p.S) v = PRED == kNone ? x : (brow ? __fadd_rn(pr[r][j], bs) : pr[r][j]);
            key = mono_key(v, p.key_bits);
          }
          slot_set(slots, p.slot, (r0 + r) * p.Sp + s, key);
        }
      }
  }

  // ---- 2. selection: each slot's key is replaced by the key's selected
  // flag.  Lane l reads back only the slots and scores it wrote (keys
  // l + 32 j).
  auto at = [&](int r, int j) { return (r0 + r) * p.Sp + lane + 32 * j; };
  if (!dense)
    select_topk<0, ROWS>(
        p, [&](int r, int j) { return slot_get(slots, p.slot, at(r, j)); },
        [&](int r, int j, bool sel) { slot_set(slots, p.slot, at(r, j), sel); }, lane);

  // ---- 3. each row's masked softmax and the probabilities' requantize;
  // each probability (bf16) replaces its key's flag
#pragma unroll 1
  for (int r = 0; r < ROWS; ++r) {
    const float* xrow = scr + size_t(r) * p.Sp;
    softmax_row<0>(
        p,
        [&](int j) {
          return slot_get(slots, p.slot, at(r, j)) ? xrow[lane + 32 * j] : kNeg;
        },
        [&](int j, __nv_bfloat16 a) {
          *reinterpret_cast<__nv_bfloat16*>(slots + size_t(at(r, j)) * p.slot) = a;
        });
  }

  // ---- 4. PV, one v chunk at a time: lanes own output columns d = lane + 32 c
  float acc[ROWS][kMaxDc];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < kMaxDc; ++c) acc[r][c] = 0.f;
  const int kstep = p.slot / 2;  // bf16 elements per slot
  const __nv_bfloat16* probs = reinterpret_cast<const __nv_bfloat16*>(slots);
  for (int c = 0; c < p.nchunks; ++c) {
    const int s0 = c * p.kc;
    const int ck = min(p.kc, p.Sp - s0);
    __syncthreads();  // every warp is done with the k chunk (or the previous v chunk)
    stage_v_chunk<NW>(p, kbase, s0, ck, vs, warp, lane);
    __syncthreads();
    pv_chunk<ROWS>(p, probs + (size_t(r0) * p.Sp + s0) * kstep, kstep, p.Sp * kstep, ck, vs,
                   lane, acc);
  }
  store_rows<ROWS>(p, g, row0 + r0, acc, lane);
}

// K4's tile: warps and rows per warp (the largest query tile whose shared
// memory fits), its shared memory, and the slot width (2 bytes hold a
// key_bits 8 or 16 key, 4 a key_bits 32 one).  false if nothing fits.
inline bool tiled_shape(int Sp, int Dp, int pred, int key_bits, int& nw, int& rows,
                        long long& smem, int& slot) {
  static const int kShapes[4][2] = {{16, 4}, {16, 2}, {16, 1}, {8, 1}};
  slot = key_bits == 32 ? 4 : 2;
  const int kc = Sp < kChunk4 ? Sp : kChunk4;
  for (const auto& sh : kShapes) {
    smem = (long long)make_layout(sh[0] * sh[1], Dp, Dp / kBlock, Sp, kc, kc + 2, pred, slot,
                                  false).total;
    if (smem <= kMaxSmem) { nw = sh[0]; rows = sh[1]; return true; }
  }
  return false;
}

template <int NW, int ROWS>
cudaError_t launch_tiled_pred(const Params& p, int pred, size_t smem, cudaStream_t stream) {
  if (pred == kTwoStep)
    return start(tiled_topk_attention_kernel<NW, ROWS, kTwoStep>, NW, ROWS, p, smem, stream);
  if (pred == kExPred)
    return start(tiled_topk_attention_kernel<NW, ROWS, kExPred>, NW, ROWS, p, smem, stream);
  return start(tiled_topk_attention_kernel<NW, ROWS, kNone>, NW, ROWS, p, smem, stream);
}

// The kernels' parameters; kc_max is the longest key chunk a block stages.
inline Params make_params(const void* q, const void* k, const void* v, const float* bias,
                          void* out, int B, int H, int N, int S, int D, int in_bf16,
                          int out_bf16, int topk, float scale, int key_bits, int relaxed,
                          int bfloat16, int flush, int ebits, int mbits, int emax,
                          float max_norm, int scale_bits, int kc_max) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.bias = bias; p.out = out;
  p.B = B; p.H = H; p.N = N; p.S = S; p.D = D;
  p.Dp = ((D < 8 ? 8 : D) + kBlock - 1) / kBlock * kBlock;
  p.nb = p.Dp / kBlock;
  p.Sp = (S + kBlock - 1) / kBlock * kBlock;
  p.nj = p.Sp / kBlock;
  p.kc = p.Sp < kc_max ? p.Sp : kc_max;
  p.kstr = p.kc + 2;  // odd word stride: the transposed k writes hit distinct banks
  p.nchunks = (p.Sp + p.kc - 1) / p.kc;
  p.scratch = nullptr; p.Np = 0; p.slot = 2;
  p.in_bf16 = in_bf16; p.out_bf16 = out_bf16; p.topk = topk;
  p.key_bits = key_bits; p.relaxed = relaxed; p.bfloat16 = bfloat16;
  p.scale = scale;
  p.fmt = make_fmt(ebits, mbits, emax, max_norm, scale_bits, flush);
  return p;
}

}  // namespace

// Shared memory the kernel needs, or 0 if it cannot take the shapes.
// pred_mode: 0 ex_pred, 1 two_step_leading_ones.
extern "C" long long topk_attention_split_smem_bytes(int N, int S, int D, int topk,
                                                     int approx, int pred_mode) {
  if (N < 1 || S < 1 || D < 1 || S > K3_MAX_TOKENS || D > MAX_HEAD_DIM) return 0;
  const int Sp = (S + kBlock - 1) / kBlock * kBlock;
  const int Dp = ((D < 8 ? 8 : D) + kBlock - 1) / kBlock * kBlock;
  const int kc = Sp < kChunk ? Sp : kChunk;
  int nj_max, rows;
  tile_shape(Sp, nj_max, rows);
  return (long long)make_layout(kWarps * rows, Dp, Dp / kBlock, Sp, kc, kc + 2,
                                pred_kind(approx, pred_mode, topk, S)).total;
}

// Launch K3 on `stream`; returns the cudaError_t of the launch (0 = ok).
// bias: (B, S) float32 or null.
extern "C" int topk_attention_split(const void* q, const void* k, const void* v,
                                    const float* bias, void* out, int B, int H, int N,
                                    int S, int D, int in_bf16, int out_bf16, int topk,
                                    float scale, int approx, int pred_mode, int key_bits,
                                    int relaxed, int bfloat16, int flush, int ebits,
                                    int mbits, int emax, float max_norm, int scale_bits,
                                    void* stream) {
  const long long smem = topk_attention_split_smem_bytes(N, S, D, topk, approx, pred_mode);
  if (smem == 0 || B < 1 || H < 1 || topk < 1 ||
      (key_bits != 8 && key_bits != 16 && key_bits != 32))
    return int(cudaErrorInvalidValue);
  const Params p = make_params(q, k, v, bias, out, B, H, N, S, D, in_bf16, out_bf16, topk,
                               scale, key_bits, relaxed, bfloat16, flush, ebits, mbits, emax,
                               max_norm, scale_bits, kChunk);
  const int pred = pred_kind(approx, pred_mode, topk, S);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int nj_max, rows;
  tile_shape(p.Sp, nj_max, rows);
  cudaError_t err;
  if (nj_max == 4) err = launch_pred<4, 4>(p, pred, size_t(smem), st);
  else if (nj_max == 8) err = launch_pred<8, 4>(p, pred, size_t(smem), st);
  else err = launch_pred<16, 2>(p, pred, size_t(smem), st);
  return int(err);
}

static inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// K4's shared memory, or 0 if it cannot take the shapes.  pred_mode: 0
// ex_pred, 1 two_step_leading_ones.
extern "C" long long topk_attention_tiled_smem_bytes(int N, int S, int D, int topk, int approx,
                                                     int pred_mode, int key_bits) {
  if (N < 1 || S < 1 || D < 1 || S > K4_MAX_KEYS || D > MAX_HEAD_DIM) return 0;
  int nw, rows, slot;
  long long smem;
  return tiled_shape(round_up(S, kBlock), round_up(D < 8 ? 8 : D, kBlock),
                     pred_kind(approx, pred_mode, topk, S), key_bits, nw, rows, smem, slot)
             ? smem
             : 0;
}

// Floats of the scratch K4 writes its scaled true scores to: (B * H, N
// padded to the largest query tile, S padded to 32).
extern "C" long long topk_attention_tiled_scratch_floats(int B, int H, int N, int S) {
  return (long long)B * H * round_up(N, kMaxTileRows) * round_up(S, kBlock);
}

// Launch K4 on `stream`; returns the cudaError_t of the launch (0 = ok).
// bias: (B, S) float32 or null; scratch: topk_attention_tiled_scratch_floats
// floats, which the kernel overwrites.
extern "C" int topk_attention_tiled(const void* q, const void* k, const void* v,
                                    const float* bias, float* scratch, void* out, int B, int H,
                                    int N, int S, int D, int in_bf16, int out_bf16, int topk,
                                    float scale, int approx, int pred_mode, int key_bits,
                                    int relaxed, int bfloat16, int flush, int ebits, int mbits,
                                    int emax, float max_norm, int scale_bits, void* stream) {
  if (topk_attention_tiled_smem_bytes(N, S, D, topk, approx, pred_mode, key_bits) == 0 ||
      B < 1 || H < 1 || topk < 1 || scratch == nullptr ||
      (key_bits != 8 && key_bits != 16 && key_bits != 32))
    return int(cudaErrorInvalidValue);
  Params p = make_params(q, k, v, bias, out, B, H, N, S, D, in_bf16, out_bf16, topk, scale,
                         key_bits, relaxed, bfloat16, flush, ebits, mbits, emax, max_norm,
                         scale_bits, kChunk4);
  const int pred = pred_kind(approx, pred_mode, topk, S);
  int nw, rows;
  long long smem;
  tiled_shape(p.Sp, p.Dp, pred, key_bits, nw, rows, smem, p.slot);
  p.scratch = scratch;
  p.Np = round_up(N, kMaxTileRows);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (nw == 8) err = launch_tiled_pred<8, 1>(p, pred, size_t(smem), st);
  else if (rows == 4) err = launch_tiled_pred<16, 4>(p, pred, size_t(smem), st);
  else if (rows == 2) err = launch_tiled_pred<16, 2>(p, pred, size_t(smem), st);
  else err = launch_tiled_pred<16, 1>(p, pred, size_t(smem), st);
  return int(err);
}
