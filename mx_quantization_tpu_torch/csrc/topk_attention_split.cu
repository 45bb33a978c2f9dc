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

#include "mx_common.cuh"

// The longest key sequence and widest head the kernel takes come from the
// wrapper (MAX_SPLIT_TOKENS and MAX_HEAD_DIM in
// ops/kernels/topk_attention.py), which passes them to nvcc.
#ifndef K3_MAX_TOKENS
#error "build with -DK3_MAX_TOKENS=<n> (ops/kernels/build.py passes it)"
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
  int in_bf16, out_bf16, topk, key_bits, relaxed, bfloat16;
  float scale;
  Fmt fmt;
};

struct Layout {  // byte offsets into the dynamic shared memory
  size_t qs, aq, qsgn, qpw, kT, akT, ksgn, kpw, bias, probs, total;
};

__host__ __device__ inline Layout make_layout(int qt, int Dp, int nb, int Sp, int kc,
                                              int kstr, int pred) {
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
  l.bias = o;  o = align16(o + size_t(Sp) * 4);
  l.probs = o; o = align16(o + size_t(qt) * Sp * 2);
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
template <int PRED>
__device__ __forceinline__ void stage_side(const Params& p, const void* src, size_t base,
                                           int first, int valid, int rows, int rstride,
                                           int dstride, __nv_bfloat16* vals,
                                           __nv_bfloat16* ops, unsigned* sgn, float* pw,
                                           int warp, int lane) {
  const int tasks = rows * p.nb;
  const bool round = p.bfloat16 && !p.in_bf16;
  for (int t0 = warp; t0 < tasks; t0 += kWarps * kPrefetch) {
    float xs[kPrefetch];
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const int t = t0 + u * kWarps;
      const int r = t / p.nb, d = (t - r * p.nb) * kBlock + lane;
      xs[u] = t < tasks && first + r < valid && d < p.D
                  ? load_in(src, p.in_bf16, base + size_t(first + r) * p.D + d)
                  : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const int t = t0 + u * kWarps;
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

// Scale (round, bias) the true scores st of a warp's ROWS query rows, and
// select each row's keys by its predictor scores pr (or its true scores).
// The rows' bisections run side by side, so that their chains of dependent
// ballots overlap.
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
  // k-th largest key by bisection; cnt_hi carries count(keys > hi)
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
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (j < p.nj)
#pragma unroll
        for (int r = 0; r < ROWS; ++r) c[r] += __popc(__ballot_sync(kFull, key[r][j] > mid[r]));
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
#pragma unroll
      for (int j = 0; j < NJ; ++j) sel[r][j] = key[r][j] >= kth;
    } else {
      // keys above the k-th, then ties lowest index first up to k
      const int room = p.topk - cnt_hi[r];
      const unsigned le = (2u << lane) - 1u;
      int before = 0;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        sel[r][j] = false;
        if (j < p.nj) {
          const unsigned eqm = __ballot_sync(kFull, key[r][j] == kth);
          const int rank = before + __popc(eqm & le);
          sel[r][j] = key[r][j] > kth || (key[r][j] == kth && rank <= room);
          before += __popc(eqm);
        }
      }
    }
  }
}

// The masked softmax of one query row over its selected keys, and the
// probabilities' requantize; written to prow[0..Sp) as bf16.
template <int NJ>
__device__ __forceinline__ void row_softmax(const Params& p, const float (&st)[NJ],
                                            const bool (&sel)[NJ], int lane,
                                            __nv_bfloat16* prow) {
  // unselected entries are -3e38 and exp gives +0 there
  float ev[NJ];
  float m = kNeg;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    ev[j] = (j < p.nj && sel[j]) ? st[j] : kNeg;
    m = fmaxf(m, ev[j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (j < p.nj) {
      ev[j] = expf(__fsub_rn(ev[j], m));
      sum = j == 0 ? ev[j] : __fadd_rn(sum, ev[j]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(kFull, sum, off));

#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (j < p.nj) {
      float a = __fdiv_rn(ev[j], sum);
      if (!p.relaxed) {
        if (p.bfloat16) a = bf16_round_away(a);
        const unsigned mb = __reduce_max_sync(kFull, __float_as_uint(a) & 0x7fffffffu);
        a = quant_val(a, mb, shared_exp(mb, p.fmt), p.fmt, true);
      }
      prow[lane + 32 * j] = __float2bfloat16_rn(a);  // serving: the RNE cast
    }
  }
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
  for (int r = 0; r < ROWS; ++r)
    row_softmax<NJ>(p, st[r], sel[r], lane, probs + (r0 + r) * p.Sp);

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

template <int NJ, int ROWS, int PRED>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  auto kern = split_topk_attention_kernel<NJ, ROWS, PRED>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (p.N + kWarps * ROWS - 1) / (kWarps * ROWS);
  kern<<<p.B * p.H * tiles, kWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int NJ, int ROWS>
cudaError_t launch_pred(const Params& p, int pred, size_t smem, cudaStream_t stream) {
  if (pred == kTwoStep) return launch<NJ, ROWS, kTwoStep>(p, smem, stream);
  if (pred == kExPred) return launch<NJ, ROWS, kExPred>(p, smem, stream);
  return launch<NJ, ROWS, kNone>(p, smem, stream);
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
  Params p;
  p.q = q; p.k = k; p.v = v; p.bias = bias; p.out = out;
  p.B = B; p.H = H; p.N = N; p.S = S; p.D = D;
  p.Dp = ((D < 8 ? 8 : D) + kBlock - 1) / kBlock * kBlock;
  p.nb = p.Dp / kBlock;
  p.Sp = (S + kBlock - 1) / kBlock * kBlock;
  p.nj = p.Sp / kBlock;
  p.kc = p.Sp < kChunk ? p.Sp : kChunk;
  p.kstr = p.kc + 2;  // odd word stride: the transposed k writes hit distinct banks
  p.nchunks = (p.Sp + p.kc - 1) / p.kc;
  p.in_bf16 = in_bf16; p.out_bf16 = out_bf16; p.topk = topk;
  p.key_bits = key_bits; p.relaxed = relaxed; p.bfloat16 = bfloat16;
  p.scale = scale;
  p.fmt = make_fmt(ebits, mbits, emax, max_norm, scale_bits, flush);
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
