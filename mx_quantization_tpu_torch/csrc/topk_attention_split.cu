// Kernels K3 and K4: MX top-k attention from split q (B, H, N, D) and k, v
// (B, H, S, D), with an optional key bias (B, S) -> (B, H, N, D).
//
// K3 replaces the TPU kernel mx_quantization_tpu/ops/kernels/topk_attention.py
// fused_topk_attention -> _split_impl, short path (N, S <= 512; body
// _topk_attn_kernel -> _one_cell, with _prep_side, _quant_axis0,
// _quant_axis0_pos, _exp_sign_approx, _two_step_approx, _kth_keys,
// _mono_keys(_top), _score_select_output, _bf16_round).  K4 replaces its
// query-tiled long-sequence path (N or S over K3_MAX_TOKENS, S <=
// K4_MAX_KEYS; body _topk_attn_kernel_tiled), which caches a (row, head)
// cell's quantized K side and walks query tiles over it.  Predictors: none
// (selection by the true scores) and all eight of the TPU kernel's:
// ex_pred, two_step_leading_ones, MXINT4, partial_Q, partial_K, true_ex,
// threshold_ex (_true_ex_approx, _threshold_ex_approx) and ELSA (the hash
// of _prep_side and the score of _score_select_output).
//
// The bounds on the card: at PixArt-alpha 256^2's self-attention (200 rows
// x 16 heads, N = S = 256, D = 72, f32 in and out) K3 reads q, k, v and
// writes the output once, 944 MB, about 0.28 ms at 3.35 TB/s, and its
// products are about 70 GFLOP, so bytes set its bound; at DiT-XL/2 512^2
// (8 rows x 16 heads, N = S = 1024, D = 72, bf16) K4's products over the
// 134 M (query, key) pairs set it (0.042 ms on the bf16 tensor cores).
// Between the products sits per-element work over the (N, S) scores: the
// k-th key, the tie rank, the softmax, the requantize.
//
// The design (PERF.md holds the ladders of switched-off phases it answers;
// the first design spent 41% of its time re-quantizing the K side per query
// tile):
//   * The K side is MX-quantized once per (row, head) cell.  A pre-pass in
//     the same call writes each cell's k as int8 grid points (row-major,
//     with one f32 scale 2^(e - (mbits-2)) per key and 32-d block), ex_pred's
//     2^e per key and block, two_step's operands n (below) as int16, and v
//     transposed (the exact tier: int8 grid points, one exponent per 32-key
//     block and column, the keys of each block permuted into the PV mma's
//     operand order; the CUDA-core PV: bf16 values) to a workspace the
//     wrapper allocates.  MXFP formats keep bf16 values and sign masks.  The
//     attention kernel copies the workspace into shared memory with
//     cp.async, 16 bytes a thread and nothing in registers.
//   * K3: one block of 8 warps per cell stages the cell's K side once and
//     walks all of its 16-row query tiles.  With two_step on the int grids
//     it goes in two phases: every tile's selection first, each tile's keys
//     computed once into a per-warp cache that the radix levels and the
//     marking pass read (the selection bits of every tile kept), then the
//     score and PV arrays restaged over n and the caches.  K4 (and K3 where
//     a cell does not fit, S = 512 with two_step at D = 128) gives each warp
//     one tile, a block W tiles, and streams the K side from the workspace
//     in chunks of 256 or 128 keys, once per pass over the keys; at the
//     DiT-512 shape the workspace (25 MB) stays in L2.  No score leaves the
//     SM: the passes recompute the scores with the tensor cores.  Without a
//     predictor, a kernel capped at 128 registers lets two blocks share an
//     SM where their shared memory fits (PixArt's cross-attention).
//   * q never enters shared memory (INT formats): each warp loads its 16
//     rows and quantizes them into the mma operand registers.
//   * Int8 tensor-core products (mma.sync m16n8k32), exact: every block sum
//     of two grid-point vectors is an integer below 2^24.  The true score
//     takes one mma per 32-d block, the block sum scaled in f32 by
//     2^(eq - (mbits-2)) and then 2^(ek - (mbits-2)), the blocks added in
//     order.  ex_pred takes the same mma on +-1 operands.  two_step's
//     operand sign * e * (2^l1 + 2^l2) / 64, after its bf16 cast, is n / 64
//     for an integer |n| <= 12288 on the int grids, so its dot product is
//     an integer: n splits into a signed high byte and an unsigned low byte,
//     four mma (s8/u8 in each combination) accumulate the byte planes over
//     every d in int32, the planes combine in int64 and round to f32 once,
//     times 2^-12.  The exact tier's PV takes one mma per 32-key block on
//     the probabilities' int8 grid points, scaled on the probability side,
//     then the v side, blocks in order.
//   * Selection: a warp owns 16 query rows on the mma accumulator layout
//     (lane (g, t) holds rows g and g + 8 at keys 8 j + 2 t and 8 j + 2 t +
//     1).  The k-th key is a radix select with 8-bit digits: per digit (1 at
//     key_bits 8, 4 at key_bits 32) a pass packs the digits of the keys
//     whose higher digits match, four to a word, into the lane's own
//     shared-memory words, and 8 bisection passes over them (__vcmpgtu4 and
//     popcounts, no atomics) find the digit and the count of greater keys;
//     a last pass marks the selected keys in a bit mask, the exact tier's
//     ties lowest index first from ballots per 8-key tile.
//   * On the CUDA cores, in f32 with a fixed order: the serving tier's PV
//     (bf16 probabilities are not on an int grid; keys in order; lane
//     (rg, cg) owns 4 rows and D8 / 8 columns and reads four keys of a
//     probability row or a v column at once) and every product of the MXFP
//     formats (within a 32-block in index order, then the blocks in order).
// What bounds them (NVIDIA H100 80GB HBM3, 700.00 W; the ladder in
// PERF.md): latency.  The int-grid kernels hold 255 registers a thread, so
// one 8-warp block per SM (the predictor-free one, capped at 128, two
// where they fit), and each phase runs far below its instruction and
// memory rates.  At PixArt-256's self top-k site (serving / exact, ms):
// staging 1.19 / 1.17 (the pre-pass kernel averages 0.50 a call over
// PixArt's self and cross calls, profiled), the two_step keys and
// selection 3.57 / 3.69 (the pass that fills the key cache, four mma
// per 8-key tile and 32-d block, ~1 ms; then four radix levels of
// dependent bisection passes), the max and sum passes 2.11 / 2.07, the
// probabilities 1.88 / 2.04, PV 1.86 serving (CUDA cores) / 1.01 exact
// (mma): 10.61 / 9.97 in all.  At DiT-512's top-k site: staging 0.20 /
// 0.19, selection 1.06 / 1.32, max and sum 1.15 / 1.14, probabilities
// 1.07 / 1.22, PV 0.93 / 0.40: 4.40 / 4.27.
//
// The plain version (ops/kernels/topk_attention.py fused_topk_attention_ref)
// sums in these orders: the true score and the exact tier's PV per 32-block
// exactly, the blocks in order (_block_scaled_dot); two_step's predictor as
// one exact dot rounded once (_exact_int_dot; MXFP: per block in d order,
// blocks in order); the softmax sum as 32 strided sums of keys m + 32 i in i
// order halved in a tree (fastquant.lane_sum, here across the quad's lanes
// and registers); the serving PV in key order.  So K3 and K4 agree with it,
// and with each other, bit for bit.  Products that feed a sum are explicit
// __fmul_rn/__fadd_rn or fused multiply-adds of bf16-exact operands, so the
// compiler contracts nothing.  Build without --use_fast_math: subnormals are
// kept and expf is the precise one.
//
// The other predictors:
//   * MXINT4, partial_Q, partial_K and threshold_ex on the int grids are, per
//     element, a small integer code times a power of two per (row, block):
//     MXINT4 the int4 grid point (|c| <= 7) of the element re-quantized from
//     the same block maximum, partial the int8 grid point on its full side
//     and +-1 (padded d 0) on the other, threshold_ex 0, +-1 or +-2 times
//     2^(e - 1) (te <= e on the int grids).  They take ex_pred's route: the
//     pre-pass writes k's codes (int8) and scales, q's go into mma operand
//     registers, and one int8 mma per 32-d block gives each block's exact
//     sum, scaled by q's then k's power of two, the blocks in order.
//   * true_ex maps a zero element to +1, off any block grid, so it takes the
//     CUDA-core kernel (the one of the MXFP grids) on every format: bf16
//     operands, the products added in d order per block, the blocks in
//     order, for its predictor and, on that kernel, its true score and PV.
//     Every predictor of the MXFP grids takes the same operand route.
//   * ELSA: the pre-pass hashes each key (bit b = sign of proj row b times
//     the quantized key, the products rounded and added in d order) into
//     four words and stores its norm sqrt(sum kv^2) (d order); each warp
//     hashes its 16 query rows the same way from its quantized q; a pair's
//     score is the norm of the key at the QUERY's index (the reference's
//     quirk; 0 past the keys) times cos[hamming], hamming the popcount of
//     the words' xor and cos a table of bits + 1 values that the wrapper
//     passes (topk_attention.py _elsa_cos_table), read from shared memory.
//     Within a row the norm is constant, so many keys tie; each tier's
//     selection rule decides them as for every predictor.
//
// The bias goes onto the scaled true scores and onto the predictor scores,
// before the padded keys are masked to -3e38.  Flush zeroes q, k, v and
// probability blocks whose maximum is f32-subnormal.

#include "topk_pred.cuh"

// The longest key sequence and widest head the kernels take come from the
// wrapper (MAX_SPLIT_TOKENS, MAX_TILED_KEYS and MAX_HEAD_DIM in
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
// The wrapper builds this source once per part, -DSPLIT_PART=0 .. 4, all
// nvcc started together: each part's library holds the host interface, the
// pre-pass and the attention kernels of its part (part_of), so that the
// eleven kernels compile side by side.  Without SPLIT_PART one library
// holds them all.
#ifndef SPLIT_PART
#define SPLIT_PART -1
#endif

namespace {

using namespace mx;

constexpr int kMaxWarps = 8;
constexpr int kRows = 16;                      // query rows a warp owns at once
constexpr int kMaxNb = MAX_HEAD_DIM / kBlock;  // 32-d blocks
constexpr long long kMaxSmem = 232448;         // 227 KB, a block's limit
constexpr long long kTwoBlockSmem = 114688;    // what lets two blocks share an SM
constexpr int kUnroll = 8;                     // pre-pass loads in flight per lane

constexpr int kMaxBits = 128;  // ELSA hash bits: four words a row

// The arrays of the K side, a bit each in a staging mask
enum : int {
  kAKq = 1, kAKsc = 2, kAKpw = 4, kAKn = 8, kAKsg = 16, kAV = 32, kAVe = 64, kAKc = 128,
  kAKcs = 256, kAKh = 512
};

// Byte offsets of a cell's arrays in the workspace, and a cell's size.
// INT formats: kq int8 [Sp][Dp]; ksc f32 [Sp][nb] 2^(ek - (mbits-2)); kpw
// f32 [Sp][nb] ex_pred's 2^ek; kn int16 [Sp][Dp] two_step's n; kc int8
// [Sp][Dp] and kcs f32 [Sp][nb] the block-grid predictors' codes and
// scales.  The CUDA-core kernel (MXFP, true_ex): kq bf16 [Sp][Dp] values;
// kpw; ksg u32 [Sp][nb] sign masks; kn bf16 [Sp][Dp] the predictor's
// operands.  ELSA: kh u32 [Sp][4] hash words, kno f32 [Sp] norms.  v
// transposed: the exact tier's INT formats int8 grid points [D8][Sp] with
// their exponents ve int16 [Sp/32][D8]; the CUDA-core PV (serving, and the
// CUDA-core kernel) bf16 values [D8][Sp].
struct Ws {
  size_t kq, ksc, kpw, kn, ksg, kc, kcs, kh, kno, v, ve, cell;
};

__host__ __device__ inline Ws make_ws(int Sp, int Dp, int nb, int D8, int intm, int pred,
                                      int relaxed) {
  const bool ex = pred == kExPred, exact_mma = intm && !relaxed;
  const bool opn = pred == kTwoStep || pred == kOperand, bint = pred == kBlockInt;
  const bool elsa = pred == kElsa;
  Ws w;
  size_t o = 0;
  w.kq = o;  o = align16(o + size_t(Sp) * Dp * (intm ? 1 : 2));
  w.ksc = o; o = align16(o + (intm ? size_t(Sp) * nb * 4 : 0));
  w.kpw = o; o = align16(o + (ex ? size_t(Sp) * nb * 4 : 0));
  w.kn = o;  o = align16(o + (opn ? size_t(Sp) * Dp * 2 : 0));
  w.ksg = o; o = align16(o + (ex && !intm ? size_t(Sp) * nb * 4 : 0));
  w.kc = o;  o = align16(o + (bint ? size_t(Sp) * Dp : 0));
  w.kcs = o; o = align16(o + (bint ? size_t(Sp) * nb * 4 : 0));
  w.kh = o;  o = align16(o + (elsa ? size_t(Sp) * 16 : 0));
  w.kno = o; o = align16(o + (elsa ? size_t(Sp) * 4 : 0));
  w.v = o;   o = align16(o + size_t(Sp) * D8 * (exact_mma ? 1 : 2));
  w.ve = o;  o = align16(o + (exact_mma ? size_t(Sp / kBlock) * D8 * 2 : 0));
  w.cell = o;
  return w;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // (B, S) or null
  const float* proj;  // ELSA: (bits, D) or null
  const float* cos_tab;  // ELSA: cos of each hamming distance, bits + 1
  void* out;
  unsigned char* ws;  // the workspace, B * H cells of w.cell bytes
  int B, H, N, S, D, Dp, nb, Sp, D8, nkb, ntq;
  // kc: keys per staged chunk, nchunks of them (1: staged once); a block
  // walks tiles_per_block row tiles with W warps; qblocks: blocks per cell
  // two_blocks: the predictor-free kernel capped at 128 registers, where two
  // blocks' shared memory fits an SM
  // cache (K3, two_step on the int grids): selection for all of the cell's
  // row tiles first, each tile's keys computed once into a per-warp cache,
  // then the score and PV arrays restaged over them
  int kc, nchunks, W, tiles_per_block, qblocks, two_blocks, cache;
  int in_bf16, out_bf16, topk, key_bits, relaxed, bfloat16, intm, shift, pred, dense;
  int mode, bits;  // the predictor mode (Mode); ELSA's hash bits
  int q_vec, k_vec, v_vec;
  float scale;
  Fmt fmt, fmt4;  // the activations' format; MXINT4's int4 grid
  Ws w;
};

// Shared memory: the staged key chunk, then each warp's area.  Chunk (INT):
// kq and kc [kc][kstr] (kstr = Dp + 16 bytes: the fragment loads hit
// distinct banks), ksc, kpw and kcs [kc][nb], kn [kc][nstr] (nstr = 2 Dp +
// 32), ve [kc/32][D8]; the CUDA-core kernel: kq, kn [kc][Dp] bf16, kpw,
// ksg; ELSA's kh [kc][4] words; v [D8][vstr] (the exact tier's INT int8,
// vstr = kc + 16 bytes; else bf16, vstr = kc + 4 elements: lane d's 8-byte
// loads of column d hit distinct banks); the bias [kc]; ELSA's cosines.  A
// warp: the selection bits, a union of the radix select's packed digits
// [Sp/16][2][32] words and {the chunk's probabilities, the PV sums carried
// between chunks}, and its q rows (the CUDA-core kernel: values and
// operands as bf16; ELSA on the int grids: values as f32, for the hash).
struct Layout {
  int kstr, nstr, vstr;
  size_t kq, ksc, kpw, kn, ksg, kc, kcs, kh, cos, v, ve, bias, warp0, warp_bytes;
  size_t w_sel, w_u, w_acc, w_q, total;
  size_t selp, warpA, warp_bytesA, w_digits;  // cache: the selection phase
};

__host__ __device__ inline Layout make_layout(const Params& p) {
  Layout l;
  const int kc = p.kc;
  const bool ex = p.pred == kExPred, topk = !p.dense;
  const bool opn = p.pred == kTwoStep || p.pred == kOperand, bint = p.pred == kBlockInt;
  const bool elsa = p.pred == kElsa;
  const bool exact_mma = p.intm && !p.relaxed;
  l.kc = l.kcs = l.kh = l.cos = 0;
  l.kstr = p.Dp + 16;
  l.nstr = 2 * p.Dp + 32;
  l.vstr = exact_mma ? kc + 16 : kc + 4;
  const size_t sel_bytes = size_t((p.Sp + 127) / 128) * 256;  // a row tile's selection bits
  if (p.cache) {
    // the bias and every row tile's selection bits stay; over them, first
    // two_step's n and each warp's key cache [Sp/8][4][32] and packed
    // digits, then the true score's and PV's arrays and each warp's
    // probabilities
    size_t o = 0;
    l.bias = o;  o = align16(o + size_t(kc) * 4);
    l.selp = o;  o = align16(o + size_t(p.ntq) * sel_bytes);
    const size_t base = o;
    l.kn = base;
    l.warpA = align16(base + size_t(kc) * l.nstr);
    l.w_digits = align16(size_t(kRows) * p.Sp * 4);
    l.warp_bytesA = l.w_digits + align16(size_t(kRows) * p.Sp);
    const size_t endA = l.warpA + size_t(p.W) * l.warp_bytesA;
    l.kq = base;  o = align16(base + size_t(kc) * l.kstr);
    l.ksc = o;    o = align16(o + size_t(kc) * p.nb * 4);
    l.v = o;      o = align16(o + size_t(p.D8) * l.vstr * (exact_mma ? 1 : 2));
    l.ve = o;     o = align16(o + (exact_mma ? size_t(kc / kBlock) * p.D8 * 2 : 0));
    l.kpw = l.ksg = o;
    l.warp0 = o;
    l.w_sel = l.w_u = l.w_acc = l.w_q = 0;
    l.warp_bytes =
        align16(exact_mma ? size_t(kc / kBlock) * 32 * 24 : size_t(kRows) * (kc + 4) * 2);
    const size_t endB = o + size_t(p.W) * l.warp_bytes;
    l.total = endA > endB ? endA : endB;
    return l;
  }
  l.selp = l.warpA = l.warp_bytesA = l.w_digits = 0;
  size_t o = 0;
  l.kq = o;   o = align16(o + (p.intm ? size_t(kc) * l.kstr : size_t(kc) * p.Dp * 2));
  l.ksc = o;  o = align16(o + (p.intm ? size_t(kc) * p.nb * 4 : 0));
  l.kpw = o;  o = align16(o + (ex ? size_t(kc) * p.nb * 4 : 0));
  l.kn = o;   o = align16(o + (opn ? size_t(kc) * (p.intm ? l.nstr : p.Dp * 2) : 0));
  l.ksg = o;  o = align16(o + (ex && !p.intm ? size_t(kc) * p.nb * 4 : 0));
  l.kc = o;   o = align16(o + (bint ? size_t(kc) * l.kstr : 0));
  l.kcs = o;  o = align16(o + (bint ? size_t(kc) * p.nb * 4 : 0));
  l.kh = o;   o = align16(o + (elsa ? size_t(kc) * 16 : 0));
  l.v = o;    o = align16(o + size_t(p.D8) * l.vstr * (exact_mma ? 1 : 2));
  l.ve = o;   o = align16(o + (exact_mma ? size_t(kc / kBlock) * p.D8 * 2 : 0));
  l.bias = o; o = align16(o + size_t(kc) * 4);
  l.cos = o;  o = align16(o + (elsa ? size_t(kMaxBits + 1) * 4 : 0));
  l.warp0 = o;
  size_t w = 0;
  l.w_sel = w; w = align16(w + (topk ? sel_bytes : 0));
  // the union: the selection's packed digits, or the chunk's probabilities
  // and the PV sums carried between chunks
  const size_t digits = topk ? size_t(kRows) * p.Sp : 0;
  const size_t probs = exact_mma ? size_t(kc / kBlock) * 32 * 24 : size_t(kRows) * (kc + 4) * 2;
  const size_t acc = p.nchunks == 1 ? 0
                     : exact_mma   ? size_t(p.D8 / 8) * 32 * 16
                                   : size_t(MAX_HEAD_DIM / 8) * 4 * 32 * 4;
  l.w_u = w;
  l.w_acc = w + align16(probs);
  w = align16(w + (digits > align16(probs) + acc ? digits : align16(probs) + acc));
  l.w_q = w;
  w = align16(w + (p.intm ? (elsa ? size_t(kRows) * p.Dp * 4 : 0)
                          : size_t(kRows) * p.Dp * 2 * (opn ? 2 : 1) + size_t(kRows) * p.nb * 8));
  l.warp_bytes = w;
  l.total = o + size_t(p.W) * w;
  return l;
}

__device__ __forceinline__ float ld_in(const void* base, int bf16, size_t idx) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(base)[idx])
              : static_cast<const float*>(base)[idx];
}

// Slot of key kk (0..31) within its 32-key block in the exact tier's v:
// key 8 jj + 2 t + e sits where the PV mma's operand layout expects the
// probability that lane t holds for it.
__device__ __forceinline__ int pv_slot(int kk) {
  const int jj = kk >> 3, t = (kk >> 1) & 3, e = kk & 1;
  return ((jj >> 1) << 4) + 4 * t + 2 * (jj & 1) + e;
}

// ---------------------------------------------------------------------------
// The pre-pass: one warp per (cell, 32-key block) quantizes k and v into the
// workspace.

template <typename T>
__device__ __forceinline__ void prepass_v(const Params& p, unsigned char* ws, int cell, int kb,
                                          int lane) {
  constexpr int E = ChunkOf<T>::kElems;
  const int s = kb * kBlock + lane;
  const T* src = static_cast<const T*>(p.v) + (size_t(cell) * p.S + s) * p.D;
  const bool round_inputs = p.bfloat16 && !p.in_bf16;
  const bool exact_mma = p.intm && !p.relaxed;
  const int nch = (p.D + E - 1) / E;
  unsigned char* vq = ws + p.w.v;
  short* ve = reinterpret_cast<short*>(ws + p.w.ve);
  __nv_bfloat16* vb = reinterpret_cast<__nv_bfloat16*>(ws + p.w.v);
  for (int c0 = 0; c0 < nch; c0 += 4) {
    uint4 raw[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int d0 = (c0 + u) * E;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (c0 + u < nch && s < p.S) raw[u] = load_chunk(src + d0, min(E, p.D - d0), p.v_vec);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c0 + u >= nch) break;  // uniform
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const int d = (c0 + u) * E + i;
        float x = chunk_elem<T>(raw[u], i);
        if (round_inputs) x = bf16_round_away(x);
        const unsigned mb = __reduce_max_sync(kFull, mag_bits(x));
        if (d >= p.D) break;  // uniform
        const int e = shared_exp(mb, p.fmt);
        if (exact_mma) {
          vq[size_t(d) * p.Sp + kb * kBlock + pv_slot(lane)] =
              (unsigned char)(quant_int(x, mb, e, p.fmt, false) & 0xff);
          if (lane == 0) ve[kb * p.D8 + d] = short(e);
        } else {  // exact in bf16 on the int grids
          vb[size_t(d) * p.Sp + s] = __float2bfloat16_rn(quant_val(x, mb, e, p.fmt, false));
        }
      }
    }
  }
  for (int d = p.D; d < p.D8; ++d) {  // padded columns: zero
    if (exact_mma) {
      vq[size_t(d) * p.Sp + kb * kBlock + lane] = 0;
      if (lane == 0) ve[kb * p.D8 + d] = 0;
    } else {
      vb[size_t(d) * p.Sp + s] = __float2bfloat16_rn(0.f);
    }
  }
}

// The four elements src[0..n) (the rest zero): one 16-byte (f32) or 8-byte
// (bf16) load where vec
template <typename T>
__device__ __forceinline__ void load4(const T* src, int n, bool vec, float (&x)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = 0.f;
  if (vec && n == 4) {
    if constexpr (sizeof(T) == 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src));
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
      x[0] = __uint_as_float(v.x << 16); x[1] = __uint_as_float(v.x & 0xffff0000u);
      x[2] = __uint_as_float(v.y << 16); x[3] = __uint_as_float(v.y & 0xffff0000u);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < n) x[i] = ld_in(src, sizeof(T) == 2, i);
}

// k on the int grids: eight lanes per (key, 32-d block), four d each, so a
// warp step quantizes four blocks (the block maximum a reduction over the
// eight lanes) and stores four grid points (and two_step's n) at once
template <typename T, int PRED>
__device__ __forceinline__ void prepass_k_int(const Params& p, unsigned char* ws, int cell,
                                              int kb, int lane) {
  constexpr int kSteps = 2;  // warp steps whose loads are in flight together
  const int gi = lane >> 3, sub = lane & 7;
  const bool round_inputs = p.bfloat16 && !p.in_bf16;
  constexpr bool ex = PRED == kExPred, two = PRED == kTwoStep, bint = PRED == kBlockInt;
  const T* src = static_cast<const T*>(p.k);
  float* ksc = reinterpret_cast<float*>(ws + p.w.ksc);
  float* kpw = reinterpret_cast<float*>(ws + p.w.kpw);
  float* kcs = reinterpret_cast<float*>(ws + p.w.kcs);
  const int pairs = kBlock * p.nb;  // (key, block) pairs: a multiple of 32
  for (int u0 = 0; u0 < pairs; u0 += 4 * kSteps) {
    float x[kSteps][4];
#pragma unroll
    for (int v = 0; v < kSteps; ++v) {
      const int pi = u0 + 4 * v + gi;
      const int s = kb * kBlock + pi / p.nb, d0 = (pi % p.nb) * kBlock + 4 * sub;
      const bool ok = pi < pairs && s < p.S && d0 < p.D;
      load4(src + (size_t(cell) * p.S + s) * p.D + d0, ok ? min(4, p.D - d0) : 0, p.k_vec,
            x[v]);
    }
#pragma unroll
    for (int v = 0; v < kSteps; ++v) {
      const int pi = u0 + 4 * v + gi;
      if (u0 + 4 * v >= pairs) break;  // uniform
      const int s = kb * kBlock + pi / p.nb, blk = pi % p.nb, d0 = blk * kBlock + 4 * sub;
      unsigned mb = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (round_inputs) x[v][i] = bf16_round_away(x[v][i]);
        mb = max(mb, mag_bits(x[v][i]));
      }
      mb = max(mb, __shfl_xor_sync(kFull, mb, 1));
      mb = max(mb, __shfl_xor_sync(kFull, mb, 2));
      mb = max(mb, __shfl_xor_sync(kFull, mb, 4));
      const int e = shared_exp(mb, p.fmt);
      unsigned w = 0u, n01 = 0u, n23 = 0u, cw = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w |= (unsigned(quant_int(x[v][i], mb, e, p.fmt, false)) & 0xffu) << (8 * i);
        if (bint)
          cw |= (unsigned(block_int_code(p.mode, p.fmt, p.fmt4, false, x[v][i], mb, e,
                                         d0 + i < p.D)) & 0xffu) << (8 * i);
        if (two) {
          const float val = bf16_rne(quant_val(x[v][i], mb, e, p.fmt, false));
          const unsigned n = unsigned(two_step_n(val, e)) & 0xffffu;
          if (i < 2) n01 |= n << (16 * i);
          else n23 |= n << (16 * (i - 2));
        }
      }
      *reinterpret_cast<unsigned*>(ws + p.w.kq + size_t(s) * p.Dp + d0) = w;
      if (two)
        *reinterpret_cast<uint2*>(ws + p.w.kn + (size_t(s) * p.Dp + d0) * 2) =
            make_uint2(n01, n23);
      if (bint) *reinterpret_cast<unsigned*>(ws + p.w.kc + size_t(s) * p.Dp + d0) = cw;
      if (sub == 0) {
        ksc[s * p.nb + blk] = pow2_sub(e - p.shift);
        if (ex) kpw[s * p.nb + blk] = pow2f(min(max(e, -126), 127));
        if (bint) kcs[s * p.nb + blk] = block_int_scale(p.mode, p.fmt4, p.shift, false, mb, e);
      }
    }
  }
}

// ELSA's hash words and norm of key s = 32 kb + lane from its quantized
// values, which this warp has just written to the workspace: bit b is proj
// row b times the key (products rounded, added in d order) >= 0, the norm
// sqrt(sum kv^2) in d order
__device__ __forceinline__ void prepass_elsa(const Params& p, unsigned char* ws, int kb,
                                             int lane) {
  const int s = kb * kBlock + lane;
  const signed char* kq = reinterpret_cast<const signed char*>(ws + p.w.kq) + size_t(s) * p.Dp;
  const __nv_bfloat16* kf = reinterpret_cast<const __nv_bfloat16*>(ws + p.w.kq) +
                            size_t(s) * p.Dp;
  const float* ksc = reinterpret_cast<const float*>(ws + p.w.ksc) + size_t(s) * p.nb;
  auto val = [&](int d) {
    return p.intm ? bf16_rne(__fmul_rn(float(kq[d]), ksc[d / kBlock]))
                  : __bfloat162float(kf[d]);
  };
  float nsum = 0.f;
  unsigned hw[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    if (32 * w >= p.bits) break;  // uniform
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    for (int d = 0; d < p.D; ++d) {
      const float x = val(d);
      if (w == 0) nsum = __fadd_rn(nsum, __fmul_rn(x, x));
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int b = min(32 * w + i, p.bits - 1);
        acc[i] = __fadd_rn(acc[i], __fmul_rn(__ldg(p.proj + size_t(b) * p.D + d), x));
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (32 * w + i < p.bits && acc[i] >= 0.f) hw[w] |= 1u << i;
  }
  reinterpret_cast<uint4*>(ws + p.w.kh)[s] = make_uint4(hw[0], hw[1], hw[2], hw[3]);
  reinterpret_cast<float*>(ws + p.w.kno)[s] = sqrtf(nsum);
}

// One instantiation per predictor kind, so that each holds only its own
// arrays' code and registers (ELSA's hashing, above all, needs many)
template <int PRED>
__global__ void __launch_bounds__(256) split_prepass_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const int task = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (task >= p.B * p.H * p.nkb) return;  // uniform over the warp
  const int cell = task / p.nkb, kb = task - cell * p.nkb;
  unsigned char* ws = p.ws + size_t(cell) * p.w.cell;
  const bool round_inputs = p.bfloat16 && !p.in_bf16;
  constexpr bool ex = PRED == kExPred, opn = PRED == kOperand;
  float* kpw = reinterpret_cast<float*>(ws + p.w.kpw);
  unsigned* ksg = reinterpret_cast<unsigned*>(ws + p.w.ksg);
  __nv_bfloat16* kf = reinterpret_cast<__nv_bfloat16*>(ws + p.w.kq);
  __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(ws + p.w.kn);
  if (p.intm) {
    if (p.in_bf16) prepass_k_int<__nv_bfloat16, PRED>(p, ws, cell, kb, lane);
    else prepass_k_int<float, PRED>(p, ws, cell, kb, lane);
  }
  // k (MXFP): one (key, 32-d block) per step, lane l holding d = 32 blk + l
  const int tasks = p.intm ? 0 : kBlock * p.nb;
  for (int u0 = 0; u0 < tasks; u0 += kUnroll) {
    float xs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int tt = u0 + u;
      const int s = kb * kBlock + tt / p.nb, d = (tt % p.nb) * kBlock + lane;
      xs[u] = tt < tasks && s < p.S && d < p.D
                  ? ld_in(p.k, p.in_bf16, (size_t(cell) * p.S + s) * p.D + d)
                  : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int tt = u0 + u;
      if (tt >= tasks) break;  // uniform
      const int s = kb * kBlock + tt / p.nb, blk = tt % p.nb, d = blk * kBlock + lane;
      const float x = round_inputs ? bf16_round_away(xs[u]) : xs[u];
      int pe;
      unsigned mb;
      const float val = quant_lane_block(x, p.fmt, pe, mb);
      kf[size_t(s) * p.Dp + d] = __float2bfloat16_rn(val);
      if (ex) {
        const unsigned neg = __ballot_sync(kFull, val < 0.f);  // zeros count as +
        if (lane == 0) {
          ksg[s * p.nb + blk] = neg;
          kpw[s * p.nb + blk] = pow2f(min(max(pe, -126), 127));
        }
      }
      if (opn)
        kt[size_t(s) * p.Dp + d] =
            __float2bfloat16_rn(fp_operand(p.mode, p.fmt4, false, val, pe, x, mb, d < p.D));
    }
  }
  if constexpr (PRED == kElsa) {
    __syncwarp();  // the warp's k values are in the workspace
    prepass_elsa(p, ws, kb, lane);
  }
  if (p.in_bf16) prepass_v<__nv_bfloat16>(p, ws, cell, kb, lane);
  else prepass_v<float>(p, ws, cell, kb, lane);
}

// ---------------------------------------------------------------------------
// The attention kernel

__device__ __forceinline__ int score_mask(const Params& p) {
  return p.intm ? kAKq | kAKsc : kAKq;
}

__device__ __forceinline__ int select_mask(const Params& p) {
  if (p.pred == kTwoStep || p.pred == kOperand) return kAKn;
  if (p.pred == kExPred) return p.intm ? kAKq | kAKpw : kAKsg | kAKpw;
  if (p.pred == kBlockInt) return kAKc | kAKcs;
  if (p.pred == kElsa) return kAKh;
  return score_mask(p);
}

__device__ __forceinline__ int pv_mask(const Params& p) {
  return p.intm && !p.relaxed ? kAV | kAVe : kAV;
}

// Copy the arrays of `mask` of key chunk c from the cell's workspace into
// shared memory (asynchronously; the caller waits), and the bias.
__device__ __forceinline__ void stage_chunk(const Params& p, const Layout& L, unsigned char* smem,
                                            const unsigned char* ws, int b, int c, int mask) {
  const int s0 = c * p.kc, ck = min(p.kc, p.Sp - s0);
  const int tid = threadIdx.x, nt = blockDim.x;
  // rows of row_bytes (a multiple of 16) at the given strides
  auto copy = [&](size_t src, int src_stride, size_t dst, int dst_stride, int rows,
                  int row_bytes) {
    const int upr = row_bytes >> 4, total = rows * upr;
    for (int u = tid; u < total; u += nt) {
      const int r = u / upr, cu = u - r * upr;
      const unsigned char* s = ws + src + size_t(r) * src_stride + cu * 16;
      unsigned char* d = smem + dst + size_t(r) * dst_stride + cu * 16;
      if (dst_stride & 15) {
#pragma unroll
        for (int i = 0; i < 4; ++i) cp_async4(d + 4 * i, s + 4 * i);
      } else {
        cp_async16(d, s);
      }
    }
  };
  const int nbb = p.nb * 4;  // bytes per key of a per-block f32 array
  if (mask & kAKq) {
    if (p.intm) copy(p.w.kq + size_t(s0) * p.Dp, p.Dp, L.kq, L.kstr, ck, p.Dp);
    else copy(p.w.kq + size_t(s0) * p.Dp * 2, 0, L.kq, 0, 1, ck * p.Dp * 2);
  }
  if (mask & kAKsc) copy(p.w.ksc + size_t(s0) * nbb, 0, L.ksc, 0, 1, ck * nbb);
  if (mask & kAKpw) copy(p.w.kpw + size_t(s0) * nbb, 0, L.kpw, 0, 1, ck * nbb);
  if (mask & kAKsg) copy(p.w.ksg + size_t(s0) * nbb, 0, L.ksg, 0, 1, ck * nbb);
  if (mask & kAKn) {
    if (p.intm) copy(p.w.kn + size_t(s0) * p.Dp * 2, p.Dp * 2, L.kn, L.nstr, ck, p.Dp * 2);
    else copy(p.w.kn + size_t(s0) * p.Dp * 2, 0, L.kn, 0, 1, ck * p.Dp * 2);
  }
  if (mask & kAKc) copy(p.w.kc + size_t(s0) * p.Dp, p.Dp, L.kc, L.kstr, ck, p.Dp);
  if (mask & kAKcs) copy(p.w.kcs + size_t(s0) * nbb, 0, L.kcs, 0, 1, ck * nbb);
  if (mask & kAKh) copy(p.w.kh + size_t(s0) * 16, 0, L.kh, 0, 1, ck * 16);
  if (mask & kAV) {
    if (p.intm && !p.relaxed) copy(p.w.v + s0, p.Sp, L.v, L.vstr, p.D8, ck);
    else copy(p.w.v + size_t(s0) * 2, p.Sp * 2, L.v, L.vstr * 2, p.D8, ck * 2);
  }
  if (mask & kAVe)
    copy(p.w.ve + size_t(s0 / kBlock) * p.D8 * 2, 0, L.ve, 0, 1, (ck / kBlock) * p.D8 * 2);
  float* bs = reinterpret_cast<float*>(smem + L.bias);
  for (int i = tid; i < ck; i += nt)
    bs[i] = p.bias && s0 + i < p.S ? p.bias[size_t(b) * p.S + s0 + i] : 0.f;
}

// Calls f(s0, ck) for each key chunk in order; where the K side comes in
// several chunks, the block stages each (all warps take part) first.
template <class F>
__device__ __forceinline__ void for_chunks(const Params& p, const Layout& L, unsigned char* smem,
                                           const unsigned char* ws, int b, int mask, const F& f) {
  for (int c = 0; c < p.nchunks; ++c) {
    if (p.nchunks > 1) {
      __syncthreads();  // every warp is done with the previous chunk
      stage_chunk(p, L, smem, ws, b, c, mask);
      cp_async_wait_all();
      __syncthreads();
    }
    f(c * p.kc, min(p.kc, p.Sp - c * p.kc));
  }
}

// ---- a warp's 16 query rows on the mma accumulator layout: lane (g, t)
// holds rows g and g + 8 (row slot r = i >> 1 of element i) at keys
// 8 j + 2 t + (i & 1) of each 8-key tile j
struct RowTile {
  int row[2];
  unsigned qa[kMaxNb][4];  // INT: q's int8 grid points, mma operand layout
  unsigned sa[kMaxNb][4];  // INT ex_pred: their signs as +-1, padded d zero
  unsigned nh[kMaxNb][4];  // INT two_step: n's high bytes (s8)
  unsigned nl[kMaxNb][4];  // INT two_step: n's low bytes (u8)
  unsigned ca[kMaxNb][4];  // INT block-grid predictors: q's codes (s8)
  float pq[2][kMaxNb];     // 2^(eq - (mbits-2))
  float pwq[2][kMaxNb];    // ex_pred's 2^eq
  float cs[2][kMaxNb];     // the block-grid predictors' scales of q
  unsigned qh[2][4];       // ELSA: the rows' hash words
  float nrm[2];            // ELSA: the norms of the keys at the rows' indices
};

// ELSA's hash words of the warp's 16 query rows from their quantized values
// vals [16][Dp] in its shared memory (T: float or bf16): lane i computes bit
// 32 w + i of every row, proj row times the values (products rounded, added
// in d order) >= 0, and a ballot makes the word; lane (g, t) keeps rows g
// and g + 8, and the norms of the keys at their indices (0 past the keys)
template <typename T>
__device__ __forceinline__ void elsa_q(const Params& p, const unsigned char* ws, const T* vals,
                                       RowTile& rt, int lane) {
  const int g = lane >> 2;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    rt.qh[0][w] = rt.qh[1][w] = 0u;
    if (32 * w >= p.bits) continue;  // uniform
    const int b = 32 * w + lane;
    const float* pr = p.proj + size_t(min(b, p.bits - 1)) * p.D;
    for (int r = 0; r < kRows; ++r) {
      float acc = 0.f;
      for (int d = 0; d < p.D; ++d) {
        float x;
        if constexpr (sizeof(T) == 4) x = vals[r * p.Dp + d];
        else x = __bfloat162float(vals[r * p.Dp + d]);
        acc = __fadd_rn(acc, __fmul_rn(__ldg(pr + d), x));
      }
      const unsigned word = __ballot_sync(kFull, b < p.bits && acc >= 0.f);
      if (r == g) rt.qh[0][w] = word;
      if (r == g + 8) rt.qh[1][w] = word;
    }
  }
  const float* kno = reinterpret_cast<const float*>(ws + p.w.kno);
#pragma unroll
  for (int r = 0; r < 2; ++r) rt.nrm[r] = rt.row[r] < p.Sp ? kno[rt.row[r]] : 0.f;
}

// q (INT formats): the four values of row n at d0 .. d0 + 3, zero past D
// and N (one 8- or 16-byte load where aligned)
template <typename T>
__device__ __forceinline__ void q_chunk(const Params& p, int cell, int n, int d0, float (&x)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = 0.f;
  if (n >= p.N || d0 >= p.D) return;
  const T* src = static_cast<const T*>(p.q) + (size_t(cell) * p.N + n) * p.D + d0;
  if (p.q_vec && d0 + 4 <= p.D) {
    if constexpr (sizeof(T) == 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src));
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
      x[0] = __uint_as_float(v.x << 16); x[1] = __uint_as_float(v.x & 0xffff0000u);
      x[2] = __uint_as_float(v.y << 16); x[3] = __uint_as_float(v.y & 0xffff0000u);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (d0 + i < p.D) x[i] = ld_in(p.q, sizeof(T) == 2, (size_t(cell) * p.N + n) * p.D + d0 + i);
}

// q's values for the lane's two rows and its 8 d of each 32-d block (4 t ..
// 4 t + 3 and 16 + 4 t .. 16 + 4 t + 3), quantized into the operand
// registers, the next block's loads in flight while one block is quantized;
// the block maximum is a quad reduction
template <int PRED, typename T>
__device__ __forceinline__ void load_q_int(const Params& p, int cell, RowTile& rt, int t,
                                           unsigned char* wq) {
  const bool round_inputs = p.bfloat16 && !p.in_bf16;
  const int g = (threadIdx.x & 31) >> 2;
  float x[2][4][4];
#pragma unroll
  for (int blk = 0; blk <= kMaxNb; ++blk) {
    if (blk < p.nb) {
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        q_chunk<T>(p, cell, rt.row[rr & 1], blk * kBlock + (rr >> 1) * 16 + 4 * t, x[blk & 1][rr]);
    }
    const int qb = blk - 1;  // the block to quantize
    if (qb < 0 || qb >= p.nb) continue;
    float(&xq)[4][4] = x[qb & 1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      unsigned mb = 0;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float& v = xq[2 * hf + r][i];
          if (round_inputs) v = bf16_round_away(v);
          mb = max(mb, mag_bits(v));
        }
      mb = max(mb, __shfl_xor_sync(kFull, mb, 1));
      mb = max(mb, __shfl_xor_sync(kFull, mb, 2));
      const int e = shared_exp(mb, p.fmt);
      rt.pq[r][qb] = pow2_sub(e - p.shift);
      if (PRED == kExPred) rt.pwq[r][qb] = pow2f(min(max(e, -126), 127));
      if (PRED == kBlockInt) rt.cs[r][qb] = block_int_scale(p.mode, p.fmt4, p.shift, true, mb, e);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int rr = 2 * hf + r, d0 = qb * kBlock + hf * 16 + 4 * t;
        unsigned w = 0u, m = 0u, wh = 0u, wl = 0u, cw = 0u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          w |= (unsigned(quant_int(xq[rr][i], mb, e, p.fmt, false)) & 0xffu) << (8 * i);
          m |= (d0 + i < p.D ? 0xffu : 0u) << (8 * i);
          if (PRED == kTwoStep) {
            const int n = two_step_n(bf16_rne(quant_val(xq[rr][i], mb, e, p.fmt, false)), e);
            wl |= (unsigned(n) & 0xffu) << (8 * i);
            wh |= (unsigned(n >> 8) & 0xffu) << (8 * i);
          }
          if (PRED == kBlockInt)
            cw |= (unsigned(block_int_code(p.mode, p.fmt, p.fmt4, true, xq[rr][i], mb, e,
                                           d0 + i < p.D)) & 0xffu) << (8 * i);
          if (PRED == kElsa)  // the quantized values, for the hash
            reinterpret_cast<float*>(wq)[(g + 8 * r) * p.Dp + d0 + i] =
                bf16_rne(quant_val(xq[rr][i], mb, e, p.fmt, false));
        }
        rt.qa[qb][rr] = w;
        if (PRED == kExPred) rt.sa[qb][rr] = sign_bytes(w) & m;
        if (PRED == kTwoStep) {
          rt.nh[qb][rr] = wh;
          rt.nl[qb][rr] = wl;
        }
        if (PRED == kBlockInt) rt.ca[qb][rr] = cw;
      }
    }
  }
}

// q (the CUDA-core kernel): the warp's 16 rows quantized into its shared
// memory as bf16 values [16][Dp], predictor operands [16][Dp], sign masks
// and predictor exponents [16][nb], one (row, block) at a time
template <int PRED>
__device__ __forceinline__ void load_q_fp(const Params& p, int cell, int r0, unsigned char* wq,
                                          RowTile& rt, int lane, int g) {
  __nv_bfloat16* qf = reinterpret_cast<__nv_bfloat16*>(wq);
  __nv_bfloat16* qt = qf + kRows * p.Dp;
  unsigned* qsg = reinterpret_cast<unsigned*>(wq + size_t(kRows) * p.Dp * 2 *
                                                       (PRED == kOperand ? 2 : 1));
  int* qpe = reinterpret_cast<int*>(qsg + kRows * p.nb);
  const bool round_inputs = p.bfloat16 && !p.in_bf16;
  for (int r = 0; r < kRows; ++r)
    for (int blk = 0; blk < p.nb; ++blk) {
      const int n = r0 + r, d = blk * kBlock + lane;
      float x = n < p.N && d < p.D
                    ? ld_in(p.q, p.in_bf16, (size_t(cell) * p.N + n) * p.D + d)
                    : 0.f;
      if (round_inputs) x = bf16_round_away(x);
      int pe;
      unsigned mb;
      const float val = quant_lane_block(x, p.fmt, pe, mb);
      qf[r * p.Dp + d] = __float2bfloat16_rn(val);
      if (PRED == kOperand)
        qt[r * p.Dp + d] =
            __float2bfloat16_rn(fp_operand(p.mode, p.fmt4, true, val, pe, x, mb, d < p.D));
      const unsigned neg = __ballot_sync(kFull, val < 0.f);  // zeros count as +
      if (lane == 0) {
        qsg[r * p.nb + blk] = neg;
        qpe[r * p.nb + blk] = pe;
      }
    }
  __syncwarp();
  if (PRED == kExPred) {
#pragma unroll
    for (int blk = 0; blk < kMaxNb; ++blk)
      if (blk < p.nb)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          rt.pwq[r][blk] = pow2f(min(max(qpe[(g + 8 * r) * p.nb + blk], -126), 127));
  }
}

// The true scores of chunk tile jt (keys 8 jt .. 8 jt + 7 of the chunk):
// per 32-d block the exact block sum (INT: one mma; MXFP: f32 in d order)
// times 2^(eq - (mbits-2)) and then 2^(ek - (mbits-2)), blocks in order;
// rounded half away to bf16 in the exact tier (bfloat=16), scaled, biased
template <bool kInt>
__device__ __forceinline__ void score_tile(const Params& p, const Layout& L,
                                           const unsigned char* smem, const unsigned char* wq,
                                           int jt, const RowTile& rt, int g, int t,
                                           float (&st)[4]) {
  const int n0 = 8 * jt;
  if constexpr (kInt) {
    const unsigned* kw = reinterpret_cast<const unsigned*>(smem + L.kq);
    const float* ksc = reinterpret_cast<const float*>(smem + L.ksc);
    const int kstrw = L.kstr / 4;
#pragma unroll
    for (int blk = 0; blk < kMaxNb; ++blk)
      if (blk < p.nb) {
        int c[4];
        mma_s8(c, rt.qa[blk], kw[(n0 + g) * kstrw + blk * 8 + t],
               kw[(n0 + g) * kstrw + blk * 8 + 4 + t]);
        const float pk0 = ksc[(n0 + 2 * t) * p.nb + blk];
        const float pk1 = ksc[(n0 + 2 * t + 1) * p.nb + blk];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float term =
              __fmul_rn(__fmul_rn(i2f_small(c[i]), rt.pq[i >> 1][blk]), (i & 1) ? pk1 : pk0);
          st[i] = blk == 0 ? term : __fadd_rn(st[i], term);
        }
      }
  } else {
    const __nv_bfloat16* qf = reinterpret_cast<const __nv_bfloat16*>(wq);
    const __nv_bfloat16* kf = reinterpret_cast<const __nv_bfloat16*>(smem + L.kq);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat16* qr = qf + (g + 8 * (i >> 1)) * p.Dp;
      const __nv_bfloat16* kr = kf + (n0 + 2 * t + (i & 1)) * p.Dp;
      float tot = 0.f;
      for (int blk = 0; blk < p.nb; ++blk) {
        const int nv = min(kBlock, p.D - kBlock * blk);
        float acc = 0.f;
        for (int dd = 0; dd < nv; ++dd)
          acc = __fmaf_rn(__bfloat162float(qr[kBlock * blk + dd]),
                          __bfloat162float(kr[kBlock * blk + dd]), acc);
        tot = blk == 0 ? acc : __fadd_rn(tot, acc);
      }
      st[i] = tot;
    }
  }
  const float* bs = reinterpret_cast<const float*>(smem + L.bias);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float x = st[i];
    if (p.bfloat16 && !p.relaxed) x = bf16_round_away(x);
    x = __fmul_rn(x, p.scale);
    if (p.bias) x = __fadd_rn(x, bs[n0 + 2 * t + (i & 1)]);
    st[i] = x;
  }
}

// The predictor scores of chunk tile jt, biased.  ex_pred: per block
// cnt * (2^eq * 2^ek), cnt the +-1 dot product over the valid d (INT: an
// mma on the signs; MXFP: popcounts of the sign masks), blocks in order.
// two_step (INT): sum over every d of nq * nk, exact in int64 from four
// byte-plane mma, rounded to f32 once, times 2^-12.  The block-grid
// predictors (INT): per block the codes' mma, times q's scale, then k's,
// blocks in order.  The CUDA-core kernel's operands: f32 products in d
// order per block, blocks in order.  ELSA: the norm at the row times the
// cosine of the hash words' hamming distance.
template <bool kInt, int PRED>
__device__ __forceinline__ void pred_tile(const Params& p, const Layout& L,
                                          const unsigned char* smem, const unsigned char* wq,
                                          int jt, const RowTile& rt, int g, int t,
                                          float (&v)[4]) {
  const int n0 = 8 * jt;
  if constexpr (PRED == kExPred) {
    const float* kpw = reinterpret_cast<const float*>(smem + L.kpw);  // 2^ek
#pragma unroll
    for (int blk = 0; blk < kMaxNb; ++blk)
      if (blk < p.nb) {
        int c[4];
        if constexpr (kInt) {
          const unsigned* kw = reinterpret_cast<const unsigned*>(smem + L.kq);
          const int kstrw = L.kstr / 4;
          mma_s8(c, rt.sa[blk], sign_bytes(kw[(n0 + g) * kstrw + blk * 8 + t]),
                 sign_bytes(kw[(n0 + g) * kstrw + blk * 8 + 4 + t]));
        } else {
          const unsigned* qsg = reinterpret_cast<const unsigned*>(
              wq + size_t(kRows) * p.Dp * 2);
          const unsigned* ksg = reinterpret_cast<const unsigned*>(smem + L.ksg);
          const int nv = min(kBlock, p.D - kBlock * blk);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            c[i] = nv - 2 * __popc(qsg[(g + 8 * (i >> 1)) * p.nb + blk] ^
                                   ksg[(n0 + 2 * t + (i & 1)) * p.nb + blk]);
        }
        const float pk0 = kpw[(n0 + 2 * t) * p.nb + blk];
        const float pk1 = kpw[(n0 + 2 * t + 1) * p.nb + blk];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float term =
              __fmul_rn(i2f_small(c[i]), __fmul_rn(rt.pwq[i >> 1][blk], (i & 1) ? pk1 : pk0));
          v[i] = blk == 0 ? term : __fadd_rn(v[i], term);
        }
      }
  } else if constexpr (PRED == kTwoStep) {  // the int grids only
    int hh[4] = {0, 0, 0, 0}, hl[4] = {0, 0, 0, 0}, lh[4] = {0, 0, 0, 0}, ll[4] = {0, 0, 0, 0};
    const unsigned char* kr = smem + L.kn + size_t(n0 + g) * L.nstr;
#pragma unroll
    for (int blk = 0; blk < kMaxNb; ++blk)
      if (blk < p.nb) {
        // n of d = 32 blk + 4 t .. + 3 and 16 more: int16 little-endian
        const uint2 w0 = *reinterpret_cast<const uint2*>(kr + blk * 64 + 8 * t);
        const uint2 w1 = *reinterpret_cast<const uint2*>(kr + blk * 64 + 32 + 8 * t);
        const unsigned l0 = __byte_perm(w0.x, w0.y, 0x6420), h0 = __byte_perm(w0.x, w0.y, 0x7531);
        const unsigned l1 = __byte_perm(w1.x, w1.y, 0x6420), h1 = __byte_perm(w1.x, w1.y, 0x7531);
        mma_acc_ss(hh, rt.nh[blk], h0, h1);
        mma_acc_su(hl, rt.nh[blk], l0, l1);
        mma_acc_us(lh, rt.nl[blk], h0, h1);
        mma_acc_uu(ll, rt.nl[blk], l0, l1);
      }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long x = (static_cast<long long>(hh[i]) << 16) +
                          (static_cast<long long>(hl[i] + lh[i]) << 8) + ll[i];
      v[i] = __fmul_rn(__ll2float_rn(x), 0x1p-12f);
    }
  } else if constexpr (PRED == kBlockInt) {
    const unsigned* kw = reinterpret_cast<const unsigned*>(smem + L.kc);
    const float* kcs = reinterpret_cast<const float*>(smem + L.kcs);
    const int kstrw = L.kstr / 4;
#pragma unroll
    for (int blk = 0; blk < kMaxNb; ++blk)
      if (blk < p.nb) {
        int c[4];
        mma_s8(c, rt.ca[blk], kw[(n0 + g) * kstrw + blk * 8 + t],
               kw[(n0 + g) * kstrw + blk * 8 + 4 + t]);
        const float pk0 = kcs[(n0 + 2 * t) * p.nb + blk];
        const float pk1 = kcs[(n0 + 2 * t + 1) * p.nb + blk];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float term =
              __fmul_rn(__fmul_rn(i2f_small(c[i]), rt.cs[i >> 1][blk]), (i & 1) ? pk1 : pk0);
          v[i] = blk == 0 ? term : __fadd_rn(v[i], term);
        }
      }
  } else if constexpr (PRED == kOperand) {
    const __nv_bfloat16* qt = reinterpret_cast<const __nv_bfloat16*>(wq) + kRows * p.Dp;
    const __nv_bfloat16* kt = reinterpret_cast<const __nv_bfloat16*>(smem + L.kn);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat16* qr = qt + (g + 8 * (i >> 1)) * p.Dp;
      const __nv_bfloat16* kr = kt + (n0 + 2 * t + (i & 1)) * p.Dp;
      float tot = 0.f;
      for (int blk = 0; blk < p.nb; ++blk) {
        const int nv = min(kBlock, p.D - kBlock * blk);
        float acc = 0.f;
        for (int dd = 0; dd < nv; ++dd)
          acc = __fmaf_rn(__bfloat162float(qr[kBlock * blk + dd]),
                          __bfloat162float(kr[kBlock * blk + dd]), acc);
        tot = blk == 0 ? acc : __fadd_rn(tot, acc);
      }
      v[i] = tot;
    }
  } else if constexpr (PRED == kElsa) {
    const uint4* kh = reinterpret_cast<const uint4*>(smem + L.kh);
    const float* tab = reinterpret_cast<const float*>(smem + L.cos);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint4 h = kh[n0 + 2 * t + e];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int ham = __popc(rt.qh[r][0] ^ h.x) + __popc(rt.qh[r][1] ^ h.y) +
                        __popc(rt.qh[r][2] ^ h.z) + __popc(rt.qh[r][3] ^ h.w);
        v[2 * r + e] = __fmul_rn(rt.nrm[r], tab[ham]);
      }
    }
  }
  if (p.bias) {
    const float* bs = reinterpret_cast<const float*>(smem + L.bias);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __fadd_rn(v[i], bs[n0 + 2 * t + (i & 1)]);
  }
}

// The selection keys of chunk tile jt: the predictor's, or the true
// scores' (top-k without a predictor); keys past S are masked
template <bool kInt, int PRED>
__device__ __forceinline__ void tile_keys(const Params& p, const Layout& L,
                                          const unsigned char* smem, const unsigned char* wq,
                                          int jt, int s0, const RowTile& rt, int g, int t,
                                          int (&k)[4]) {
  float v[4];
  if constexpr (PRED == kNone) score_tile<kInt>(p, L, smem, wq, jt, rt, g, t, v);
  else pred_tile<kInt, PRED>(p, L, smem, wq, jt, rt, g, t, v);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    k[i] = mono_key(s0 + 8 * jt + 2 * t + (i & 1) < p.S ? v[i] : kNeg, p.key_bits);
}

// the exact tier's ties at the k-th key, lowest index first: the rank of a
// tie counts the ties of the earlier tiles, of the row's lower lanes in this
// tile (from four ballots), and for key 2 t + 1 the lane's own key 2 t
__device__ __forceinline__ void take_ties(int j, const int (&k)[4], const int (&kth)[2],
                                          const int (&room)[2], int g, int t, int (&before)[2],
                                          unsigned (&word)[2]) {
  const unsigned quad = 0xfu << (4 * g), lower = ((1u << t) - 1u) << (4 * g);
  const int sh = 2 * (j & 15);
  unsigned bal[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) bal[i] = __ballot_sync(kFull, k[i] == kth[i >> 1]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int eq0 = k[2 * r] == kth[r], eq1 = k[2 * r + 1] == kth[r];
    const int rank0 =
        before[r] + __popc(bal[2 * r] & lower) + __popc(bal[2 * r + 1] & lower) + 1;
    if (k[2 * r] > kth[r] || (eq0 && rank0 <= room[r])) word[r] |= 1u << sh;
    if (k[2 * r + 1] > kth[r] || (eq1 && rank0 + eq0 <= room[r])) word[r] |= 2u << sh;
    before[r] += __popc(bal[2 * r] & quad) + __popc(bal[2 * r + 1] & quad);
  }
}

// The selected keys of the warp's 16 rows, as bits in its shared memory:
// word ((j >> 4) * 2 + r) * 32 + lane, bit 2 (j & 15) + e, for key
// 8 j + 2 t + e of row slot r.  The k-th key by a radix select, 8 bits a
// level from the top: a pass over the keys packs, for each row, the digit
// of every key whose higher digits equal the row's prefix (0 for the rest)
// four to a word in the lane's own words of shared memory; then 8
// bisection passes over the words (__vcmpgtu4, popcounts, the quad's four
// lanes summed) find the digit at which the count of greater digits drops
// below what is left of k.  The counts of greater keys add up to
// count(keys > kth), as the bisection's cnt_hi.  A last pass marks the
// selected keys.  With a cache (one chunk), the keys are computed once into
// it, [Sp/8][4][32], and every pass reads them there.
template <bool kInt, int PRED>
__device__ __forceinline__ void select_tile(const Params& p, const Layout& L, unsigned char* smem,
                                            const unsigned char* ws, int b,
                                            const unsigned char* wq, const RowTile& rt,
                                            int lane, unsigned* selw, unsigned* pk,
                                            int* cache) {
  const int g = lane >> 2, t = lane & 3;
  const int mask = select_mask(p);
  // the selection keys of chunk tile jt
  auto keys = [&](int jt, int s0, int (&k)[4]) {
    if (cache) {
#pragma unroll
      for (int i = 0; i < 4; ++i) k[i] = cache[((s0 / 8 + jt) * 4 + i) * 32 + lane];
    } else {
      tile_keys<kInt, PRED>(p, L, smem, wq, jt, s0, rt, g, t, k);
    }
  };
  if (cache) {
#pragma unroll 2
    for (int jt = 0; jt < p.Sp / 8; ++jt) {
      int k[4];
      tile_keys<kInt, PRED>(p, L, smem, wq, jt, 0, rt, g, t, k);
#pragma unroll
      for (int i = 0; i < 4; ++i) cache[(jt * 4 + i) * 32 + lane] = k[i];
    }
  }
  const unsigned lo0 = p.key_bits == 8 ? 0xffffff80u : p.key_bits == 16 ? 0xffff8000u : 0x80000000u;
  const int nw = p.Sp / 16;  // words per row slot and lane
  unsigned pre[2] = {0u, 0u};
  int above[2] = {0, 0};
  for (int lv = 0; lv < p.key_bits / 8; ++lv) {
    const int sh = p.key_bits - 8 * (lv + 1);
    for_chunks(p, L, smem, ws, b, mask, [&](int s0, int ck) {
      unsigned word[2] = {0u, 0u};
#pragma unroll 2
      for (int jt = 0; jt < ck / 8; ++jt) {
        const int j = s0 / 8 + jt;
        int k[4];
        keys(jt, s0, k);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const unsigned u = unsigned(k[i]) - lo0;
          const unsigned d =
              lv == 0 || (u >> (sh + 8)) == pre[i >> 1] ? (u >> sh) & 255u : 0u;
          word[i >> 1] |= d << (8 * (2 * (j & 1) + (i & 1)));
        }
        if (j & 1) {
          pk[((j >> 1) * 2) * 32 + lane] = word[0];
          pk[((j >> 1) * 2 + 1) * 32 + lane] = word[1];
          word[0] = word[1] = 0u;
        }
      }
    });
    __syncwarp();
    // the digit: bisection with the count of greater digits carried
    int lo[2] = {0, 0}, hi[2] = {255, 255}, cnt_hi[2] = {0, 0};
    const int want[2] = {p.topk - above[0], p.topk - above[1]};
    for (int it = 0; it < 8; ++it) {
      int mid[2], c[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) mid[r] = (lo[r] + hi[r]) >> 1;
      const unsigned m0 = unsigned(mid[0]) * 0x01010101u, m1 = unsigned(mid[1]) * 0x01010101u;
      // per word, the bytes above mid as 0xff bytes: popc / 8 digits; four
      // partial counts per row keep the adds independent
      int part[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll 4
      for (int w = 0; w < nw; ++w) {
        part[0][w & 3] += __popc(__vcmpgtu4(pk[(w * 2) * 32 + lane], m0));
        part[1][w & 3] += __popc(__vcmpgtu4(pk[(w * 2 + 1) * 32 + lane], m1));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        c[r] = ((part[r][0] + part[r][1]) + (part[r][2] + part[r][3])) >> 3;
        c[r] += __shfl_xor_sync(kFull, c[r], 1);
        c[r] += __shfl_xor_sync(kFull, c[r], 2);
        if (c[r] >= want[r]) lo[r] = mid[r] + 1;
        else { hi[r] = mid[r]; cnt_hi[r] = c[r]; }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      pre[r] = (pre[r] << 8) | unsigned(lo[r]);
      above[r] += cnt_hi[r];
    }
    __syncwarp();  // the next level's pass overwrites the words
  }
  // serving: every key >= the k-th; exact: the keys above it, then ties
  const int kth[2] = {int(pre[0] + lo0), int(pre[1] + lo0)};
  const int room[2] = {p.topk - above[0], p.topk - above[1]};
  int before[2] = {0, 0};
  for (int i = lane; i < (p.Sp + 127) / 128 * 64; i += 32) selw[i] = 0u;
  __syncwarp();
  for_chunks(p, L, smem, ws, b, mask, [&](int s0, int ck) {
    unsigned word[2] = {0u, 0u};
#pragma unroll 2
    for (int jt = 0; jt < ck / 8; ++jt) {
      const int j = s0 / 8 + jt;
      int k[4];
      keys(jt, s0, k);
      if (p.relaxed) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k[i] >= kth[i >> 1]) word[i >> 1] |= 1u << (2 * (j & 15) + (i & 1));
      } else {
        take_ties(j, k, kth, room, g, t, before, word);
      }
      if ((j & 15) == 15 || jt == ck / 8 - 1) {
        selw[((j >> 4) * 2) * 32 + lane] |= word[0];
        selw[((j >> 4) * 2 + 1) * 32 + lane] |= word[1];
        word[0] = word[1] = 0u;
      }
    }
  });
  __syncwarp();
}

// ---- PV of one chunk's probabilities

// Exact tier, INT formats: one mma per (8-column tile, 32-key block) on the
// probabilities' grid points (lane-private words, in the operand layout;
// v's keys permuted to match), scaled on the probability side, then the v
// side, the blocks added in order; acc carries each lane's sums between
// chunks
__device__ __forceinline__ void pv_mma(const Params& p, const Layout& L,
                                       const unsigned char* smem, unsigned char* wa, int cell,
                                       const RowTile& rt, int s0, int ck, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const uint4* pgw = reinterpret_cast<const uint4*>(wa + L.w_u);
  const float2* pgs = reinterpret_cast<const float2*>(pgw + (p.kc / kBlock) * 32);
  float4* accw = reinterpret_cast<float4*>(wa + L.w_acc);
  const unsigned* vw = reinterpret_cast<const unsigned*>(smem + L.v);
  const short* ve = reinterpret_cast<const short*>(smem + L.ve);
  const int vstrw = L.vstr / 4;
  const bool first = s0 == 0, last = s0 + ck == p.Sp;
  for (int ct = 0; ct < p.D8 / 8; ++ct) {
    const int col0 = ct * 8 + 2 * t;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    if (!first) {
      const float4 a4 = accw[ct * 32 + lane];
      o[0] = a4.x; o[1] = a4.y; o[2] = a4.z; o[3] = a4.w;
    }
    for (int kb = 0; kb < ck / kBlock; ++kb) {
      const uint4 pw4 = pgw[kb * 32 + lane];
      const unsigned pa[4] = {pw4.x, pw4.y, pw4.z, pw4.w};
      const float2 pp = pgs[kb * 32 + lane];
      int c[4];
      mma_s8(c, pa, vw[(ct * 8 + g) * vstrw + kb * 8 + t],
             vw[(ct * 8 + g) * vstrw + kb * 8 + 4 + t]);
      const float pv0 = col0 < p.D ? pow2_sub(ve[kb * p.D8 + col0] - p.shift) : 0.f;
      const float pv1 = col0 + 1 < p.D ? pow2_sub(ve[kb * p.D8 + col0 + 1] - p.shift) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float term =
            __fmul_rn(__fmul_rn(i2f_small(c[i]), (i >> 1) ? pp.y : pp.x), (i & 1) ? pv1 : pv0);
        o[i] = first && kb == 0 ? term : __fadd_rn(o[i], term);
      }
    }
    if (!last) {
      accw[ct * 32 + lane] = make_float4(o[0], o[1], o[2], o[3]);
      continue;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rt.row[i >> 1], col = col0 + (i & 1);
      if (r >= p.N || col >= p.D) continue;
      float x = o[i];
      if (p.bfloat16) x = bf16_round_away(x);
      const size_t idx = (size_t(cell) * p.N + r) * p.D + col;
      if (p.out_bf16) static_cast<__nv_bfloat16*>(p.out)[idx] = __float2bfloat16_rn(x);
      else static_cast<float*>(p.out)[idx] = x;
    }
  }
}

// On the CUDA cores (the serving tier, and the MXFP exact tier): lane
// (rg, cg) owns output rows 4 rg .. 4 rg + 3 and columns cg * C .. cg * C +
// C - 1 (C = D8 / 8), taken four at a time so that the sums stay in the
// registers of the 128-register kernel,
// and reads four keys of a probability row or of a v column (bf16) at
// once; the serving tier sums over the keys in order, the MXFP exact tier
// within each 32-key block in order and then the blocks in order; acc
// carries the sums between chunks
template <bool kInt>
__device__ __forceinline__ void pv_cores(const Params& p, const Layout& L,
                                         const unsigned char* smem, unsigned char* wa, int cell,
                                         int r0, int s0, int ck, int lane) {
  constexpr int kMaxH = 4;  // columns of a pass: two blocks' registers hold them
  const bool blockwise = !kInt && !p.relaxed;
  const int C = p.D8 / 8, rg = lane >> 3, cg = lane & 7;
  const int pstr = p.kc + 4;  // probability row stride: the four row groups' banks differ
  const __nv_bfloat16* pb = reinterpret_cast<const __nv_bfloat16*>(wa + L.w_u) + 4 * rg * pstr;
  float* accs = reinterpret_cast<float*>(wa + L.w_acc);  // [C][4][32]
  const bool first = s0 == 0, last = s0 + ck == p.Sp;
  for (int c0 = 0; c0 < C; c0 += kMaxH) {
    const int ch = min(kMaxH, C - c0);
    const __nv_bfloat16* vb = reinterpret_cast<const __nv_bfloat16*>(smem + L.v) +
                              size_t(cg * C + c0) * L.vstr;  // [D8][vstr]
    float acc[4][kMaxH], part[4][kMaxH];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < kMaxH; ++c) {
        acc[r][c] = first || c >= ch ? 0.f : accs[((c0 + c) * 4 + r) * 32 + lane];
        part[r][c] = 0.f;
      }
    for (int sl = 0; sl < ck; sl += 4) {
      float a[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint2 pw = *reinterpret_cast<const uint2*>(pb + r * pstr + sl);
        a[r][0] = __uint_as_float(pw.x << 16);
        a[r][1] = __uint_as_float(pw.x & 0xffff0000u);
        a[r][2] = __uint_as_float(pw.y << 16);
        a[r][3] = __uint_as_float(pw.y & 0xffff0000u);
      }
#pragma unroll
      for (int c = 0; c < kMaxH; ++c) {
        if (c >= ch) break;
        const uint2 vw = *reinterpret_cast<const uint2*>(vb + size_t(c) * L.vstr + sl);
        const float vv[4] = {__uint_as_float(vw.x << 16), __uint_as_float(vw.x & 0xffff0000u),
                             __uint_as_float(vw.y << 16), __uint_as_float(vw.y & 0xffff0000u)};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if (blockwise) part[r][c] = __fmaf_rn(a[r][i], vv[i], part[r][c]);
            else acc[r][c] = __fmaf_rn(a[r][i], vv[i], acc[r][c]);
          }
      }
      if (blockwise && (sl + 4) % kBlock == 0) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < kMaxH; ++c) {
            acc[r][c] = first && sl < kBlock ? part[r][c] : __fadd_rn(acc[r][c], part[r][c]);
            part[r][c] = 0.f;
          }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = r0 + 4 * rg + r;
#pragma unroll
      for (int c = 0; c < kMaxH; ++c) {
        if (c >= ch) break;
        if (!last) {
          accs[((c0 + c) * 4 + r) * 32 + lane] = acc[r][c];
          continue;
        }
        const int d = cg * C + c0 + c;
        if (n >= p.N || d >= p.D) continue;
        float x = acc[r][c];
        if (p.bfloat16 && !p.relaxed) x = bf16_round_away(x);
        const size_t idx = (size_t(cell) * p.N + n) * p.D + d;
        if (p.out_bf16) static_cast<__nv_bfloat16*>(p.out)[idx] = __float2bfloat16_rn(x);
        else static_cast<float*>(p.out)[idx] = x;
      }
    }
  }
}

// One warp's 16-row query tile: q, selection, the masked softmax over the
// true scores (recomputed in each pass: the row maxima, the sum, the
// probabilities), PV
// q of the 16-row tile at r0: INT formats into the operand registers,
// MXFP into the warp's shared memory wq
template <bool kInt, int PRED>
__device__ __forceinline__ void load_q(const Params& p, const unsigned char* ws, int cell, int r0,
                                       unsigned char* wq, RowTile& rt, int lane) {
  const int g = lane >> 2, t = lane & 3;
  rt.row[0] = r0 + g;
  rt.row[1] = r0 + g + 8;
  if constexpr (kInt) {
    if (p.in_bf16) load_q_int<PRED, __nv_bfloat16>(p, cell, rt, t, wq);
    else load_q_int<PRED, float>(p, cell, rt, t, wq);
  } else {
    load_q_fp<PRED>(p, cell, r0, wq, rt, lane, g);
  }
  if constexpr (PRED == kElsa) {
    __syncwarp();  // the rows' quantized values are in wq
    if constexpr (kInt) elsa_q(p, ws, reinterpret_cast<const float*>(wq), rt, lane);
    else elsa_q(p, ws, reinterpret_cast<const __nv_bfloat16*>(wq), rt, lane);
  }
}

// The masked softmax over the true scores (recomputed in each pass: the row
// maxima, the sum, the probabilities) and PV of the tile at r0, whose
// selected keys are the bits selw (unless dense)
template <bool kInt, int PRED>
__device__ __forceinline__ void softmax_pv(const Params& p, const Layout& L, unsigned char* smem,
                                           const unsigned char* ws, unsigned char* wa, int cell,
                                           int b, const RowTile& rt, int r0,
                                           const unsigned* selw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned char* wq = wa + L.w_q;
  auto keep = [&](int j, int i) -> bool {
    if (p.dense) return 8 * j + 2 * t + (i & 1) < p.S;
    return (selw[((j >> 4) * 2 + (i >> 1)) * 32 + lane] >> (2 * (j & 15) + (i & 1))) & 1u;
  };
  const int smask = score_mask(p);

  // ---- the row maxima (order-free)
  float mp[4] = {kNeg, kNeg, kNeg, kNeg};
  for_chunks(p, L, smem, ws, b, smask, [&](int s0, int ck) {
    for (int jt = 0; jt < ck / 8; jt += 4) {
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        float st[4];
        score_tile<kInt>(p, L, smem, wq, jt + q4, rt, g, t, st);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          mp[i] = fmaxf(mp[i], keep(s0 / 8 + jt + q4, i) ? st[i] : kNeg);
      }
    }
  });
  float mx[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mp[2 * r], mp[2 * r + 1]);
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
  }

  // ---- the sum: 32 strided sums of keys m + 32 i in i order (lane t holds
  // m = 8 p + 2 t + e, p the tile within the 32-key block), halved in a
  // tree: m + 16 and m + 8 in the lane, m + 4 and m + 2 across the quad,
  // m + 1 in the lane (fastquant.lane_sum's order)
  float ps[2][4][2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int q4 = 0; q4 < 4; ++q4) ps[r][q4][0] = ps[r][q4][1] = 0.f;
  for_chunks(p, L, smem, ws, b, smask, [&](int s0, int ck) {
    for (int jt = 0; jt < ck / 8; jt += 4) {
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        float st[4];
        score_tile<kInt>(p, L, smem, wq, jt + q4, rt, g, t, st);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = keep(s0 / 8 + jt + q4, i) ? st[i] : kNeg;
          ps[i >> 1][q4][i & 1] =
              __fadd_rn(ps[i >> 1][q4][i & 1], expf(__fsub_rn(x, mx[i >> 1])));
        }
      }
    }
  });
  float sum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float s2[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s2[e] = __fadd_rn(__fadd_rn(ps[r][0][e], ps[r][2][e]), __fadd_rn(ps[r][1][e], ps[r][3][e]));
      s2[e] = __fadd_rn(s2[e], __shfl_xor_sync(kFull, s2[e], 2));
      s2[e] = __fadd_rn(s2[e], __shfl_xor_sync(kFull, s2[e], 1));
    }
    sum[r] = __fadd_rn(s2[0], s2[1]);
  }

  // ---- by 32-key block: the probabilities, then PV of the chunk.  The
  // exact tier's int8 grid points (one exponent per row and block) go from
  // the accumulator layout straight into PV's operand layout, each lane
  // keeping its own words; the serving tier (bf16) and MXFP store the warp's
  // probabilities for PV on the CUDA cores
  const bool exact_mma = kInt && !p.relaxed;
  uint4* pgw = reinterpret_cast<uint4*>(wa + L.w_u);
  float2* pgs = reinterpret_cast<float2*>(pgw + (p.kc / kBlock) * 32);
  __nv_bfloat16* pb = reinterpret_cast<__nv_bfloat16*>(wa + L.w_u);
  for_chunks(p, L, smem, ws, b, smask | pv_mask(p), [&](int s0, int ck) {
    for (int kb = 0; kb < ck / kBlock; ++kb) {
      float a[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int jt = 4 * kb + jj;
        score_tile<kInt>(p, L, smem, wq, jt, rt, g, t, a[jj]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = keep(s0 / 8 + jt, i) ? a[jj][i] : kNeg;
          float q = div_prob(expf(__fsub_rn(x, mx[i >> 1])), sum[i >> 1]);
          if (!p.relaxed && p.bfloat16) q = bf16_round_away(q);
          a[jj][i] = q;
        }
      }
      unsigned mbr[2] = {0u, 0u};
      int er[2] = {0, 0};
      if (!p.relaxed) {  // the block's MX exponent per row
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            mbr[r] = max(mbr[r], max(mag_bits(a[jj][2 * r]), mag_bits(a[jj][2 * r + 1])));
          mbr[r] = max(mbr[r], __shfl_xor_sync(kFull, mbr[r], 1));
          mbr[r] = max(mbr[r], __shfl_xor_sync(kFull, mbr[r], 2));
          er[r] = shared_exp(mbr[r], p.fmt);
        }
      }
      if (exact_mma) {
        unsigned pa[4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          unsigned w[2] = {0u, 0u};
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              w[jj >> 1] |= unsigned(quant_int(a[jj][2 * r + e], mbr[r], er[r], p.fmt, true))
                            << (8 * (2 * (jj & 1) + e));
          pa[r] = w[0];
          pa[2 + r] = w[1];
        }
        pgw[kb * 32 + lane] = make_uint4(pa[0], pa[1], pa[2], pa[3]);
        pgs[kb * 32 + lane] = make_float2(pow2_sub(er[0] - p.shift), pow2_sub(er[1] - p.shift));
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float a0 = a[jj][2 * r], a1 = a[jj][2 * r + 1];
            if (!p.relaxed) {  // MXFP exact: requantize
              a0 = quant_val(a0, mbr[r], er[r], p.fmt, true);
              a1 = quant_val(a1, mbr[r], er[r], p.fmt, true);
            }
            *reinterpret_cast<__nv_bfloat162*>(pb + (g + 8 * r) * (p.kc + 4) +
                                               8 * (4 * kb + jj) + 2 * t) =
                __floats2bfloat162_rn(a0, a1);
          }
      }
    }
    __syncwarp();
    if (exact_mma) pv_mma(p, L, smem, wa, cell, rt, s0, ck, lane);
    else pv_cores<kInt>(p, L, smem, wa, cell, r0, s0, ck, lane);
    __syncwarp();
  });
}

// One warp's 16-row query tile: q, selection, softmax and PV
template <bool kInt, int PRED>
__device__ __forceinline__ void row_tile(const Params& p, const Layout& L, unsigned char* smem,
                                         const unsigned char* ws, unsigned char* wa, int cell,
                                         int b, int tile) {
  const int lane = threadIdx.x & 31;
  RowTile rt;
  load_q<kInt, PRED>(p, ws, cell, tile * kRows, wa + L.w_q, rt, lane);
  unsigned* selw = reinterpret_cast<unsigned*>(wa + L.w_sel);
  if (!p.dense)
    select_tile<kInt, PRED>(p, L, smem, ws, b, wa + L.w_q, rt, lane, selw,
                            reinterpret_cast<unsigned*>(wa + L.w_u), nullptr);
  softmax_pv<kInt, PRED>(p, L, smem, ws, wa, cell, b, rt, tile * kRows, selw);
}

// One block per (cell, group of row tiles).  Where the K side comes in one
// chunk it is staged once and each warp walks its row tiles alone;
// otherwise each warp takes one tile and the warps go through the chunks
// together.
template <bool kInt, int PRED, int kMinBlocks>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
    split_topk_attention_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(p);
  if constexpr (PRED == kElsa) {  // the cosine of each hamming distance
    float* tab = reinterpret_cast<float*>(smem + L.cos);
    for (int i = threadIdx.x; i <= p.bits; i += blockDim.x) tab[i] = __ldg(p.cos_tab + i);
    __syncthreads();
  }
  const int warp = threadIdx.x >> 5;
  const int cell = blockIdx.x / p.qblocks, qblk = blockIdx.x - cell * p.qblocks;
  const int b = cell / p.H;
  const unsigned char* ws = p.ws + size_t(cell) * p.w.cell;
  unsigned char* wa = smem + L.warp0 + size_t(warp) * L.warp_bytes;
  const int t0 = qblk * p.tiles_per_block;
  if (p.cache) {
    const int t1 = min(t0 + p.tiles_per_block, p.ntq);
    const int lane = threadIdx.x & 31;
    const int sel_words = (p.Sp + 127) / 128 * 64;
    unsigned* selp = reinterpret_cast<unsigned*>(smem + L.selp);
    unsigned char* wA = smem + L.warpA + size_t(warp) * L.warp_bytesA;
    stage_chunk(p, L, smem, ws, b, 0, select_mask(p));
    cp_async_wait_all();
    __syncthreads();
    for (int tile = t0 + warp; tile < t1; tile += p.W) {
      RowTile rt;
      load_q<kInt, PRED>(p, ws, cell, tile * kRows, nullptr, rt, lane);
      select_tile<kInt, PRED>(p, L, smem, ws, b, nullptr, rt, lane, selp + tile * sel_words,
                              reinterpret_cast<unsigned*>(wA + L.w_digits),
                              reinterpret_cast<int*>(wA));
    }
    __syncthreads();  // every tile is selected: the true score's arrays replace the keys'
    stage_chunk(p, L, smem, ws, b, 0, score_mask(p) | pv_mask(p));
    cp_async_wait_all();
    __syncthreads();
    for (int tile = t0 + warp; tile < t1; tile += p.W) {
      RowTile rt;
      load_q<kInt, PRED>(p, ws, cell, tile * kRows, nullptr, rt, lane);
      softmax_pv<kInt, PRED>(p, L, smem, ws, wa, cell, b, rt, tile * kRows,
                             selp + tile * sel_words);
    }
  } else if (p.nchunks == 1) {
    stage_chunk(p, L, smem, ws, b, 0, score_mask(p) | select_mask(p) | pv_mask(p));
    cp_async_wait_all();
    __syncthreads();
    const int t1 = min(t0 + p.tiles_per_block, p.ntq);
    for (int tile = t0 + warp; tile < t1; tile += p.W)
      row_tile<kInt, PRED>(p, L, smem, ws, wa, cell, b, tile);
  } else {
    row_tile<kInt, PRED>(p, L, smem, ws, wa, cell, b, t0 + warp);
  }
}

// ex_pred and ELSA have their own routes on both kernels; true_ex, and
// every other predictor on the MXFP grids, take the CUDA-core kernel's
// operands; on the int grids two_step takes its byte planes and the rest
// the block-grid codes
inline int pred_kind(int approx, int mode, int topk, int S, int ebits) {
  if (topk >= S || !approx) return kNone;
  if (mode == mExPred) return kExPred;
  if (mode == mElsa) return kElsa;
  if (ebits != 0 || mode == mTrueEx) return kOperand;
  return mode == mTwoStep ? kTwoStep : kBlockInt;
}

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The kernels' parameters, without pointers
inline Params make_params(int B, int H, int N, int S, int D, int in_bf16, int out_bf16,
                          int topk, float scale, int approx, int pred_mode, int key_bits,
                          int relaxed, int bfloat16, int flush, int ebits, int mbits, int emax,
                          float max_norm, int scale_bits, int bits) {
  Params p = {};
  p.B = B; p.H = H; p.N = N; p.S = S; p.D = D;
  p.Dp = round_up(D < 8 ? 8 : D, kBlock);
  p.nb = p.Dp / kBlock;
  p.Sp = round_up(S, kBlock);
  p.D8 = round_up(D, 8);
  p.nkb = p.Sp / kBlock;
  p.ntq = (N + kRows - 1) / kRows;
  p.in_bf16 = in_bf16; p.out_bf16 = out_bf16; p.topk = topk;
  p.key_bits = key_bits; p.relaxed = relaxed; p.bfloat16 = bfloat16;
  p.shift = mbits - 2;
  p.pred = pred_kind(approx, pred_mode, topk, S, ebits);
  p.intm = ebits == 0 && p.pred != kOperand;
  p.mode = pred_mode;
  p.bits = bits;
  p.dense = topk >= S;
  p.scale = scale;
  p.fmt = make_fmt(ebits, mbits, emax, max_norm, scale_bits, flush);
  p.fmt4 = make_fmt(0, 4, 0, 0.f, scale_bits, flush);  // MXINT4: JAX passes no ebits
  p.w = make_ws(p.Sp, p.Dp, p.nb, p.D8, p.intm, p.pred, relaxed);
  return p;
}

// K3 (tiled = 0): one block per cell, the K side staged once (in two
// phases with the key cache for two_step on the int grids) where that
// fits; K4, and K3 where it does not fit: blocks of W row tiles streaming
// chunks of 256 or 128 keys, the most warps that fit, then the larger
// chunk (more warps first: at N = S = 4096 a warp's radix digits take 64
// KB, and two warps over 128-key chunks ran 2.2x faster than one over 256).
// false if nothing fits.
inline bool configure(Params& p, int tiled) {
  p.two_blocks = 0;
  p.cache = 0;
  if (!tiled) {
    p.kc = p.Sp; p.nchunks = 1; p.W = kMaxWarps;
    p.tiles_per_block = p.ntq; p.qblocks = 1;
    p.cache = p.pred == kTwoStep && p.intm;
    if (p.cache && (long long)make_layout(p).total <= kMaxSmem) return true;
    p.cache = 0;
    if ((long long)make_layout(p).total <= kMaxSmem) {
      p.two_blocks = p.pred == kNone && (long long)make_layout(p).total <= kTwoBlockSmem;
      return true;
    }
  }
  const int kcs[2] = {256, 128};
  for (int W = kMaxWarps; W >= 1; W >>= 1)
    for (int kc : kcs) {
      p.kc = p.Sp < kc ? p.Sp : kc;
      p.nchunks = (p.Sp + p.kc - 1) / p.kc;
      p.W = W;
      p.tiles_per_block = W;
      p.qblocks = (p.ntq + W - 1) / W;
      if ((long long)make_layout(p).total <= kMaxSmem) {
        p.two_blocks = p.pred == kNone && (long long)make_layout(p).total <= kTwoBlockSmem;
        return true;
      }
    }
  return false;
}

bool shapes_ok(int N, int S, int D, int tiled) {
  return N >= 1 && S >= 1 && D >= 1 && D <= MAX_HEAD_DIM &&
         (tiled ? S <= K4_MAX_KEYS : (N <= K3_MAX_TOKENS && S <= K3_MAX_TOKENS));
}

template <bool kInt, int PRED, int kMinBlocks>
cudaError_t start(const Params& p, size_t smem, cudaStream_t stream) {
  auto kern = split_topk_attention_kernel<kInt, PRED, kMinBlocks>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kern<<<p.B * p.H * p.qblocks, p.W * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

// The part of the build whose library holds the attention kernel of p
// (topk_attention_split_part tells the wrapper): the int-grid kernels
// without a predictor, with ex_pred, with two_step, with the block-grid
// codes or ELSA; then every CUDA-core kernel
inline int part_of(const Params& p) {
  if (!p.intm) return 4;
  return p.pred == kNone ? 0 : p.pred == kExPred ? 1 : p.pred == kTwoStep ? 2 : 3;
}

// Launch the attention kernel of p (of this build's part)
cudaError_t start_pred(const Params& p, size_t smem, cudaStream_t stream) {
#if SPLIT_PART == -1 || SPLIT_PART == 0
  if (part_of(p) == 0)
    return p.two_blocks ? start<true, kNone, 2>(p, smem, stream)
                        : start<true, kNone, 1>(p, smem, stream);
#endif
#if SPLIT_PART == -1 || SPLIT_PART == 1
  if (part_of(p) == 1) return start<true, kExPred, 1>(p, smem, stream);
#endif
#if SPLIT_PART == -1 || SPLIT_PART == 2
  if (part_of(p) == 2) return start<true, kTwoStep, 1>(p, smem, stream);
#endif
#if SPLIT_PART == -1 || SPLIT_PART == 3
  if (part_of(p) == 3)
    return p.pred == kElsa ? start<true, kElsa, 1>(p, smem, stream)
                           : start<true, kBlockInt, 1>(p, smem, stream);
#endif
#if SPLIT_PART == -1 || SPLIT_PART == 4
  if (part_of(p) == 4) {
    if (p.pred == kOperand) return start<false, kOperand, 1>(p, smem, stream);
    if (p.pred == kExPred) return start<false, kExPred, 1>(p, smem, stream);
    if (p.pred == kElsa) return start<false, kElsa, 1>(p, smem, stream);
    return p.two_blocks ? start<false, kNone, 2>(p, smem, stream)
                        : start<false, kNone, 1>(p, smem, stream);
  }
#endif
  return cudaErrorInvalidValue;  // another part's kernel
}

}  // namespace

// Shared memory the kernel (K3: tiled = 0; K4: tiled = 1) needs, or 0 if it
// cannot take the shapes.  pred_mode: 0 ex_pred, 1 two_step_leading_ones,
// 2 MXINT4, 3 partial_Q, 4 partial_K, 5 true_ex, 6 threshold_ex, 7 ELSA.
extern "C" long long topk_attention_split_smem_bytes(int N, int S, int D, int topk, int approx,
                                                     int pred_mode, int key_bits, int relaxed,
                                                     int ebits, int tiled) {
  if (!shapes_ok(N, S, D, tiled) || topk < 1 || pred_mode < 0 || pred_mode > mElsa) return 0;
  Params p = make_params(1, 1, N, S, D, 0, 0, topk, 1.f, approx, pred_mode, key_bits, relaxed,
                         0, 0, ebits, 8, 0, 0.f, 8, kMaxBits);
  return configure(p, tiled) ? (long long)make_layout(p).total : 0;
}

// Bytes of the workspace the pre-pass writes: B * H cells.
extern "C" long long topk_attention_split_workspace_bytes(int B, int H, int S, int D, int topk,
                                                          int approx, int pred_mode,
                                                          int relaxed, int ebits) {
  const Params p = make_params(B, H, 1, S, D, 0, 0, topk, 1.f, approx, pred_mode, 8, relaxed,
                               0, 0, ebits, 8, 0, 0.f, 8, kMaxBits);
  return (long long)B * H * (long long)p.w.cell;
}

// The part of the build (0 .. SPLIT_PARTS - 1) whose library launches the
// call with these arguments; every part answers, -1 for arguments no part
// takes.
extern "C" int topk_attention_split_part(int S, int topk, int approx, int pred_mode,
                                         int ebits) {
  if (S < 1 || topk < 1 || pred_mode < 0 || pred_mode > mElsa) return -1;
  return part_of(make_params(1, 1, 1, S, kBlock, 0, 0, topk, 1.f, approx, pred_mode, 8, 0, 0,
                             0, ebits, 8, 0, 0.f, 8, kMaxBits));
}

// Launch K3 (tiled = 0) or K4 (tiled = 1) on `stream`: the pre-pass, then
// the attention kernel; returns the cudaError_t of the launches (0 = ok).
// bias: (B, S) float32 or null; ELSA: proj (bits, D) float32 and cos_tab
// (bits + 1) float32, else null; ws: topk_attention_split_workspace_bytes.
extern "C" int topk_attention_split(const void* q, const void* k, const void* v,
                                    const float* bias, const float* proj, const float* cos_tab,
                                    void* ws, void* out, int B, int H, int N, int S, int D,
                                    int in_bf16, int out_bf16, int topk, float scale, int approx,
                                    int pred_mode, int key_bits, int relaxed, int bfloat16,
                                    int flush, int ebits, int mbits, int emax, float max_norm,
                                    int scale_bits, int bits, int tiled, void* stream) {
  if (!shapes_ok(N, S, D, tiled) || B < 1 || H < 1 || topk < 1 || ws == nullptr ||
      (key_bits != 8 && key_bits != 16 && key_bits != 32) || pred_mode < 0 ||
      pred_mode > mElsa)
    return int(cudaErrorInvalidValue);
  Params p = make_params(B, H, N, S, D, in_bf16, out_bf16, topk, scale, approx, pred_mode,
                         key_bits, relaxed, bfloat16, flush, ebits, mbits, emax, max_norm,
                         scale_bits, bits);
  if (p.pred == kElsa && (proj == nullptr || cos_tab == nullptr || bits < 1 || bits > kMaxBits))
    return int(cudaErrorInvalidValue);
  if (!configure(p, tiled) || (SPLIT_PART != -1 && part_of(p) != SPLIT_PART))
    return int(cudaErrorInvalidValue);
  p.q = q; p.k = k; p.v = v; p.bias = bias; p.out = out;
  p.proj = proj; p.cos_tab = cos_tab;
  p.ws = static_cast<unsigned char*>(ws);
  auto aligned = [](const void* ptr, int m) {
    return (reinterpret_cast<uintptr_t>(ptr) & (m - 1)) == 0;
  };
  p.q_vec = aligned(q, in_bf16 ? 8 : 16) && D % 4 == 0;
  p.k_vec = aligned(k, in_bf16 ? 8 : 16) && D % 4 == 0;
  p.v_vec = aligned(v, 16) && D % (in_bf16 ? 8 : 4) == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (B * H * p.nkb + 7) / 8;
  switch (p.pred) {
    case kExPred: split_prepass_kernel<kExPred><<<blocks, 256, 0, st>>>(p); break;
    case kTwoStep: split_prepass_kernel<kTwoStep><<<blocks, 256, 0, st>>>(p); break;
    case kBlockInt: split_prepass_kernel<kBlockInt><<<blocks, 256, 0, st>>>(p); break;
    case kOperand: split_prepass_kernel<kOperand><<<blocks, 256, 0, st>>>(p); break;
    case kElsa: split_prepass_kernel<kElsa><<<blocks, 256, 0, st>>>(p); break;
    default: split_prepass_kernel<kNone><<<blocks, 256, 0, st>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  return int(start_pred(p, make_layout(p).total, st));
}
