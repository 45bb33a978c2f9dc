"""Kernel K8: the TPU attention-ablation tools' cell functions as one
pass-switched kernel (CUDA C++, ``csrc/topk_attention_ablate.cu``).

It replaces the eight ``pl.pallas_call`` sites of the repository's
attention-ablation tools, each a copy of the DiT top-k attention cell
with static pass switches: ``tools/attnk_bench.py`` ``make`` (:119),
``make_i16`` (:258), ``make_batched`` (:341) and ``make_trans`` (:464);
``tools/attnk3_bench.py`` ``make`` (:264); ``tools/servingk_bench.py``
``make`` (:136) and ``probe_pretransposed`` (:250); and
``tools/passprice_bench.py`` ``make`` (:182).  The switches are one 32-bit
pass word (the constants below), a runtime launch argument, so one build
serves every variant; ``layout`` and ``key_form`` say how q and k arrive
and how the selection keys are formed.  No model path launches it: the
port's tools (``mx_quantization_tpu_torch/tools/``) drive it as the TPU
tools drive theirs.  The source's note says what bounds it and how the
design answers.

The function, per cell (q, k, v of one (batch row, head)), q and k (N, D)
bf16 (``layout`` 0) or (D, N) with every row live (``layout`` 1), v (N,
Dv), N = S keys, MXINT8 in blocks of 32, scale bits 8; every step below
runs only where its bit is set:
  * q and k padded along D to Dp = round_up(D, 32) (layout 0; the padded
    d masked out of the predictor) and MX-quantized (QKQ) or kept as bf16
    values; v quantized along the tokens in 32-blocks per column (VQ)
  * true scores: each 32-d block summed exactly (the integer grid points'
    sum, times 2^(eq - 6) and then 2^(ek - 6); unquantized: the bf16
    values' products in d order from +0) and the blocks added in order;
    rounded half away to bf16 (SROUND), then times the scale (SCL)
  * the selection score: the ex_pred predictor (PRED; sign * 2^(block
    exponent) operands, each block's sum exact, the blocks in order; the
    unquantized operands' plain product without QKQ), else the true score
  * keys (KEYS) by ``key_form``: "row8" the top 8 monotone bits and the
    k-th key of each query row by an 8-step bisection over [-128, 127]
    (the production pipeline); "row8_9step" the same by a 9-step one over
    [-129, 128] (``make_trans``); "row16_bf16" the 16-bit monotone key of
    the score rounded to bf16 (RNE), 16 steps (``make_i16``); "col8" the
    8-bit key with the k-th key of each key COLUMN over the cell's query
    rows (``make``'s straight layout reduces ``_kth_keys`` over the
    queries); "col16" the top 16 bits, the k-th key of each key column
    over the query rows of ``group`` cells (``make_batched`` stacks 4).
    Without SEARCH the k-th key and the count of greater keys are 0
  * selection (SEL): the exact tier's greater keys plus ties lowest index
    first up to k (RANK; the count of greater keys per query row), else
    every key >= the k-th (the serving tier, ``norank``)
  * MAX: the masked scores less their maximum; FSCALE: times the scale
    here instead of SCL; EXP: exp; LINEXP: (x * 1.0009765625), 0 where
    unselected (``noexp``); DIV: divided by the sum (32 strided sums of
    keys m + 32 i in i order, then a halving tree: K3's ``lane_sum``);
    AROUND: rounded half away to bf16
  * BFSM (``servingk`` ``bfsm``): the softmax in bf16 arithmetic as JAX
    compiles it on the CPU (XLA keeps some of it in f32): the scores, the
    masked scores less their maximum and (FSCALE) that times bf16(scale)
    each rounded to bf16 (RNE); exp in f32; the f32 sum of the unrounded
    exps rounded to bf16; the bf16 exps over it in f32, not rounded
  * AQ: the probabilities MX-quantized along the keys in 32-blocks with the
    sign-free quantizer (FOLD: ``attnk3``'s ``v4`` folded constants
    2^(6 - e) and 2^(e - 6), built from bits as JAX builds them), else
    cast to bf16 (RNE); NOAT: quantized along the queries instead, and
    the output row j is column j of the quantized probabilities times v
    (``attnk`` ``noat``)
  * PV: with AQ and VQ per 32-key block exactly (grid points, times the
    probabilities' then v's power of two), the blocks in order; else the
    products in key order from +0; rounded half away to bf16 (OROUND);
    cast to bf16 (RNE)
  * without MM the output is v (``passprice`` L00 and L01)
VM, MXC, UNROLL, V1 and V3 (``NEUTRAL``) change how the kernel counts and
ranks (h-form keys, float counts, an unrolled search, f32 keys, a shuffle
scan), not what it computes, as in the TPU tools, and the plain version
ignores them.
EXACT and SERVING are the production pipeline's two tiers: they equal the
port's K3 (``fused_topk_attention_ref``) at ex_pred, key_bits 8, bfloat 16
and bf16 output, bit for bit.
``ablate_attention`` launches the kernel on CUDA tensors and raises where
it cannot; only CPU tensors take the plain version
``ablate_attention_ref``.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ...formats import FormatParams
from ..fastquant import bf16_round_half_away, lane_sum, quantize_blocks
from . import build
from .topk_attention import (_block_scaled_dot, _blocks_in_order,
                             _blockwise_scores, _dot_in_order,
                             _ex_pred_operand, _mono_keys, _mx_mantissas,
                             _pow2_sub, _scaled_blocks)

SOURCE = "topk_attention_ablate.cu"

# the pass word
PREP = 1 << 0     # q and k laid out with D along blocks and padded
MM = 1 << 1       # the score and PV products (off: the output is v)
VQ = 1 << 2       # v MX-quantized
QKQ = 1 << 3      # q and k MX-quantized
PRED = 1 << 4     # select by the ex_pred predictor's scores
SROUND = 1 << 5   # scores rounded half away to bf16 before the scale
SCL = 1 << 6      # scores times the scale
KEYS = 1 << 7     # monotone selection keys
SEARCH = 1 << 8   # the k-th key by bisection (off: 0, and no greater keys)
SEL = 1 << 9      # the selection applies (off: every key)
RANK = 1 << 10    # ties lowest index first up to k (off: every key >= kth)
MAX = 1 << 11     # the masked scores less their maximum
EXP = 1 << 12     # exp
DIV = 1 << 13     # divided by the sum
AROUND = 1 << 14  # probabilities rounded half away to bf16
AQ = 1 << 15      # probabilities MX-quantized (off: cast to bf16)
OROUND = 1 << 16  # output rounded half away to bf16
LINEXP = 1 << 17  # (x * 1.0009765625) in place of exp
FSCALE = 1 << 18  # the scale multiplies the exp argument
BFSM = 1 << 19    # the softmax in bf16 arithmetic
NOAT = 1 << 20    # probabilities quantized along the queries, PV transposed
FOLD = 1 << 21    # the sign-free quantize with folded scale constants
VM = 1 << 22      # h-form keys (value-neutral)
MXC = 1 << 23     # counts as float sums of indicators (value-neutral)
UNROLL = 1 << 24  # the search unrolled (value-neutral)
V1 = 1 << 25      # keys and counts as f32 (value-neutral)
V3 = 1 << 26      # the tie rank by a shuffle scan (value-neutral)
PASS_NAMES = ("PREP", "MM", "VQ", "QKQ", "PRED", "SROUND", "SCL", "KEYS",
              "SEARCH", "SEL", "RANK", "MAX", "EXP", "DIV", "AROUND", "AQ",
              "OROUND", "LINEXP", "FSCALE", "BFSM", "NOAT", "FOLD", "VM",
              "MXC", "UNROLL", "V1", "V3")
ALL_PASSES = (1 << len(PASS_NAMES)) - 1

# the production pipeline's tiers (tools/attnk3_bench.py base,
# tools/servingk_bench.py base, tools/passprice_bench.py L15 and L12)
SERVING = (PREP | MM | VQ | QKQ | PRED | SCL | KEYS | SEARCH | SEL | MAX |
           EXP | DIV)
EXACT = SERVING | SROUND | RANK | AROUND | AQ | OROUND
# the bits that change how the kernel computes, not what
NEUTRAL = VM | MXC | UNROLL | V1 | V3

# key form: (its number in the C interface, key bits, bisection lo, hi,
# steps, threshold per key column)
KEY_FORMS = {
    "row8": (0, 8, -128, 127, 8, False),
    "row8_9step": (1, 8, -129, 128, 9, False),
    "row16_bf16": (2, 16, -32768, 32767, 16, False),
    "col8": (3, 8, -128, 127, 8, True),
    "col16": (4, 16, -32768, 32767, 16, True),
}
LAYOUTS = (0, 1)  # q, k (G, N, D); q, k (G, D, N) with every row live

# the tools' domain: MXINT8 in blocks of 32, N = S tokens (a multiple of
# the block), head dims up to MAX_HEAD_DIM
BLOCK = 32
MAX_TOKENS = 512
MAX_HEAD_DIM = 128
MAX_GROUP = 4  # make_batched's cells per column threshold
_FMT = FormatParams(0, 8, 0, 0.0, 0.0)
_SHIFT = 6  # mbits - 2
_NEG = -3.0e38
_NEG_BF16 = float(torch.tensor(_NEG).to(torch.bfloat16))
_LIN = 1.0009765625


def passes_of(*names: str) -> int:
    """The word of the named passes."""
    return sum(1 << PASS_NAMES.index(n) for n in names)


def pass_names(word: int):
    return [n for i, n in enumerate(PASS_NAMES) if word >> i & 1]


def check_passes(passes: int, bfloat: int) -> None:
    """Raise on a word outside the tools' combinations."""
    if passes & ~ALL_PASSES:
        raise ValueError(f"unknown pass bits {passes & ~ALL_PASSES:#x}")
    needs = ((MM, PREP), (SEARCH, KEYS), (SEL, KEYS), (RANK, SEL), (FOLD, AQ),
             (NOAT, AQ | VQ), (AQ, VQ), (LINEXP, MAX), (FSCALE, MAX),
             (BFSM, MAX | EXP | DIV | SEL))
    for bit, need in needs:
        if passes & bit and passes & need != need:
            raise ValueError(f"{pass_names(bit)} needs {pass_names(need)}")
    excl = ((EXP, LINEXP), (SCL, FSCALE), (BFSM, AQ), (BFSM, AROUND),
            (BFSM, SROUND), (NOAT, FOLD))
    for a, b in excl:
        if passes & a and passes & b:
            raise ValueError(f"{pass_names(a | b)} exclude each other")
    if bfloat not in (0, 16):
        raise ValueError(f"bfloat must be 0 or 16, not {bfloat}")
    if passes & (SROUND | AROUND | OROUND) and bfloat != 16:
        raise ValueError("the bf16 rounds SROUND, AROUND and OROUND are the "
                         "bfloat=16 operating point's")


def _shapes(q, k_, v, layout, key_form, group, k):
    """(G, N, Dqk, Dv) of a call, checked against the tools' domain."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be 0 or 1, not {layout}")
    if key_form not in KEY_FORMS:
        raise ValueError(f"unknown key_form {key_form!r}: {list(KEY_FORMS)}")
    if q.dim() != 3 or k_.shape != q.shape or v.dim() != 3:
        raise ValueError("q, k and v must be 3-d, q and k of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k_.shape)}, "
                         f"{tuple(v.shape)}")
    G, N, Dv = v.shape
    Dqk = q.shape[2] if layout == 0 else q.shape[1]
    n_qk = q.shape[1] if layout == 0 else q.shape[2]
    if q.shape[0] != G or n_qk != N:
        raise ValueError(f"q and k carry {q.shape[0]} cells of {n_qk} "
                         f"tokens, v {G} of {N}")
    if any(t.dtype != torch.bfloat16 for t in (q, k_, v)):
        raise TypeError("q, k and v must be bfloat16, as the tools feed them")
    if N % BLOCK or not BLOCK <= N <= MAX_TOKENS:
        raise NotImplementedError(
            f"N = S = {N}: K8 takes multiples of {BLOCK} up to {MAX_TOKENS}")
    if not 1 <= Dqk <= MAX_HEAD_DIM or not 1 <= Dv <= MAX_HEAD_DIM or \
            (layout == 0 and Dqk != Dv):
        raise NotImplementedError(
            f"K8 takes head dims up to {MAX_HEAD_DIM} (q and k {Dqk}, v "
            f"{Dv}; layout 0 takes one D)")
    if not 1 <= k <= N:
        raise ValueError(f"k must be in 1..{N}, got {k}")
    if not 1 <= group <= MAX_GROUP or G % group or \
            (group > 1 and not KEY_FORMS[key_form][5]):
        raise ValueError(f"group={group} must divide G={G} and be at most "
                         f"{MAX_GROUP}; only the column key forms group cells")
    if KEY_FORMS[key_form][5] and group * N < k:
        raise ValueError(f"a key column holds {group * N} rows, fewer than "
                         f"k={k}")
    return G, N, Dqk, Dv


# ----------------------------------------------------------------------
# plain version
# ----------------------------------------------------------------------
def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _quantize_probs(x: torch.Tensor, fold: bool):
    """Sign-free MX quantize of x (..., n) along its last axis in 32-blocks:
    (grid points (..., n/32, 32), each block's multiplier (..., n/32))."""
    xb = x.reshape(*x.shape[:-1], -1, BLOCK)
    if not fold:
        pm, pe = _mx_mantissas(xb, _FMT, 8, False, nonneg=True)
        return pm, _pow2_sub(pe - _SHIFT)
    # attnk3_bench v4: the block maximum of the bits, unmasked (x >= +0),
    # and the constants 2^(6 - e) and 2^(e - 6) built from bits as int32
    mb = xb.contiguous().view(torch.int32).amax(-1)
    e8 = ((mb >> 23) - 127).clamp(-127, 127).to(torch.int64)
    c1 = ((133 - e8) << 23).to(torch.int32).view(torch.float32)
    c2 = ((e8 + 121) << 23).to(torch.int32).view(torch.float32)
    q8 = torch.minimum(torch.floor(xb * c1[..., None] + 0.5),
                       torch.tensor(127.0, device=x.device))
    return q8, c2


def _bisect(keys: torch.Tensor, k: int, lo: int, hi: int, steps: int,
            dim: int) -> torch.Tensor:
    """The k-th largest key along ``dim`` by ``steps`` bisection steps
    from [lo, hi], as the TPU tools' searches run it."""
    shape = list(keys.shape)
    shape[dim] = 1
    lo = torch.full(shape, lo, dtype=torch.int64, device=keys.device)
    hi = torch.full(shape, hi, dtype=torch.int64, device=keys.device)
    for _ in range(steps):
        mid = lo + ((hi - lo) >> 1)
        up = (keys > mid).sum(dim, keepdim=True) >= k
        lo = torch.where(up, mid + 1, lo)
        hi = torch.where(up, hi, mid)
    return lo


def _selection(s_sel, passes, k, key_form, group):
    """(G, N, S) selection mask (None: every key)."""
    if not passes & SEL:
        return None
    _, bits, lo, hi, steps, column = KEY_FORMS[key_form]
    if key_form == "row16_bf16":
        s_sel = _bf16(s_sel)
    keys = _mono_keys(s_sel, bits)
    G, N, S = keys.shape
    if not passes & SEARCH:
        kth = torch.zeros(G, 1, 1, dtype=torch.int64, device=keys.device)
    elif column:
        kth = _bisect(keys.reshape(G // group, group * N, S), k, lo, hi,
                      steps, 1).repeat_interleave(group, 0)
    else:
        kth = _bisect(keys, k, lo, hi, steps, 2)
    if not passes & RANK:
        return keys >= kth
    gt = keys > kth
    n_gt = gt.sum(-1, keepdim=True) if passes & SEARCH else 0
    eq = keys == kth
    rank = torch.cumsum(eq.to(torch.int64), dim=-1)
    return gt | (eq & (rank <= k - n_gt))


def _bf16_softmax(st, sel, scale, passes):
    """BFSM: ``servingk_bench`` bfsm's softmax as XLA compiles it on the
    CPU (module docstring); returns the f32 quotients."""
    sb = _bf16(st)
    masked = sb if sel is None else torch.where(sel, sb, _NEG_BF16)
    x = _bf16(masked - masked.amax(-1, keepdim=True))
    if passes & FSCALE:
        x = _bf16(x * _bf16(torch.tensor(scale, dtype=torch.float32)))
    e = torch.exp(x)
    return _bf16(e) / _bf16(lane_sum(e))


def _probabilities(st, sel, scale, passes):
    """The softmax steps of the word on the (G, N, S) scores."""
    if passes & BFSM:
        return _bf16_softmax(st, sel, scale, passes)
    x = st
    if passes & MAX:
        masked = st if sel is None else torch.where(sel, st, _NEG)
        x = masked - masked.amax(-1, keepdim=True)
    if passes & FSCALE:
        x = x * scale
    if passes & EXP:
        x = torch.exp(x)
    elif passes & LINEXP:
        x = x * _LIN
        if sel is not None:
            x = torch.where(sel, x, 0.0)
    if passes & DIV:
        x = x / lane_sum(x)
    if passes & AROUND:
        x = bf16_round_half_away(x)
    return x


def ablate_attention_ref(q: torch.Tensor, k_: torch.Tensor, v: torch.Tensor,
                         *, passes: int, k: int, scale: float,
                         layout: int = 0, bfloat: int = 16,
                         key_form: str = "row8",
                         group: int = 1) -> torch.Tensor:
    """Plain PyTorch version of K8 (the module docstring), vectorized over
    the cells: q, k (G, N, D) (layout 0) or (G, D, N) (layout 1), v (G, N,
    Dv), bf16 -> (G, N, Dv) bf16."""
    check_passes(passes, bfloat)
    passes &= ~NEUTRAL
    G, N, Dqk, Dv = _shapes(q, k_, v, layout, key_form, group, k)
    if not passes & MM:
        return v.clone()
    if layout == 1:
        q, k_ = q.transpose(1, 2), k_.transpose(1, 2)
    Dp = -(-Dqk // BLOCK) * BLOCK
    qb, kb = (torch.nn.functional.pad(x.to(torch.float32), (0, Dp - Dqk))
              .reshape(G, N, Dp // BLOCK, BLOCK) for x in (q, k_))
    if passes & QKQ:
        qm, qe = _mx_mantissas(qb, _FMT, 8, False)
        km, ke = _mx_mantissas(kb, _FMT, 8, False)
        raw = _block_scaled_dot(qm, qe, km, ke, _SHIFT)
    else:
        raw = _blocks_in_order(qb, kb)
    st = bf16_round_half_away(raw) if passes & SROUND else raw
    if passes & SCL:
        st = st * scale
    if not passes & PRED:
        s_sel = st
    elif passes & QKQ:
        qv, qe1 = quantize_blocks(qb, _FMT, 8)
        kv, ke1 = quantize_blocks(kb, _FMT, 8)
        s_sel = _blockwise_scores(_ex_pred_operand(qv, qe1, Dqk),
                                  _ex_pred_operand(kv, ke1, Dqk))
    else:
        s_sel = raw
    sel = _selection(s_sel, passes, k, key_form, group)
    x = _probabilities(st, sel, scale, passes)

    v32 = v.to(torch.float32)
    vt = v32.transpose(1, 2).reshape(G, Dv, N // BLOCK, BLOCK)
    if passes & VQ:
        vm, ve = _mx_mantissas(vt, _FMT, 8, False)
        vsc = _pow2_sub(ve - _SHIFT)
    if passes & NOAT:  # quantized along the queries: out[j] = P[:, j] . v
        pm, psc = _quantize_probs(x.transpose(1, 2), False)
        out = _scaled_blocks(pm, psc, vm, vsc)
    elif passes & AQ:
        pm, psc = _quantize_probs(x, bool(passes & FOLD))
        out = _scaled_blocks(pm, psc, vm, vsc)
    else:
        a = x if passes & BFSM else _bf16(x)
        vq = (vm * vsc[..., None]).reshape(G, Dv, N).transpose(1, 2) \
            if passes & VQ else v32
        out = _dot_in_order(a, vq)
    if passes & OROUND:
        out = bf16_round_half_away(out)
    return out.to(torch.bfloat16)


# ----------------------------------------------------------------------
# kernel wrapper
# ----------------------------------------------------------------------
@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    i, u, f, p = ctypes.c_int, ctypes.c_uint, ctypes.c_float, ctypes.c_void_p
    lib.topk_ablate_workspace_bytes.argtypes = [i] * 5 + [u] + [i] * 3
    lib.topk_ablate_workspace_bytes.restype = ctypes.c_longlong
    lib.topk_ablate.argtypes = [p] * 5 + [i] * 5 + [u] + [i] * 3 + [f, p]
    lib.topk_ablate.restype = i
    return lib


def ablate_attention(q: torch.Tensor, k_: torch.Tensor, v: torch.Tensor, *,
                     passes: int, k: int, scale: float, layout: int = 0,
                     bfloat: int = 16, key_form: str = "row8",
                     group: int = 1) -> torch.Tensor:
    """K8 on CUDA tensors (the plain version on CPU tensors): q, k (G, N,
    D) (layout 0) or (G, D, N) (layout 1), v (G, N, Dv), bf16 -> (G, N,
    Dv) bf16, the cell function of the pass word ``passes`` (module
    docstring).  Raises where the kernel cannot take the call."""
    if q.device.type == "cpu":
        return ablate_attention_ref(q, k_, v, passes=passes, k=k,
                                    scale=scale, layout=layout, bfloat=bfloat,
                                    key_form=key_form, group=group)
    check_passes(passes, bfloat)
    G, N, Dqk, Dv = _shapes(q, k_, v, layout, key_form, group, k)
    if q.device.type != "cuda" or k_.device != q.device or \
            v.device != q.device:
        raise ValueError("K8 runs on CUDA tensors of one device (or on CPU "
                         f"tensors), not {q.device}, {k_.device}, {v.device}")
    if not (q.is_contiguous() and k_.is_contiguous() and v.is_contiguous()):
        raise ValueError("K8 takes contiguous q, k and v")
    form = KEY_FORMS[key_form][0]
    lib = _library()
    nbytes = lib.topk_ablate_workspace_bytes(G, N, Dqk, Dv, layout, passes,
                                             form, group, k)
    if nbytes <= 0:
        raise NotImplementedError(
            f"K8 cannot take G={G}, N={N}, D={Dqk}/{Dv}, layout {layout}, "
            f"{key_form}, group {group}, k={k}, passes {passes:#x}")
    ws = torch.empty(nbytes, dtype=torch.uint8, device=q.device)
    out = torch.empty(G, N, Dv, dtype=torch.bfloat16, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.topk_ablate(q.data_ptr(), k_.data_ptr(), v.data_ptr(),
                              ws.data_ptr(), out.data_ptr(), G, N, Dqk, Dv,
                              layout, passes, form, group, k, float(scale),
                              torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K8 launch failed with CUDA error {err}")
    ablate_attention.launches += 1
    ablate_attention.sites[(tuple(q.shape), layout, passes, key_form, group,
                            k)] += 1
    return out


# launches, and launches per call site: (q shape, layout, pass word, key
# form, group, k)
ablate_attention.launches = 0
ablate_attention.sites = collections.Counter()
