"""The port's hand-written kernels against their plain PyTorch versions on
the card (K1: MX quantize, Triton; K2: fused qkv top-k attention, CUDA;
K3: split q/k/v top-k attention, CUDA, every predictor mode; K4: its
query-tiled long-sequence path, CUDA; K5: LN + modulate + MX quantize,
CUDA; K6: GELU + MX quantize, Triton; K7: split-emission qkv top-k
attention, CUDA; K8: the TPU ablation tools' pass-switched attention,
CUDA), K1 at the end-task path's sites (T5-XXL, CLIP), and the
slices' forwards on the card against the same forwards on the plain
versions.

Marked ``gpu``; each test skips where no CUDA device exists.  On a machine
with one:  python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from mx_quantization_tpu_torch.formats import format_params
from mx_quantization_tpu_torch.models.dit import (DiTConfig, DiTQuantConfig,
                                                  dit_forward, init_dit)
from mx_quantization_tpu_torch.models.pixart import (PixArtConfig,
                                                     PixArtQuantConfig,
                                                     init_pixart)
from mx_quantization_tpu_torch.ops.kernels.ln_modulate_quantize import (
    MAX_CHANNELS, ln_modulate_quantize, ln_modulate_quantize_ref)
from mx_quantization_tpu_torch.ops.kernels.quantize import (
    gelu_quantize, gelu_quantize_ref, mx_quantize, mx_quantize_ref)
from mx_quantization_tpu_torch.ops.kernels import topk_ablate
from mx_quantization_tpu_torch.ops.kernels.topk_attention import (
    MAX_TILED_KEYS, QKV_INT_PARTS, QKV_PRED_MODES, ROUTE_BLOCKS, ROUTE_QKV,
    ROUTE_QKV_BS, _qkv_library, fused_topk_attention, fused_topk_attention_qkv,
    fused_topk_attention_qkv_ref, fused_topk_attention_qkv_t,
    fused_topk_attention_qkv_t_ref, fused_topk_attention_ref,
    fused_topk_attention_tiled, qkv_call_args, qkv_route)
from mx_quantization_tpu_torch.ops.linear import mm_f32
from mx_quantization_tpu_torch.predictors.elsa import orthogonal_matrix
from mx_quantization_tpu_torch.tools import ablate_common
from mx_quantization_tpu_torch.utils.prequantize import prequantize_weights
from mx_quantization_tpu_torch.workloads.dit import dit_mx_specs, sample_dit
from mx_quantization_tpu_torch.workloads.pixart import (pixart_mx_specs,
                                                        sample_pixart)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _normal(shape, seed, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("fmt", ["int8", "int4", "int2", "fp8_e4m3",
                                 "fp8_e5m2", "fp6_e3m2", "fp4_e2m1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bfloat", [0, 16])
@pytest.mark.parametrize("flush", [False, True])
def test_k1_matches_plain(cuda, fmt, dtype, bfloat, flush):
    x = _normal((100, 288), 1, dtype)  # ragged rows, a partial K tile
    got = mx_quantize(x.to(cuda), fmt, 32, 8, flush=flush, bfloat=bfloat)
    want = mx_quantize_ref(x.to(cuda), fmt, 32, 8, flush=flush,
                           bfloat=bfloat)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(5, 120, 4096), (5, 120, 10240),
                                   (4, 257, 1024), (4, 77, 3072)])
def test_k1_end_task_sites(cuda, shape):
    """K1 at the end-task path's sites: T5-XXL's projections (4096) and
    FFN output (10240) inputs over 5 prompts of 120 tokens, and CLIP
    ViT-L/14's image (257 tokens) and text (77) towers, at the PixArt specs
    (f32, MXINT8, flush, bfloat 32) as ``encode_prompts_t5(quantize=True)``
    runs them."""
    x = _normal(shape, 7).to(cuda)
    x[0, 0, :32] = 1e-39  # a block of subnormals: flushed
    for bfloat in (0, 32):
        got = mx_quantize(x, "int8", 32, 8, flush=True, bfloat=bfloat)
        want = mx_quantize_ref(x, "int8", 32, 8, flush=True, bfloat=bfloat)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_t5_encode_counts_k1(cuda):
    """A tiny T5 encode with the PixArt specs launches K1 seven times a
    layer on the card, and agrees with the same encode on the CPU's plain
    version within the CPU tests' block bound."""
    from mx_quantization_tpu_torch.models.t5 import (T5Config, T5Encoder,
                                                     init_t5_encoder,
                                                     t5_encode)
    cfg = T5Config(vocab_size=256, d_model=64, d_kv=16, d_ff=128,
                   num_layers=3, num_heads=4,
                   relative_attention_num_buckets=8,
                   relative_attention_max_distance=32)
    cpu = init_t5_encoder(cfg, torch.Generator().manual_seed(0), "cpu")
    card = T5Encoder(cfg, cuda)
    card.load_state_dict(cpu.state_dict())
    ids = torch.randint(0, 256, (3, 20), generator=torch.Generator())
    mask = (torch.arange(20)[None] < torch.tensor([[20], [11], [1]])).int()
    before = mx_quantize.launches
    got = t5_encode(card, ids, mask, mx_specs=pixart_mx_specs())
    assert mx_quantize.launches - before == 7 * cfg.num_layers
    want = t5_encode(cpu, ids, mask, mx_specs=pixart_mx_specs())
    scale = want.abs().max()
    diff = (got.cpu() - want).abs()
    assert (diff > 1e-6 * scale).float().mean() <= 0.01
    assert diff.max() <= 2.0 ** -6 * scale


_K2_CASES = [  # (B, N, H, D, k, key_bits, contract)
    (2, 64, 2, 72, 9, 8, "exact"),
    (2, 64, 2, 72, 9, 8, "serving"),
    (2, 40, 2, 72, 9, 32, "exact"),   # N % 32 != 0: padded keys
    (2, 40, 2, 64, 9, 16, "serving"),
    (2, 64, 2, 72, 64, 8, "exact"),   # dense branch
    (2, 64, 2, 72, 64, 8, "serving"),
    (1, 256, 4, 72, 154, 8, "exact"),
    (1, 256, 4, 72, 154, 8, "serving"),
]


@pytest.mark.parametrize("case", _K2_CASES)
@pytest.mark.parametrize("in_dtype,out_dtype",
                         [(torch.float32, torch.float32),
                          (torch.bfloat16, torch.bfloat16)])
def test_k2_matches_plain(cuda, case, in_dtype, out_dtype):
    B, N, H, D, k, kb, contract = case
    x = _normal((B, N, 3 * H * D), 2, in_dtype).to(cuda)
    kw = dict(k=k, scale=D ** -0.5, key_bits=kb, bfloat=16,
              contract=contract, out_dtype=out_dtype)
    got = fused_topk_attention_qkv(x, H, **kw)
    want = fused_topk_attention_qkv_ref(x, H, **kw)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and torch.isfinite(got).all()
    assert torch.equal(got, want)  # same arithmetic in the same order


def _spread_qkv(B, N, H, D, seed, q_scales, k_scales):
    """qkv whose q and k 32-d chunks are scaled by the given powers of two
    (one per chunk), so that their MX exponents lie that far apart (at
    blocks below 32 each block of a chunk shares its power, above 32 a
    block spans powers)."""
    x = _normal((B, N, 3, H, D), seed)
    for side, scales in ((0, q_scales), (1, k_scales)):
        for blk, sc in enumerate(scales):
            x[:, :, side, :, 32 * blk:32 * (blk + 1)] *= 2.0 ** sc
    return x.reshape(B, N, 3 * H * D)


@pytest.mark.parametrize("bs", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("contract", ["exact", "serving"])
@pytest.mark.parametrize("k", [9, 64])
@pytest.mark.parametrize("scales", [
    ((-12, 0, 12), (12, -12, 0)),      # chunks 12 binades apart
    ((-60, 0, 0), (-60, 0, 0)),        # chunk 0: 2^(eq + ek - 12) < 2^-126
], ids=["spread", "underflow"])
def test_k2_block_exponents_spread_and_underflow(cuda, contract, k, scales,
                                                 bs):
    """The true score's per-block sums and their power-of-two scales where
    d order and block order round differently, and where a block pair's
    scale underflows: bit for bit at f32 output, at every MX block (the
    int8 tensor cores: the block-32 build at 32, the block's build at the
    others)."""
    B, N, H, D = 2, 64, 2, 72
    x = _spread_qkv(B, N, H, D, 7, *scales).to(cuda)
    kw = dict(k=k, scale=D ** -0.5, key_bits=8, bfloat=16, contract=contract,
              block_size=bs)
    route = ROUTE_QKV if bs == 32 else ROUTE_QKV_BS
    before = fused_topk_attention_qkv.routes[route]
    got = fused_topk_attention_qkv(x, H, **kw)
    want = fused_topk_attention_qkv_ref(x, H, **kw)
    torch.cuda.synchronize()
    assert fused_topk_attention_qkv.routes[route] == before + 1
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("contract", ["exact", "serving"])
def test_k2_mxfp_format(cuda, contract):
    B, N, H, D = 2, 64, 2, 72
    ebits, mbits, emax, max_norm, _ = format_params("fp8_e4m3")
    x = _normal((B, N, 3 * H * D), 3).to(cuda)
    kw = dict(k=9, scale=D ** -0.5, key_bits=8, bfloat=16, ebits=ebits,
              mbits=mbits, emax=emax, max_norm=max_norm, contract=contract)
    got = fused_topk_attention_qkv(x, H, **kw)
    want = fused_topk_attention_qkv_ref(x, H, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_k2_counts_launches(cuda):
    x = _normal((1, 64, 3 * 2 * 64), 4).to(cuda)
    before = fused_topk_attention_qkv.launches
    fused_topk_attention_qkv(x, 2, k=8, scale=0.125)
    assert fused_topk_attention_qkv.launches == before + 1


_K3_CASES = [  # (B, H, N, S, D, k, key_bits, pred_mode, approx)
    (2, 2, 64, 64, 72, 9, 32, "two_step_leading_ones", True),
    (2, 2, 64, 40, 72, 9, 32, "two_step_leading_ones", True),  # S % 32
    (2, 2, 64, 40, 72, 9, 8, "ex_pred", True),
    (2, 2, 64, 40, 72, 9, 16, "ex_pred", False),   # true-score top-k
    (2, 2, 64, 120, 72, 120, 32, "ex_pred", True),  # dense, S = 120
    (2, 2, 300, 77, 72, 20, 32, "two_step_leading_ones", True),
    (1, 2, 512, 512, 72, 77, 32, "two_step_leading_ones", True),
    (1, 2, 512, 512, 128, 77, 8, "ex_pred", True),
    (1, 2, 256, 256, 72, 256, 32, "two_step_leading_ones", True),  # dense
    # the corner whose K side does not fit one block: streamed in chunks
    (1, 2, 512, 512, 128, 77, 32, "two_step_leading_ones", True),
    (1, 2, 320, 512, 128, 50, 16, "two_step_leading_ones", True),  # S != N
]


def _k3_inputs(B, H, N, S, D, dtype, seed, with_bias):
    q = (4 * _normal((B, H, N, D), seed)).to(dtype)
    k = (4 * _normal((B, H, S, D), seed + 1)).to(dtype)
    v = _normal((B, H, S, D), seed + 2, dtype)
    bias = None
    if with_bias:  # caption masks of varying valid length
        valid = torch.arange(S)[None] < torch.tensor(
            [max(1, S - 7 * (i + 1)) for i in range(B)])[:, None]
        bias = ((1.0 - valid.float()) * -10000.0)[:, None, None, :]
    return q, k, v, bias


@pytest.mark.parametrize("case", _K3_CASES)
@pytest.mark.parametrize("contract", ["exact", "serving"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("in_dtype,out_dtype",
                         [(torch.float32, torch.float32),
                          (torch.bfloat16, torch.bfloat16)])
def test_k3_matches_plain(cuda, case, contract, with_bias, in_dtype,
                          out_dtype):
    B, H, N, S, D, k, kb, pred_mode, approx = case
    q, kk, v, bias = (None if t is None else t.to(cuda) for t in _k3_inputs(
        B, H, N, S, D, in_dtype, 11, with_bias))
    kw = dict(k=k, scale=D ** -0.5, key_bits=kb, pred_mode=pred_mode,
              approx=approx, contract=contract, out_dtype=out_dtype,
              flush=True)
    got = fused_topk_attention(q, kk, v, bias, **kw)
    want = fused_topk_attention_ref(q, kk, v, bias, **kw)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and torch.isfinite(got).all()
    assert torch.equal(got, want)  # same arithmetic in the same order


@pytest.mark.parametrize("bfloat", [0, 16])
@pytest.mark.parametrize("fmt", ["int8", "int4", "fp8_e4m3", "fp6_e3m2"])
def test_k3_formats_and_subnormal_flush(cuda, bfloat, fmt):
    B, H, N, S, D = 2, 2, 64, 96, 72
    ebits, mbits, emax, max_norm, _ = format_params(fmt)
    q, k, v, bias = _k3_inputs(B, H, N, S, D, torch.float32, 21, True)
    k[0, 0, 5, :32] = 1e-39   # a block of subnormals: flushed to zero
    v[1, 1, 32:64, 3] = 3e-39
    q[0, 1, 7, 32:64] = -2e-40
    kw = dict(k=17, scale=D ** -0.5, key_bits=32, bfloat=bfloat, flush=True,
              ebits=ebits, mbits=mbits, emax=emax, max_norm=max_norm,
              pred_mode="two_step_leading_ones")
    args = [t.to(cuda) for t in (q, k, v, bias)]
    got = fused_topk_attention(*args, **kw)
    want = fused_topk_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("kernel", ["K3", "K4"])
@pytest.mark.parametrize("fmt", ["fp8_e4m3", "fp4_e2m1"])
@pytest.mark.parametrize("pred_mode", ["ex_pred", "two_step_leading_ones"])
def test_split_mxfp_corners(cuda, kernel, fmt, pred_mode):
    """The MXFP formats (CUDA-core products) at S != N with the bias, key_bits
    32, bf16 in and out, both tiers: bit for bit."""
    ebits, mbits, emax, max_norm, _ = format_params(fmt)
    args = [t.to(cuda) for t in _k3_inputs(1, 2, 200, 160, 72,
                                           torch.bfloat16, 71, True)]
    fn = fused_topk_attention if kernel == "K3" else \
        fused_topk_attention_tiled
    for contract in ("exact", "serving"):
        kw = dict(k=33, scale=72 ** -0.5, key_bits=32, bfloat=16, flush=True,
                  ebits=ebits, mbits=mbits, emax=emax, max_norm=max_norm,
                  pred_mode=pred_mode, contract=contract,
                  out_dtype=torch.bfloat16)
        got = fn(*args, **kw)
        want = fused_topk_attention_ref(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_k3_counts_launches_and_refuses_k4_shapes(cuda):
    """K3 launches only where N, S <= 512; a longer call goes to K4 and
    leaves K3's count alone."""
    q, k, v, _ = _k3_inputs(1, 2, 64, 64, 72, torch.float32, 31, False)
    before, before4 = (fused_topk_attention.launches,
                       fused_topk_attention_tiled.launches)
    fused_topk_attention(q.to(cuda), k.to(cuda), v.to(cuda), k=8,
                         scale=0.125)
    assert fused_topk_attention.launches == before + 1
    long = torch.zeros(1, 1, 600, 72, device=cuda)
    fused_topk_attention(long, long, long, k=8, scale=0.125)
    assert fused_topk_attention.launches == before + 1
    assert fused_topk_attention_tiled.launches == before4 + 1


_K4_CASES = [  # (B, H, N, S, D, k, key_bits, pred_mode, approx)
    (1, 2, 640, 640, 72, 77, 8, "ex_pred", True),
    (1, 2, 640, 640, 72, 77, 32, "two_step_leading_ones", True),
    (1, 2, 613, 120, 72, 20, 16, "two_step_leading_ones", True),  # N % 32
    (1, 2, 200, 4096, 72, 154, 8, "ex_pred", True),
    (1, 2, 100, 4096, 72, 77, 32, "two_step_leading_ones", True),  # 8 rows
    (1, 2, 530, 700, 72, 50, 16, "ex_pred", False),  # true-score top-k
    (1, 2, 1024, 1024, 128, 154, 8, "ex_pred", True),
    (1, 2, 1000, 1000, 72, 1000, 8, "ex_pred", True),  # dense
    (1, 2, 600, 2048, 72, 2048, 32, "two_step_leading_ones", True),  # dense
]


@pytest.mark.parametrize("case", _K4_CASES)
@pytest.mark.parametrize("contract", ["exact", "serving"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("in_dtype,out_dtype",
                         [(torch.float32, torch.float32),
                          (torch.bfloat16, torch.bfloat16)])
def test_k4_matches_plain(cuda, case, contract, with_bias, in_dtype,
                          out_dtype):
    B, H, N, S, D, k, kb, pred_mode, approx = case
    q, kk, v, bias = (None if t is None else t.to(cuda) for t in _k3_inputs(
        B, H, N, S, D, in_dtype, 41, with_bias))
    kw = dict(k=k, scale=D ** -0.5, key_bits=kb, pred_mode=pred_mode,
              approx=approx, contract=contract, out_dtype=out_dtype,
              flush=True)
    before = fused_topk_attention_tiled.launches
    got = fused_topk_attention(q, kk, v, bias, **kw)
    want = fused_topk_attention_ref(q, kk, v, bias, **kw)
    torch.cuda.synchronize()
    assert fused_topk_attention_tiled.launches == before + 1
    assert got.dtype == out_dtype and torch.isfinite(got).all()
    assert torch.equal(got, want)  # same arithmetic in the same order


@pytest.mark.parametrize("bfloat", [0, 16])
@pytest.mark.parametrize("fmt", ["int8", "int4", "fp8_e4m3", "fp6_e3m2"])
def test_k4_formats_and_subnormal_flush(cuda, bfloat, fmt):
    B, H, N, S, D = 1, 2, 600, 640, 72
    ebits, mbits, emax, max_norm, _ = format_params(fmt)
    q, k, v, bias = _k3_inputs(B, H, N, S, D, torch.float32, 51, True)
    k[0, 0, 5, :32] = 1e-39   # a block of subnormals: flushed to zero
    v[0, 1, 544:576, 3] = 3e-39
    q[0, 1, 7, 32:64] = -2e-40
    kw = dict(k=77, scale=D ** -0.5, key_bits=32, bfloat=bfloat, flush=True,
              ebits=ebits, mbits=mbits, emax=emax, max_norm=max_norm,
              pred_mode="two_step_leading_ones")
    args = [t.to(cuda) for t in (q, k, v, bias)]
    got = fused_topk_attention(*args, **kw)
    want = fused_topk_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


_K3_K4_CASES = [  # (N, S, k, pred_mode, approx, with_bias)
    (256, 256, 77, "ex_pred", True, False),
    (256, 120, 20, "two_step_leading_ones", True, True),
    (300, 77, 20, "ex_pred", False, True),
    (512, 512, 512, "ex_pred", True, False),  # dense
    (512, 512, 77, "ex_pred", True, False),
    (512, 512, 77, "two_step_leading_ones", True, True),
]


@pytest.mark.parametrize("case", _K3_K4_CASES)
@pytest.mark.parametrize("contract", ["exact", "serving"])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
def test_k4_matches_k3(cuda, case, contract, in_dtype):
    """On shapes both kernels take, K4 equals K3 bit for bit: the same
    summation orders, another tiling."""
    N, S, k, pred_mode, approx, with_bias = case
    args = [None if t is None else t.to(cuda) for t in _k3_inputs(
        2, 2, N, S, 72, in_dtype, 61, with_bias)]
    kw = dict(k=k, scale=72 ** -0.5, key_bits=8, pred_mode=pred_mode,
              approx=approx, contract=contract, out_dtype=in_dtype,
              bfloat=16)
    before3, before4 = (fused_topk_attention.launches,
                        fused_topk_attention_tiled.launches)
    got = fused_topk_attention_tiled(*args, **kw)
    want = fused_topk_attention(*args, **kw)
    torch.cuda.synchronize()
    assert fused_topk_attention.launches == before3 + 1
    assert fused_topk_attention_tiled.launches == before4 + 1
    assert torch.equal(got, want)


def test_k4_refuses_what_it_does_not_serve(cuda):
    q = torch.zeros(1, 1, 600, 72, device=cuda)
    longer = torch.zeros(1, 1, MAX_TILED_KEYS + 1, 72, device=cuda)
    with pytest.raises(NotImplementedError, match="XLA path"):
        fused_topk_attention_tiled(q, longer, longer, k=8, scale=0.125)
    wide = torch.zeros(1, 1, 600, 136, device=cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fused_topk_attention_tiled(wide, wide, wide, k=8, scale=0.125)
    # ELSA needs its projection, of at most MAX_ELSA_BITS rows of width D
    with pytest.raises(ValueError, match="projection"):
        fused_topk_attention_tiled(q, q, q, k=8, scale=0.125,
                                   pred_mode="ELSA")
    with pytest.raises(NotImplementedError, match="bits"):
        fused_topk_attention_tiled(q, q, q, None,
                                   torch.zeros(200, 72, device=cuda),
                                   k=8, scale=0.125, pred_mode="ELSA")


_NEW_MODES = ("MXINT4", "partial_Q", "partial_K", "true_ex", "threshold_ex",
              "ELSA")


def _proj(mode, cuda, D=72):
    return orthogonal_matrix(D, cuda) if mode == "ELSA" else None


@pytest.mark.parametrize("mode", _NEW_MODES)
@pytest.mark.parametrize("kernel", ["K3", "K4"])
@pytest.mark.parametrize("contract", ["exact", "serving"])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
def test_split_modes_match_plain(cuda, mode, kernel, contract, in_dtype):
    """Each predictor mode on K3 and K4, bit for bit: ELSA square (N = S =
    200), the others N = 200 against S = 160 with the caption bias; f32 in
    at key_bits 32 with flush, bf16 in at key_bits 8, bfloat 16."""
    S = 200 if mode == "ELSA" else 160
    args = [t if t is None else t.to(cuda) for t in _k3_inputs(
        2, 2, 200, S, 72, in_dtype, 81, mode != "ELSA")]
    bf16 = in_dtype == torch.bfloat16
    kw = dict(k=33, scale=72 ** -0.5, key_bits=8 if bf16 else 32,
              bfloat=16 if bf16 else 0, flush=not bf16, pred_mode=mode,
              contract=contract, out_dtype=in_dtype)
    fn = fused_topk_attention if kernel == "K3" else \
        fused_topk_attention_tiled
    got = fn(*args, _proj(mode, cuda), **kw)
    want = fused_topk_attention_ref(*args, _proj(mode, cuda), **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", _NEW_MODES)
@pytest.mark.parametrize("fmt", ["int4", "fp8_e4m3"])
def test_split_modes_other_formats(cuda, mode, fmt):
    """Each mode on the int4 grid (the block-grid codes) and an MXFP grid
    (the CUDA-core operands), with subnormal blocks under flush, K3 and K4,
    both tiers."""
    ebits, mbits, emax, max_norm, _ = format_params(fmt)
    q, k, v, _ = _k3_inputs(1, 2, 96, 96, 72, torch.float32, 91, False)
    k[0, 0, 5, :32] = 1e-39
    q[0, 1, 7, 32:64] = -2e-40
    args = [t.to(cuda) for t in (q, k, v)]
    for fn in (fused_topk_attention, fused_topk_attention_tiled):
        for contract in ("exact", "serving"):
            kw = dict(k=17, scale=72 ** -0.5, key_bits=32, flush=True,
                      ebits=ebits, mbits=mbits, emax=emax, max_norm=max_norm,
                      pred_mode=mode, contract=contract)
            got = fn(*args, None, _proj(mode, cuda), **kw)
            want = fused_topk_attention_ref(*args, None, _proj(mode, cuda),
                                            **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want)


@pytest.mark.parametrize("kernel", ["K3", "K4"])
def test_elsa_tie_heavy_rows_match_plain(cuda, kernel):
    """Keys in groups of eight copies: every query row meets many keys at
    one hamming distance, so each tier's tie rule decides the selection;
    bit for bit, both tiers, key_bits 32 and 8."""
    q, k, v, _ = _k3_inputs(1, 2, 256, 256, 72, torch.float32, 95, False)
    k = k[:, :, ::8].repeat_interleave(8, dim=2).contiguous()
    args = [t.to(cuda) for t in (q, k, v)]
    fn = fused_topk_attention if kernel == "K3" else \
        fused_topk_attention_tiled
    for contract in ("exact", "serving"):
        for kb in (32, 8):
            kw = dict(k=37, scale=72 ** -0.5, key_bits=kb, pred_mode="ELSA",
                      contract=contract)
            got = fn(*args, None, _proj("ELSA", cuda), **kw)
            want = fused_topk_attention_ref(*args, None, _proj("ELSA", cuda),
                                            **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want)


def test_tiny_1024_shaped_pixart_on_card(cuda):
    """PixArt-alpha 1024^2's shapes at two blocks of four heads: N = 4096
    latent tokens with micro-conditioning, bf16 activations, prequantized
    weights, self top-k two_step and cross top-k k = 60 over the masked
    caption, both tiers: K4 in every attention, finite latents of shape
    (1, 4, 128, 128)."""
    cfg = PixArtConfig(sample_size=128, num_layers=2, num_attention_heads=4,
                       caption_channels=64)
    model = init_pixart(cfg, torch.Generator().manual_seed(0), cuda)
    model, specs = prequantize_weights(model, pixart_mx_specs(),
                                       serve_dtype=torch.bfloat16)
    emb = _normal((1, 120, 64), 97).to(cuda)
    mask = (torch.arange(120) < 77).float()[None].to(cuda)
    null = _normal((1, 120, 64), 98).to(cuda)
    for contract in ("exact", "serving"):
        qcfg = PixArtQuantConfig(
            mx_specs=specs, mx_quant=True, self_top_k=True, self_k=77,
            cross_top_k=True, cross_k=60, ex_pred=True,
            pred_mode="two_step_leading_ones", exclude_blocks=(1,),
            topk_key_bits=8, activation_dtype="bfloat16", contract=contract)
        before = (fused_topk_attention.launches,
                  fused_topk_attention_tiled.launches)
        lat = sample_pixart(model, qcfg, emb, mask, null, num_steps=2,
                            latents=_normal((1, 4, 128, 128), 99),
                            device=cuda)
        torch.cuda.synchronize()
        assert lat.shape == (1, 4, 128, 128) and torch.isfinite(lat).all()
        assert fused_topk_attention.launches == before[0]
        assert fused_topk_attention_tiled.launches == before[1] + 2 * 4


@pytest.mark.parametrize("fmt", ["int8", "int4", "fp8_e4m3", "fp4_e2m1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bfloat", [0, 16])
@pytest.mark.parametrize("flush", [False, True])
@pytest.mark.parametrize("C", [96, 1152, 1280, 4096])
def test_k5_matches_plain(cuda, fmt, dtype, bfloat, flush, C):
    x = (3 * _normal((3, 50, C), 41) + 0.5).to(dtype)  # rows % 8 != 0
    shift, scale = 0.3 * _normal((3, C), 42), 0.3 * _normal((3, C), 43)
    if flush:  # a block of subnormal modulated values
        scale[0, :32], shift[0, :32] = -1.0, 1e-39
    args = [t.to(cuda) for t in (x, shift, scale)]
    kw = dict(elem_format=fmt, flush=flush, bfloat=bfloat)
    got = ln_modulate_quantize(*args, **kw)
    want = ln_modulate_quantize_ref(*args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("C", [96, 1280, 2304])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_f32_output(cuda, dtype, C):
    x = (3 * _normal((3, 50, C), 51)).to(dtype)
    shift, scale = 0.3 * _normal((3, C), 52), 0.3 * _normal((3, C), 53)
    args = [t.to(cuda) for t in (x, shift, scale)]
    kw = dict(bfloat=16, out_dtype=torch.float32)
    got = ln_modulate_quantize(*args, **kw)
    want = ln_modulate_quantize_ref(*args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_k5_counts_launches_and_refuses_wide_rows(cuda):
    x, s = torch.ones(2, 8, 64, device=cuda), torch.zeros(2, 64, device=cuda)
    before = ln_modulate_quantize.launches
    ln_modulate_quantize(x, s, s)
    assert ln_modulate_quantize.launches == before + 1
    # 1280 channels, wider than DiT-XL's, are served
    x = (3 * _normal((2, 8, 1280), 44)).to(cuda)
    shift, scale = ((0.3 * _normal((2, 1280), 45 + i)).to(cuda)
                    for i in range(2))
    assert torch.equal(ln_modulate_quantize(x, shift, scale, bfloat=16),
                       ln_modulate_quantize_ref(x, shift, scale, bfloat=16))
    assert ln_modulate_quantize.launches == before + 2
    C = MAX_CHANNELS + 32
    wide, sw = torch.ones(1, 2, C, device=cuda), torch.zeros(1, C,
                                                              device=cuda)
    with pytest.raises(NotImplementedError, match="MAX_CHANNELS"):
        ln_modulate_quantize(wide, sw, sw)


def test_k5_reads_strided_bf16_modulation(cuda):
    """shift and scale as the DiT blocks pass them: bf16 chunks of the
    adaLN output, rows 6 C apart, read in place."""
    x = (3 * _normal((2, 40, 1152), 47)).to(torch.bfloat16).to(cuda)
    mod = (0.3 * _normal((2, 6 * 1152), 48)).to(torch.bfloat16).to(cuda)
    shift, scale = mod[:, :1152], mod[:, 1152:2304]
    got = ln_modulate_quantize(x, shift, scale, bfloat=16)
    want = ln_modulate_quantize_ref(x, shift.contiguous(),
                                    scale.contiguous(), bfloat=16)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_dit_hidden_1280_serving_runs_k5(cuda):
    """A two-block DiT of hidden 1280 with fuse_ln_modulate in the serving
    tier: the gate (JAX's) sends every LN-modulate to K5, which serves the
    width; K5 launches twice per block and once in the final layer."""
    cfg = DiTConfig(input_size=8, hidden_size=1280, depth=2, num_heads=20,
                    num_classes=10)
    qcfg = DiTQuantConfig(mx_specs=dit_mx_specs(), mx_quant=True,
                          top_k=True, k=6, exclude_blocks=(1,),
                          topk_key_bits=8, contract="serving",
                          activation_dtype="bfloat16", fuse_ln_modulate=True)
    model = init_dit(cfg, torch.Generator().manual_seed(0), cuda,
                     randomize_all=True)
    x = _normal((2, 4, 8, 8), 49).to(cuda)
    t, y = torch.tensor([10, 200], device=cuda), torch.tensor([1, 3],
                                                              device=cuda)
    before = ln_modulate_quantize.launches
    ln_modulate_quantize.sites.clear()
    out = dit_forward(model, x, t, y, qcfg)
    torch.cuda.synchronize()
    assert out.shape == (2, cfg.out_channels, 8, 8)
    assert torch.isfinite(out).all()
    assert ln_modulate_quantize.launches - before == 2 * cfg.depth + 1
    assert {site[0] for site in ln_modulate_quantize.sites} == {(2, 16, 1280)}


@pytest.mark.parametrize("fmt", ["int8", "int4", "fp8_e4m3", "fp6_e3m2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bfloat", [0, 16, 32])
@pytest.mark.parametrize("flush", [False, True])
@pytest.mark.parametrize("approximate", [True, False])
def test_k6_matches_plain(cuda, fmt, dtype, bfloat, flush, approximate):
    x = (3 * _normal((100, 288), 44)).to(dtype)  # ragged rows, a partial tile
    kw = dict(elem_format=fmt, flush=flush, bfloat=bfloat,
              approximate=approximate)
    got = gelu_quantize(x.to(cuda), **kw)
    want = gelu_quantize_ref(x.to(cuda), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _split_t_operands(qkv, H, Dp):
    """K2's (B, N, 3*H*D) input as K7's qk_t (2*H*Dp, B, N) and v."""
    B, N, F = qkv.shape
    D = F // (3 * H)
    qk = torch.nn.functional.pad(qkv[..., :2 * H * D].reshape(B, N, 2, H, D),
                                 (0, Dp - D))
    qk_t = qk.permute(2, 3, 4, 0, 1).reshape(2 * H * Dp, B, N).contiguous()
    return qk_t, qkv[..., 2 * H * D:].contiguous()


_K7_CASES = [  # (B, N, H, D, k, key_bits, contract)
    (2, 128, 2, 72, 20, 8, "exact"),
    (2, 128, 2, 72, 20, 8, "serving"),
    (2, 256, 2, 32, 20, 32, "exact"),
    (2, 256, 2, 32, 20, 16, "serving"),
    (2, 256, 4, 72, 256, 8, "exact"),    # dense branch
    (2, 256, 4, 72, 256, 8, "serving"),
    (1, 256, 4, 72, 154, 8, "exact"),
    (1, 256, 4, 72, 154, 8, "serving"),
]


@pytest.mark.parametrize("case", _K7_CASES)
@pytest.mark.parametrize("in_dtype,out_dtype",
                         [(torch.float32, torch.float32),
                          (torch.bfloat16, torch.bfloat16)])
def test_k7_matches_plain_and_k2(cuda, case, in_dtype, out_dtype):
    B, N, H, D, k, kb, contract = case
    qkv = _normal((B, N, 3 * H * D), 45, in_dtype).to(cuda)
    qk_t, v = _split_t_operands(qkv, H, -(-D // 32) * 32)
    kw = dict(k=k, scale=D ** -0.5, key_bits=kb, bfloat=16,
              contract=contract, out_dtype=out_dtype)
    got = fused_topk_attention_qkv_t(qk_t, v, H, n_valid=N, **kw)
    want = fused_topk_attention_qkv_t_ref(qk_t, v, H, n_valid=N, **kw)
    k2 = fused_topk_attention_qkv(qkv, H, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, k2)  # K2's math on the same values


def test_k7_masks_keys_past_n_valid_and_counts_launches(cuda):
    B, N, H, D = 2, 128, 2, 72
    qkv = _normal((B, N, 3 * H * D), 46).to(cuda)
    qkv[:, 100:] = 0  # the padded tokens are zero
    qk_t, v = _split_t_operands(qkv, H, 96)
    kw = dict(k=20, scale=D ** -0.5, key_bits=8, bfloat=16, n_valid=100)
    before = fused_topk_attention_qkv_t.launches
    got = fused_topk_attention_qkv_t(qk_t, v, H, **kw)
    assert fused_topk_attention_qkv_t.launches == before + 1
    assert torch.equal(got, fused_topk_attention_qkv_t_ref(qk_t, v, H, **kw))
    long = torch.zeros(2 * H * 96, 1, 640, device=cuda)
    with pytest.raises(NotImplementedError, match="512"):
        fused_topk_attention_qkv_t(long, torch.zeros(1, 640, H * D,
                                                     device=cuda), H,
                                   k=20, scale=0.1, n_valid=640)
    assert fused_topk_attention_qkv_t.launches == before + 1


def _k2_k7(qkv, H, kw, Dp=None):
    """K2 and K7 on the same values, each against its plain version and
    against each other."""
    D = qkv.shape[2] // (3 * H)
    qk_t, v = _split_t_operands(qkv, H, Dp or -(-D // 32) * 32)
    got = fused_topk_attention_qkv(qkv, H, **kw)
    want = fused_topk_attention_qkv_ref(qkv, H, **kw)
    k7 = fused_topk_attention_qkv_t(qk_t, v, H, n_valid=qkv.shape[1], **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)
    assert torch.equal(k7, got)


@pytest.mark.parametrize("mode", QKV_PRED_MODES)
@pytest.mark.parametrize("contract", ["exact", "serving"])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
def test_k2_k7_modes_match_plain(cuda, mode, contract, in_dtype):
    """Every predictor of the TPU kernels' qkv entries at the DiT site's N
    and D (bf16: key_bits 8, bfloat 16; f32: key_bits 32, flush), top-k
    and two rows."""
    bf16 = in_dtype == torch.bfloat16
    qkv = _normal((2, 256, 3 * 2 * 72), 47, in_dtype).to(cuda)
    kw = dict(k=154, scale=72 ** -0.5, key_bits=8 if bf16 else 32,
              bfloat=16 if bf16 else 0, flush=not bf16, pred_mode=mode,
              contract=contract, out_dtype=in_dtype)
    _k2_k7(qkv, 2, kw)


@pytest.mark.parametrize("N", [300, 384, 512])
@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("mode", QKV_PRED_MODES)
def test_k2_k7_long_rows(cuda, N, fmt, mode):
    """N past 256 up to the TPU entries' 512 (the radix select, the wider
    selection masks; some calls in fewer warps or two phases), on the int
    grid and an MXFP grid, key_bits 8 and 32, both tiers."""
    ebits, mbits, emax, max_norm, _ = format_params(fmt)
    qkv = _normal((1, N, 3 * 2 * 72), 48, torch.bfloat16).to(cuda)
    for contract in ("exact", "serving"):
        for kb in (8, 32):
            kw = dict(k=N // 3, scale=72 ** -0.5, key_bits=kb, bfloat=16,
                      ebits=ebits, mbits=mbits, emax=emax,
                      max_norm=max_norm, pred_mode=mode, contract=contract,
                      out_dtype=torch.bfloat16)
            _k2_k7(qkv, 2, kw)


@pytest.mark.parametrize("mode", QKV_PRED_MODES)
@pytest.mark.parametrize("fmt", ["int4", "fp6_e3m2"])
def test_k2_k7_modes_other_formats(cuda, mode, fmt):
    """Each mode on the int4 grid and an fp6 grid, with subnormal blocks
    under flush, D = 64 and 128, both tiers."""
    ebits, mbits, emax, max_norm, _ = format_params(fmt)
    for D in (64, 128):
        qkv = _normal((1, 96, 3 * 2 * D), 49).to(cuda)
        qkv[0, 5, 2 * D:2 * D + 32] = 1e-39  # a k block of head 0
        qkv[0, 7, 32:64] = -2e-40            # a q block of head 0
        for contract in ("exact", "serving"):
            kw = dict(k=17, scale=D ** -0.5, key_bits=32, flush=True,
                      ebits=ebits, mbits=mbits, emax=emax,
                      max_norm=max_norm, pred_mode=mode, contract=contract)
            _k2_k7(qkv, 2, kw)


@pytest.mark.parametrize("contract", ["exact", "serving"])
def test_k2_deit_base_two_step_site(cuda, contract):
    """K2 at DeiT-base's qkv site in two_step (f32, 12 heads of 64, N =
    197, k = 30, key_bits 32): the key cache of the radix select."""
    x = _normal((2, 197, 3 * 12 * 64), 64).to(cuda)
    kw = dict(k=30, scale=64 ** -0.5, key_bits=32,
              pred_mode="two_step_leading_ones", contract=contract)
    got = fused_topk_attention_qkv(x, 12, **kw)
    want = fused_topk_attention_qkv_ref(x, 12, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.equal(got, want)


def test_bf16_product_has_f32_output(cuda):
    a = _normal((64, 96), 5, torch.bfloat16)
    b = _normal((48, 96), 6, torch.bfloat16)
    got = mm_f32(a.to(cuda), b.to(cuda))
    assert got.dtype == torch.float32
    # bf16 products are exact in f32; only the summation order differs
    torch.testing.assert_close(got.cpu(), mm_f32(a, b), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("opt_ins", [False, True])
def test_tiny_sampling_on_card_matches_cpu(cuda, opt_ins):
    """The whole slice at a tiny size: kernels on the card against the
    plain versions on the CPU, same weights and noise; with ``opt_ins``
    the serving tier with K5, K6 and K7 (N = 256)."""
    cfg = DiTConfig(input_size=32 if opt_ins else 8, hidden_size=64,
                    depth=2, num_heads=2, num_classes=10)
    qcfg = DiTQuantConfig(mx_specs=dit_mx_specs(), mx_quant=True,
                          top_k=True, k=6, exclude_blocks=(1,),
                          topk_key_bits=8)
    if opt_ins:
        qcfg = dataclasses.replace(qcfg, contract="serving",
                                   fuse_ln_modulate=True, fuse_gelu=True,
                                   qkv_layout="split_t")
    side = cfg.input_size
    z = _normal((2, 4, side, side), 7)
    noise = [_normal((4, 4, side, side), 8 + i) for i in range(3)]
    outs = []
    for dev in ("cpu", cuda):
        model = init_dit(cfg, torch.Generator().manual_seed(0), dev,
                         randomize_all=True)
        outs.append(sample_dit(model, qcfg, [1, 3], num_steps=3, z=z,
                               step_noise=noise, device=dev).cpu())
    assert torch.isfinite(outs[1]).all()
    # the f32 matmuls sum in another order on the card, which can move an
    # MX grid choice: bulk agreement, as the JAX model goldens check
    close = torch.isclose(outs[1], outs[0], rtol=1e-3, atol=1e-3)
    assert close.float().mean() >= 0.99


def test_tiny_long_sequence_sampling_on_card_matches_cpu(cuda):
    """The 512^2 path at a tiny size (N = 1024: K4 in every block), both
    tiers: the card against the plain versions on the CPU."""
    cfg = DiTConfig(input_size=64, hidden_size=64, depth=2, num_heads=2,
                    num_classes=10)
    z = _normal((2, 4, 64, 64), 17)
    noise = [_normal((4, 4, 64, 64), 18 + i) for i in range(2)]
    for contract in ("exact", "serving"):
        qcfg = DiTQuantConfig(mx_specs=dit_mx_specs(), mx_quant=True,
                              top_k=True, k=154, exclude_blocks=(1,),
                              topk_key_bits=8, contract=contract)
        outs = []
        for dev in ("cpu", cuda):
            model = init_dit(cfg, torch.Generator().manual_seed(0), dev,
                             randomize_all=True)
            outs.append(sample_dit(model, qcfg, [1, 3], num_steps=2, z=z,
                                   step_noise=noise, device=dev).cpu())
        assert torch.isfinite(outs[1]).all()
        close = torch.isclose(outs[1], outs[0], rtol=1e-3, atol=1e-3)
        assert close.float().mean() >= 0.99


# ---- DeiT (slice 7): f32 activations, bfloat 32 (the kernels' bfloat 0),
# no flush, key_bits 32, N = 197 tokens (padded to 224), D = 64

@pytest.mark.parametrize("H,k", [(3, 80), (6, 60), (12, 197)])
@pytest.mark.parametrize("contract", ["exact", "serving"])
def test_k2_deit_sites(cuda, H, k, contract):
    """K2 at DeiT's qkv sites (f32 qkv, bfloat 0, key_bits 32; k = 197 is
    the last block's dense call), f32 output."""
    x = _normal((4, 197, 3 * H * 64), 60 + H).to(cuda)
    kw = dict(k=k, scale=64 ** -0.5, key_bits=32, bfloat=0,
              contract=contract, out_dtype=torch.float32)
    got = fused_topk_attention_qkv(x, H, **kw)
    want = fused_topk_attention_qkv_ref(x, H, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.equal(got, want)


@pytest.mark.parametrize("pred_mode", ["two_step_leading_ones", "ELSA"])
@pytest.mark.parametrize("contract", ["exact", "serving"])
def test_k3_deit_base_site(cuda, pred_mode, contract):
    """K3 at DeiT-base's split site: (B, 12, 197, 64) f32, k = 30,
    key_bits 32, no flush; ELSA with the structured projection."""
    q, kk, v = (t.to(cuda) for t in _k3_inputs(
        2, 12, 197, 197, 64, torch.float32, 61, False)[:3])
    proj = orthogonal_matrix(64, cuda) if pred_mode == "ELSA" else None
    kw = dict(k=30, scale=64 ** -0.5, key_bits=32, pred_mode=pred_mode,
              contract=contract, out_dtype=torch.float32)
    got = fused_topk_attention(q, kk, v, None, proj, **kw)
    want = fused_topk_attention_ref(q, kk, v, None, proj, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.equal(got, want)


def test_k6_deit_site(cuda):
    """K6's erf form at DeiT-base's fc2 input, f32, bfloat 32."""
    x = (2 * _normal((2, 197, 3072), 62)).to(cuda)
    kw = dict(bfloat=32, approximate=False, out_dtype=torch.bfloat16)
    got = gelu_quantize(x, **kw)
    want = gelu_quantize_ref(x, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("plan", ["ex_pred exact", "ex_pred serving",
                                  "two_step exact", "fuse_gelu serving"])
def test_deit_tiny_on_card_matches_plain_versions(cuda, plan, monkeypatch):
    """DeiT-tiny at full width and depth, 2 images: the forward through the
    kernels against the same forward on the card with every kernel wrapper
    replaced by its plain version.  The rest of the forward is the same
    torch code on the same device, so the logits agree bit for bit; the
    kernels' launches are DeiT's per-forward counts."""
    from mx_quantization_tpu_torch import attention
    from mx_quantization_tpu_torch.models.vit import (VIT_CONFIGS,
                                                      VitQuantConfig,
                                                      init_vit, vit_forward)
    from mx_quantization_tpu_torch.ops.kernels import quantize as kq
    from mx_quantization_tpu_torch.workloads.deit import default_mx_specs
    mode, contract = plan.split()
    cfg = VIT_CONFIGS["deit_tiny_patch16_224"]
    model = init_vit(cfg, torch.Generator().manual_seed(0), cuda)
    model, specs = prequantize_weights(model, default_mx_specs())
    qcfg = VitQuantConfig(
        mx_specs=specs, mx_quant=True, top_k=True,
        k=30 if mode == "two_step" else 80,
        pred_mode=("two_step_leading_ones" if mode == "two_step"
                   else "ex_pred"),
        contract=contract, fuse_gelu=mode == "fuse_gelu")
    x = _normal((2, 3, 224, 224), 63).to(cuda)
    wrappers = (kq.mx_quantize, kq.gelu_quantize,
                attention.fused_topk_attention_qkv,
                attention.fused_topk_attention)
    before = [w.launches for w in wrappers]
    with torch.inference_mode():
        got = vit_forward(model, x, qcfg)
    launches = [w.launches - b for w, b in zip(wrappers, before)]
    per_fwd = {"ex_pred": [48, 0, 12, 0], "two_step": [48, 0, 12, 0],
               "fuse_gelu": [36, 12, 12, 0]}[mode]
    assert launches == per_fwd
    monkeypatch.setattr(kq, "mx_quantize", kq.mx_quantize_ref)
    monkeypatch.setattr(kq, "gelu_quantize", kq.gelu_quantize_ref)
    monkeypatch.setattr(attention, "fused_topk_attention_qkv",
                        fused_topk_attention_qkv_ref)
    monkeypatch.setattr(attention, "fused_topk_attention",
                        fused_topk_attention_ref)
    with torch.inference_mode():
        want = vit_forward(model, x, qcfg)
    torch.cuda.synchronize()
    assert got.shape == (2, 1000) and torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("family", ["elem", "bfloat", "fp", "mx", "mxnone"])
def test_emulation_quantizers_match_goldens_on_card(cuda, family):
    """The emulation engine's quantizers (plain torch, no kernel) on CUDA
    tensors: every reference-torch golden key of the family under
    tests/test_quantize_parity.py's rule, and bit for bit the port's own
    CPU result (CUDA keeps subnormals, as the bit arithmetic expects)."""
    from emulation_goldens import golden_cases, golden_mismatches, load
    elem, mx_npz = load()
    n = 0
    for fam, _, key, x, call in golden_cases(elem, mx_npz):
        if fam != family:
            continue
        n += 1
        xt = torch.from_numpy(np.ascontiguousarray(x))
        got = call(xt.to(cuda)).cpu()
        want = (mx_npz if family.startswith("mx") else elem)[key]
        assert not golden_mismatches(got, want), key
        cpu = call(xt)
        assert torch.equal(got.isnan(), cpu.isnan()), key
        keep = ~cpu.isnan()
        assert torch.equal(got[keep].view(torch.int32),
                           cpu[keep].view(torch.int32)), key
    assert n


@pytest.mark.parametrize("site", ["dit_qkv", "deit_fc1"])
def test_ref_linear_matches_fused_on_card(cuda, site):
    """The emulation linear against the fast one (K1 and the bf16 GEMM)
    at a DiT site (bf16 activations, bfloat=16) and a DeiT site (f32,
    bfloat 32), within tests/test_fastpath.py's 1e-6 bound."""
    from mx_quantization_tpu_torch.ops.linear import linear
    from mx_quantization_tpu_torch.workloads.deit import default_mx_specs
    if site == "dit_qkv":
        x = _normal((4, 256, 1152), 1, torch.bfloat16).to(cuda)
        w, b = _normal((3456, 1152), 2) * 0.03, _normal((3456,), 3)
        specs = dit_mx_specs()
    else:
        x = _normal((4, 197, 384), 4).to(cuda)
        w, b = _normal((1536, 384), 5) * 0.05, _normal((1536,), 6)
        specs = default_mx_specs()
    w, b = w.to(cuda), b.to(cuda)
    before = mx_quantize.launches
    fused = linear(x, w, b, mx_specs=specs)
    assert mx_quantize.launches == before + 1
    ref = linear(x, w, b, mx_specs=specs.replace(custom_tpu="ref"))
    assert mx_quantize.launches == before + 1
    torch.testing.assert_close(ref, fused, rtol=1e-6, atol=1e-6)


def _no_sync(fn):
    """``fn`` with every synchronizing CUDA call an error."""
    def run(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return run


@pytest.mark.parametrize("solver", ["ddpm", "dpm++"])
def test_server_dispatch_and_refill_do_not_sync(cuda, solver):
    """The continuous-batching server on the card with every host sync an
    error in its dispatch and its refill: a small fused-engine DiT with
    top-k (K1, K2) under DDPM, and a small PixArt with MXINT8 two_step
    top-k (K1, K3) and dict conditions from numpy under DPM-Solver++; a
    staggered stream, every request answered.  The DiT burst is also
    sample_dit's result, bit for bit, with the server's noise replayed."""
    from mx_quantization_tpu_torch.serving import DiffusionServer, Request
    rng = np.random.RandomState(0)
    if solver == "ddpm":
        cfg = DiTConfig(input_size=8, hidden_size=64, depth=2, num_heads=2,
                        num_classes=10)
        model = init_dit(cfg, torch.Generator().manual_seed(0), cuda,
                         randomize_all=True)
        qcfg = DiTQuantConfig(mx_specs=dit_mx_specs(), mx_quant=True,
                              top_k=True, k=6, exclude_blocks=(1,),
                              topk_key_bits=8, contract="serving",
                              activation_dtype="bfloat16")

        def model_fn(x, t, y):
            return dit_forward(model, x, t, y, qcfg)
        null, make = 10, (lambda i: i % 10)
    else:
        from mx_quantization_tpu_torch.models.pixart import pixart_forward
        cfg = PixArtConfig(num_attention_heads=2, attention_head_dim=32,
                           num_layers=2, sample_size=8, patch_size=2,
                           cross_attention_dim=64, caption_channels=48,
                           micro_conds=False)
        model = init_pixart(cfg, torch.Generator().manual_seed(0), cuda)
        qcfg = PixArtQuantConfig(
            mx_specs=pixart_mx_specs(), mx_quant=True, self_top_k=True,
            self_k=8, ex_pred=True, pred_mode="two_step_leading_ones",
            topk_key_bits=8, contract="serving")

        def model_fn(x, t, cond):
            return pixart_forward(model, x, cond["embeds"], t, qcfg,
                                  encoder_attention_mask=cond["mask"])
        null = {"embeds": rng.randn(6, 48).astype(np.float32) * 0.02,
                "mask": np.ones((6,), np.float32)}

        def make(i):
            return {"embeds": rng.randn(6, 48).astype(np.float32) * 0.02,
                    "mask": (np.arange(6) < 2 + i % 5).astype(np.float32)}
    srv = DiffusionServer(model_fn, (4, 8, 8), num_steps=4, slots=3,
                          solver=solver, null_condition=null, seed=5,
                          device=cuda)
    srv._dispatch = _no_sync(srv._dispatch)
    srv._fill_slots = _no_sync(srv._fill_slots)
    for i in range(5):
        srv.submit(Request(i, make(i)))
        srv.step()
    res = srv.run_until_drained()
    assert sorted(res) == list(range(5))
    assert all(np.isfinite(r.latent).all() and r.latent.shape == (4, 8, 8)
               for r in res.values())
    if solver == "dpm++":
        return
    srv = DiffusionServer(model_fn, (4, 8, 8), num_steps=4, slots=3,
                          null_condition=null, seed=5, device=cuda)
    for i in range(3):
        srv.submit(Request(i, i))
    res = srv.run_until_drained()
    g = torch.Generator(device=cuda).manual_seed(5)
    z = torch.stack([torch.randn((4, 8, 8), generator=g, device=cuda)
                     for _ in range(3)])
    noise = [torch.randn((3, 4, 8, 8), generator=g, device=cuda)
             for _ in range(4)]
    want = sample_dit(model, qcfg, [0, 1, 2], num_steps=4, z=z,
                      step_noise=[torch.cat([n, n]) for n in noise],
                      device=cuda).cpu()
    for i in range(3):
        assert torch.equal(torch.from_numpy(res[i].latent), want[i])


# ---- training: K1 at the surrogate backward's new sites, and a
# tiny quantization-aware training step on the card against the CPU

@pytest.mark.parametrize("shape,bfloat", [((32, 16, 256, 256), 16),
                                          ((64, 6, 197, 64), 32)])
def test_k1_training_sites(cuda, shape, bfloat):
    """The surrogate backward rematerializes attention through the fast
    matmul, whose operand a takes K1: at DiT-XL/2 256^2 (batch 32) the PV
    product's (B, H, N, N) f32 probabilities, bfloat 16; at DeiT-small
    (batch 64) the score product's q, 64 wide, bfloat 32."""
    x = _normal(shape, 31).to(cuda)
    if bfloat == 16:
        x = torch.softmax(4 * x, dim=-1)
    got = mx_quantize(x, "int8", 32, 8, bfloat=bfloat)
    want = mx_quantize_ref(x, "int8", 32, 8, bfloat=bfloat)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("model", ["dit", "deit"])
def test_tiny_training_step_on_card_matches_cpu(cuda, model):
    """One quantization-aware loss and its gradients (quantize_backprop,
    the fused engine: K1 and K2 on the card, their plain versions on the
    CPU; the surrogate backward) on the same weights and inputs.  f32 sums
    add in other orders on the card, which can move an MX grid point: the
    loss within 1e-5 relative, each gradient finite and within one bf16
    step (2^-7) plus 1e-6 on at least 99% of its elements."""
    from mx_quantization_tpu_torch.diffusion import create_diffusion
    from mx_quantization_tpu_torch.models.vit import (VitConfig,
                                                      VitQuantConfig,
                                                      init_vit, vit_forward)
    from mx_quantization_tpu_torch.workloads.deit import default_mx_specs
    from mx_quantization_tpu_torch.workloads.deit_train import \
        label_smoothing_ce
    from mx_quantization_tpu_torch.workloads.dit_train import \
        trainable_tensors
    res = []
    for dev in ("cpu", cuda):
        if model == "dit":
            m = init_dit(DiTConfig(input_size=8, hidden_size=64, depth=2,
                                   num_heads=2, num_classes=10),
                         torch.Generator().manual_seed(0), dev,
                         randomize_all=True)
            qcfg = DiTQuantConfig(
                mx_specs=dit_mx_specs().replace(quantize_backprop=True),
                mx_quant=True, top_k=True, k=6, exclude_blocks=(1,),
                topk_key_bits=8)
            tensors = trainable_tensors(m)
            loss = create_diffusion(None).training_losses(
                lambda xt, tt, y: dit_forward(m, xt, tt, y, qcfg),
                _normal((2, 4, 8, 8), 32).to(dev),
                torch.tensor([0, 637], device=dev),
                model_kwargs={"y": torch.tensor([1, 7], device=dev)},
                noise=_normal((2, 4, 8, 8), 33).to(dev))["loss"].mean()
        else:
            m = init_vit(VitConfig(img_size=32, patch_size=8,
                                   num_classes=10, embed_dim=128, depth=2,
                                   num_heads=2),
                         torch.Generator().manual_seed(0), dev)
            qcfg = VitQuantConfig(
                mx_specs=default_mx_specs().replace(quantize_backprop=True),
                mx_quant=True, top_k=True, k=6)
            m.requires_grad_(True)
            tensors = list(m.parameters())
            loss = label_smoothing_ce(
                vit_forward(m, _normal((4, 3, 32, 32), 34).to(dev), qcfg),
                torch.tensor([1, 2, 3, 4], device=dev))
        loss.backward()
        res.append((loss.item(), [p.grad.cpu() for p in tensors]))
    (lc, gc), (ld, gd) = res
    assert abs(ld / lc - 1) <= 1e-5
    for a, b in zip(gd, gc):
        assert torch.isfinite(a).all()
        close = torch.isclose(a, b, rtol=2.0 ** -7, atol=1e-6)
        assert close.float().mean() >= 0.99


_BLOCKS = (8, 16, 64, 128)
_ALL_MODES = QKV_PRED_MODES + ("ELSA",)


@pytest.mark.parametrize("bs", _BLOCKS)
@pytest.mark.parametrize("mode", QKV_PRED_MODES)
@pytest.mark.parametrize("fmt", ["int8", "int2", "fp8_e4m3"])
def test_k2_k7_at_block_sizes(cuda, bs, mode, fmt):
    """K2 and K7 at the block sizes other than 32, bit for bit to their
    plain versions and K7 equal to K2: every qkv predictor on two int grids
    (the int8 tensor-core build of the block, ``qkv_route``'s ROUTE_QKV_BS;
    true_ex's top-k calls the blocks kernel) and an MXFP grid (the blocks
    kernel), both tiers, bf16 in at key_bits 8 (DiT's) and f32 in at
    key_bits 32; N = 200 (keys padded past a block), the dense call, N =
    256 at key_bits 8 in both tiers (DiT's packed-register bisection), N
    = 512 at key_bits 32 (the radix select at the longest cell), and N =
    512 at D = 128 in both tiers (the largest cell: at block 8 its k scales
    are four times block 32's count)."""
    ebits, mbits, emax, max_norm, _ = format_params(fmt)
    H = 2
    for contract, dtype, kb, k, N, D in (
            ("serving", torch.bfloat16, 8, 47, 200, 72),
            ("exact", torch.float32, 32, 47, 200, 72),
            ("exact", torch.bfloat16, 8, 200, 200, 72),
            ("serving", torch.bfloat16, 8, 154, 256, 72),
            ("exact", torch.bfloat16, 8, 154, 256, 72),
            ("exact", torch.float32, 32, 200, 512, 72),
            ("serving", torch.bfloat16, 16, 200, 512, 128),
            ("exact", torch.bfloat16, 8, 200, 512, 128)):
        qkv = (2 * _normal((2, N, 3 * H * D), bs + len(mode))).to(dtype).to(
            cuda)
        kw = dict(k=k, scale=D ** -0.5, key_bits=kb, block_size=bs,
                  bfloat=16 if dtype == torch.bfloat16 else 0, flush=True,
                  pred_mode=mode, contract=contract, out_dtype=dtype,
                  ebits=ebits, mbits=mbits, emax=emax, max_norm=max_norm)
        route = qkv_route(bs, ebits, mode if k < N else None)
        assert route == (ROUTE_QKV_BS if ebits == 0 and (
            mode != "true_ex" or k >= N) else ROUTE_BLOCKS)
        before = (fused_topk_attention_qkv.routes[route],
                  fused_topk_attention_qkv_t.routes[route])
        got = fused_topk_attention_qkv(qkv, H, **kw)
        want = fused_topk_attention_qkv_ref(qkv, H, **kw)
        Dp = -(-D // bs) * bs
        qk = torch.nn.functional.pad(
            qkv[..., :2 * H * D].reshape(2, N, 2, H, D), (0, Dp - D))
        qk_t = qk.permute(2, 3, 4, 0, 1).reshape(2 * H * Dp, 2, N)
        k7 = fused_topk_attention_qkv_t(qk_t.contiguous(),
                                        qkv[..., 2 * H * D:].contiguous(), H,
                                        n_valid=N, **kw)
        torch.cuda.synchronize()
        assert (fused_topk_attention_qkv.routes[route],
                fused_topk_attention_qkv_t.routes[route]) == (
                    before[0] + 1, before[1] + 1), route
        assert torch.isfinite(got).all()
        assert torch.equal(got, want), (contract, kb, k, N, D)
        assert torch.equal(k7, got), (contract, kb, k, N, D)


@pytest.mark.parametrize("bs", _BLOCKS)
def test_qkv_block_builds_take_every_int_cell(cuda, bs):
    """Every K2/K7 cell on the int grids that block 32 takes, the block's
    build takes too (a part of its four, no raise): N and D up to the
    domain's 512 and 128, each predictor of the int route and the dense
    call, every key_bits, both tiers."""
    lib, lib32 = _qkv_library(0, bs), _qkv_library(0)
    modes = [m for m in QKV_PRED_MODES if m != "true_ex"]
    for N in (1, 31, 33, 200, 256, 257, 449, 481, 500, 512):
        for D in (1, 8, 9, 64, 72, 100, 120, 121, 127, 128):
            for kw in [dict(k=N, approx=False, pred_mode=modes[0])] + [
                    dict(k=max(1, N // 2), approx=True, pred_mode=m)
                    for m in modes]:
                for kb in (8, 16, 32):
                    for contract in ("serving", "exact"):
                        args = qkv_call_args(N, N, D, dict(
                            kw, key_bits=kb, contract=contract, ebits=0))
                        assert lib32.topk_attention_qkv_part(*args) >= 0
                        part = lib.topk_attention_qkv_part(*args)
                        assert 0 <= part < QKV_INT_PARTS, (args, part)


@pytest.mark.parametrize("bs", _BLOCKS)
@pytest.mark.parametrize("mode", _ALL_MODES)
@pytest.mark.parametrize("kernel", ["K3", "K4"])
def test_split_at_block_sizes(cuda, bs, mode, kernel):
    """K3 and K4 at the block sizes other than 32, bit for bit to their
    plain version: every predictor (ELSA square, the others 120 queries
    against 90 keys with the caption bias), f32 in with flush at key_bits
    32 in the exact tier, bf16 in at key_bits 8 in the serving tier; the
    int8 grid, and fp8_e4m3 at two block sizes."""
    fmt = "fp8_e4m3" if bs in (16, 128) else "int8"
    ebits, mbits, emax, max_norm, _ = format_params(fmt)
    S = 120 if mode == "ELSA" else 90
    fn = fused_topk_attention if kernel == "K3" else \
        fused_topk_attention_tiled
    for contract, dtype, kb in (("exact", torch.float32, 32),
                                ("serving", torch.bfloat16, 8)):
        args = [t if t is None else t.to(cuda) for t in _k3_inputs(
            2, 2, 120, S, 72, dtype, bs + 3, mode != "ELSA")]
        kw = dict(k=29, scale=72 ** -0.5, key_bits=kb, block_size=bs,
                  bfloat=16 if dtype == torch.bfloat16 else 0,
                  flush=dtype == torch.float32, pred_mode=mode,
                  contract=contract, out_dtype=dtype, ebits=ebits,
                  mbits=mbits, emax=emax, max_norm=max_norm)
        got = fn(*args, _proj(mode, cuda), **kw)
        want = fused_topk_attention_ref(*args, _proj(mode, cuda), **kw)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert torch.equal(got, want), contract


@pytest.mark.parametrize("bs", _BLOCKS)
def test_k4_long_at_block_sizes(cuda, bs):
    """K4 at 1024 and 4096 keys (DiT-512's and PixArt-1024's lengths) at
    the block sizes other than 32, bit for bit, both tiers."""
    for N, k in ((1024, 154), (4096, 77)):
        args = [t.to(cuda) for t in _k3_inputs(1, 2, 64, N, 72,
                                                torch.bfloat16, bs, False)[:3]]
        for contract in ("exact", "serving"):
            kw = dict(k=k, scale=72 ** -0.5, key_bits=8, block_size=bs,
                      bfloat=16, pred_mode="two_step_leading_ones",
                      contract=contract, out_dtype=torch.bfloat16)
            got = fused_topk_attention_tiled(*args, **kw)
            want = fused_topk_attention_ref(*args, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (N, contract)


@pytest.mark.parametrize("bs", _BLOCKS)
@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("C", [384, 1152, 2304])
def test_k5_at_block_sizes(cuda, bs, fmt, C):
    """K5 at the block sizes other than 32, bit for bit: rows in registers
    (384, 1152) and in shared memory (2304), bf16 in with the bf16 round
    and f32 in with flush."""
    x = (3 * _normal((2, 40, C), bs) + 0.5).to(cuda)
    shift, scale = ((0.3 * _normal((2, C), bs + 1 + i)).to(cuda)
                    for i in range(2))
    for dtype, bfloat, flush in ((torch.bfloat16, 16, False),
                                 (torch.float32, 0, True)):
        kw = dict(elem_format=fmt, block_size=bs, flush=flush, bfloat=bfloat)
        got = ln_modulate_quantize(x.to(dtype), shift, scale, **kw)
        want = ln_modulate_quantize_ref(x.to(dtype), shift, scale, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), dtype


@pytest.mark.parametrize("bs", _BLOCKS)
@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3"])
def test_k1_k6_at_block_sizes(cuda, bs, fmt):
    """K1 and K6 at the block sizes other than 32, bit for bit, at DiT's
    sites cut to 2 images: the linears' bf16 inputs (1152, 4608 channels)
    and the adaLN's f32 condition for K1, fc2's input for K6 (tanh and
    erf), at DiT's bfloat 16 and PixArt's f32 flush."""
    for shape, dtype in (((2, 64, 1152), torch.bfloat16),
                         ((2, 64, 4608), torch.bfloat16), ((2, 1152),
                                                           torch.float32)):
        x = (3 * _normal(shape, bs)).to(dtype).to(cuda)
        for bfloat, flush in ((16, False), (0, True)):
            kw = dict(flush=flush, bfloat=bfloat)
            got = mx_quantize(x, fmt, bs, 8, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, mx_quantize_ref(x, fmt, bs, 8, **kw))
            if shape[-1] != 4608:
                continue
            for approximate in (True, False):
                kw6 = dict(kw, elem_format=fmt, block_size=bs,
                           approximate=approximate)
                got = gelu_quantize(x, **kw6)
                torch.cuda.synchronize()
                assert torch.equal(got, gelu_quantize_ref(x, **kw6))


_ABLATE = sorted(ablate_common.distinct_variants().items(),
                 key=lambda kv: kv[1][0])


@pytest.mark.parametrize("layout", [0, 1])
@pytest.mark.parametrize("var,modes", _ABLATE,
                         ids=["/".join(m[0]) for _, m in _ABLATE])
def test_k8_matches_plain(cuda, var, modes, layout):
    """K8 (the ablation tools' pass-switched kernel) at every word the four
    tools use, bit for bit against its plain version, at 16 cells of the
    tools' shape, in both operand layouts."""
    var = var._replace(layout=layout)
    q, k_, v = ablate_common.inputs(16, cuda, seed=3, layout=layout)
    got = ablate_common.call(var, q, k_, v)
    torch.cuda.synchronize()
    assert torch.equal(got, ablate_common.call(var, q, k_, v, plain=True))


@pytest.mark.parametrize("tier", ["exact", "serving"])
def test_k8_all_on_words_equal_k3(cuda, tier):
    """The all-on exact and serving words equal the port's K3 kernel at the
    tools' point, bit for bit."""
    q, k_, v = ablate_common.inputs(16, cuda, seed=4)
    word = topk_ablate.EXACT if tier == "exact" else topk_ablate.SERVING
    var = ablate_common.Variant(word, 0, "row8", tier, "")
    got = ablate_common.call(var, q, k_, v)
    launches = fused_topk_attention.launches
    want = ablate_common.prod(tier, q, k_, v)
    torch.cuda.synchronize()
    assert fused_topk_attention.launches == launches + 1
    assert torch.equal(got, want)


def test_k8_counts_launches_and_refuses_outside_its_domain(cuda):
    q, k_, v = ablate_common.inputs(2, cuda)
    before = topk_ablate.ablate_attention.launches
    topk_ablate.ablate_attention(q, k_, v, passes=topk_ablate.SERVING,
                                 k=154, scale=72 ** -0.5)
    assert topk_ablate.ablate_attention.launches == before + 1
    for bad in (dict(k=300), dict(key_form="col16", group=3),
                dict(passes=topk_ablate.SEL)):
        kw = dict(passes=topk_ablate.SERVING, k=154, scale=1.0)
        kw.update(bad)
        with pytest.raises((ValueError, NotImplementedError)):
            topk_ablate.ablate_attention(q, k_, v, **kw)
    wide = torch.zeros(2, 256, 160, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(NotImplementedError):
        topk_ablate.ablate_attention(wide, wide, wide, passes=0, k=154,
                                     scale=1.0)


# K9-K11: the TPU measurement tools' kernels (mx_matmul_ablation,
# kth_bench, lanequant_bench)
_MM_FORMATS = ["int8", "int4", "int2", "fp8_e5m2", "fp8_e4m3", "fp6_e3m2",
               "fp6_e2m3", "fp4", "float16", "bfloat16"]


def _mixed_rows(shape, seed, dtype=torch.float32):
    """Seeded N(0, 1) rows, each scaled by 2^s for s in [-20, 20], with an
    all-zero and an all-subnormal row."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    x *= (2.0 ** rng.randint(-20, 21, size=shape[0])).astype(
        np.float32)[:, None]
    x[0] = 0.0
    x[1] = rng.randn(shape[1]).astype(np.float32) * 1e-39
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("bs", list(_BLOCKS) + [32])
@pytest.mark.parametrize("fmt", _MM_FORMATS)
def test_k9_matches_plain(cuda, fmt, bs):
    """K9 bit for bit against its plain version over every format and
    block, scale bits 8 and 5, M and N off the 64 x 64 tiles, K off the
    128-value chunks, A's rows scaled over 2^+-20 with zero and subnormal
    rows (blocks of scale 0), and the two sides in different formats."""
    from mx_quantization_tpu_torch.ops.kernels.mx_matmul import (
        mx_matmul, mx_matmul_ref)
    K = 5 * max(bs, 32) + bs
    a = _mixed_rows((131, K), bs).to(cuda)
    b = (0.02 * _normal((K, 77), bs + 1)).to(cuda)
    for fb in (fmt, "int8", "bfloat16"):
        for sb in (8, 5):
            got = mx_matmul(a, b, fmt, fb, bs, sb)
            torch.cuda.synchronize()
            assert torch.equal(got, mx_matmul_ref(a, b, fmt, fb, bs, sb)), \
                (fb, sb)


def test_k9_at_the_tool_point(cuda):
    """K9 at DiT-XL/2's fc2 on 256 rows bit for bit, within the summation
    bound of the unfused path, counting its launches; raises outside its
    domain."""
    from mx_quantization_tpu_torch.ops.kernels import mx_matmul as mm
    from mx_quantization_tpu_torch.tools import mx_matmul_ablation as tool
    a, b = tool.inputs(256, 4608, 1152, cuda)
    before = mm.mx_matmul.launches
    got = mm.mx_matmul(a, b)
    assert mm.mx_matmul.launches == before + 1
    assert torch.equal(got, mm.mx_matmul_ref(a, b))
    qa, qb = mm.quantize_operands(a, b)
    assert ((got - tool.unfused(a, qb)).abs() <=
            mm.summation_bound(qa, qb)).all()
    with pytest.raises(TypeError):
        mm.mx_matmul(a.to(torch.bfloat16), b)
    with pytest.raises(ValueError):
        mm.mx_matmul(a, b, block_size=4)


@pytest.mark.parametrize("k", [1, 2, 154, 255, 256])
def test_k10_matches_plain_and_kthvalue(cuda, k):
    """Each strategy bit for bit against its plain version and
    ``torch.kthvalue``, on seeded N(0, 1) cells and on cells of few
    values (ties, negatives, +-0, the ends of the key range)."""
    from mx_quantization_tpu_torch.ops.kernels.kth_select import (
        STRATEGIES, keys_of, kth_select, kth_select_ref)
    rng = np.random.RandomState(k)
    vals = np.array([-3.0e38, -2.0, -1.0, -0.5, -0.0, 0.0, 1.5, 3.0e38],
                    np.float32)
    for x in (_normal((9, 256, 256), k),
              torch.from_numpy(vals[rng.randint(0, 8, (5, 256, 256))])):
        x = x.to(cuda)
        want = torch.kthvalue(keys_of(x), 256 - k + 1, dim=-1).values.to(
            torch.float32)[..., None].expand(x.shape)
        for strategy in STRATEGIES:
            got = kth_select(x, k, strategy)
            torch.cuda.synchronize()
            assert torch.equal(got, kth_select_ref(x, k, strategy)), strategy
            assert torch.equal(got, want), strategy


@pytest.mark.parametrize("bs", list(_BLOCKS) + [32])
@pytest.mark.parametrize("fmt", ["int8", "int4", "int2", "fp8_e4m3",
                                 "fp8_e5m2", "fp6_e3m2", "fp6_e2m3", "fp4"])
def test_k11_matches_plain_and_k1(cuda, fmt, bs):
    """K11 bit for bit against its plain version over every format and
    block, f32 and bf16 in and out, bfloat 0 and 16, flush, scale bits 8
    and 5, rows off any tile, and against K1 at bf16 in and out (each K1
    specialization is a Triton compile); nomax against its plain
    version."""
    from mx_quantization_tpu_torch.ops.kernels.lane_quantize import (
        lane_quantize, lane_quantize_ref)
    base = _mixed_rows((37, 384), bs)
    for din in (torch.float32, torch.bfloat16):
        x = base.to(din).to(cuda)
        for dout in (torch.float32, torch.bfloat16):
            for bfloat in (0, 16):
                for flush in (False, True):
                    for sb in (8, 5):
                        args = (fmt, bs, sb, dout, flush, bfloat)
                        got = lane_quantize(x, *args)
                        torch.cuda.synchronize()
                        assert torch.equal(got, lane_quantize_ref(x, *args))
                        if din == dout == torch.bfloat16 and bfloat == 16 \
                                and not flush and sb == 8:
                            assert torch.equal(got, mx_quantize(x, *args))
        nomax = lane_quantize(x, fmt, bs, nomax=True)
        assert torch.equal(nomax, lane_quantize_ref(x, fmt, bs, nomax=True))
    with pytest.raises(ValueError):
        lane_quantize(x, fmt, 4)
