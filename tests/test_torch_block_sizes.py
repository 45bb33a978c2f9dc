"""The port's kernels' plain versions at the MX block sizes other than 32
against the JAX package's Pallas kernels in interpret mode: K2 (both
tiers), K7, K3 with a key bias, K4 on its tiled path, K5, and the
``topk_attention`` entry, each at block sizes 8, 16, 64 and 128 (the DiT
forward at block 16 is tests/test_torch_dit.py's); and the block sizes that
neither side takes (24 and 48, which do not divide the TPU kernels' token
padding of 128) raising on both sides.

Each case varies what the block-32 tests cover (predictor, format, tier)
across the block sizes, so that the four sizes together cross them.  The
bounds are the block-32 tests': tests/test_torch_attention.py's
``check_rows`` (every query row within 2e-5, except at most 1% of rows,
each with at most two probabilities one grid step apart, the exact tier's
step that of the probability's MX block of bs keys) for the attention
kernels, and ``_assert_grid_tie_parity`` (at most 0.1% of the elements one
grid step apart) for K5, as tests/test_torch_fused_quant.py holds them at
block 32.  Torch runs on one thread, at small shapes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mx_quantization_tpu import finalize_mx_specs
from mx_quantization_tpu.attention import \
    TopKAttentionConfig as JaxAttnConfig
from mx_quantization_tpu.attention import topk_attention as jax_topk
from mx_quantization_tpu.ops.kernels.quantize import \
    ln_modulate_quantize_pallas
from mx_quantization_tpu.ops.kernels.topk_attention import (
    fused_topk_attention, fused_topk_attention_qkv,
    fused_topk_attention_qkv_t)

from mx_quantization_tpu_torch.attention import (TopKAttentionConfig,
                                                 topk_attention)
from mx_quantization_tpu_torch.formats import format_params
from mx_quantization_tpu_torch.ops.kernels import topk_attention as ta
from mx_quantization_tpu_torch.ops.kernels.ln_modulate_quantize import \
    ln_modulate_quantize_ref
from mx_quantization_tpu_torch.specs import finalize_mx_specs as port_specs
from test_gelu_fusion import _assert_grid_tie_parity
from test_torch_attention import assert_matches_jax
from test_torch_attention_split import (PIXART, assert_split_matches_jax,
                                        split_inputs)
from test_torch_attention_tiled import assert_long_matches_jax
from test_torch_dit512 import _one_torch_thread  # noqa: F401
from test_torch_qkv_split_t import assert_k7_matches_jax, split_t_operands

BLOCKS = (8, 16, 64, 128)
D = 72
# what each block size runs beside the block: K2's predictor, K3's and
# K4's predictor and format
K2_MODES = dict(zip(BLOCKS, ("ex_pred", "two_step_leading_ones", "MXINT4",
                             "threshold_ex")))
SPLIT_CASES = dict(zip(BLOCKS, (("two_step_leading_ones", "int8"),
                                ("ex_pred", "fp8_e4m3"),
                                ("partial_K", "int8"),
                                ("true_ex", "int4"))))


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _fmt_kw(fmt):
    ebits, mbits, emax, max_norm, _ = format_params(fmt)
    return dict(ebits=ebits, mbits=mbits, emax=emax, max_norm=max_norm)


@pytest.mark.parametrize("contract", ["exact", "serving"])
@pytest.mark.parametrize("bs", BLOCKS)
def test_k2_plain_matches_jax(bs, contract):
    """DiT's kind of call (bfloat 16, key_bits 8), N = 64 of D = 72."""
    H = 2
    x = np.random.RandomState(bs).randn(1, 64, 3 * H * D).astype(np.float32)
    kw = dict(k=13, scale=D ** -0.5, key_bits=8, bfloat=16,
              contract=contract, block_size=bs, pred_mode=K2_MODES[bs])
    assert_matches_jax(
        lambda a: ta.fused_topk_attention_qkv_ref(torch.from_numpy(a), H,
                                                  **kw),
        lambda a: fused_topk_attention_qkv(jnp.asarray(a), H, **kw), x, H,
        contract=contract, block_size=bs)


@pytest.mark.parametrize("bs", BLOCKS)
def test_k7_plain_matches_jax(bs):
    """N = 128 (K7's lane alignment), the head padded to the block as
    DiT's split-emission projection pads it, the tiers alternating."""
    H, N = 2, 128
    contract = "exact" if bs in (8, 64) else "serving"
    qkv = np.random.RandomState(100 + bs).randn(1, N, 3 * H * D).astype(
        np.float32)
    qk_t, v = split_t_operands(qkv, H, -(-D // bs) * bs)
    kw = dict(k=20, scale=D ** -0.5, n_valid=N, key_bits=8, bfloat=16,
              contract=contract, block_size=bs)
    assert_k7_matches_jax(
        lambda a, b: ta.fused_topk_attention_qkv_t_ref(
            torch.from_numpy(a), torch.from_numpy(b), H, **kw),
        lambda a, b: fused_topk_attention_qkv_t(jnp.asarray(a),
                                                jnp.asarray(b), H, **kw),
        qk_t, v, H, contract, block_size=bs)


@pytest.mark.parametrize("bs", BLOCKS)
def test_k3_plain_with_bias_matches_jax(bs):
    """PixArt's cross-attention kind of call: 64 queries against 40 keys
    with a caption-mask bias, f32, flush; a predictor and a format per
    block size."""
    mode, fmt = SPLIT_CASES[bs]
    contract = "serving" if bs in (8, 64) else "exact"
    q, k, v, bias = split_inputs(40, 200 + bs, True)
    kw = dict(k=9, scale=D ** -0.5, key_bits=32, flush=True,
              contract=contract, block_size=bs, pred_mode=mode,
              **_fmt_kw(fmt))
    assert_split_matches_jax(
        lambda *a: ta.fused_topk_attention_ref(*map(_t, a), **kw),
        lambda *a: fused_topk_attention(*map(_j, a), **kw), q, k, v, bias,
        mbits=kw["mbits"], contract=contract, block_size=bs)


@pytest.mark.parametrize("bs", BLOCKS)
def test_k4_plain_tiled_matches_jax(bs):
    """64 queries against 520 keys: JAX's query-tiled path (keys past
    512), the port's K4 plain version."""
    mode, fmt = SPLIT_CASES[bs]
    contract = "exact" if bs in (8, 64) else "serving"
    q, k, v, _ = split_inputs(520, 300 + bs, False, n=64, b=1)
    kw = dict(k=77, scale=D ** -0.5, key_bits=8, flush=True,
              contract=contract, block_size=bs, pred_mode=mode,
              **_fmt_kw(fmt))
    assert_long_matches_jax(
        lambda *a: ta.fused_topk_attention_ref(*map(_t, a), **kw),
        lambda *a: fused_topk_attention(*map(_j, a), **kw), q, k, v, None,
        mbits=kw["mbits"], contract=contract, block_size=bs)


@pytest.mark.parametrize("bs", BLOCKS)
def test_k5_plain_matches_jax(bs):
    """C = 384, a multiple of every block, N = 50 rows; bf16 in and the
    bf16 round at two block sizes, f32 and flush at the others."""
    rng = np.random.RandomState(bs)
    x = (3 * rng.randn(2, 50, 384) + 0.5).astype(np.float32)
    shift, scale = (0.3 * rng.randn(2, 2, 384)).astype(np.float32)
    bf16 = bs in (16, 128)
    dtype = "bfloat16" if bf16 else "float32"
    kw = dict(elem_format="int8" if bs < 64 else "fp8_e4m3", block_size=bs,
              scale_bits=8, flush=not bf16, bfloat=16 if bf16 else 0)
    want = ln_modulate_quantize_pallas(jnp.asarray(x).astype(dtype),
                                       jnp.asarray(shift),
                                       jnp.asarray(scale), **kw)
    got = ln_modulate_quantize_ref(
        torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(shift),
        torch.from_numpy(scale), **kw)
    assert got.shape == x.shape
    _assert_grid_tie_parity(want, got.float().numpy())


@pytest.mark.parametrize("bs", BLOCKS)
def test_topk_attention_entry_matches_jax(bs):
    """``topk_attention`` at PixArt's specs with the block size changed:
    self-attention top-k (two_step) at 8, the dense excluded-block call at
    16, 64 and 128 (JAX's interpret-mode selection takes ~8 s a call)."""
    specs = dict(PIXART, block_size=bs)
    top_k = bs == 8
    cfg = dict(mx_quant=True, top_k=top_k, k=9, approx_flag=top_k,
               pred_mode="two_step_leading_ones", key_bits=32)
    q, k, v, _ = split_inputs(64, 400 + bs, False)

    def port(*a):
        return topk_attention(*map(_t, a[:3]), D ** -0.5, port_specs(specs),
                              TopKAttentionConfig(**cfg))[0].float()

    def jax_fn(*a):
        return jax_topk(*map(_j, a[:3]), D ** -0.5, finalize_mx_specs(specs),
                        JaxAttnConfig(**cfg))[0].astype(jnp.float32)

    assert_split_matches_jax(port, jax_fn, q, k, v, None, block_size=bs)


def test_blocks_outside_the_domain_raise():
    """24 and 48 do not divide 128: JAX's kernels fail in their reshape, the
    port's raise a ValueError naming the limit, on the plain versions as
    on the kernels' checks.  1, 2 and 4 JAX runs; the port raises
    NotImplementedError naming ROADMAP.md."""
    H = 2
    x = np.random.RandomState(0).randn(1, 64, 3 * H * D).astype(np.float32)
    q = x.reshape(1, 64, 3, H, D)[:, :, 0].transpose(0, 2, 1, 3).copy()
    for bs in (24, 48):
        kw = dict(k=20, scale=0.1, key_bits=8, bfloat=16, block_size=bs)
        with pytest.raises(TypeError, match="reshape"):
            fused_topk_attention_qkv(jnp.asarray(x), H, **kw)
        with pytest.raises(TypeError, match="reshape"):
            fused_topk_attention(*(jnp.asarray(q),) * 3, **kw)
        with pytest.raises(ValueError, match="divide 128"):
            ta.fused_topk_attention_qkv_ref(torch.from_numpy(x), H, **kw)
        with pytest.raises(ValueError, match="divide 128"):
            ta.fused_topk_attention_ref(*(torch.from_numpy(q),) * 3, **kw)
    for bs in (1, 2, 4):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ta.fused_topk_attention_qkv_ref(torch.from_numpy(x), H, k=20,
                                            scale=0.1, block_size=bs)
    x5 = torch.ones(1, 2, 96)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ln_modulate_quantize_ref(x5, x5[:, 0], x5[:, 0], block_size=4)
    with pytest.raises(ValueError, match="multiple"):
        ln_modulate_quantize_ref(x5, x5[:, 0], x5[:, 0], block_size=64)


def test_k4_key_limit_message_names_the_xla_path():
    """Past K4's 4096 keys ``topk_attention`` takes the XLA path (the
    emulation engine among its routes); the kernel's raise says so."""
    ta.check_split_shape("K4", ta.MAX_TILED_KEYS, D)
    with pytest.raises(NotImplementedError) as err:
        ta.check_split_shape("K4", ta.MAX_TILED_KEYS + 1, D)
    msg = str(err.value)
    assert "XLA path" in msg and "custom_tpu='ref'" in msg
    assert "not done" not in msg
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ta.check_split_shape("K3", 64, ta.MAX_HEAD_DIM + 8)
