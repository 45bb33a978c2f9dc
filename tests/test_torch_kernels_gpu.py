"""The port's hand-written kernels against their plain PyTorch versions on
the card (K1: MX quantize, Triton; K2: fused qkv top-k attention, CUDA).

Marked ``gpu``; each test skips where no CUDA device exists.  On a machine
with one:  python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q
"""

import numpy as np
import pytest
import torch

from mx_quantization_tpu_torch.formats import format_params
from mx_quantization_tpu_torch.models.dit import (DiTConfig, DiTQuantConfig,
                                                  init_dit)
from mx_quantization_tpu_torch.ops.kernels.quantize import (mx_quantize,
                                                            mx_quantize_ref)
from mx_quantization_tpu_torch.ops.kernels.topk_attention import (
    fused_topk_attention_qkv, fused_topk_attention_qkv_ref)
from mx_quantization_tpu_torch.ops.linear import mm_f32
from mx_quantization_tpu_torch.workloads.dit import dit_mx_specs, sample_dit

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
    # same arithmetic in the same order; the tolerance only covers a
    # difference between expf builds
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-5,
                               atol=2e-5)


def test_k2_mxfp_format(cuda):
    B, N, H, D = 2, 64, 2, 72
    ebits, mbits, emax, max_norm, _ = format_params("fp8_e4m3")
    x = _normal((B, N, 3 * H * D), 3).to(cuda)
    kw = dict(k=9, scale=D ** -0.5, key_bits=8, bfloat=16, ebits=ebits,
              mbits=mbits, emax=emax, max_norm=max_norm)
    got = fused_topk_attention_qkv(x, H, **kw)
    want = fused_topk_attention_qkv_ref(x, H, **kw)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_k2_counts_launches(cuda):
    x = _normal((1, 64, 3 * 2 * 64), 4).to(cuda)
    before = fused_topk_attention_qkv.launches
    fused_topk_attention_qkv(x, 2, k=8, scale=0.125)
    assert fused_topk_attention_qkv.launches == before + 1


def test_bf16_product_has_f32_output(cuda):
    a = _normal((64, 96), 5, torch.bfloat16)
    b = _normal((48, 96), 6, torch.bfloat16)
    got = mm_f32(a.to(cuda), b.to(cuda))
    assert got.dtype == torch.float32
    # bf16 products are exact in f32; only the summation order differs
    torch.testing.assert_close(got.cpu(), mm_f32(a, b), rtol=1e-5,
                               atol=1e-5)


def test_tiny_sampling_on_card_matches_cpu(cuda):
    """The whole slice at a tiny size: kernels on the card against the
    plain versions on the CPU, same weights and noise."""
    cfg = DiTConfig(input_size=8, hidden_size=64, depth=2, num_heads=2,
                    num_classes=10)
    qcfg = DiTQuantConfig(mx_specs=dit_mx_specs(), mx_quant=True,
                          top_k=True, k=6, exclude_blocks=(1,),
                          topk_key_bits=8)
    z = _normal((2, 4, 8, 8), 7)
    noise = [_normal((4, 4, 8, 8), 8 + i) for i in range(3)]
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
