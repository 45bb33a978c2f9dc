"""The port's fused qkv top-k attention (K2's plain version, and the
``attention.py`` entry) against the JAX package's
``fused_topk_attention_qkv`` in interpret mode.

Tolerance: rtol = atol = 2e-5 at f32 output, the bound the JAX suite holds
its kernel to against its XLA path (tests/test_fused_attention_kernel.py),
for every query row whose attention probabilities match JAX's.  The
probabilities are read through a probe: the same q and k with every head's
v set to the identity, so that query n's output row holds the
probabilities that meet v in the PV product, after the serving tier's bf16
cast or the exact tier's MX requantize.  torch's and XLA's float32 exp, and
the order in which each sums the scores, differ in the last bits on the
CPU; where that puts a probability on the other side of a rounding
boundary, it lands one step of its grid away.  A row where the probe shows
such a flip may differ from JAX's by those steps times max |v|, but no
more: at most two probabilities of the row may differ, each by one grid
step, and at most one row in a hundred may flip.  At bf16 output the
tolerance is one bf16 ulp (the RNE cast of f32 sums taken in other orders).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mx_quantization_tpu import finalize_mx_specs
from mx_quantization_tpu.attention import \
    TopKAttentionConfig as JaxAttnConfig
from mx_quantization_tpu.attention import \
    fused_qkv_topk_attention as jax_qkv_attention
from mx_quantization_tpu.ops.kernels.topk_attention import \
    fused_topk_attention_qkv as jax_kernel

from mx_quantization_tpu_torch.attention import (TopKAttentionConfig,
                                                 fused_qkv_eligible,
                                                 fused_qkv_topk_attention)
from mx_quantization_tpu_torch.ops.kernels.topk_attention import (
    fused_topk_attention_qkv, fused_topk_attention_qkv_ref)
from mx_quantization_tpu_torch.specs import finalize_mx_specs as port_specs

TOL = dict(rtol=2e-5, atol=2e-5)


def _probe(x, H):
    """x with every head's v replaced by the identity (v[n, d] = n == d);
    a one-hot column quantizes to exactly 1 on every MX grid."""
    B, N, F = x.shape
    D = F // (3 * H)
    assert D >= N
    p = x.copy().reshape(B, N, 3, H, D)
    p[:, :, 2] = np.eye(N, D, dtype=x.dtype)[None, :, None, :]
    return p.reshape(B, N, F)


def check_rows(got, want, pg, pw, vmax, mbits=8, contract="exact",
               out_bf16=False):
    """The criterion of the module docstring on (cells, N, D) outputs,
    (cells, N, S) probed probabilities and each cell's max |v| (cells,)."""
    N, S = pg.shape[-2:]
    tol = dict(rtol=2.0 ** -8, atol=2e-5) if out_bf16 else TOL
    flip = (pg != pw).any(-1)  # (cells, N) query rows
    close = np.isclose(got, want, **tol).all(-1)
    assert (close | flip).all(), \
        f"{(~close & ~flip).sum()} rows outside tolerance, same probabilities"
    assert flip.sum() <= flip.size // 100, f"{flip.sum()} rows flip"
    if not flip.any():
        return
    # one grid step: a bf16 ulp (serving); the step of the MX grid of the
    # probability's 32-key block (exact)
    hi = np.maximum(pg, pw)[flip]
    if contract == "serving":
        step = 2.0 ** -7 * hi
    else:
        Sp = -(-S // 32) * 32
        blk = np.pad(hi, ((0, 0), (0, Sp - S))).reshape(len(hi), -1, 32)
        step = np.repeat(blk.max(-1), 32, axis=-1)[:, :S] * 2.0 ** -(mbits - 2)
    dp = np.abs(pg - pw)[flip]
    assert ((dp > 0).sum(-1) <= 2).all()
    assert (dp <= step).all()
    vm = np.repeat(vmax[:, None], N, axis=1)[flip] * (1 + 2.0 ** -(mbits - 2))
    err = np.abs(got - want)[flip].max(-1)
    assert (err <= dp.sum(-1) * vm + 2e-5 + 2.0 ** -8 *
            np.abs(want[flip]).max(-1)).all()


def assert_matches_jax(port, jax_fn, x, H, mbits=8, contract="exact",
                       out_bf16=False):
    """port, jax_fn: (B, N, 3*H*D) float32 array -> (B, N, H*D) float32
    array.  The criterion of the module docstring."""
    B, N, F = x.shape
    D = F // (3 * H)

    def cells(a, width):  # (B, N, H*width) -> (B*H, N, width)
        return np.asarray(a, np.float32).reshape(B, N, H, -1)[..., :width
                                                             ].transpose(
            0, 2, 1, 3).reshape(B * H, N, width)

    got, want = cells(port(x), D), cells(jax_fn(x), D)
    pg, pw = cells(port(_probe(x, H)), N), cells(jax_fn(_probe(x, H)), N)
    v = x.reshape(B, N, 3, H, D)[:, :, 2]  # (B, N, H, D)
    vmax = np.abs(v).max(axis=(1, 3)).reshape(B * H)
    check_rows(got, want, pg, pw, vmax, mbits, contract, out_bf16)


SPECS = dict(w_elem_format="int8", a_elem_format="int8", scale_bits=8,
             block_size=32, bfloat=16, quantize_backprop=False,
             custom_tpu="fused")


def _qkv(B, N, H, D, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(B, N, 3 * H * D).astype(np.float32)


@pytest.mark.parametrize("D", [72, 64])
@pytest.mark.parametrize("N", [40, 64])
@pytest.mark.parametrize("k", [9, None])
@pytest.mark.parametrize("key_bits", [8, 32])
@pytest.mark.parametrize("contract", ["exact", "serving"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel(D, N, k, key_bits, contract, dtype):
    B, H = 2, 2
    k = N if k is None else k
    x = _qkv(B, N, H, D, seed=D + N + k)
    kw = dict(k=k, scale=D ** -0.5, key_bits=key_bits, bfloat=16,
              contract=contract)
    assert fused_topk_attention_qkv_ref(
        torch.from_numpy(x), H, **kw).dtype == torch.float32
    assert_matches_jax(
        lambda a: fused_topk_attention_qkv_ref(
            torch.from_numpy(a).to(getattr(torch, dtype)), H, **kw),
        lambda a: jax_kernel(jnp.asarray(a).astype(dtype), H, **kw),
        x, H, contract=contract)


@pytest.mark.parametrize("top_k", [True, False])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_attention_entry_matches_jax(top_k, out_dtype):
    """Through attention.py, incl. the k = N normalization of an excluded
    block (top_k=False) and the bf16 output."""
    B, N, H, D = 2, 32, 2, 72
    x = _qkv(B, N, H, D, seed=5)
    cfg = dict(mx_quant=True, top_k=top_k, k=7, approx_flag=top_k,
               key_bits=8, out_dtype=out_dtype)

    def port(a):
        return fused_qkv_topk_attention(torch.from_numpy(a), H, D ** -0.5,
                                        port_specs(SPECS),
                                        TopKAttentionConfig(**cfg))

    def jax_fn(a):
        return jax_qkv_attention(jnp.asarray(a), H, D ** -0.5,
                                 finalize_mx_specs(SPECS),
                                 JaxAttnConfig(**cfg)).astype(jnp.float32)

    assert str(port(x).dtype) == f"torch.{out_dtype}"
    assert_matches_jax(lambda a: port(a).float(), jax_fn, x, H,
                       out_bf16=out_dtype == "bfloat16")


def test_mxfp_format_matches_jax():
    B, N, H, D = 2, 40, 2, 72
    x = _qkv(B, N, H, D, seed=6)
    kw = dict(k=9, scale=D ** -0.5, key_bits=8, bfloat=16, ebits=4, mbits=5,
              emax=8, max_norm=448.0)
    assert_matches_jax(
        lambda a: fused_topk_attention_qkv_ref(torch.from_numpy(a), H, **kw),
        lambda a: jax_kernel(jnp.asarray(a), H, **kw), x, H, mbits=5)


def test_eligibility():
    specs = port_specs(SPECS)
    cfg = TopKAttentionConfig(k=8)
    assert fused_qkv_eligible(specs, cfg, 256)
    assert fused_qkv_eligible(specs, cfg, 512)
    assert not fused_qkv_eligible(specs, cfg, 513)
    assert not fused_qkv_eligible(None, cfg, 64)
    assert fused_qkv_eligible(specs, cfg._replace(pred_mode="MXINT4"), 64)
    assert not fused_qkv_eligible(specs, cfg._replace(pred_mode="ELSA"), 64)
    assert fused_qkv_eligible(
        specs, cfg._replace(pred_mode="ELSA", approx_flag=False), 64)
    assert not fused_qkv_eligible(specs.replace(custom_tpu="ref"), cfg, 64)


def test_wrapper_uses_plain_only_on_cpu():
    x = torch.from_numpy(_qkv(1, 32, 2, 64, seed=7))
    before = fused_topk_attention_qkv.launches
    out = fused_topk_attention_qkv(x, 2, k=5, scale=0.125)
    assert fused_topk_attention_qkv.launches == before  # nothing launched
    assert torch.equal(out, fused_topk_attention_qkv_ref(x, 2, k=5,
                                                         scale=0.125))
    with pytest.raises(ValueError):
        fused_topk_attention_qkv(torch.empty(1, 32, 384, device="meta"), 2,
                                 k=5, scale=0.125)
    with pytest.raises(NotImplementedError):  # ELSA is the split entry's
        fused_topk_attention_qkv(x, 2, k=5, scale=0.125, pred_mode="ELSA")
    assert torch.equal(
        fused_topk_attention_qkv(x, 2, k=5, scale=0.125, pred_mode="MXINT4"),
        fused_topk_attention_qkv_ref(x, 2, k=5, scale=0.125,
                                     pred_mode="MXINT4"))
    assert fused_topk_attention_qkv.launches == before
