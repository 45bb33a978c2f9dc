"""The DiT-XL/2 512^2 path of the port (N = 1024 tokens: every block's
attention takes the split entry and, on the card, kernel K4) against the
JAX package, on a tiny DiT: hidden 64, depth 2, 2 heads of 32, latent 64
(32 x 32 patches), random parameters (numpy, seeded) carried over by
``dit_params_from_jax``.

As in tests/test_torch_dit.py, whole forwards are not compared end to end
(one moved MX grid point spreads over the image); the forward is checked
stage by stage on the port's own inputs, with every MX activation quantize
and attention call the port made handed to JAX:
  * each quantize: JAX's input within ``_check`` of the port's, and JAX's
    quantizer on the port's input bit-equal to the port's output;
  * each attention call: JAX's q, k, v within ``_check`` of the port's, and
    the port's attention on its q, k, v held to JAX's ``fused_topk_attention``
    (its query-tiled kernel in interpret mode) on the same inputs under
    tests/test_torch_attention_tiled.py's criterion;
  * each block step, the embedding and the final layer held to JAX's on
    the port's input under ``_check``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mx_quantization_tpu.attention as jax_attention
import mx_quantization_tpu.models.dit as jax_dit
from mx_quantization_tpu.attention import \
    TopKAttentionConfig as JaxAttnConfig
from mx_quantization_tpu.models.dit import DiTConfig as JaxDiTConfig
from mx_quantization_tpu.models.dit import DiTQuantConfig as JaxQuantConfig
from mx_quantization_tpu.models.dit import _dit_block_step as jax_block_step
from mx_quantization_tpu.models.dit import init_dit as jax_init_dit
from mx_quantization_tpu.models.stacked import unstack_block
from mx_quantization_tpu.ops.fastquant import \
    quantize_mx_serving as jax_quantize
from mx_quantization_tpu.ops.kernels.topk_attention import \
    fused_topk_attention as jax_kernel
from mx_quantization_tpu.workloads.dit import dit_mx_specs as jax_specs

import mx_quantization_tpu_torch.models.dit as port_dit
from mx_quantization_tpu_torch.models.dit import (DiTConfig, DiTQuantConfig,
                                                  dit_forward, init_dit)
from mx_quantization_tpu_torch.utils.checkpoint import dit_params_from_jax
from mx_quantization_tpu_torch.workloads.dit import dit_mx_specs, sample_dit
from test_torch_attention_tiled import assert_long_matches_jax
from test_torch_dit import (JAX_LINEAR, PORT_LINEAR, _check, _jax_embed,
                            _jax_final_layer, _np)

CFG_KW = dict(input_size=64, patch_size=2, in_channels=4, hidden_size=64,
              depth=2, num_heads=2, num_classes=10)
QKW = dict(mx_quant=True, top_k=True, k=154, ex_pred=True,
           exclude_blocks=(1,), topk_key_bits=8)
N_TOKENS = (64 // 2) ** 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions here work on score tensors large enough that torch
    spreads each elementwise op over every core; the test suite runs several
    processes side by side, where such spread ops only contend with each
    other.  One torch thread keeps this module's cost to its own work."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    jcfg = JaxDiTConfig(**CFG_KW)
    tree = jax_init_dit(jax.random.key(0), jcfg)
    rng = np.random.RandomState(0)
    tree = jax.tree.map(
        lambda a: (0.05 * rng.randn(*a.shape)).astype(np.float32), tree)
    model = dit_params_from_jax(tree, DiTConfig(**CFG_KW), device="cpu")
    return jcfg, jax.tree.map(jnp.asarray, tree), model


def record(monkeypatch, names=("dit_embed", "dit_block_step",
                               "dit_final_layer", "topk_attention",
                               "fused_qkv_topk_attention",
                               "fused_topk_attention_qkv_t")):
    """Record, in the order they return, the port's DiT stages, attention
    entries and MX activation quantizes as (name, args, kwargs, output)."""
    calls = []

    def wrap(module, name):
        def wrapped(*args, _real=getattr(module, name), **kwargs):
            out = _real(*args, **kwargs)
            calls.append((name, args, kwargs, out))
            return out
        monkeypatch.setattr(module, name, wrapped)

    for name in names:
        wrap(port_dit, name)
    wrap(PORT_LINEAR, "quantize_mx_serving")
    return calls


def _kernel_kw(specs, cfg, S, scale):
    """JAX's ``fused_topk_attention`` keywords for a topk_attention call
    (``attention._fused_topk_attention_ad``'s, with a dense config at
    k = S as its dispatch makes it), at f32 output."""
    if not cfg.top_k:
        cfg = cfg._replace(top_k=True, approx_flag=False, k=S)
    return dict(k=cfg.k, scale=scale, block_size=specs.block_size,
                scale_bits=specs.effective_scale_bits(),
                approx=cfg.approx_flag, pred_mode=cfg.pred_mode,
                key_bits=cfg.key_bits, out_dtype=jnp.float32,
                contract=cfg.contract,
                **jax_attention._kernel_elemwise_args(specs),
                **jax_attention._kernel_format_args(specs))


def check_stages(monkeypatch, calls, model, jparams, jcfg, jq):
    """Hold each recorded stage to JAX's on its input, JAX's quantizes and
    attention calls answered by the port's (module docstring)."""
    pending = []

    def take(name):
        assert pending and pending[0][0] == name, \
            f"JAX calls {name} where the port did not"
        return pending.pop(0)

    def quantize(x, *args, **kwargs):
        _, (xp, *_), _, out = take("quantize_mx_serving")
        _check(_np(xp), x)
        real = jax_quantize(jnp.asarray(_np(xp)).astype(x.dtype), *args,
                            **kwargs)
        np.testing.assert_array_equal(_np(out), np.asarray(real, np.float32))
        return jnp.asarray(_np(out)).astype(real.dtype)

    def attention(q, k, v, scale, specs, cfg, orthogonal_matrix=None,
                  bias=None):
        _, (qp, kp, vp, pscale, pspecs, pcfg), _, out = take(
            "topk_attention")
        for got, want in ((qp, q), (kp, k), (vp, v)):
            _check(_np(got), want)
        assert pscale == scale and bias is None
        kw = _kernel_kw(specs, cfg, k.shape[-2], scale)
        assert_long_matches_jax(
            lambda *a: port_dit.topk_attention(
                *map(torch.from_numpy, a[:3]), pscale, pspecs, pcfg)[0],
            lambda *a: jax_kernel(*map(jnp.asarray, a[:3]), **kw),
            _np(qp), _np(kp), _np(vp), None, contract=pcfg.contract)
        return jnp.asarray(_np(out[0])).astype(cfg.out_dtype), None

    monkeypatch.setattr(JAX_LINEAR, "quantize_mx_serving", quantize)
    monkeypatch.setattr(jax_dit, "topk_attention", attention)
    stages = 0
    for name, args, kw, out in calls:
        if name in ("quantize_mx_serving", "topk_attention"):
            pending.append((name, args, kw, out))
            continue
        stages += 1
        if name == "dit_embed":
            _, x, t, y, _ = args
            h, c = _jax_embed(jparams, jnp.asarray(_np(x)),
                              jnp.asarray(_np(t)),
                              jnp.asarray(y.numpy().astype(np.int32)),
                              jcfg, jnp.float32)
            _check(_np(out[0]), h)
            _check(_np(out[1]), c)
        elif name == "dit_block_step":
            blk, attn_cfg, x, cb = args
            i = list(model.blocks).index(blk)
            want = jax_block_step(
                unstack_block(jparams["blocks"], i),
                JaxAttnConfig(**attn_cfg._asdict()), jnp.asarray(_np(x)),
                jnp.asarray(_np(cb)), cfg=jcfg, specs=jq.mx_specs,
                act_dtype=jnp.float32)
            _check(_np(out), want)
        elif name == "dit_final_layer":
            _, h, c, _ = args
            want = _jax_final_layer(jparams, jnp.asarray(_np(h)),
                                    jnp.asarray(_np(c)), jcfg, jq.mx_specs)
            _check(_np(out), want)
        else:
            raise AssertionError(f"the port called {name} at N = 1024")
        assert not pending, f"the port called {pending[0][0]}; JAX did not"
    monkeypatch.undo()
    assert stages == jcfg.depth + 2


# One tier each for the stage-by-stage forward and the CPU sampler: the
# serving tier's attention is held to JAX's tiled kernel in
# tests/test_torch_attention_tiled.py, and both tiers' sampling on the card
# to this CPU path in tests/test_torch_kernels_gpu.py.
@pytest.mark.parametrize("contract", ["exact"])
def test_forward_matches_jax_stage_by_stage(models, contract, monkeypatch):
    jcfg, jparams, model = models
    rng = np.random.RandomState(1)
    x = rng.randn(1, 4, 64, 64).astype(np.float32)
    t = np.array([137.0], np.float32)  # < 300: see tests/test_torch_dit.py
    y = torch.tensor([3])
    calls = record(monkeypatch)
    got = dit_forward(model, torch.from_numpy(x), torch.from_numpy(t), y,
                      DiTQuantConfig(mx_specs=dit_mx_specs(),
                                     contract=contract, **QKW))
    monkeypatch.undo()
    assert got.shape == (1, 8, 64, 64) and torch.isfinite(got).all()
    attn = [c for c in calls if c[0] == "topk_attention"]
    assert len(attn) == jcfg.depth
    assert attn[0][1][5].top_k and not attn[1][1][5].top_k  # block 1 dense
    assert all(c[1][0].shape == (1, 2, N_TOKENS, 32) for c in attn)
    check_stages(monkeypatch, calls, model, jparams, jcfg,
                 JaxQuantConfig(mx_specs=jax_specs(), contract=contract,
                                **QKW))


@pytest.mark.parametrize("qkv_layout", ["fused", "split_t"])
def test_long_sequences_take_the_split_entry(models, qkv_layout,
                                             monkeypatch):
    """N = 1024 > 512: neither the fused qkv entry (K2) nor, with
    ``qkv_layout="split_t"``, the split-emission entry (K7) applies, as in
    JAX; every block goes through ``topk_attention``."""
    _, _, model = models
    rng = np.random.RandomState(2)
    calls = record(monkeypatch, ("topk_attention", "fused_qkv_topk_attention",
                                 "fused_topk_attention_qkv_t"))
    qcfg = DiTQuantConfig(mx_specs=dit_mx_specs(), qkv_layout=qkv_layout,
                          contract="serving", **QKW)
    dit_forward(model, torch.from_numpy(rng.randn(1, 4, 64, 64).astype(
        np.float32)), torch.tensor([10.0]), torch.tensor([1]), qcfg)
    names = [c[0] for c in calls if c[0] != "quantize_mx_serving"]
    assert names == ["topk_attention"] * model.cfg.depth


def test_params_carry_over_at_512(models):
    """``dit_params_from_jax`` takes any input_size: the 1024-token
    positional embedding and every weight arrive unchanged."""
    _, jparams, model = models
    sd = model.state_dict()
    assert model.cfg.num_patches == N_TOKENS
    np.testing.assert_array_equal(
        sd["pos_embed"].reshape(-1, 64).numpy(),
        np.asarray(jparams["pos_embed"]).reshape(-1, 64))
    np.testing.assert_array_equal(
        sd["blocks.0.attn.qkv.weight"].numpy(),
        np.asarray(jparams["blocks"]["attn"]["qkv"]["weight"][0]))


@pytest.mark.parametrize("contract", ["serving"])
def test_sample_dit_two_steps_on_cpu(contract):
    cfg = DiTConfig(**CFG_KW)
    model = init_dit(cfg, torch.Generator().manual_seed(0), "cpu",
                     randomize_all=True)
    qcfg = DiTQuantConfig(mx_specs=dit_mx_specs(), contract=contract, **QKW)
    lat = sample_dit(model, qcfg, [3], torch.Generator().manual_seed(1),
                     num_steps=2, device="cpu")
    assert lat.shape == (1, 4, 64, 64) and torch.isfinite(lat).all()
