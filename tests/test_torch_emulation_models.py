"""The models on the emulation path against the JAX package: DeiT on the
ref engine and with ``sparse_impl="gather"``, and one DiT and one PixArt
block on the ref engine, at tiny sizes with every parameter drawn at random
(numpy, seeded) and carried over by the checkpoint converters (the CLIs:
tests/test_torch_emulation_cli.py).

As in tests/test_torch_vit.py, whole forwards are not compared end to end:
an ulp of an f32 sum that meets an MX rounding boundary moves one grid
point, and the next linear spreads it.  The forward is checked stage by
stage on the port's own inputs (tests/test_torch_dit.py's ``_check``),
with every quantized linear and attention call the port made handed to
JAX, each checked first:
  * each linear: JAX's input within ``_check`` of the port's, and JAX's
    linear on the port's input held to the port's output
    (tests/test_torch_emulation_linear.py's bound for the specs' bfloat);
  * each attention call: JAX's q, k, v within ``_check`` of the port's, and
    JAX's ``topk_attention`` on the port's q, k, v giving the same selected
    indices and the same outputs on at least 99% of the query rows
    (tests/test_torch_emulation_attention.py).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mx_quantization_tpu.models.dit as jax_dit
import mx_quantization_tpu.models.pixart as jax_pixart
import mx_quantization_tpu.models.vit as jax_vit
import mx_quantization_tpu.workloads.deit as jax_deit_cli
import mx_quantization_tpu.workloads.dit as jax_dit_cli
import mx_quantization_tpu.workloads.pixart as jax_pixart_cli
from mx_quantization_tpu.attention import \
    TopKAttentionConfig as JaxAttnConfig
from mx_quantization_tpu.attention import topk_attention as jax_topk
from mx_quantization_tpu.models.dit import DiTConfig as JaxDiTConfig
from mx_quantization_tpu.models.dit import init_dit as jax_init_dit
from mx_quantization_tpu.models.pixart import PixArtConfig as JaxPixConfig
from mx_quantization_tpu.models.pixart import init_pixart as jax_init_pixart
from mx_quantization_tpu.models.stacked import unstack_block
from mx_quantization_tpu.models.vit import VitConfig as JaxVitConfig
from mx_quantization_tpu.models.vit import VitQuantConfig as JaxQuantConfig
from mx_quantization_tpu.models.vit import init_vit as jax_init_vit
from mx_quantization_tpu.ops.linear import linear as jax_linear

import mx_quantization_tpu_torch.models.dit as port_dit
import mx_quantization_tpu_torch.models.pixart as port_pixart
import mx_quantization_tpu_torch.models.vit as port_vit
from mx_quantization_tpu_torch.attention import TopKAttentionConfig
from mx_quantization_tpu_torch.models.dit import DiTConfig, dit_block_step
from mx_quantization_tpu_torch.models.pixart import (PixArtConfig,
                                                     PixArtQuantConfig,
                                                     pixart_block_apply)
from mx_quantization_tpu_torch.models.vit import (VitConfig, VitQuantConfig,
                                                  vit_forward)
from mx_quantization_tpu_torch.ops.kernels.quantize import mx_quantize
from mx_quantization_tpu_torch.ops.kernels.topk_attention import (
    fused_topk_attention, fused_topk_attention_qkv)
from mx_quantization_tpu_torch.utils.checkpoint import (dit_params_from_jax,
                                                        pixart_params_from_jax,
                                                        vit_params_from_jax)
from mx_quantization_tpu_torch.workloads.deit import default_mx_specs
from mx_quantization_tpu_torch.workloads.dit import dit_mx_specs
from mx_quantization_tpu_torch.workloads.pixart import pixart_mx_specs
from test_torch_dit import _check, _np
from test_torch_emulation_linear import assert_matches_jax
from test_torch_emulation_quant import _one_torch_thread  # noqa: F401

PORT_LINEAR = importlib.import_module("mx_quantization_tpu_torch.ops.linear")
VIT_KW = dict(img_size=32, patch_size=8, in_chans=3, num_classes=10,
              embed_dim=128, depth=2, num_heads=2)
KERNELS = (mx_quantize, fused_topk_attention, fused_topk_attention_qkv)


def _random_tree(tree, seed):
    rng = np.random.RandomState(seed)

    def draw(path, a):
        name = jax.tree_util.keystr(path)
        if "norm" in name and "weight" in name:
            return (1 + 0.1 * rng.randn(*a.shape)).astype(np.float32)
        return (0.05 * rng.randn(*a.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, tree)


def record(monkeypatch, modules):
    """Record the quantized linear and attention calls the port makes
    through ``modules``, as (name, args, kwargs, output)."""
    calls = []

    def wrap(module, name):
        def wrapped(*args, _real=getattr(module, name), **kwargs):
            out = _real(*args, **kwargs)
            if name != "linear" or kwargs.get("mx_specs") is not None:
                calls.append((name, args, kwargs, out))
            return out
        monkeypatch.setattr(module, name, wrapped)

    for m in modules:
        for name in ("linear", "topk_attention"):
            if hasattr(m, name):
                wrap(m, name)
    wrap(PORT_LINEAR, "linear")
    return calls


# JAX's ops compiled whole per static config: eager dispatch would compile
# each of their primitives anew for every shape, at minutes per model
_jax_linear = jax.jit(jax_linear, static_argnames=("mx_specs",))
_jax_topk = jax.jit(jax_topk, static_argnums=(3, 4, 5))


def answer(monkeypatch, modules, pending, elem):
    """Make JAX's quantized linears and attention calls in ``modules`` take
    the port's recorded answers, each checked first."""
    def take(name):
        assert pending and pending[0][0] == name, \
            f"JAX calls {name} where the port called " \
            f"{pending[0][0] if pending else 'nothing'}"
        return pending.pop(0)

    def linear(x, w, b=None, mx_specs=None):
        if mx_specs is None:
            return jax_linear(x, w, b)
        _, (xp, *_), _, out = take("linear")
        _check(_np(xp), x)
        assert_matches_jax(out, _jax_linear(
            jnp.asarray(_np(xp)).astype(x.dtype), w, b, mx_specs=mx_specs),
            elem)
        return jnp.asarray(_np(out))

    def attention(q, k, v, scale, specs, cfg, orthogonal_matrix=None,
                  bias=None):
        _, (qp, kp, vp, _, pspecs, pcfg), pkw, (out, idx) = take(
            "topk_attention")
        for a, b in ((qp, q), (kp, k), (vp, v)):
            _check(_np(a), b)
        pb = pkw.get("bias")
        jout, jidx = _jax_topk(
            *(jnp.asarray(_np(t)) for t in (qp, kp, vp)), scale, specs, cfg,
            orthogonal_matrix=orthogonal_matrix,
            bias=None if pb is None else jnp.asarray(_np(pb)))
        assert (idx is None) == (jidx is None)
        if idx is not None:
            np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        close = np.isclose(_np(out), np.asarray(jout), rtol=2e-4,
                           atol=2e-5).all(-1)
        assert close.mean() >= 0.99
        return jnp.asarray(_np(out)), jidx

    for m in modules:
        monkeypatch.setattr(m, "linear", linear)
        monkeypatch.setattr(m, "topk_attention", attention)


def _no_kernel_launched(fn):
    before = [k.launches for k in KERNELS]
    out = fn()
    assert [k.launches for k in KERNELS] == before
    return out


@pytest.fixture(scope="module")
def vit_models():
    jcfg = JaxVitConfig(**VIT_KW)
    tree = _random_tree(jax_init_vit(jax.random.key(0), jcfg), 0)
    model = vit_params_from_jax(tree, VitConfig(**VIT_KW), device="cpu")
    return jcfg, jax.tree.map(jnp.asarray, tree), model


# name: (engine, plan keywords)
VIT_CASES = {
    "ref_ex_pred": ("ref", dict(pred_mode="ex_pred")),
    "ref_two_step": ("ref", dict(pred_mode="two_step_leading_ones")),
    "fused_gather": ("fused", dict(pred_mode="ex_pred",
                                   sparse_impl="gather")),
}


@pytest.mark.parametrize("case", sorted(VIT_CASES))
def test_deit_matches_jax_stage_by_stage(vit_models, case, monkeypatch):
    jcfg, jparams, model = vit_models
    engine, plan = VIT_CASES[case]
    kw = dict(mx_quant=True, top_k=True, k=6, **plan)
    x = np.random.RandomState(1).randn(2, 3, 32, 32).astype(np.float32)
    calls = record(monkeypatch, [port_vit])
    stages = []

    def stage(name):
        def wrapped(*args, _real=getattr(port_vit, name), **kwargs):
            out = _real(*args, **kwargs)
            stages.append((name, args, out, len(calls)))
            return out
        monkeypatch.setattr(port_vit, name, wrapped)
    for name in ("vit_embed", "vit_block", "vit_head"):
        stage(name)
    got = _no_kernel_launched(lambda: vit_forward(
        model, torch.from_numpy(x),
        VitQuantConfig(mx_specs=default_mx_specs(engine), **kw)))
    monkeypatch.undo()
    assert got.shape == (2, 10) and torch.isfinite(got).all()
    # qkv, attention, proj, fc1, fc2 of each block; the ref engine's and
    # "gather"'s top-k return the selected indices (block 0)
    assert [c[0] for c in calls] == ["linear", "topk_attention", "linear",
                                     "linear", "linear"] * 2
    assert calls[1][3][1] is not None and calls[6][3][1] is None

    jq = JaxQuantConfig(mx_specs=jax_deit_cli.default_mx_specs(engine), **kw)
    done = 0
    for name, args, out, upto in stages:
        pending = list(calls[done:upto])
        done = upto
        if name == "vit_block":
            answer(monkeypatch, [jax_vit], pending, {})
            blk, attn_cfg, xin = args[:3]
            i = list(model.blocks).index(blk)
            bp = unstack_block(jparams["blocks"], i)
            acfg = JaxAttnConfig(**attn_cfg._asdict())
            xj = jnp.asarray(_np(xin))
            mxs = jq.mx_specs
            h = jax_vit.layer_norm(xj, bp["norm1"]["weight"],
                                   bp["norm1"]["bias"], eps=jcfg.eps)
            xj = xj + jax_vit.vit_attention(bp["attn"], h, jcfg, mxs, acfg)
            h = jax_vit.layer_norm(xj, bp["norm2"]["weight"],
                                   bp["norm2"]["bias"], eps=jcfg.eps)
            want = xj + jax_vit.vit_mlp(bp["mlp"], h, mxs)
            monkeypatch.undo()
            assert not pending, f"the port called {pending[0][0]}; JAX not"
            _check(_np(out), want)
        else:
            assert not pending
    assert [s[0] for s in stages] == ["vit_embed", "vit_block", "vit_block",
                                      "vit_head"]


def test_dit_block_matches_jax_on_the_ref_engine(monkeypatch):
    """One DiT block at the DiT specs (bfloat=16) on the ref engine, top-k
    ex_pred (the dense no-top-k branch: the DeiT case's last block and
    tests/test_torch_emulation_attention.py)."""
    kw = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=64,
              depth=1, num_heads=2, num_classes=10)
    jcfg = JaxDiTConfig(**kw)
    tree = _random_tree(jax_init_dit(jax.random.key(0), jcfg), 2)
    model = dit_params_from_jax(tree, DiTConfig(**kw), device="cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 16, 64).astype(np.float32)
    cb = rng.randn(2, 64).astype(np.float32)
    specs, jspecs = dit_mx_specs("ref"), jax_dit_cli.dit_mx_specs("ref")
    acfg = dict(k=6, pred_mode="ex_pred")
    calls = record(monkeypatch, [port_dit])
    got = _no_kernel_launched(lambda: dit_block_step(
        model.blocks[0], TopKAttentionConfig(**acfg),
        torch.from_numpy(x), torch.from_numpy(cb), cfg=model.cfg,
        specs=specs, act_dtype=torch.float32))
    monkeypatch.undo()
    assert [c[0] for c in calls] == ["linear", "topk_attention"] + \
        ["linear"] * 3
    pending = list(calls)
    answer(monkeypatch, [jax_dit], pending, dict(bfloat=16))
    want = jax_dit._dit_block_step(
        unstack_block(jparams["blocks"], 0), JaxAttnConfig(**acfg),
        jnp.asarray(x), jnp.asarray(cb), cfg=jcfg, specs=jspecs,
        act_dtype=jnp.float32)
    monkeypatch.undo()
    assert not pending
    _check(_np(got), want)


def test_pixart_block_matches_jax_on_the_ref_engine(monkeypatch):
    """One PixArt block at the PixArt specs (flush, bfloat 32) on the ref
    engine: self top-k two_step and cross top-k under a caption mask."""
    kw = dict(sample_size=4, num_layers=1, num_attention_heads=2,
              attention_head_dim=32, caption_channels=32)
    jcfg = JaxPixConfig(**kw)
    tree = _random_tree(jax_init_pixart(jax.random.key(0), jcfg), 4)
    model = pixart_params_from_jax(tree, PixArtConfig(**kw), device="cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    rng = np.random.RandomState(5)
    d = jcfg.inner_dim
    x = rng.randn(2, 16, d).astype(np.float32)
    ctx = rng.randn(2, 12, d).astype(np.float32)
    t6 = 0.1 * rng.randn(2, 6 * d).astype(np.float32)
    bias = np.zeros((2, 1, 1, 12), np.float32)
    bias[1, ..., 7:] = -10000.0
    qkw = dict(mx_quant=True, self_top_k=True, self_k=6, cross_top_k=True,
               cross_k=5, pred_mode="two_step_leading_ones")
    qcfg = PixArtQuantConfig(mx_specs=pixart_mx_specs("ref"), **qkw)
    jq = jax_pixart.PixArtQuantConfig(
        mx_specs=jax_pixart_cli.pixart_mx_specs("ref"), **qkw)
    calls = record(monkeypatch, [port_pixart])
    got = _no_kernel_launched(lambda: pixart_block_apply(
        model.blocks[0], torch.from_numpy(x), torch.from_numpy(ctx),
        torch.from_numpy(t6), model.cfg, qcfg.mx_specs,
        qcfg.self_attn_cfg(0, None), qcfg.cross_attn_cfg(0, None),
        bias=torch.from_numpy(bias)))
    monkeypatch.undo()
    names = [c[0] for c in calls]
    assert names.count("topk_attention") == 2
    pending = list(calls)
    answer(monkeypatch, [jax_pixart], pending, {})
    want = jax_pixart.pixart_block_apply(
        unstack_block(jparams["blocks"], 0), jnp.asarray(x),
        jnp.asarray(ctx), jnp.asarray(t6), jcfg, jq.mx_specs,
        jq.self_attn_cfg(0, None), jq.cross_attn_cfg(0, None),
        bias=jnp.asarray(bias))
    monkeypatch.undo()
    assert not pending
    _check(_np(got), want)
