"""The port's PixArt-alpha transformer against the JAX package's: weights
carried over from JAX's ``init_pixart`` (2 layers, 2 heads of 72, the
config of tests/test_pixart_model_golden.py), the diffusers-name loader on
the golden state dict, and the forward stage by stage.

Whole forwards are not compared end to end, for the reason
tests/test_torch_dit.py gives: one MX grid point moved by an ulp upstream
spreads over the image.  The port's embedding, blocks and final layer are
recorded as they run, with every MX activation quantize and every
attention call inside them; each stage's output is held to the JAX stage
run on the port's input under the JAX suite's model-level criterion
(``_check``), with JAX's quantizes and attention calls answered by the
port's recorded outputs.  Each answered quantize is checked first (JAX's
input within ``_check`` of the port's, JAX's quantizer on the port's input
bit-equal to the port's output), and each answered attention call likewise
(JAX's q, k, v within ``_check`` of the port's, and the port's attention on
its inputs held to JAX's kernel under tests/test_torch_attention_split.py's
criterion).
"""

import dataclasses
import importlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mx_quantization_tpu.models.pixart as jax_pixart
from mx_quantization_tpu.attention import \
    TopKAttentionConfig as JaxAttnConfig
from mx_quantization_tpu.attention import topk_attention as jax_topk
from mx_quantization_tpu.models.common import patch_embed as jax_patch_embed
from mx_quantization_tpu.models.dit import \
    get_2d_sincos_pos_embed as jax_sincos
from mx_quantization_tpu.models.dit import \
    timestep_embedding as jax_timestep_embedding
from mx_quantization_tpu.models.pixart import PixArtConfig as JaxConfig
from mx_quantization_tpu.models.pixart import \
    PixArtQuantConfig as JaxQuantConfig
from mx_quantization_tpu.models.stacked import unstack_block
from mx_quantization_tpu.ops import linear as jax_linear
from mx_quantization_tpu.ops.fastquant import \
    quantize_mx_serving as jax_quantize
from mx_quantization_tpu.utils.checkpoint import \
    load_pixart_checkpoint as jax_load
from mx_quantization_tpu.workloads.pixart import pixart_mx_specs as jax_specs

import mx_quantization_tpu_torch.models.pixart as port_pixart
from mx_quantization_tpu_torch.attention import topk_attention
from mx_quantization_tpu_torch.models.pixart import (PixArt, PixArtConfig,
                                                     PixArtQuantConfig,
                                                     pixart_forward)
from mx_quantization_tpu_torch.utils.checkpoint import (
    load_pixart_checkpoint, pixart_params_from_jax)
from mx_quantization_tpu_torch.workloads.pixart import main as pixart_main
from mx_quantization_tpu_torch.workloads.pixart import pixart_mx_specs
from test_torch_attention_split import assert_split_matches_jax
from test_torch_dit import _check, _np

CFG_KW = dict(num_attention_heads=2, attention_head_dim=72, in_channels=4,
              out_channels=8, num_layers=2, cross_attention_dim=144,
              sample_size=8, patch_size=2, caption_channels=32)
QKW = dict(mx_quant=True, self_top_k=True, self_k=6, ex_pred=True,
           pred_mode="two_step_leading_ones", exclude_blocks=(1,))
TOKENS = 12  # caption tokens
JAX_LINEAR = importlib.import_module("mx_quantization_tpu.ops.linear")
PORT_LINEAR = importlib.import_module("mx_quantization_tpu_torch.ops.linear")
SD = os.path.join(os.path.dirname(__file__), "golden", "pixart_model_sd.pt")


def _leaf(tree, name):
    """The JAX tree's array for a port parameter name (blocks stacked)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        node = tree["blocks"]
        for key in parts[2:]:
            node = node[key]
        return np.asarray(node)[int(parts[1])]
    node = tree
    for key in parts:
        node = node[key]
    return np.asarray(node)


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig(**CFG_KW)
    tree = jax.tree.map(np.asarray, jax_pixart.init_pixart(
        jax.random.key(0), jcfg))
    model = pixart_params_from_jax(tree, PixArtConfig(**CFG_KW),
                                   device="cpu")
    return jcfg, jax.tree.map(jnp.asarray, tree), tree, model


def test_params_from_jax_carry_over_exactly(models):
    *_, tree, model = models
    sd = model.state_dict()
    assert len(sd) == 15 + 21 * 2  # top level + 2 blocks
    for name, val in sd.items():
        np.testing.assert_array_equal(val.numpy(), _leaf(tree, name))
    np.testing.assert_array_equal(model.pos_embed.pe.numpy(),
                                  np.asarray(tree["pos_embed"]["pe"]))


def test_loader_matches_jax_loader():
    cfg = PixArtConfig(**CFG_KW)
    sd = load_pixart_checkpoint(SD, num_layers=2)
    want = jax_load(SD, num_layers=2)
    model = PixArt(cfg, device="cpu")
    model.load_state_dict(sd)  # every name, every shape
    for name, val in sd.items():
        np.testing.assert_array_equal(val.numpy(), _leaf(want, name))
    # the position table comes from the config (JAX's loader builds it for
    # the 256^2 grid; its golden test rebuilds it at this one)
    np.testing.assert_array_equal(model.pos_embed.pe.numpy(), jax_sincos(
        cfg.inner_dim, cfg.sample_size // cfg.patch_size)[None])


def record_calls(monkeypatch, stages=("pixart_embed", "pixart_block_apply",
                                      "pixart_final_layer")):
    """Record, in the order they return, the port's PixArt stages and every
    MX activation quantize and attention call inside them, as (name, args,
    kwargs, output)."""
    calls = []

    def record(module, name):
        def wrapped(*args, _real=getattr(module, name), **kwargs):
            out = _real(*args, **kwargs)
            calls.append((name, args, kwargs, out))
            return out
        monkeypatch.setattr(module, name, wrapped)

    for name in (*stages, "topk_attention"):
        record(port_pixart, name)
    record(PORT_LINEAR, "quantize_mx_serving")
    return calls


def answer_jax(monkeypatch, pending):
    """Make JAX's activation quantizes and attention calls take the port's
    recorded answers from ``pending`` (checking each first)."""
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

    def unanswered(*a):
        """JAX's topk_attention with its own quantizer (its top-k branch
        runs an XLA score product before it takes the kernel)."""
        answered = JAX_LINEAR.quantize_mx_serving
        JAX_LINEAR.quantize_mx_serving = jax_quantize
        try:
            return jax_topk(*a[:6], bias=a[6])[0]
        finally:
            JAX_LINEAR.quantize_mx_serving = answered

    def attention(q, k, v, scale, specs, cfg, bias=None,
                  orthogonal_matrix=None):
        _, (qp, kp, vp, _, pspecs, pcfg), pkw, (out, _) = take(
            "topk_attention")
        for a, b in ((qp, q), (kp, k), (vp, v)):
            _check(_np(a), b)
        pbias = pkw.get("bias")
        assert (pbias is None) == (bias is None)
        assert_split_matches_jax(
            lambda *a: topk_attention(*map(torch.from_numpy, a[:3]), scale,
                                      pspecs, pcfg, bias=None if a[3] is None
                                      else torch.from_numpy(a[3]))[0],
            lambda *a: unanswered(*map(jnp.asarray, a[:3]), scale, specs,
                                  cfg, None if a[3] is None
                                  else jnp.asarray(a[3])),
            _np(qp), _np(kp), _np(vp), None if pbias is None else _np(pbias),
            contract=pcfg.contract)
        return jnp.asarray(_np(out)).astype(cfg.out_dtype), None

    monkeypatch.setattr(JAX_LINEAR, "quantize_mx_serving", quantize)
    monkeypatch.setattr(jax_pixart, "topk_attention", attention)


def _jax_embed(p, x, enc, t, jcfg, resolution=None, aspect_ratio=None):
    """JAX pixart_forward's embedding lines (models/pixart.py), the
    micro-conditioning's included."""
    pe = p["pos_embed"]
    h = jax_patch_embed(x, pe["proj"]["weight"], pe["proj"]["bias"],
                        jcfg.patch_size) + pe["pe"]
    ada = p["adaln_single"]
    emb = jax_linear(jax_timestep_embedding(t, 256),
                     ada["emb_mlp0"]["weight"], ada["emb_mlp0"]["bias"])
    emb = jax_linear(jax.nn.silu(emb), ada["emb_mlp2"]["weight"],
                     ada["emb_mlp2"]["bias"])
    if jcfg.use_additional_conditions:
        B = x.shape[0]
        if resolution is None:
            resolution = jnp.full((B, 2), float(jcfg.sample_size * 8),
                                  jnp.float32)
        if aspect_ratio is None:
            aspect_ratio = jnp.ones((B, 1), jnp.float32)

        def size_emb(v, m0, m2):
            e = jax_timestep_embedding(v.reshape(-1), 256)
            e = jax_linear(e, ada[m0]["weight"], ada[m0]["bias"])
            e = jax_linear(jax.nn.silu(e), ada[m2]["weight"], ada[m2]["bias"])
            return e.reshape(v.shape[0], -1)

        emb = emb + jnp.concatenate(
            [size_emb(resolution, "res_mlp0", "res_mlp2"),
             size_emb(aspect_ratio, "ar_mlp0", "ar_mlp2")], axis=-1)
    t6 = jax_linear(jax.nn.silu(emb), ada["linear"]["weight"],
                    ada["linear"]["bias"])
    cp = p["caption_projection"]
    ctx = jax_linear(enc, cp["linear_1"]["weight"], cp["linear_1"]["bias"])
    ctx = jax.nn.gelu(ctx, approximate=True)
    ctx = jax_linear(ctx, cp["linear_2"]["weight"], cp["linear_2"]["bias"])
    return h, ctx, t6, emb


def _jax_final_layer(p, x, emb, jcfg):
    """JAX pixart_forward's final-layer and unpatchify lines."""
    shift, scale = jnp.split(p["scale_shift_table"][None] + emb[:, None], 2,
                             axis=1)
    x = jax_pixart._ln(x, 1e-6) * (1 + scale) + shift
    x = jax_linear(x, p["proj_out"]["weight"], p["proj_out"]["bias"])
    B, hw = x.shape[0], jcfg.sample_size // jcfg.patch_size
    x = x.reshape(B, hw, hw, jcfg.patch_size, jcfg.patch_size,
                  jcfg.out_channels)
    x = jnp.einsum("nhwpqc->nchpwq", x)
    return x.reshape(B, jcfg.out_channels, hw * jcfg.patch_size,
                     hw * jcfg.patch_size)


def check_stages(monkeypatch, calls, model, jparams, jcfg, jq):
    """Hold each recorded stage to the JAX stage run on its input, JAX's
    quantizes and attention calls answered by the port's (module
    docstring)."""
    pending = []
    answer_jax(monkeypatch, pending)
    stages = 0
    for name, args, kw, out in calls:
        if name in ("quantize_mx_serving", "topk_attention"):
            pending.append((name, args, kw, out))
            continue
        stages += 1
        if name == "pixart_embed":
            _, x, enc, t, _ = args
            want = _jax_embed(jparams, *(jnp.asarray(_np(a))
                                         for a in (x, enc, t)), jcfg,
                              **{key: None if a is None else
                                 jnp.asarray(_np(a)) for key, a in kw.items()})
            for got, w in zip(out, want):
                _check(_np(got), w)
        elif name == "pixart_block_apply":
            blk, x, ctx, t6, _, _, self_cfg, cross_cfg = args
            i = list(model.blocks).index(blk)
            bias = kw.get("bias")
            want = jax_pixart.pixart_block_apply(
                unstack_block(jparams["blocks"], i), jnp.asarray(_np(x)),
                jnp.asarray(_np(ctx)), jnp.asarray(_np(t6)), jcfg,
                jq.mx_specs, JaxAttnConfig(**self_cfg._asdict()),
                JaxAttnConfig(**cross_cfg._asdict()),
                bias=None if bias is None else jnp.asarray(_np(bias)))
            _check(_np(out), want)
        else:
            _, x, emb = args
            _check(_np(out), _jax_final_layer(jparams, jnp.asarray(_np(x)),
                                              jnp.asarray(_np(emb)), jcfg))
        assert not pending, f"the port called {pending[0][0]}; JAX did not"
    monkeypatch.undo()
    return stages


def pixart_inputs(seed, n=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4, 8, 8).astype(np.float32)
    enc = rng.randn(n, TOKENS, 32).astype(np.float32)
    t = rng.randint(0, 300, size=n).astype(np.float32)
    mask = (np.arange(TOKENS)[None] <
            np.linspace(5, TOKENS, n).round()[:, None]).astype(np.float32)
    return x, enc, t, mask


@pytest.mark.parametrize("contract", ["exact", "serving"])
def test_forward_matches_jax_stage_by_stage(models, contract, monkeypatch):
    jcfg, jparams, _, model = models
    x, enc, t, mask = pixart_inputs(1)
    calls = record_calls(monkeypatch)
    got = pixart_forward(model, *map(torch.from_numpy, (x, enc, t)),
                         PixArtQuantConfig(mx_specs=pixart_mx_specs(),
                                           contract=contract, **QKW),
                         encoder_attention_mask=torch.from_numpy(mask))
    monkeypatch.undo()
    assert got.shape == (2, 8, 8, 8) and torch.isfinite(got).all()
    assert torch.equal(got, calls[-1][3])
    # 2 layers x (self 4 + cross 4 + MLP 2) quantizes, 2 x 2 attentions
    assert sum(c[0] == "quantize_mx_serving" for c in calls) == 20
    attn = [c for c in calls if c[0] == "topk_attention"]
    assert [(c[1][5].top_k, c[2]["bias"] is not None) for c in attn] == [
        (True, False), (False, True), (False, False), (False, True)]
    stages = check_stages(monkeypatch, calls, model, jparams, jcfg,
                          JaxQuantConfig(mx_specs=jax_specs(),
                                         contract=contract, **QKW))
    assert stages == 2 + jcfg.num_layers


@pytest.mark.parametrize("cross", [False, True])
def test_mha_matches_jax(models, cross, monkeypatch):
    """_mha alone: self-attention (two_step top-k) and the masked
    cross-attention (dense, bias on the true scores)."""
    jcfg, jparams, _, model = models
    rng = np.random.RandomState(11)
    x = rng.randn(2, 16, 144).astype(np.float32)
    kv = rng.randn(2, TOKENS, 144).astype(np.float32) if cross else x
    mask = (np.arange(TOKENS)[None] < np.array([[4], [12]])
            ).astype(np.float32)
    bias = ((1 - mask) * -10000.0)[:, None, None] if cross else None
    pq = PixArtQuantConfig(mx_specs=pixart_mx_specs(), **QKW)
    jq = JaxQuantConfig(mx_specs=jax_specs(), **QKW)
    acfg = (pq.cross_attn_cfg if cross else pq.self_attn_cfg)(0, None)
    which = "attn2" if cross else "attn1"
    calls = record_calls(monkeypatch, stages=())
    got = port_pixart._mha(getattr(model.blocks[0], which),
                           torch.from_numpy(x), torch.from_numpy(kv),
                           model.cfg, pq.mx_specs, acfg,
                           bias=None if bias is None
                           else torch.from_numpy(bias))
    monkeypatch.undo()
    assert [c[0] for c in calls].count("topk_attention") == 1
    answer_jax(monkeypatch, calls)
    want = jax_pixart._mha(unstack_block(jparams["blocks"], 0)[which],
                           jnp.asarray(x), jnp.asarray(kv), jcfg,
                           jq.mx_specs, JaxAttnConfig(**acfg._asdict()),
                           bias=None if bias is None else jnp.asarray(bias))
    monkeypatch.undo()
    assert not calls, f"the port called {calls[0][0]}; JAX did not"
    _check(got.numpy(), want)


def test_unported_options_raise():
    """Micro-conditioning and ELSA are ported; what still raises is ELSA in
    the cross-attention (non-square: JAX leaves its kernels for the XLA
    path there, whose ELSA predictor raises ValueError, square attention
    only, in both packages).  The T5 flag is ported: a folder without T5
    weights raises before anything is read."""
    cfg = PixArtConfig(**CFG_KW)
    micro = PixArt(PixArtConfig(**{**CFG_KW, "micro_conds": True}),
                   device="cpu")
    assert micro.adaln_single.res_mlp0.weight.shape == (48, 256)
    model = PixArt(cfg, device="cpu")
    x, enc, t, _ = map(torch.from_numpy, pixart_inputs(2))
    # fuse_gelu is ported (kernel K6); without MX quantization it is a no-op
    assert torch.equal(
        pixart_forward(model, x, enc, t, PixArtQuantConfig(fuse_gelu=True)),
        pixart_forward(model, x, enc, t, PixArtQuantConfig()))
    elsa = PixArtQuantConfig(mx_specs=pixart_mx_specs(),
                             **{**QKW, "pred_mode": "ELSA"})
    assert torch.isfinite(pixart_forward(model, x, enc, t, elsa)).all()
    with pytest.raises(ValueError, match="square"):
        pixart_forward(model, x, enc, t, dataclasses.replace(
            elsa, cross_top_k=True, cross_k=5))
    with pytest.raises(FileNotFoundError, match="no T5 weights"):
        pixart_main(["--device", "cpu", "--t5-path", "t5"])
