"""The port's DiT forward against the JAX package's, with every parameter
drawn at random (numpy, seeded) and carried over by ``dit_params_from_jax``;
and the port's native checkpoint loader against the reference torch DiT's
golden output.

Whole forwards are not compared end to end.  XLA's and torch's float32
matmuls sum in other orders and their sin/cos/SiLU/LN/exp differ in the
last bits; where such a difference meets an MX rounding boundary, one grid
point moves (a 2^-6 step of its block's maximum), the next linear spreads
it over a whole token row and attention over the image, so two correct
implementations can end far apart.  So the forward is checked stage by
stage, with every rounding decision the port made handed to JAX:
  * the port's embedding, block steps and final layer are recorded as they
    run, with every MX activation quantize and every attention call inside
    them;
  * each stage's output is held to the JAX stage run on the port's input,
    under the JAX suite's model-level criterion ``_check``
    (tests/test_model_golden.py), with JAX's activation quantizes and
    attention calls answered by the port's recorded outputs;
  * each answered quantize is checked first: JAX's input within ``_check``
    of the port's, and JAX's quantizer on the port's input bit-equal to the
    port's output;
  * each answered attention call likewise: JAX's qkv within ``_check`` of
    the port's, and the port's attention on its qkv held to JAX's kernel
    under tests/test_torch_attention.py's criterion.
The CFG guidance is held, on the port's own model output, to JAX's
``dit_forward_with_cfg``.

bf16 activations are compared per block, calling JAX's ``_dit_block_step``
eagerly (XLA on the CPU rejects bf16 dots inside scan next to an
interpret-mode Pallas call).  XLA's and torch's bf16 sigmoid and GELU
differ in the last bit on a third of the inputs, which moves MX grid points
downstream, so bit-equality is not the criterion: the port's bf16 block
must sit closer to JAX's bf16 block than JAX's bf16 block sits to JAX's f32
block, and no farther from the f32 block than JAX's bf16 block is (20%).
"""

import dataclasses
import importlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mx_quantization_tpu.models.dit as jax_dit
from mx_quantization_tpu.attention import \
    TopKAttentionConfig as JaxAttnConfig
from mx_quantization_tpu.attention import \
    fused_qkv_topk_attention as jax_qkv_attention
from mx_quantization_tpu.models.common import patch_embed as jax_patch_embed
from mx_quantization_tpu.models.dit import DiTConfig as JaxDiTConfig
from mx_quantization_tpu.models.dit import DiTQuantConfig as JaxQuantConfig
from mx_quantization_tpu.models.dit import _dit_block_step as jax_block_step
from mx_quantization_tpu.models.dit import init_dit as jax_init_dit
from mx_quantization_tpu.models.dit import \
    timestep_embedding as jax_timestep_embedding
from mx_quantization_tpu.models.stacked import unstack_block
from mx_quantization_tpu.ops import linear as jax_linear
from mx_quantization_tpu.ops.fastquant import \
    quantize_mx_serving as jax_quantize
from mx_quantization_tpu.workloads.dit import dit_mx_specs as jax_specs

import mx_quantization_tpu_torch.models.dit as port_dit
from mx_quantization_tpu_torch.models.dit import (DiT, DiTConfig,
                                                  DiTQuantConfig,
                                                  dit_block_step,
                                                  dit_forward,
                                                  dit_forward_with_cfg,
                                                  timestep_embedding)
from mx_quantization_tpu_torch.attention import fused_qkv_topk_attention
from mx_quantization_tpu_torch.utils.checkpoint import (dit_params_from_jax,
                                                        load_dit_checkpoint)
from mx_quantization_tpu_torch.workloads.dit import dit_mx_specs
from test_torch_attention import assert_matches_jax

CFG_KW = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=288,
              depth=2, num_heads=4, num_classes=10)
QKW = dict(mx_quant=True, top_k=True, k=6, ex_pred=True,
           exclude_blocks=(1,), topk_key_bits=8)
JAX_LINEAR = importlib.import_module("mx_quantization_tpu.ops.linear")
PORT_LINEAR = importlib.import_module("mx_quantization_tpu_torch.ops.linear")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _check(got, want, close_frac=0.99, mean_tol=2e-4):
    """tests/test_model_golden.py's model-level criterion."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    close = np.isclose(got, want, rtol=1e-4, atol=1e-4)
    assert close.mean() >= close_frac, \
        f"only {close.mean():.4f} of outputs match"
    assert abs(got.mean() - want.mean()) < mean_tol
    assert abs(got.std() - want.std()) / want.std() < 5e-3


def _np(a):
    return a.detach().float().numpy() if torch.is_tensor(a) else np.asarray(
        a, np.float32)


def record_stages(monkeypatch):
    """Record, in the order they return, every stage the port's DiT forward
    runs and every MX activation quantize and attention call inside them,
    as (name, args, kwargs, output)."""
    calls = []

    def record(module, name):
        def wrapped(*args, _real=getattr(module, name), **kwargs):
            out = _real(*args, **kwargs)
            calls.append((name, args, kwargs, out))
            return out
        monkeypatch.setattr(module, name, wrapped)

    for name in ("dit_embed", "dit_block_step", "dit_final_layer",
                 "fused_qkv_topk_attention"):
        record(port_dit, name)
    record(PORT_LINEAR, "quantize_mx_serving")
    return calls


def _jax_embed(p, x, t, y, jcfg, act):
    """JAX dit_forward's embedding lines (models/dit.py)."""
    pe = p["x_embedder"]
    prec = "default" if act == jnp.bfloat16 else "highest"
    h = jax_patch_embed(x, pe["weight"], pe.get("bias"), jcfg.patch_size,
                        precision=prec) + p["pos_embed"]
    te = p["t_embedder"]
    t_emb = jax_linear(jax_timestep_embedding(t, 256),
                       te["mlp0"]["weight"], te["mlp0"]["bias"])
    t_emb = jax_linear(jax.nn.silu(t_emb), te["mlp2"]["weight"],
                       te["mlp2"]["bias"])
    return h.astype(act), t_emb + p["y_embedder"]["table"][y]


def _jax_final_layer(p, h, c, jcfg, specs):
    """JAX dit_forward's final-layer and unpatchify lines."""
    fl = p["final_layer"]
    mod = jax_linear(jax.nn.silu(c), fl["adaLN"]["weight"],
                     fl["adaLN"]["bias"], mx_specs=specs)
    shift, scale = jnp.split(mod.astype(h.dtype), 2, axis=-1)
    h = jax_dit.modulate(jax_dit._ln(h), shift, scale)
    h = jax_linear(h, fl["linear"]["weight"], fl["linear"]["bias"],
                   mx_specs=specs).astype(jnp.float32)
    B, c_out, psz = h.shape[0], jcfg.out_channels, jcfg.patch_size
    g = int(h.shape[1] ** 0.5)
    h = jnp.einsum("nhwpqc->nchpwq",
                   h.reshape(B, g, g, psz, psz, c_out))
    return h.reshape(B, c_out, g * psz, g * psz)


def check_stages(monkeypatch, calls, model, jparams, jcfg, jq):
    """Hold each recorded stage to the JAX stage run on its input, JAX's
    quantizes and attention calls answered by the port's (module
    docstring)."""
    act = jnp.bfloat16 if jq.activation_dtype == "bfloat16" else jnp.float32
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

    def attention(qkv, H, scale, specs, cfg):
        _, (qp, _, _, pspecs, pcfg), _, out = take("fused_qkv_topk_attention")
        _check(_np(qp), qkv)
        assert_matches_jax(
            lambda a: fused_qkv_topk_attention(torch.from_numpy(a), H, scale,
                                               pspecs, pcfg).float(),
            lambda a: jax_qkv_attention(jnp.asarray(a), H, scale, specs,
                                        cfg).astype(jnp.float32),
            _np(qp), H, contract=pcfg.contract,
            block_size=pspecs.block_size)
        return jnp.asarray(_np(out)).astype(cfg.out_dtype)

    monkeypatch.setattr(JAX_LINEAR, "quantize_mx_serving", quantize)
    monkeypatch.setattr(jax_dit, "fused_qkv_topk_attention", attention)
    stages = 0
    for name, args, kw, out in calls:
        if name in ("quantize_mx_serving", "fused_qkv_topk_attention"):
            pending.append((name, args, kw, out))
            continue
        stages += 1
        if name == "dit_embed":
            _, x, t, y, _ = args
            h, c = _jax_embed(jparams, jnp.asarray(_np(x)),
                              jnp.asarray(_np(t)),
                              jnp.asarray(y.numpy().astype(np.int32)),
                              jcfg, act)
            _check(_np(out[0]), h)
            _check(_np(out[1]), c)
        elif name == "dit_block_step":
            blk, attn_cfg, x, cb = args
            i = list(model.blocks).index(blk)
            want = jax_block_step(
                unstack_block(jparams["blocks"], i),
                JaxAttnConfig(**attn_cfg._asdict()),
                jnp.asarray(_np(x)).astype(act),
                jnp.asarray(_np(cb)).astype(act), cfg=jcfg,
                specs=jq.mx_specs, act_dtype=act, fuse_gelu=jq.fuse_gelu)
            _check(_np(out), want)
        else:
            _, h, c, _ = args
            want = _jax_final_layer(jparams, jnp.asarray(_np(h)).astype(act),
                                    jnp.asarray(_np(c)), jcfg, jq.mx_specs)
            _check(_np(out), want)
        assert not pending, f"the port called {pending[0][0]}; JAX did not"
    monkeypatch.undo()
    assert stages % (jcfg.depth + 2) == 0 and stages


def check_cfg_guidance(monkeypatch, got, inner, x, t, y, jcfg, jq, scale):
    """The port's CFG output ``got`` against JAX's ``dit_forward_with_cfg``
    run on the port's own model output ``inner``."""
    monkeypatch.setattr(jax_dit, "dit_forward",
                        lambda *a, **k: jnp.asarray(_np(inner)))
    want = jax_dit.dit_forward_with_cfg(
        None, jnp.asarray(_np(x)), jnp.asarray(_np(t)),
        jnp.asarray(y.numpy().astype(np.int32)), jcfg, jq, scale)
    monkeypatch.undo()
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.fixture(scope="module")
def models():
    jcfg = JaxDiTConfig(**CFG_KW)
    tree = jax_init_dit(jax.random.key(0), jcfg)
    rng = np.random.RandomState(0)
    tree = jax.tree.map(
        lambda a: (0.05 * rng.randn(*a.shape)).astype(np.float32), tree)
    model = dit_params_from_jax(tree, DiTConfig(**CFG_KW), device="cpu")
    return jcfg, jax.tree.map(jnp.asarray, tree), model


def _inputs(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 4, 8, 8).astype(np.float32)
    t = rng.randint(0, 300, size=2).astype(np.float32)
    return x, t, np.array([3, 7], np.int32)


@pytest.mark.parametrize("contract", ["exact", "serving"])
def test_forward_matches_jax(models, contract, monkeypatch):
    jcfg, jparams, model = models
    x, t, y = _inputs(1)
    stages = record_stages(monkeypatch)
    got = dit_forward(model, torch.from_numpy(x), torch.from_numpy(t),
                      torch.from_numpy(y).long(),
                      DiTQuantConfig(mx_specs=dit_mx_specs(),
                                     contract=contract, **QKW))
    monkeypatch.undo()
    assert got.shape == (2, 8, 8, 8) and torch.isfinite(got).all()
    assert torch.equal(got, stages[-1][3])
    check_stages(monkeypatch, stages, model, jparams, jcfg,
                 JaxQuantConfig(mx_specs=jax_specs(), contract=contract,
                                **QKW))


def test_forward_at_block_16_matches_jax(models, monkeypatch):
    """A 2-block DiT (hidden 288, 4 heads of D = 72, 16 tokens), serving
    tier, MXINT8 in 16-element blocks: every stage held to JAX's on the
    port's stage input (``check_stages``), K2's plain version at block 16
    in every attention call."""
    jcfg, jparams, model = models
    x, t, y = _inputs(2)
    specs = dataclasses.replace(dit_mx_specs(), block_size=16)
    calls = record_stages(monkeypatch)
    got = dit_forward(model, torch.from_numpy(x), torch.from_numpy(t),
                      torch.from_numpy(y).long(),
                      DiTQuantConfig(mx_specs=specs, contract="serving",
                                     **QKW))
    monkeypatch.undo()
    assert got.shape == (2, 8, 8, 8) and torch.isfinite(got).all()
    attn = [c for c in calls if c[0] == "fused_qkv_topk_attention"]
    assert len(attn) == 2 and all(c[1][3].block_size == 16 for c in attn)
    check_stages(monkeypatch, calls, model, jparams, jcfg,
                 JaxQuantConfig(mx_specs=dataclasses.replace(
                     jax_specs(), block_size=16), contract="serving", **QKW))


@pytest.mark.parametrize("contract", ["exact", "serving"])
def test_cfg_forward_matches_jax(models, contract, monkeypatch):
    jcfg, jparams, model = models
    x, t, _ = _inputs(1)
    # one image: its conditional and unconditional (null class) rows
    x, t = np.concatenate([x[:1], x[:1]]), np.concatenate([t[:1], t[:1]])
    y = torch.tensor([3, 10])
    jq = JaxQuantConfig(mx_specs=jax_specs(), contract=contract, **QKW)
    stages = record_stages(monkeypatch)
    got = dit_forward_with_cfg(
        model, torch.from_numpy(x), torch.from_numpy(t), y,
        DiTQuantConfig(mx_specs=dit_mx_specs(), contract=contract, **QKW),
        4.0)
    monkeypatch.undo()
    check_stages(monkeypatch, stages, model, jparams, jcfg, jq)
    check_cfg_guidance(monkeypatch, got, stages[-1][3], x, t, y, jcfg, jq,
                       4.0)


@pytest.mark.parametrize("contract", ["exact", "serving"])
@pytest.mark.parametrize("block", [0, 1])
def test_f32_block_matches_jax(models, contract, block):
    jcfg, jparams, model = models
    rng = np.random.RandomState(5 + block)
    x = rng.randn(4, 16, 288).astype(np.float32)
    cb = (0.5 * rng.randn(4, 288)).astype(np.float32)
    jq = JaxQuantConfig(mx_specs=jax_specs(), contract=contract, **QKW)
    want = jax_block_step(unstack_block(jparams["blocks"], block),
                          jq.block_attn_cfg(block, None), jnp.asarray(x),
                          jnp.asarray(cb), cfg=jcfg, specs=jq.mx_specs,
                          act_dtype=jnp.float32)
    pq = DiTQuantConfig(mx_specs=dit_mx_specs(), contract=contract, **QKW)
    got = dit_block_step(model.blocks[block], pq.block_attn_cfg(block, None),
                         torch.from_numpy(x), torch.from_numpy(cb),
                         cfg=model.cfg, specs=pq.mx_specs,
                         act_dtype=torch.float32)
    close = np.isclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert close.mean() >= 0.995, f"only {close.mean():.4f} match"


@pytest.mark.parametrize("contract", ["exact", "serving"])
@pytest.mark.parametrize("block", [0, 1])
def test_bf16_block_matches_jax(models, contract, block):
    jcfg, jparams, model = models
    rng = np.random.RandomState(3 + block)
    x = rng.randn(2, 16, 288).astype(np.float32)
    cb = (0.5 * rng.randn(2, 288)).astype(np.float32)
    jax_out = {}
    for act in ("bfloat16", "float32"):
        jq = JaxQuantConfig(mx_specs=jax_specs(), contract=contract,
                            activation_dtype=act, **QKW)
        dt = getattr(jnp, act)
        jax_out[act] = np.asarray(jax_block_step(
            unstack_block(jparams["blocks"], block),
            jq.block_attn_cfg(block, None), jnp.asarray(x).astype(dt),
            jnp.asarray(cb).astype(dt), cfg=jcfg, specs=jq.mx_specs,
            act_dtype=dt), np.float32)
    pq = DiTQuantConfig(mx_specs=dit_mx_specs(), contract=contract,
                        activation_dtype="bfloat16", **QKW)
    got = dit_block_step(model.blocks[block], pq.block_attn_cfg(block, None),
                         torch.from_numpy(x).to(torch.bfloat16),
                         torch.from_numpy(cb).to(torch.bfloat16),
                         cfg=model.cfg, specs=pq.mx_specs,
                         act_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    bf16_noise = rel(jax_out["bfloat16"], jax_out["float32"])
    assert rel(got, jax_out["bfloat16"]) < bf16_noise
    assert rel(got, jax_out["float32"]) <= 1.2 * bf16_noise


def test_two_step_block_takes_the_split_entry(models, monkeypatch):
    """pred_mode="two_step_leading_ones": the port's dit_attention routes it
    as JAX routes it, to the fused qkv entry (kernel K2; before K2 took
    every predictor of JAX's qkv gate, the port sent it to the split entry,
    kernel K3).  The attention call is held to JAX's qkv kernel on the
    port's qkv, and the block to JAX's as in test_f32_block_matches_jax."""
    jcfg, jparams, model = models
    contract = "exact"  # the serving tier routes the same way
    qkw = {**QKW, "pred_mode": "two_step_leading_ones"}
    rng = np.random.RandomState(9)
    x = rng.randn(4, 16, 288).astype(np.float32)
    cb = (0.5 * rng.randn(4, 288)).astype(np.float32)
    calls = []

    def record(name):
        def wrapped(*args, _real=getattr(port_dit, name), **kwargs):
            calls.append((name, args, kwargs))
            return _real(*args, **kwargs)
        monkeypatch.setattr(port_dit, name, wrapped)

    record("topk_attention")
    record("fused_qkv_topk_attention")
    pq = DiTQuantConfig(mx_specs=dit_mx_specs(), contract=contract, **qkw)
    got = dit_block_step(model.blocks[0], pq.block_attn_cfg(0, None),
                         torch.from_numpy(x), torch.from_numpy(cb),
                         cfg=model.cfg, specs=pq.mx_specs,
                         act_dtype=torch.float32)
    monkeypatch.undo()
    assert [c[0] for c in calls] == ["fused_qkv_topk_attention"]
    (qkv, H, scale, pspecs, pcfg), _ = calls[0][1:]
    assert pcfg.pred_mode == "two_step_leading_ones" and pcfg.top_k
    jq = JaxQuantConfig(mx_specs=jax_specs(), contract=contract, **qkw)
    assert_matches_jax(
        lambda a: port_dit.fused_qkv_topk_attention(
            torch.from_numpy(a), H, scale, pspecs, pcfg).float(),
        lambda a: jax_qkv_attention(
            jnp.asarray(a), H, scale, jq.mx_specs,
            JaxAttnConfig(**pcfg._asdict())).astype(jnp.float32),
        _np(qkv), H, contract=contract)
    want = jax_block_step(unstack_block(jparams["blocks"], 0),
                          jq.block_attn_cfg(0, None), jnp.asarray(x),
                          jnp.asarray(cb), cfg=jcfg, specs=jq.mx_specs,
                          act_dtype=jnp.float32)
    close = np.isclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert close.mean() >= 0.995, f"only {close.mean():.4f} match"


def test_timestep_embedding_matches_jax():
    t = np.array([0, 1, 7, 250, 500, 999], np.float32)
    want = np.asarray(jax_timestep_embedding(jnp.asarray(t), 256))
    got = timestep_embedding(torch.from_numpy(t), 256).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-5)


def test_params_carry_over_exactly(models):
    jcfg, jparams, model = models
    sd = model.state_dict()
    np.testing.assert_array_equal(
        sd["blocks.1.mlp.fc2.weight"].numpy(),
        np.asarray(jparams["blocks"]["mlp"]["fc2"]["weight"][1]))
    np.testing.assert_array_equal(sd["y_embedder.table"].numpy(),
                                  np.asarray(jparams["y_embedder"]["table"]))


def test_native_loader_matches_reference_golden():
    """tests/golden/dit_model_sd.pt (the reference torch DiT's state dict)
    through the port's loader; dims as in tests/make_golden_model.py."""
    golden = np.load(os.path.join(GOLDEN, "dit_model.npz"))
    cfg = DiTConfig(input_size=8, patch_size=2, in_channels=4, hidden_size=64,
                    depth=2, num_heads=2, num_classes=10)
    model = DiT(cfg, device="cpu")
    model.load_state_dict(load_dit_checkpoint(
        os.path.join(GOLDEN, "dit_model_sd.pt"), depth=2))
    qcfg = DiTQuantConfig(mx_specs=dit_mx_specs(), mx_quant=True, top_k=True,
                          k=8, ex_pred=True, exclude_blocks=(1,))
    out = dit_forward(model, torch.from_numpy(golden["x"]),
                      torch.from_numpy(golden["t"]),
                      torch.from_numpy(golden["y"]).long(), qcfg)
    _check(out.numpy(), golden["out_ex_pred"])
