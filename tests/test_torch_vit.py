"""The port's DeiT forward (``models/vit.py``) against the JAX package's,
with every parameter drawn at random (numpy, seeded) and carried over by
``vit_params_from_jax``.

The model is tiny: 32^2 images in 8^2 patches (N = 17 tokens with the cls
token), embed 128 in 2 heads of D = 64 (DeiT's head dim, and a width that
ELSA's structured projection takes), depth 3, 10 classes.  At the DeiT
specs (MXINT8, bfloat 32, key_bits 32) the routing cases are:
  * ex_pred top-k: K2's plain version (blocks 0, 1) and the last block
    dense on K2 (the last-block rule);
  * two_step top-k with block 1 excluded to ex_pred: K2's plain version
    in two_step (block 0), K2 (block 1), K2 dense (block 2), as JAX routes
    them to its qkv kernel;
  * ex_pred top-k with block 0 excluded to two_step, which is also the
    last block's type: K2 in two_step (block 0), K2 (block 1), K2 dense
    (block 2: the last-block rule comes before ``exclude_blocks``);
  * ELSA (serving tier): K3 with the structured projection, K2 dense last;
  * true top-k (``approx_flag=False``): K2 selects by the true scores;
  * unquantized (``mx_quant=False``).
Whole forwards are not compared end to end: as in tests/test_torch_dit.py,
XLA's and torch's float32 matmuls, LN statistics, exp and erfc differ in
the last bits, and where such a difference meets an MX rounding boundary
one grid point moves and the next linear spreads it.  So the forward is
checked stage by stage (the embedding, each block, the head), with every
MX activation quantize and attention call the port made handed to JAX,
each checked first (tests/test_torch_dit.py's module docstring): JAX's
quantizer on the port's input bit-equal to the port's output, the port's
attention on its qkv (or q, k, v) held to JAX's kernel in interpret mode
under tests/test_torch_attention.py's criterion.  Stages are held by
tests/test_model_golden.py's ``_check``.  The unfused erf GELU
(``gelu_erf``) is within 8e-6 relative of ``jax.nn.gelu(approximate=False)``
(torch's and XLA's erfc differ by ulps on the CPU); the fused one (K6) is
held to JAX's kernel by ``_assert_grid_tie_parity`` (tests/
test_gelu_fusion.py: at most 0.1% one-step flips).

Each forward case runs in one tier; the other tier of the same kernels is
held to JAX in tests/test_torch_attention*.py and the chip runs both.
"""

import copy
import importlib
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mx_quantization_tpu.models.vit as jax_vit
from mx_quantization_tpu.attention import \
    TopKAttentionConfig as JaxAttnConfig
from mx_quantization_tpu.attention import \
    fused_qkv_topk_attention as jax_qkv_attention
from mx_quantization_tpu.attention import topk_attention as jax_topk
from mx_quantization_tpu.models.stacked import unstack_block
from mx_quantization_tpu.models.vit import VitConfig as JaxVitConfig
from mx_quantization_tpu.models.vit import VitQuantConfig as JaxQuantConfig
from mx_quantization_tpu.models.vit import init_vit as jax_init_vit
from mx_quantization_tpu.ops import layer_norm as jax_layer_norm
from mx_quantization_tpu.ops import linear as jax_linear
from mx_quantization_tpu.ops.fastquant import \
    quantize_mx_serving as jax_quantize
from mx_quantization_tpu.predictors.elsa import \
    create_structured_orthogonal_matrix
from mx_quantization_tpu.utils.prequantize import \
    prequantize_weights as jax_prequantize
from mx_quantization_tpu.workloads.deit import \
    default_mx_specs as jax_specs

import mx_quantization_tpu_torch.models.vit as port_vit
from mx_quantization_tpu_torch.models.vit import (VitConfig, VitQuantConfig,
                                                  vit_forward, vit_mlp)
from mx_quantization_tpu_torch.ops.linear import gelu_erf
from mx_quantization_tpu_torch.utils.checkpoint import vit_params_from_jax
from mx_quantization_tpu_torch.utils.prequantize import prequantize_weights
from mx_quantization_tpu_torch.workloads.deit import default_mx_specs
from test_gelu_fusion import _assert_grid_tie_parity, _interpret_gelu_serving
from test_torch_attention import assert_matches_jax
from test_torch_attention_split import assert_split_matches_jax
from test_torch_dit import _check, _np
from test_torch_dit512 import _one_torch_thread  # noqa: F401


CFG_KW = dict(img_size=32, patch_size=8, in_chans=3, num_classes=10,
              embed_dim=128, depth=3, num_heads=2)
JAX_LINEAR = importlib.import_module("mx_quantization_tpu.ops.linear")
PORT_LINEAR = importlib.import_module("mx_quantization_tpu_torch.ops.linear")

# name: (contract, plan keywords)
CASES = {
    "ex_pred": ("exact", dict(pred_mode="ex_pred")),
    "two_step_exclude_ex_pred": ("exact", dict(
        pred_mode="two_step_leading_ones", exclude_blocks=(1,))),
    "exclude_two_step_last_block": ("exact", dict(
        pred_mode="ex_pred", exclude_blocks=(0,),
        exclude_block_type="two_step_leading_ones")),
    "ELSA": ("serving", dict(pred_mode="ELSA")),
    "true_topk": ("exact", dict(approx_flag=False)),
}
# the port's attention entries each case takes, by block
ROUTES = {
    "ex_pred": ["fused_qkv_topk_attention"] * 3,
    "two_step_exclude_ex_pred": ["fused_qkv_topk_attention"] * 3,
    "exclude_two_step_last_block": ["fused_qkv_topk_attention"] * 3,
    "ELSA": ["topk_attention", "topk_attention", "fused_qkv_topk_attention"],
    "true_topk": ["fused_qkv_topk_attention"] * 3,
}


@pytest.fixture(scope="module")
def models():
    jcfg = JaxVitConfig(**CFG_KW)
    tree = jax_init_vit(jax.random.key(0), jcfg)
    rng = np.random.RandomState(0)

    def draw(path, a):
        name = jax.tree_util.keystr(path)
        if "norm" in name and "weight" in name:
            return (1 + 0.1 * rng.randn(*a.shape)).astype(np.float32)
        return (0.05 * rng.randn(*a.shape)).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, tree)
    model = vit_params_from_jax(tree, VitConfig(**CFG_KW), device="cpu")
    return jcfg, jax.tree.map(jnp.asarray, tree), model


def _images(seed, n=2):
    return np.random.RandomState(seed).randn(n, 3, 32, 32).astype(np.float32)


def record_calls(monkeypatch):
    """Record, in the order they return, every stage of the port's forward
    and every MX activation quantize and attention call inside them, as
    (name, args, kwargs, output)."""
    calls = []

    def record(module, name):
        def wrapped(*args, _real=getattr(module, name), **kwargs):
            out = _real(*args, **kwargs)
            calls.append((name, args, kwargs, out))
            return out
        monkeypatch.setattr(module, name, wrapped)

    for name in ("vit_embed", "vit_block", "vit_head",
                 "fused_qkv_topk_attention", "topk_attention"):
        record(port_vit, name)
    record(PORT_LINEAR, "quantize_mx_serving")
    return calls


def answer_jax(monkeypatch, pending):
    """Make JAX's activation quantizes and attention calls take the port's
    recorded answers from ``pending``, each checked first."""
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

    def qkv_attention(qkv, H, scale, specs, cfg):
        """JAX's qkv entry, answered by the port's (K2) call."""
        _, (qp, _, _, pspecs, pcfg), _, out = take("fused_qkv_topk_attention")

        def port(a):
            return port_vit.fused_qkv_topk_attention(
                torch.from_numpy(a), H, scale, pspecs, pcfg)
        _check(_np(qp), qkv)
        assert_matches_jax(
            lambda a: port(a).float(),
            lambda a: jax_qkv_attention(
                jnp.asarray(a), H, scale, specs, cfg).astype(jnp.float32),
            _np(qp), H, contract=pcfg.contract)
        return jnp.asarray(_np(out))

    def unanswered(*a, **kw):
        """JAX's topk_attention with its own quantizer (its top-k branch
        runs an XLA score product before it takes the kernel)."""
        answered = JAX_LINEAR.quantize_mx_serving
        JAX_LINEAR.quantize_mx_serving = jax_quantize
        try:
            return jax_topk(*a, **kw)[0]
        finally:
            JAX_LINEAR.quantize_mx_serving = answered

    def split_attention(q, k, v, scale, specs, cfg, orthogonal_matrix=None):
        _, (qp, kp, vp, _, pspecs, pcfg), pkw, (out, _) = take(
            "topk_attention")
        for a, b in ((qp, q), (kp, k), (vp, v)):
            _check(_np(a), b)
        om = pkw.get("orthogonal_matrix")
        assert (om is None) == (orthogonal_matrix is None)
        assert_split_matches_jax(
            lambda *a: port_vit.topk_attention(
                *map(torch.from_numpy, a[:3]), scale, pspecs, pcfg,
                orthogonal_matrix=om)[0],
            lambda *a: unanswered(*map(jnp.asarray, a[:3]), scale, specs,
                                  cfg, orthogonal_matrix=orthogonal_matrix),
            _np(qp), _np(kp), _np(vp), None, contract=pcfg.contract)
        return jnp.asarray(_np(out)), None

    monkeypatch.setattr(JAX_LINEAR, "quantize_mx_serving", quantize)
    monkeypatch.setattr(jax_vit, "fused_qkv_topk_attention", qkv_attention)
    monkeypatch.setattr(jax_vit, "topk_attention", split_attention)


def jax_block(bp, attn_cfg, x, jcfg, jq, om):
    """The body of JAX ``vit_forward``'s block loop (models/vit.py)."""
    mxs = jq.mx_specs if attn_cfg.mx_quant else None
    h = jax_layer_norm(x, bp["norm1"]["weight"], bp["norm1"]["bias"],
                       eps=jcfg.eps)
    x = x + jax_vit.vit_attention(bp["attn"], h, jcfg, jq.mx_specs, attn_cfg,
                                  om)
    h = jax_layer_norm(x, bp["norm2"]["weight"], bp["norm2"]["bias"],
                       eps=jcfg.eps)
    return x + jax_vit.vit_mlp(bp["mlp"], h, mxs, contract=attn_cfg.contract,
                               fuse_gelu=jq.fuse_gelu)


def jax_embed(p, x, jcfg):
    """JAX ``vit_forward``'s lines before the blocks."""
    B = x.shape[0]
    pe = p["patch_embed"]
    h = jax_vit.conv2d(x, pe["weight"], pe.get("bias"),
                       stride=jcfg.patch_size, mx_specs=None)
    h = h.reshape(B, jcfg.embed_dim, -1).transpose(0, 2, 1)
    cls = jnp.broadcast_to(p["cls_token"], (B, 1, jcfg.embed_dim))
    return jnp.concatenate([cls, h], axis=1) + p["pos_embed"]


def jax_head(p, h, jcfg):
    """JAX ``vit_forward``'s lines after the blocks."""
    h = jax_layer_norm(h, p["norm"]["weight"], p["norm"]["bias"],
                       eps=jcfg.eps)
    return jax_linear(h[:, 0], p["head"]["weight"], p["head"]["bias"],
                      mx_specs=None)


def check_stages(monkeypatch, calls, model, jparams, jcfg, jq, om):
    """Hold each recorded stage to the JAX stage run on its input, JAX's
    quantizes and attention calls answered by the port's."""
    pending = []
    answer_jax(monkeypatch, pending)
    stages = 0
    for name, args, kw, out in calls:
        if name in ("quantize_mx_serving", "fused_qkv_topk_attention",
                    "topk_attention"):
            pending.append((name, args, kw, out))
            continue
        stages += 1
        if name == "vit_embed":
            want = jax_embed(jparams, jnp.asarray(_np(args[1])), jcfg)
        elif name == "vit_block":
            blk, attn_cfg, x = args[:3]
            i = list(model.blocks).index(blk)
            want = jax_block(unstack_block(jparams["blocks"], i),
                             JaxAttnConfig(**attn_cfg._asdict()),
                             jnp.asarray(_np(x)), jcfg, jq, om)
        else:
            want = jax_head(jparams, jnp.asarray(_np(args[1])), jcfg)
        _check(_np(out), want)
        assert not pending, f"the port called {pending[0][0]}; JAX did not"
    monkeypatch.undo()
    assert stages == jcfg.depth + 2


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax_stage_by_stage(models, case, monkeypatch):
    jcfg, jparams, model = models
    contract, plan = CASES[case]
    D = jcfg.embed_dim // jcfg.num_heads
    om = None
    if plan.get("pred_mode") == "ELSA":
        om = create_structured_orthogonal_matrix(D)
    kw = dict(mx_quant=True, top_k=True, k=6, contract=contract, **plan)
    x = _images(1)
    calls = record_calls(monkeypatch)
    got = vit_forward(model, torch.from_numpy(x),
                      VitQuantConfig(mx_specs=default_mx_specs(), **kw),
                      None if om is None else torch.from_numpy(om))
    monkeypatch.undo()
    assert got.shape == (2, 10) and torch.isfinite(got).all()
    assert torch.equal(got, calls[-1][3])
    routes = [c[0] for c in calls if c[0] in ("fused_qkv_topk_attention",
                                              "topk_attention")]
    assert routes == ROUTES[case]
    # qkv, proj, fc1, fc2 of each block
    assert sum(c[0] == "quantize_mx_serving" for c in calls) == 4 * 3
    check_stages(monkeypatch, calls, model, jparams, jcfg,
                 JaxQuantConfig(mx_specs=jax_specs(), **kw),
                 None if om is None else jnp.asarray(om))


def test_unquantized_forward_matches_jax(models):
    """mx_quant=False: every product in full f32 (no MX grid to move), so
    the whole forward is held at once."""
    jcfg, jparams, model = models
    x = _images(2)
    got = vit_forward(model, torch.from_numpy(x), VitQuantConfig())
    want = jax_vit.vit_forward(jparams, jnp.asarray(x), jcfg,
                               JaxQuantConfig())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_block_attn_cfg_matches_jax():
    """Every block of a depth-12 plan, for every combination of the
    excluded blocks (the last one included), their type and the last-block
    rule, with and without MX quantization: the port's per-block attention
    config equals JAX's."""
    n = 0
    for mx_quant, exclude, etype, last in itertools.product(
            (True, False), ((), (0, 5), (11,), (3, 11)),
            ("ex_pred", "two_step_leading_ones"), (True, False)):
        kw = dict(mx_quant=mx_quant, top_k=True, k=30, pred_mode="ELSA",
                  exclude_blocks=exclude, exclude_block_type=etype,
                  last_block_no_topk=last, topk_key_bits=16,
                  contract="serving")
        port = VitQuantConfig(
            mx_specs=default_mx_specs() if mx_quant else None, **kw)
        jq = JaxQuantConfig(mx_specs=jax_specs() if mx_quant else None, **kw)
        for i in range(12):
            assert port.block_attn_cfg(i, 12)._asdict() == \
                jq.block_attn_cfg(i, 12)._asdict(), (kw, i)
            n += 1
    assert n == 12 * 32


def test_fused_gelu_mlp_matches_jax(models, monkeypatch):
    """``fuse_gelu`` in the serving tier: the MLP's erf GELU rides in fc2's
    input quantize (K6's plain version here) where its gate holds (8 rows
    of 17 tokens: the fc1 output has 69,632 >= 2^16 elements).  The port's
    MLP against JAX's, JAX's quantizes and fused GELU quantize answered by
    the port's (K6 held to JAX's kernel in interpret mode first).  The
    exact tier never takes K6."""
    jcfg, jparams, model = models
    rng = np.random.RandomState(4)
    h = rng.randn(8, 17, 128).astype(np.float32)
    specs, jspecs = default_mx_specs(), jax_specs()
    calls = record_calls(monkeypatch)

    def k6(*args, _real=PORT_LINEAR.gelu_quantize_serving, **kwargs):
        out = _real(*args, **kwargs)
        calls.append(("gelu_quantize_serving", args, kwargs, out))
        return out

    monkeypatch.setattr(PORT_LINEAR, "gelu_quantize_serving", k6)
    vit_mlp(model.blocks[0].mlp, torch.from_numpy(h), specs, "exact", True)
    assert "gelu_quantize_serving" not in [c[0] for c in calls]
    calls.clear()
    got = vit_mlp(model.blocks[0].mlp, torch.from_numpy(h), specs, "serving",
                  True)
    monkeypatch.undo()
    fused = [c for c in calls if c[0] == "gelu_quantize_serving"]
    assert len(fused) == 1 and fused[0][2]["approximate"] is False
    pending = [c for c in calls if c[0] != "gelu_quantize_serving"]
    answer_jax(monkeypatch, pending)

    def fused_gelu(x, s, approximate=True):
        assert approximate is False
        (xp, _), _, out = fused.pop(0)[1:]
        _check(_np(xp), x)
        _assert_grid_tie_parity(_interpret_gelu_serving(
            jnp.asarray(_np(xp)), s, approximate), _np(out))
        return jnp.asarray(_np(out)).astype(jnp.bfloat16)

    monkeypatch.setattr(jax_vit, "gelu_quantize_serving", fused_gelu)
    want = jax_vit.vit_mlp(unstack_block(jparams["blocks"], 0)["mlp"],
                           jnp.asarray(h), jspecs, contract="serving",
                           fuse_gelu=True)
    monkeypatch.undo()
    assert not pending and not fused, "the port made calls JAX did not"
    _check(_np(got), want)


def test_gelu_erf_matches_jax():
    """The unfused erf GELU against ``jax.nn.gelu(approximate=False)``:
    the same operations in the same order, but torch's and XLA's erfc
    differ by ulps on the CPU (at these draws up to 10 ulp for x > -5 and
    57 ulp at x = -11.7, where GELU is -1e-30): within 8e-6 relative
    (67 ulp)."""
    x = np.random.RandomState(7).randn(1 << 16).astype(np.float32) * 3
    got = gelu_erf(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False))
    np.testing.assert_allclose(got, want, rtol=8e-6, atol=0)


def test_prequantize_snaps_exactly_jax_set(models):
    """``prequantize_weights`` on a ``ViT`` snaps the block linears (qkv,
    proj, fc1, fc2: 4 per block) and nothing else, bit for bit JAX's: the
    patch embed and the head stay unquantized."""
    jcfg, jparams, model = models
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tree, _ = jax_prequantize(jparams, jax_specs())
    snapped, specs = prequantize_weights(copy.deepcopy(model),
                                         default_mx_specs())
    assert specs.prequantized_weights
    want = vit_params_from_jax(jax.tree.map(np.asarray, tree),
                               VitConfig(**CFG_KW), device="cpu").state_dict()
    changed = []
    for name, val in snapped.state_dict().items():
        assert torch.equal(val, want[name]), name
        if not torch.equal(val, before[name]):
            changed.append(name)
    assert sorted(changed) == sorted(
        f"blocks.{i}.{m}.weight" for i in range(3)
        for m in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"))


def test_params_carry_over_exactly(models):
    jcfg, jparams, model = models
    sd = model.state_dict()
    np.testing.assert_array_equal(
        sd["blocks.2.mlp.fc2.weight"].numpy(),
        np.asarray(jparams["blocks"]["mlp"]["fc2"]["weight"][2]))
    np.testing.assert_array_equal(sd["pos_embed"].numpy(),
                                  np.asarray(jparams["pos_embed"]))
    np.testing.assert_array_equal(sd["patch_embed.weight"].numpy(),
                                  np.asarray(jparams["patch_embed"]["weight"]))
