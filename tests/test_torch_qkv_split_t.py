"""The DiT opt-ins ``fuse_ln_modulate``, ``fuse_gelu`` and
``qkv_layout="split_t"`` (kernels K5, K6 and K7) against the JAX package.

  * K7's plain version against JAX's ``fused_topk_attention_qkv_t`` in
    interpret mode, by tests/test_torch_attention.py's criterion: every
    query row within 2e-5, except rows whose attention probabilities, read
    through a probe, flip by one grid step (the probe runs where a row is
    outside the tolerance: v set to one-hot columns, D keys per probe).
    K7's plain version equals K2's on the same values bit for bit.
  * ``_qkv_split_t`` against JAX's on the same activation, by
    tests/test_torch_linear.py's criterion (at least 99% of the outputs
    bit-equal, none more than one bf16 step apart: the f32 sums of the
    projection add in another order).
  * The whole opt-in forward, stage by stage, in tests/test_torch_dit.py's
    pattern (whole forwards are not compared end to end): on a tiny DiT
    (N = 256, hidden 288, 4 heads of D = 72, depth 2, weights prequantized
    to bf16) whose JAX parameter tree comes in through
    ``dit_params_from_jax``, every stage is held to the
    JAX stage run on the port's input, with JAX's K1, K5, K6 and K7 calls
    answered by the port's, and each answered call checked on its own: K1
    bit-equal, K5 and K6 by tests/test_torch_fused_quant.py's criterion,
    K7 as above, the (qk_t, v) JAX's ``_qkv_split_t`` makes from the
    port's K5 output against the port's.  The per-forward call counts are
    the ones ``chip_smoke.py`` holds the card to.
  * With the flags off, and where their gates fail, no K5, K6 or K7 call is
    made and the forward is bit-identical to the default plan's.
"""

import dataclasses
import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mx_quantization_tpu.models.dit as jax_dit
from mx_quantization_tpu.attention import \
    TopKAttentionConfig as JaxAttnConfig
from mx_quantization_tpu.models.dit import DiTConfig as JaxDiTConfig
from mx_quantization_tpu.models.dit import DiTQuantConfig as JaxQuantConfig
from mx_quantization_tpu.models.dit import _dit_block_step as jax_block_step
from mx_quantization_tpu.models.dit import init_dit as jax_init_dit
from mx_quantization_tpu.models.stacked import unstack_block
from mx_quantization_tpu.ops import linear as jax_linear
from mx_quantization_tpu.ops.fastquant import \
    quantize_mx_serving as jax_quantize
from mx_quantization_tpu.ops.kernels.quantize import \
    ln_modulate_quantize_pallas
from mx_quantization_tpu.ops.kernels.topk_attention import \
    fused_topk_attention_qkv_t as jax_k7
from mx_quantization_tpu.utils.prequantize import \
    prequantize_weights as jax_prequantize
from mx_quantization_tpu.workloads.dit import dit_mx_specs as jax_specs

import mx_quantization_tpu_torch.models.dit as port_dit
import mx_quantization_tpu_torch.ops.kernels.topk_attention as ta
from mx_quantization_tpu_torch.models.dit import (DiTConfig, DiTQuantConfig,
                                                  dit_forward)
from mx_quantization_tpu_torch.ops.kernels.quantize import mx_quantize_ref
from mx_quantization_tpu_torch.ops.kernels.topk_attention import (
    fused_topk_attention_qkv_ref, fused_topk_attention_qkv_t,
    fused_topk_attention_qkv_t_ref)
from mx_quantization_tpu_torch.utils.checkpoint import dit_params_from_jax
from mx_quantization_tpu_torch.utils.prequantize import prequantize_weights
from mx_quantization_tpu_torch.workloads.dit import dit_mx_specs
from test_gelu_fusion import _assert_grid_tie_parity, _interpret_gelu_serving
from test_torch_attention import TOL, check_rows
from test_torch_dit import _check, _jax_embed, _np
from test_torch_linear import _assert_bf16_close

JAX_LINEAR = importlib.import_module("mx_quantization_tpu.ops.linear")
JAX_FASTQUANT = importlib.import_module("mx_quantization_tpu.ops.fastquant")
JAX_ATTN_KERNELS = importlib.import_module(
    "mx_quantization_tpu.ops.kernels.topk_attention")
PORT_LINEAR = importlib.import_module("mx_quantization_tpu_torch.ops.linear")
CFG_KW = dict(input_size=32, patch_size=2, in_channels=4, depth=2,
              num_heads=2, num_classes=10)  # N = 256 tokens
OPT_INS = dict(fuse_ln_modulate=True, fuse_gelu=True, qkv_layout="split_t")
QKW = dict(mx_quant=True, top_k=True, k=20, ex_pred=True,
           exclude_blocks=(1,), topk_key_bits=8)


def split_t_operands(qkv: np.ndarray, H: int, Dp: int):
    """A (B, N, 3*H*D) fused-qkv array as K7's qk_t (2*H*Dp, B, N), each
    head's rows past D zero, and v (B, N, H*D)."""
    B, N, F = qkv.shape
    D = F // (3 * H)
    qk = np.zeros((B, N, 2, H, Dp), np.float32)
    qk[..., :D] = qkv[..., :2 * H * D].reshape(B, N, 2, H, D)
    qk_t = np.ascontiguousarray(qk.transpose(2, 3, 4, 0, 1)).reshape(
        2 * H * Dp, B, N)
    return qk_t, np.ascontiguousarray(qkv[..., 2 * H * D:])


def assert_k7_matches_jax(port, jax_fn, qk_t, v, H, contract="exact",
                          mbits=8, block_size=32):
    """port, jax_fn: (qk_t, v) float32 arrays -> (B, N, H*D) float32.  The
    criterion of the module docstring."""
    B, N, F = v.shape
    D = F // H

    def cells(a, width):  # (B, N, H*width) -> (B*H, N, width)
        return np.asarray(a, np.float32).reshape(B, N, H, width).transpose(
            0, 2, 1, 3).reshape(B * H, N, width)

    got, want = cells(port(qk_t, v), D), cells(jax_fn(qk_t, v), D)
    if np.isclose(got, want, **TOL).all():
        return
    pg, pw = [], []
    for c0 in range(0, N, D):
        keys = np.arange(c0, min(c0 + D, N))
        probe = np.zeros((B, N, H, D), np.float32)
        probe[:, keys, :, keys - c0] = 1.0
        probe = probe.reshape(B, N, F)
        pg.append(cells(port(qk_t, probe), D)[..., :len(keys)])
        pw.append(cells(jax_fn(qk_t, probe), D)[..., :len(keys)])
    vmax = np.abs(v.reshape(B, N, H, D)).max(axis=(1, 3)).reshape(B * H)
    check_rows(got, want, np.concatenate(pg, -1), np.concatenate(pw, -1),
               vmax, mbits, contract, block_size=block_size)


def _k7_kw(k, D, contract, n_valid):
    return dict(k=k, scale=D ** -0.5, n_valid=n_valid, key_bits=8, bfloat=16,
                contract=contract)


@pytest.mark.parametrize("N,D,k,contract", [
    (128, 32, 20, "exact"), (128, 32, 20, "serving"),
    (256, 72, 20, "exact"), (256, 72, 20, "serving"),
    (256, 72, 256, "exact"), (256, 72, 256, "serving"),  # dense branch
])
def test_k7_plain_matches_jax_kernel(N, D, k, contract):
    H, Dp = 2, -(-D // 32) * 32
    qkv = np.random.RandomState(N + D + k).randn(2, N, 3 * H * D).astype(
        np.float32)
    qk_t, v = split_t_operands(qkv, H, Dp)
    kw = _k7_kw(k, D, contract, N)
    assert_k7_matches_jax(
        lambda a, b: fused_topk_attention_qkv_t_ref(
            torch.from_numpy(a), torch.from_numpy(b), H, **kw),
        lambda a, b: jax_k7(jnp.asarray(a), jnp.asarray(b), H, **kw),
        qk_t, v, H, contract)


def test_k7_plain_masks_keys_past_n_valid_like_jax():
    """Tokens past n_valid are zero (the projection's padding) and masked
    as keys; their query rows are still computed, as JAX's are."""
    H, D, N = 2, 72, 128
    qkv = np.random.RandomState(3).randn(2, N, 3 * H * D).astype(np.float32)
    qkv[:, 100:] = 0.0
    qk_t, v = split_t_operands(qkv, H, 96)
    kw = _k7_kw(20, D, "exact", 100)
    assert_k7_matches_jax(
        lambda a, b: fused_topk_attention_qkv_t_ref(
            torch.from_numpy(a), torch.from_numpy(b), H, **kw),
        lambda a, b: jax_k7(jnp.asarray(a), jnp.asarray(b), H, **kw),
        qk_t, v, H)


@pytest.mark.parametrize("contract", ["exact", "serving"])
@pytest.mark.parametrize("k", [9, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k7_plain_equals_k2_plain(contract, k, dtype):
    H, D, N = 2, 72, 64
    qkv = np.random.RandomState(k).randn(2, N, 3 * H * D).astype(np.float32)
    qk_t, v = split_t_operands(qkv, H, 96)
    kw = dict(k=k, scale=D ** -0.5, key_bits=8, bfloat=16, contract=contract)
    got = fused_topk_attention_qkv_t(torch.from_numpy(qk_t).to(dtype),
                                     torch.from_numpy(v).to(dtype), H,
                                     n_valid=N, **kw)
    want = fused_topk_attention_qkv_ref(torch.from_numpy(qkv).to(dtype), H,
                                        **kw)
    assert torch.equal(got, want)


def test_k7_refuses_what_the_port_does_not_serve():
    z = torch.zeros(2 * 2 * 96, 1, 384, device="meta")
    with pytest.raises(ValueError):  # neither a CPU nor a CUDA tensor
        fused_topk_attention_qkv_t(z, torch.zeros(1, 384, 144, device="meta"),
                                   2, k=20, scale=0.1, n_valid=384)
    with pytest.raises(NotImplementedError):  # ELSA is the split entry's
        fused_topk_attention_qkv_t_ref(
            torch.zeros(384, 1, 64), torch.zeros(1, 64, 144), 2, k=9,
            scale=0.1, n_valid=64, pred_mode="ELSA")
    with pytest.raises(NotImplementedError):  # past the TPU entry's 512
        ta._qkv_lib("K7", 640, 640, 72, dict(
            k=20, approx=True, pred_mode="ex_pred", key_bits=8,
            contract="exact", ebits=0))


@pytest.mark.parametrize("prequantized", [False, True])
@pytest.mark.parametrize("weights_bf16", [False, True])
def test_qkv_split_t_matches_jax(prequantized, weights_bf16):
    B, N, C, H, D = 2, 128, 128, 2, 72
    rng = np.random.RandomState(7)
    x = rng.randn(B, N, C).astype(np.float32)
    w = (0.05 * rng.randn(3 * H * D, C)).astype(np.float32)
    b = (0.1 * rng.randn(3 * H * D)).astype(np.float32)
    specs, jspecs = dit_mx_specs(), jax_specs()
    if prequantized:  # an activation already on the MX grid (K5's output)
        x = _np(mx_quantize_ref(torch.from_numpy(x), bfloat=16))
    if weights_bf16:
        jp, jspecs = jax_prequantize({"qkv": {"weight": jnp.asarray(w)}},
                                     jspecs, serve_dtype=jnp.bfloat16)
        w = np.asarray(jp["qkv"]["weight"], np.float32)
        specs = specs.replace(prequantized_weights=True)
    qkv = torch.nn.Module()
    qkv.weight = torch.nn.Parameter(torch.from_numpy(w).to(
        torch.bfloat16 if weights_bf16 else torch.float32),
        requires_grad=False)
    qkv.bias = torch.nn.Parameter(torch.from_numpy(b), requires_grad=False)
    qk_t, v, Dp = port_dit._qkv_split_t(torch.from_numpy(x), qkv, specs, H,
                                        D, prequantized)
    jqk_t, jv, jDp = jax_dit._qkv_split_t(
        jnp.asarray(x), {"weight": jnp.asarray(w).astype(
            jnp.bfloat16 if weights_bf16 else jnp.float32),
            "bias": jnp.asarray(b)}, jspecs, H, D, prequantized)
    assert Dp == jDp == 96 and qk_t.shape == (2 * H * Dp, B, N)
    assert not qk_t.reshape(2 * H, Dp, B, N)[:, D:].any()  # padded rows
    _assert_bf16_close(qk_t.numpy(), jqk_t)
    _assert_bf16_close(v.numpy(), jv)


# ----------------------------------------------------------------------
# the opt-in forward, stage by stage
# ----------------------------------------------------------------------
@functools.cache
def models(hidden, heads):
    """A random JAX parameter tree and the port's model loaded from it
    (hidden % 32 == 0, as K5's gate and the card's K1 need), each with its
    weights prequantized to bf16 as at the bench point; returns the JAX
    config, tree and specs and the port's model and specs."""
    kw = {**CFG_KW, "hidden_size": hidden, "num_heads": heads}
    jcfg = JaxDiTConfig(**kw)
    tree = jax_init_dit(jax.random.key(0), jcfg)
    rng = np.random.RandomState(0)
    tree = jax.tree.map(
        lambda a: (0.05 * rng.randn(*a.shape)).astype(np.float32), tree)
    model = dit_params_from_jax(tree, DiTConfig(**kw), device="cpu")
    model, specs = prequantize_weights(model, dit_mx_specs(),
                                       serve_dtype=torch.bfloat16)
    jtree, jspecs = jax_prequantize(jax.tree.map(jnp.asarray, tree),
                                    jax_specs(), serve_dtype=jnp.bfloat16)
    return jcfg, jtree, jspecs, model, specs


def record_stages(monkeypatch):
    """Record, in the order they return, the port's DiT stages and every
    K1, K5, K6 and K7 call and split-emission projection inside them, as
    (name, args, kwargs, output)."""
    calls = []

    def record(module, name):
        def wrapped(*args, _real=getattr(module, name), **kwargs):
            out = _real(*args, **kwargs)
            calls.append((name, args, kwargs, out))
            return out
        monkeypatch.setattr(module, name, wrapped)

    for name in ("dit_embed", "dit_block_step", "dit_final_layer",
                 "ln_modulate_quantize", "_qkv_split_t",
                 "fused_topk_attention_qkv_t", "quantize_mx_serving"):
        record(port_dit, name)
    record(PORT_LINEAR, "quantize_mx_serving")
    record(PORT_LINEAR, "gelu_quantize_serving")
    return calls


def answer_jax(monkeypatch, pending, jq):
    """JAX's K1, K6 and K7 calls take the port's recorded answers from
    ``pending``, each checked first (module docstring); returns the
    ``lnmod_fn`` of JAX's ``dit_forward`` with its K5 calls answered the
    same way."""
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

    def lnmod(x, shift, scale):
        if jq.contract != "serving":  # JAX's gate at bfloat=16
            return jax_dit.modulate(jax_dit._ln(x), shift, scale), False
        _, (xp, shp, scp, *args), kwargs, out = take("ln_modulate_quantize")
        for a, b in ((xp, x), (shp, shift), (scp, scale)):
            _check(_np(a), b)
        _assert_grid_tie_parity(ln_modulate_quantize_pallas(
            *(jnp.asarray(_np(a)) for a in (xp, shp, scp)), *args,
            **kwargs), _np(out))
        return jnp.asarray(_np(out)).astype(jnp.bfloat16), True

    def gelu_quantize(h, specs, approximate=True):
        _, (hp, _), _, out = take("gelu_quantize_serving")
        _check(_np(hp), h)
        _assert_grid_tie_parity(_interpret_gelu_serving(
            jnp.asarray(_np(hp)), specs, approximate), _np(out))
        return jnp.asarray(_np(out)).astype(jnp.bfloat16)

    def attention_t(qk_t, v, H, **kw):
        _, _, _, (pqk, pv, _) = take("_qkv_split_t")
        _assert_bf16_close(_np(pqk), qk_t)  # same activation, same weights
        _assert_bf16_close(_np(pv), v)
        _, (aqk, av, aH), akw, out = take("fused_topk_attention_qkv_t")
        assert aH == H and akw["n_valid"] == kw["n_valid"]
        assert_k7_matches_jax(
            lambda a, b: fused_topk_attention_qkv_t(
                torch.from_numpy(a), torch.from_numpy(b), H, **akw).float(),
            lambda a, b: jax_k7(jnp.asarray(a), jnp.asarray(b), H,
                                **kw).astype(jnp.float32),
            _np(aqk), _np(av), H, kw["contract"])
        return jnp.asarray(_np(out)).astype(kw["out_dtype"])

    monkeypatch.setattr(JAX_LINEAR, "quantize_mx_serving", quantize)
    monkeypatch.setattr(JAX_FASTQUANT, "quantize_mx_serving", quantize)
    monkeypatch.setattr(jax_dit, "gelu_quantize_serving", gelu_quantize)
    monkeypatch.setattr(JAX_ATTN_KERNELS, "fused_topk_attention_qkv_t",
                        attention_t)
    return lnmod


def _jax_final_layer(p, h, c, jcfg, specs, lnmod):
    """JAX dit_forward's final-layer lines, K5 included."""
    fl = p["final_layer"]
    mod = jax_linear(jax.nn.silu(c), fl["adaLN"]["weight"],
                     fl["adaLN"]["bias"], mx_specs=specs)
    shift, scale = jnp.split(mod.astype(h.dtype), 2, axis=-1)
    h, preq = lnmod(h, shift, scale)
    h = jax_linear(h, fl["linear"]["weight"], fl["linear"]["bias"],
                   mx_specs=specs.replace(prequantized_activations=preq)
                   ).astype(jnp.float32)
    B, c_out, psz = h.shape[0], jcfg.out_channels, jcfg.patch_size
    g = int(h.shape[1] ** 0.5)
    h = jnp.einsum("nhwpqc->nchpwq", h.reshape(B, g, g, psz, psz, c_out))
    return h.reshape(B, c_out, g * psz, g * psz)


def check_stages(monkeypatch, calls, model, jparams, jcfg, jq):
    """Hold each recorded stage to the JAX stage run on its input, JAX's
    kernel calls answered by the port's (module docstring)."""
    pending = []
    lnmod = answer_jax(monkeypatch, pending, jq)
    answered = ("quantize_mx_serving", "ln_modulate_quantize",
                "gelu_quantize_serving", "_qkv_split_t",
                "fused_topk_attention_qkv_t")
    stages = 0
    for name, args, kw, out in calls:
        if name in answered:
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
            want = jax_block_step(
                unstack_block(jparams["blocks"],
                              list(model.blocks).index(blk)),
                JaxAttnConfig(**attn_cfg._asdict()), jnp.asarray(_np(x)),
                jnp.asarray(_np(cb)), cfg=jcfg, specs=jq.mx_specs,
                act_dtype=jnp.float32, lnmod_fn=lnmod,
                qkv_layout=jq.qkv_layout, fuse_gelu=jq.fuse_gelu)
            _check(_np(out), want)
        else:
            _, h, c, _ = args
            _check(_np(out), _jax_final_layer(
                jparams, jnp.asarray(_np(h)), jnp.asarray(_np(c)), jcfg,
                jq.mx_specs, lnmod))
        assert not pending, f"the port called {pending[0][0]}; JAX did not"
    monkeypatch.undo()
    assert stages == jcfg.depth + 2


def _inputs(seed):
    """One image: the fc1 output still holds 2^16 elements (K6's gate)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(1, 4, 32, 32).astype(np.float32)
    t = rng.randint(0, 300, size=1).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(t), torch.tensor([3])


def _count(calls, name):
    return sum(c[0] == name for c in calls)


@pytest.mark.parametrize("contract", ["serving", "exact"])
def test_opt_in_forward_matches_jax_stage_by_stage(contract, monkeypatch):
    jcfg, jparams, jspecs, model, specs = models(288, 4)  # D = 72, Dp = 96
    calls = record_stages(monkeypatch)
    got = dit_forward(model, *_inputs(1), DiTQuantConfig(
        mx_specs=specs, contract=contract, **QKW, **OPT_INS))
    monkeypatch.undo()
    assert got.shape == (1, 8, 32, 32) and torch.isfinite(got).all()
    assert torch.equal(got, calls[-1][3])
    # the per-forward counts chip_smoke.py holds the card to: serving K5
    # 2 * depth + 1, K6 depth, K7 depth, K1 depth + 1 (proj, final adaLN);
    # exact K7 depth, K1 4 * depth + 2, K5 and K6 none
    depth, serving = jcfg.depth, contract == "serving"
    assert _count(calls, "ln_modulate_quantize") == serving * (2 * depth + 1)
    assert _count(calls, "gelu_quantize_serving") == serving * depth
    assert _count(calls, "fused_topk_attention_qkv_t") == depth
    assert _count(calls, "quantize_mx_serving") == (
        depth + 1 if serving else 4 * depth + 2)
    check_stages(monkeypatch, calls, model, jparams, jcfg, JaxQuantConfig(
        mx_specs=jspecs, contract=contract, **QKW, **OPT_INS))


def test_flags_off_and_failing_gates_leave_the_forward_unchanged(
        monkeypatch):
    """Default plan: no K5, K6 or K7 call.  All three flags where none of
    their gates holds (the exact tier at bfloat=16, N = 16 tokens): the
    same calls and the same bits as the default plan."""
    cfg = DiTConfig(**{**CFG_KW, "input_size": 8, "hidden_size": 64})
    model = port_dit.init_dit(cfg, torch.Generator().manual_seed(0), "cpu",
                              randomize_all=True)
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 4, 8, 8).astype(
        np.float32))
    t, y = torch.tensor([10.0, 200.0]), torch.tensor([1, 2])
    base = DiTQuantConfig(mx_specs=dit_mx_specs(), contract="exact", **QKW)
    runs = []
    for qc in (base, dataclasses.replace(base, **OPT_INS)):
        calls = record_stages(monkeypatch)
        runs.append((dit_forward(model, x, t, y, qc), [c[0] for c in calls]))
        monkeypatch.undo()
    (a, names_a), (b, names_b) = runs
    for name in ("ln_modulate_quantize", "gelu_quantize_serving",
                 "_qkv_split_t", "fused_topk_attention_qkv_t"):
        assert name not in names_a + names_b
    assert names_a == names_b
    assert torch.equal(a, b)
