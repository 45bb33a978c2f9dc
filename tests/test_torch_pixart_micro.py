"""PixArt-alpha 1024^2's micro-conditioning in the port against the JAX
package, on a tiny ``PixArtConfig(micro_conds=True)`` (2 layers, 2 heads of
72, tests/test_torch_pixart.py's config): the parameters carried over from
JAX's ``init_pixart``, the forward stage by stage (that module's
``check_stages``: each stage held to JAX's on the port's input, JAX's MX
quantizes and attention calls answered by the port's, checked first), the
``resolution`` / ``aspect_ratio`` defaults and an explicit non-square value,
and the diffusers-name loader against JAX's on a state dict with the
embedders.  The PixArt CLI's 1024^2 operating-point options reach the
sampler.  Then ELSA through each workload: a tiny PixArt through
``sample_pixart`` and a tiny DiT through ``sample_dit``, their ELSA
attention calls held to JAX's ``topk_attention`` with the same projection
under tests/test_torch_attention_split.py's criterion.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mx_quantization_tpu.attention as jax_attention
import mx_quantization_tpu.models.pixart as jax_pixart
from mx_quantization_tpu.models.pixart import PixArtConfig as JaxConfig
from mx_quantization_tpu.models.pixart import \
    PixArtQuantConfig as JaxQuantConfig
from mx_quantization_tpu.ops.kernels.topk_attention import \
    fused_topk_attention as jax_kernel
from mx_quantization_tpu.predictors.elsa import \
    create_structured_orthogonal_matrix as jax_matrix
from mx_quantization_tpu.utils.checkpoint import \
    load_pixart_checkpoint as jax_load
from mx_quantization_tpu.workloads.dit import dit_mx_specs as jax_dit_specs
from mx_quantization_tpu.workloads.pixart import pixart_mx_specs as jax_specs

import mx_quantization_tpu_torch.models.dit as port_dit
import mx_quantization_tpu_torch.models.pixart as port_pixart
from mx_quantization_tpu_torch.models.dit import (DiTConfig, DiTQuantConfig,
                                                  init_dit)
from mx_quantization_tpu_torch.models.pixart import (PixArt, PixArtConfig,
                                                     PixArtQuantConfig,
                                                     init_pixart,
                                                     pixart_embed,
                                                     pixart_forward)
from mx_quantization_tpu_torch.utils.checkpoint import (
    load_pixart_checkpoint, pixart_params_from_jax)
import mx_quantization_tpu_torch.workloads.pixart as port_workload
from mx_quantization_tpu_torch.predictors.elsa import orthogonal_matrix
from mx_quantization_tpu_torch.utils.prequantize import prequantize_weights
from mx_quantization_tpu_torch.workloads.dit import dit_mx_specs, sample_dit
from mx_quantization_tpu_torch.workloads.pixart import (pixart_mx_specs,
                                                        sample_pixart)
from test_torch_attention_split import assert_split_matches_jax
from test_torch_dit import _check
from test_torch_pixart import (CFG_KW, QKW, SD, _jax_embed, _leaf,
                               check_stages, pixart_inputs, record_calls)

MICRO_KW = {**CFG_KW, "micro_conds": True}


@pytest.fixture(scope="module")
def micro_models():
    jcfg = JaxConfig(**MICRO_KW)
    tree = jax.tree.map(np.asarray, jax_pixart.init_pixart(
        jax.random.key(3), jcfg))
    model = pixart_params_from_jax(tree, PixArtConfig(**MICRO_KW),
                                   device="cpu")
    return jcfg, jax.tree.map(jnp.asarray, tree), tree, model


def test_params_from_jax_carry_over_exactly(micro_models):
    *_, tree, model = micro_models
    sd = model.state_dict()
    assert len(sd) == 15 + 8 + 21 * 2  # the embedders' 4 linears
    assert model.adaln_single.res_mlp0.weight.shape == (48, 256)
    for name, val in sd.items():
        np.testing.assert_array_equal(val.numpy(), _leaf(tree, name))


def test_forward_matches_jax_stage_by_stage(micro_models, monkeypatch):
    """The default resolution and aspect ratio, exact tier (the serving
    tier's blocks are held in tests/test_torch_pixart.py)."""
    jcfg, jparams, _, model = micro_models
    x, enc, t, mask = pixart_inputs(4)
    calls = record_calls(monkeypatch)
    got = pixart_forward(model, *map(torch.from_numpy, (x, enc, t)),
                         PixArtQuantConfig(mx_specs=pixart_mx_specs(), **QKW),
                         encoder_attention_mask=torch.from_numpy(mask))
    monkeypatch.undo()
    assert got.shape == (2, 8, 8, 8) and torch.isfinite(got).all()
    assert calls[0][0] == "pixart_embed"
    stages = check_stages(monkeypatch, calls, model, jparams, jcfg,
                          JaxQuantConfig(mx_specs=jax_specs(), **QKW))
    assert stages == 2 + jcfg.num_layers


def test_resolution_and_aspect_ratio_defaults(micro_models):
    """The defaults are the native pixel size 8 * sample_size, square, and
    aspect ratio 1; an explicit non-square value moves the conditioning,
    and the embedding stage is held to JAX's at it."""
    jcfg, jparams, _, model = micro_models
    x, enc, t, _ = map(torch.from_numpy, pixart_inputs(5))
    q = PixArtQuantConfig()
    emb = pixart_embed(model, x, enc, t, q)[3]
    same = pixart_embed(model, x, enc, t, q,
                        resolution=torch.full((2, 2), 64.0),
                        aspect_ratio=torch.ones(2, 1))[3]
    assert torch.equal(emb, same)
    size = dict(resolution=torch.tensor([[64.0, 48.0], [48.0, 64.0]]),
                aspect_ratio=torch.tensor([[0.75], [4.0 / 3.0]]))
    other = pixart_embed(model, x, enc, t, q, **size)
    assert not torch.allclose(emb, other[3])
    want = _jax_embed(jparams, *(jnp.asarray(a.numpy()) for a in (x, enc, t)),
                      jcfg, **{k: jnp.asarray(v.numpy())
                               for k, v in size.items()})
    for got, w in zip(other, want):
        _check(got.numpy(), w)
    # without micro-conditioning the embedding ignores them
    plain = pixart_params_from_jax(
        jax.tree.map(np.asarray, jax_pixart.init_pixart(
            jax.random.key(3), JaxConfig(**CFG_KW))),
        PixArtConfig(**CFG_KW), device="cpu")
    assert not PixArtConfig(**CFG_KW).use_additional_conditions
    assert torch.equal(pixart_embed(plain, x, enc, t, q)[3],
                       pixart_embed(plain, x, enc, t, q,
                                    resolution=torch.ones(2, 2))[3])
    # 1024^2 (sample_size 128) turns it on by default, as diffusers does
    big = PixArtConfig(sample_size=128, num_layers=1,
                       num_attention_heads=1, caption_channels=8)
    assert big.use_additional_conditions and not dataclasses.replace(
        big, micro_conds=False).use_additional_conditions
    assert PixArt(big, device="cpu").adaln_single.ar_mlp2.weight.shape == \
        (24, 24)


def test_loader_maps_the_embedders_as_jax(tmp_path):
    sd = torch.load(SD, map_location="cpu", weights_only=True)
    gen = torch.Generator().manual_seed(4)
    for name in ("resolution", "aspect_ratio"):
        pre = f"adaln_single.emb.{name}_embedder."
        sd[pre + "linear_1.weight"] = torch.randn(48, 256, generator=gen)
        sd[pre + "linear_1.bias"] = torch.randn(48, generator=gen)
        sd[pre + "linear_2.weight"] = torch.randn(48, 48, generator=gen)
        sd[pre + "linear_2.bias"] = torch.randn(48, generator=gen)
    path = str(tmp_path / "pixart_micro_sd.pt")
    torch.save(sd, path)
    ours = load_pixart_checkpoint(path, num_layers=2)
    want = jax_load(path, num_layers=2)
    model = PixArt(PixArtConfig(**MICRO_KW), device="cpu")
    model.load_state_dict(ours)  # every name, every shape
    assert "adaln_single.ar_mlp2.bias" in ours
    for name, val in ours.items():
        np.testing.assert_array_equal(val.numpy(), _leaf(want, name))


def _record(monkeypatch, module):
    calls = []

    def wrapped(*args, _real=module.topk_attention, **kwargs):
        out = _real(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out
    monkeypatch.setattr(module, "topk_attention", wrapped)
    return calls


def _elsa_calls_match_jax(calls, proj, jax_specs_):
    """The ELSA calls (top-k with the predictor on) took ``proj``; the
    first, replayed, is held to JAX's kernel with the same matrix and the
    keywords JAX's ``topk_attention`` gives it (its XLA score product
    before the kernel is left out)."""
    elsa = [c for c in calls if c[0][5].top_k and c[0][5].approx_flag]
    assert elsa and all(c[1]["orthogonal_matrix"] is proj for c in elsa)
    (q, k, v, scale, specs, cfg), kw, (out, _) = elsa[0]
    assert cfg.pred_mode == "ELSA"
    assert torch.equal(out, port_pixart.topk_attention(
        q, k, v, scale, specs, cfg, orthogonal_matrix=proj)[0])
    jkw = dict(k=cfg.k, scale=scale, block_size=jax_specs_.block_size,
               scale_bits=jax_specs_.effective_scale_bits(), approx=True,
               pred_mode="ELSA", key_bits=cfg.key_bits, contract=cfg.contract,
               **jax_attention._kernel_elemwise_args(jax_specs_),
               **jax_attention._kernel_format_args(jax_specs_))
    assert_split_matches_jax(
        lambda *a: port_pixart.topk_attention(
            *map(torch.from_numpy, a[:3]), scale, specs, cfg,
            orthogonal_matrix=proj)[0],
        lambda *a: jax_kernel(*map(jnp.asarray, a[:3]), None,
                              jnp.asarray(proj.numpy()), **jkw),
        *(t.numpy() for t in (q, k, v)), None, contract=cfg.contract)
    return len(elsa)


def test_elsa_through_sample_pixart_matches_jax(monkeypatch):
    model = init_pixart(PixArtConfig(**CFG_KW),
                        torch.Generator().manual_seed(6), "cpu")
    proj = torch.from_numpy(jax_matrix(72))
    x, enc, _, mask = pixart_inputs(7)
    calls = _record(monkeypatch, port_pixart)
    qcfg = PixArtQuantConfig(mx_specs=pixart_mx_specs(),
                             **{**QKW, "pred_mode": "ELSA"})
    lat = sample_pixart(model, qcfg, torch.from_numpy(enc),
                        torch.from_numpy(mask), torch.zeros(1, 12, 32),
                        num_steps=2, latents=torch.from_numpy(x),
                        device="cpu", orthogonal_matrix=proj)
    monkeypatch.undo()
    assert torch.isfinite(lat).all()
    # block 0's self-attention in each of the 2 steps (block 1 excluded)
    assert _elsa_calls_match_jax(calls, proj, jax_specs()) == 2


def test_elsa_through_sample_dit_matches_jax(monkeypatch):
    cfg = DiTConfig(input_size=8, hidden_size=128, depth=2, num_heads=2,
                    num_classes=10)
    model = init_dit(cfg, torch.Generator().manual_seed(8), "cpu",
                     randomize_all=True)
    proj = torch.from_numpy(jax_matrix(64))
    calls = _record(monkeypatch, port_dit)
    qcfg = DiTQuantConfig(mx_specs=dit_mx_specs(), mx_quant=True,
                          top_k=True, k=6, ex_pred=True, pred_mode="ELSA",
                          exclude_blocks=(1,))
    lat = sample_dit(model, qcfg, [1, 3], torch.Generator().manual_seed(9),
                     num_steps=2, device="cpu", orthogonal_matrix=proj)
    monkeypatch.undo()
    assert torch.isfinite(lat).all()
    assert _elsa_calls_match_jax(calls, proj, jax_dit_specs()) == 2


def test_cli_takes_the_operating_point_options(tmp_path, monkeypatch):
    """--key-bits, --activation-dtype, --prequantize and --pred-mode ELSA
    reach ``sample_pixart`` (a tiny model on the CPU), and the latents
    written are the sampler's."""
    seen = []

    def wrapped(model, qcfg, *args, _real=port_workload.sample_pixart,
                **kwargs):
        lat = _real(model, qcfg, *args, **kwargs)
        seen.append((model, qcfg, kwargs["orthogonal_matrix"], lat))
        return lat
    monkeypatch.setattr(port_workload, "sample_pixart", wrapped)
    out = tmp_path / "lat.npz"
    port_workload.main([
        "--device", "cpu", "--num-layers", "2", "--num-heads", "2",
        "--caption-channels", "32", "--image-size", "64",
        "--max-token-length", "12", "--num-steps", "2", "--mx-quant",
        "--self-top-k", "--self-k", "6", "--exclude-blocks", "1",
        "--pred-mode", "ELSA", "--key-bits", "8", "--activation-dtype",
        "bfloat16", "--prequantize", "--contract", "serving",
        "--out", str(out)])
    (model, qcfg, proj, lat), = seen
    assert (qcfg.topk_key_bits, qcfg.activation_dtype, qcfg.pred_mode,
            qcfg.contract) == (8, "bfloat16", "ELSA", "serving")
    want_model, want_specs = prequantize_weights(
        init_pixart(model.cfg, torch.Generator().manual_seed(0), "cpu"),
        pixart_mx_specs(), serve_dtype=torch.bfloat16)
    assert qcfg.mx_specs == want_specs and want_specs.prequantized_weights
    got_sd, want_sd = model.state_dict(), want_model.state_dict()
    assert got_sd.keys() == want_sd.keys()
    assert all(torch.equal(got_sd[n], want_sd[n]) for n in want_sd)
    assert any(t.dtype == torch.bfloat16 for t in got_sd.values())
    assert torch.equal(proj, orthogonal_matrix(72, "cpu"))
    np.testing.assert_array_equal(np.load(out)["latents"], lat.numpy())
    assert lat.shape == (1, 4, 8, 8) and torch.isfinite(lat).all()
