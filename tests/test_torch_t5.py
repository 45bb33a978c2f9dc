"""The port's T5 v1.1 encoder (``models/t5.py``) and PixArt's T5 prompt
encoding (``encode_prompts_t5``, the CLI's ``--t5-path``) against the JAX
package's, on the CPU at a tiny config (vocab 256, d_model 64, d_kv 16,
d_ff 128, 3 layers, 4 heads, 8 buckets, max distance 32), the weights from
JAX's ``init_t5_encoder`` (scaled by 10 so that the attention is not
uniform) carried over by ``t5_params_from_jax``.

Tolerances:
  * the bucket table: equal, for every relative position up to +-512;
  * the unquantized encoder: within 2e-5 of the output's largest magnitude
    (f32 products and sums in another order than XLA's, through 3 layers
    and the unscaled attention);
  * MXINT8 (``pixart_mx_specs``: block 32, flush, bfloat 32), block by
    block with JAX's block input handed over: at most 1% of the outputs
    more than 1e-6 of the largest magnitude apart, and none more than one
    MX grid step (2^-6 of the largest magnitude);
  * the loaders: equal, key for key.

transformers is not imported: the checkpoint keys are transformers'
T5EncoderModel names written by the test, and the tokenizer is a stub put
in ``sys.modules`` (the repository holds no tokenizer files).
"""

import json
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mx_quantization_tpu.models.t5 as jax_t5
import mx_quantization_tpu.workloads.pixart as jax_pixart
from mx_quantization_tpu.workloads.pixart import \
    pixart_mx_specs as jax_pixart_specs

from mx_quantization_tpu_torch.models import t5
from mx_quantization_tpu_torch.utils.checkpoint import t5_params_from_jax
from mx_quantization_tpu_torch.workloads import pixart as port_pixart
from mx_quantization_tpu_torch.workloads.pixart import pixart_mx_specs

TINY = dict(vocab_size=256, d_model=64, d_kv=16, d_ff=128, num_layers=3,
            num_heads=4, relative_attention_num_buckets=8,
            relative_attention_max_distance=32)
B, L = 3, 20
LENGTHS = (20, 11, 1)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_t5.T5Config(**TINY)
    params = jax.tree.map(np.asarray,
                          jax_t5.init_t5_encoder(jax.random.key(0), jcfg))
    params = jax.tree.map(
        lambda a: a * 10 if a.ndim == 2 and a.shape[0] != 256 else a, params)
    model = t5_params_from_jax(params, t5.T5Config(**TINY), "cpu")
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 256, (B, L))
    mask = (np.arange(L)[None] < np.array(LENGTHS)[:, None]).astype(np.int32)
    return jcfg, params, model, ids, mask


def _hf_state_dict(params, num_layers):
    """transformers' T5EncoderModel names for a JAX tree."""
    sd = {"shared.weight": params["embed"],
          "encoder.embed_tokens.weight": params["embed"],
          "encoder.block.0.layer.0.SelfAttention.relative_attention_bias"
          ".weight": params["rel_bias"],
          "encoder.final_layer_norm.weight": params["final_ln"]}
    for i in range(num_layers):
        blk, pre = params["blocks"][i], f"encoder.block.{i}.layer"
        sd[f"{pre}.0.layer_norm.weight"] = blk["attn"]["ln"]
        for n in ("q", "k", "v", "o"):
            sd[f"{pre}.0.SelfAttention.{n}.weight"] = blk["attn"][n]
        sd[f"{pre}.1.layer_norm.weight"] = blk["ff"]["ln"]
        for n in ("wi_0", "wi_1", "wo"):
            sd[f"{pre}.1.DenseReluDense.{n}.weight"] = blk["ff"][n]
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in sd.items()}


@pytest.mark.parametrize("buckets,distance", [(32, 128), (8, 32)])
def test_bucket_table_equals_jax(buckets, distance):
    """T5-XXL's and T5-small's table (32 buckets to distance 128) and the
    tiny config's, at every relative position up to +-512: the f32 log is
    truncated, and at 16, 32, ..., 512 it lands on an integer."""
    assert all(c.relative_attention_num_buckets == 32 and
               c.relative_attention_max_distance == 128
               for c in t5.T5_CONFIGS.values())
    rel = np.arange(-512, 513)
    want = np.asarray(jax_t5.relative_position_bucket(jnp.asarray(rel),
                                                      buckets, distance))
    got = t5.relative_position_bucket(rel, buckets, distance)
    np.testing.assert_array_equal(got, want)


def test_configs_match_jax():
    assert {k: v.__dict__ for k, v in t5.T5_CONFIGS.items()} == \
        {k: v.__dict__ for k, v in jax_t5.T5_CONFIGS.items()}


def test_encode_matches_jax(tiny):
    jcfg, params, model, ids, mask = tiny
    want = np.asarray(jax_t5.t5_encode(
        jax.tree.map(jnp.asarray, params), jnp.asarray(ids),
        jnp.asarray(mask), jcfg))
    got = t5.t5_encode(model, torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.shape == (B, L, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


def test_encode_mxint8_block_by_block(tiny, monkeypatch):
    """Each layer on JAX's input to it (read from JAX's norm calls), with
    the PixArt specs, as ``encode_prompts_t5(quantize=True)`` runs it."""
    jcfg, params, model, ids, mask = tiny
    stream = []
    norm = jax_t5._rms_norm

    def spy(x, w, eps):
        stream.append(np.asarray(x))
        return norm(x, w, eps)

    monkeypatch.setattr(jax_t5, "_rms_norm", spy)
    jax_t5.t5_encode(jax.tree.map(jnp.asarray, params), jnp.asarray(ids),
                     jnp.asarray(mask), jcfg, mx_specs=jax_pixart_specs())
    monkeypatch.undo()
    ins = stream[0::2]  # each layer's input, then the final norm's
    assert len(ins) == TINY["num_layers"] + 1
    bias = t5.position_bias(model, L, torch.from_numpy(mask))
    for i, blk in enumerate(model.blocks):
        got = t5.t5_block(blk, torch.from_numpy(ins[i].copy()), bias,
                          model.cfg, pixart_mx_specs()).numpy()
        want = ins[i + 1]
        scale = np.abs(want).max()
        diff = np.abs(got - want)
        assert (diff > 1e-6 * scale).mean() <= 0.01, i
        assert diff.max() <= 2.0 ** -6 * scale, i


@pytest.mark.parametrize("as_file", [False, True])
def test_loader_matches_jax(tiny, tmp_path, as_file):
    jcfg, params, _, _, _ = tiny
    sd = _hf_state_dict(params, TINY["num_layers"])
    src = sd
    if as_file:
        src = str(tmp_path / "pytorch_model.bin")
        torch.save(sd, src)
    got = t5.load_t5_checkpoint(src, t5.T5Config(**TINY))
    want = jax_t5.load_t5_checkpoint(src, jcfg)
    model = t5.T5Encoder(t5.T5Config(**TINY), "cpu")
    assert set(got) == set(model.state_dict())
    for name, value in got.items():
        node = want
        for key in name.split("."):
            node = node[int(key)] if isinstance(node, list) else node[key]
        np.testing.assert_array_equal(value.numpy(), node, err_msg=name)
    model.load_state_dict(got)


class _StubTokenizer:
    """Stands in for transformers' AutoTokenizer: prompt i becomes ids
    i + 1 ... padded with 0 to ``max_length`` (length 1 + len(prompt))."""

    def __call__(self, prompts, max_length, padding, truncation,
                 return_tensors):
        ids = np.zeros((len(prompts), max_length), np.int64)
        mask = np.zeros((len(prompts), max_length), np.int64)
        for i, p in enumerate(prompts):
            n = min(max_length, 1 + len(p))
            ids[i, :n] = (np.arange(n) * 7 + i + 1) % 256
            mask[i, :n] = 1
        return {"input_ids": ids, "attention_mask": mask}


@pytest.fixture
def t5_folder(tiny, tmp_path, monkeypatch):
    """A checkpoint folder (pytorch_model.bin + config.json) and the
    tokenizer stub in place of the transformers module."""
    _, params, _, _, _ = tiny
    torch.save(_hf_state_dict(params, TINY["num_layers"]),
               tmp_path / "pytorch_model.bin")
    with open(tmp_path / "config.json", "w") as f:
        json.dump(TINY, f)
    stub = types.ModuleType("transformers")
    stub.AutoTokenizer = types.SimpleNamespace(
        from_pretrained=lambda path, **kw: _StubTokenizer())
    monkeypatch.setitem(sys.modules, "transformers", stub)
    return str(tmp_path)


@pytest.mark.parametrize("quantize", [False, True])
def test_encode_prompts_matches_jax(t5_folder, quantize):
    prompts = ["an astronaut riding a horse", "a cat", ""]
    got, got_mask = port_pixart.encode_prompts_t5(
        prompts, t5_folder, max_length=16, quantize=quantize, device="cpu")
    want, want_mask = jax_pixart.encode_prompts_t5(
        prompts, t5_folder, max_length=16, quantize=quantize)
    np.testing.assert_array_equal(got_mask, want_mask)
    assert got.shape == (3, 16, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


def test_cli_t5_path(t5_folder, tmp_path):
    """``--t5-path``: the prompts and the empty prompt encoded from the
    folder, then sampled by a tiny PixArt whose caption width is T5's."""
    out = tmp_path / "lat.npz"
    port_pixart.main(["--device", "cpu", "--t5-path", t5_folder,
                      "--num-layers", "2", "--num-heads", "2",
                      "--caption-channels", "64", "--image-size", "64",
                      "--max-token-length", "12", "--num-steps", "2",
                      "--mx-quant", "--self-top-k", "--self-k", "6",
                      "--prompts", "a", "bb", "--out", str(out)])
    lat = np.load(out)["latents"]
    assert lat.shape == (2, 4, 8, 8) and np.isfinite(lat).all()


def test_entry_points_default_to_cuda(tiny):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where no CUDA device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t5.T5Encoder(t5.T5Config(**TINY))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t5.init_t5_encoder(t5.T5Config(**TINY), torch.Generator())
