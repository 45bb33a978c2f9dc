"""DiT quantization-aware training on the port against the JAX package,
at depth 2 and hidden 64 on the CPU:

* one training step (``make_train_step``: ``loss.backward()`` through
  ``dit_forward`` and ``training_losses``, MSE + VB with a t == 0 sample's
  decoder NLL, then AdamW and the EMA) against JAX's on the same
  parameters (``dit_params_from_jax``), t and noise, on the fused engine
  (attention through K2's plain version and the surrogate backward): the
  loss, every gradient, every updated parameter and EMA entry;
* the reference torch trajectory golden (tests/golden/train_traj.npz,
  4 SGD steps at lr 1e-3 from train_sd.pt, MXINT8, bfloat 16,
  quantize_backprop=True, k = 8, block 1 excluded) at the bounds of
  tests/test_train_trajectory_golden.py, which the port meets with no JAX
  run;
* the opt-ins whose kernels have no backward (K5, K6, K7) raising where
  autograd records them.

Tolerances.  The loss within 1e-5 relative.  The gradients: the quantized
linears' operands and products are the JAX package's (tests/
test_torch_backward.py), but the model's unquantized f32 parts (LN,
modulate, the embedders, the softmax) add in other orders and hand their
last-bit differences to the next quantizer, so a bf16-rounded gradient may
sit one bf16 step from JAX's on a few percent of the elements: every
element within one bf16 step (2^-7 relative) plus 1e-6.  The updated
parameters: AdamW's first step moves each by lr * g / (|g| + eps), so they
agree to 1e-5 (a tenth of the learning rate); the EMA to 1e-6.
"""

import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from mx_quantization_tpu.diffusion import create_diffusion as jax_diffusion
from mx_quantization_tpu.models.dit import DiTConfig as JaxDiTConfig
from mx_quantization_tpu.models.dit import DiTQuantConfig as JaxQuant
from mx_quantization_tpu.models.dit import dit_forward as jax_dit_forward
from mx_quantization_tpu.models.dit import init_dit as jax_init_dit
from mx_quantization_tpu.specs import finalize_mx_specs as jax_finalize
from mx_quantization_tpu.workloads.dit_train import \
    update_ema as jax_update_ema

from mx_quantization_tpu_torch.diffusion import create_diffusion
from mx_quantization_tpu_torch.models.dit import (DiT, DiTConfig,
                                                  DiTQuantConfig, dit_forward)
from mx_quantization_tpu_torch.specs import finalize_mx_specs
from mx_quantization_tpu_torch.utils.checkpoint import (dit_params_from_jax,
                                                        load_dit_checkpoint)
from mx_quantization_tpu_torch.workloads.dit_train import (ema_state_dict,
                                                           make_train_step,
                                                           trainable_tensors)

GOLD = os.path.join(os.path.dirname(__file__), "golden")
KW = dict(input_size=8, hidden_size=64, depth=2, num_heads=2, num_classes=10)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one torch thread keeps the module's cost its own
    when the suite runs several processes side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _specs(engine, bfloat=16):
    d = dict(w_elem_format="int8", a_elem_format="int8", scale_bits=8,
             shared_exp_method="max", block_size=32, bfloat=bfloat, fp=0,
             round="nearest", mx_flush_fp32_subnorms=False,
             quantize_backprop=True, custom_tpu=engine)
    return finalize_mx_specs(d), jax_finalize(d)


def _plans(engine):
    specs, jspecs = _specs(engine)
    kw = dict(mx_quant=True, top_k=True, k=6, exclude_blocks=(1,))
    return DiTQuantConfig(mx_specs=specs, **kw), JaxQuant(mx_specs=jspecs,
                                                          **kw)


def _models():
    """JAX's init with every leaf moved off its init value (the adaLN and
    final projections start at zero), and the port's copy."""
    rng = np.random.RandomState(0)
    params = jax.tree.map(
        lambda a: a + 0.02 * rng.randn(*a.shape).astype(np.float32),
        jax_init_dit(jax.random.key(0), JaxDiTConfig(**KW)))
    return params, dit_params_from_jax(jax.tree.map(np.asarray, params),
                                       DiTConfig(**KW), "cpu")


def _leaf(tree, name):
    """The JAX tree's leaf under the port's state-dict name."""
    parts, idx = name.split("."), None
    if parts[0] == "blocks":
        tree, idx, parts = tree["blocks"], int(parts[1]), parts[2:]
    for key in parts:
        tree = tree[key]
    return np.asarray(tree if idx is None else tree[idx])


def _batch(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 4, 8, 8).astype(np.float32), np.array([1, 7]),
            rng.randn(2, 4, 8, 8).astype(np.float32))


def test_dit_train_step_matches_jax():
    """The gradients, then the AdamW step and the EMA update, against JAX's
    ``make_train_step`` taken apart: ``jax.value_and_grad`` of its loss at
    the t and noise its key gives, ``optax.adamw``'s update and its
    ``update_ema`` (two compiled graphs, the gradients and the update,
    where JAX's step is one)."""
    qcfg, jq = _plans("fused")
    params, model = _models()
    x0, y, _ = _batch(2)
    key = jax.random.key(5)
    # JAX's step draws t, then the noise, from the key's two halves
    t_key, n_key = jax.random.split(key)
    t = np.array(jax.random.randint(t_key, (2,), 0, 1000))
    noise = np.asarray(jax.random.normal(n_key, x0.shape))
    t[0] = 0  # and one sample at t == 0, the decoder NLL
    jcfg = JaxDiTConfig(**KW)

    def jloss(p):
        terms = jax_diffusion(None).training_losses(
            lambda xt, tt, y: jax_dit_forward(p, xt, tt, y, jcfg, jq),
            jnp.asarray(x0), jnp.asarray(t), None,
            model_kwargs={"y": jnp.asarray(y)}, noise=jnp.asarray(noise))
        return jnp.mean(terms["loss"])
    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)

    @jax.jit  # eager, the update's many small ops take ~10 s
    def jupdate(jg, params):
        opt = optax.adamw(1e-4, weight_decay=0.0)
        updates, _ = opt.update(jg, opt.init(params), params)
        jp = optax.apply_updates(params, updates)
        return jp, jax_update_ema(params, jp)
    jp, je = jupdate(jg, params)

    tensors = trainable_tensors(model)
    ema = [p.detach().clone() for p in tensors]
    optimizer = torch.optim.AdamW(tensors, lr=1e-4, betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=0.0)
    step = make_train_step(model, ema, qcfg, create_diffusion(None),
                           optimizer)
    # the step zeroes the gradients first and leaves them for reading
    loss = step(*map(torch.tensor, (x0, y, t, noise)))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    names = [n for n, _ in model.named_parameters()] + ["pos_embed"]
    assert len(names) == len(tensors)
    sd = model.state_dict()
    for name, prm, e in zip(names, tensors, ema):
        want = _leaf(jg, name)
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(prm.grad.numpy(), want, rtol=2.0 ** -7,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(sd[name].numpy(), _leaf(jp, name),
                                   rtol=0, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(e.numpy(), _leaf(je, name), rtol=0,
                                   atol=1e-6, err_msg=name)


def test_qat_trajectory_golden():
    """tests/test_train_trajectory_golden.py on the port: the same four
    batches, SGD at lr 1e-3 over JAX's parameter tree (the position table
    included), the same bounds."""
    golden = np.load(os.path.join(GOLD, "train_traj.npz"))
    cfg = DiTConfig(patch_size=2, in_channels=4, class_dropout_prob=0.0,
                    **KW)  # the golden's label table has no null row
    model = DiT(cfg, "cpu")
    model.load_state_dict(load_dit_checkpoint(
        os.path.join(GOLD, "train_sd.pt"), depth=2))
    specs, _ = _specs("ref")
    qcfg = DiTQuantConfig(mx_specs=specs, mx_quant=True, top_k=True, k=8,
                          ex_pred=True, pred_mode="ex_pred",
                          exclude_blocks=(1,))
    diffusion = create_diffusion(None)
    opt = torch.optim.SGD(trainable_tensors(model), lr=1e-3)
    losses, mses, vbs = [], [], []
    for s in range(4):
        x0, y, t, noise = (torch.from_numpy(golden[f"s{s}_{k}"])
                           for k in ("x0", "y", "t", "noise"))
        terms = diffusion.training_losses(
            lambda xt, tt, y: dit_forward(model, xt, tt, y, qcfg), x0, t,
            model_kwargs={"y": y}, noise=noise)
        loss = terms["loss"].mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
        mses.append(terms["mse"].mean().item())
        vbs.append(terms["vb"].mean().item())
    np.testing.assert_allclose(losses[0], golden["losses"][0], rtol=2e-4)
    np.testing.assert_allclose(mses[0], golden["mses"][0], rtol=2e-4)
    np.testing.assert_allclose(vbs[0], golden["vbs"][0], rtol=2e-3)
    for s in range(1, 4):
        np.testing.assert_allclose(losses[s], golden["losses"][s], rtol=2e-2,
                                   err_msg=f"step {s}")
    assert losses[0] > losses[-1]


@pytest.mark.parametrize("opt_in", ["fuse_ln_modulate", "fuse_gelu",
                                    "split_t"])
def test_inference_only_opt_ins_raise_under_autograd(opt_in):
    """K5, K6 and K7 have no backward.  JAX raises at K5 under
    ``jax.grad``; through K7 (and the K1 in front of it) its gradient is
    silently zero; K6 is gated off under ``quantize_backprop``, as here,
    so it takes the serving tier without it.  The port raises at each,
    and the forward alone still runs."""
    specs, jspecs = _specs("fused")
    kw = dict(mx_quant=True, top_k=True, k=20, exclude_blocks=(1,))
    if opt_in == "fuse_ln_modulate":
        kw.update(fuse_ln_modulate=True, contract="serving")
    elif opt_in == "fuse_gelu":
        specs = specs.replace(quantize_backprop=False)
        kw.update(fuse_gelu=True, contract="serving")
    else:
        kw.update(qkv_layout="split_t")
    # N = 256 tokens: K6's 2^16-element and K7's N % 128 gates hold
    cfg = DiTConfig(input_size=32, hidden_size=64, depth=2, num_heads=2,
                    num_classes=10)
    model = DiT(cfg, "cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0, 0.02, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 4, 32, 32, generator=torch.Generator().manual_seed(1))
    t, y = torch.tensor([3.0, 500.0]), torch.tensor([1, 3])
    qcfg = DiTQuantConfig(mx_specs=specs, **kw)
    with torch.no_grad():
        assert torch.isfinite(dit_forward(model, x, t, y, qcfg)).all()
    trainable_tensors(model)
    with pytest.raises(RuntimeError, match="inference-only"):
        dit_forward(model, x, t, y, qcfg)
    if opt_in == "fuse_ln_modulate":
        jcfg = JaxDiTConfig(input_size=8, hidden_size=64, depth=1,
                            num_heads=2, num_classes=10)
        params = jax_init_dit(jax.random.key(0), jcfg)
        jq = JaxQuant(mx_specs=jspecs, **kw)
        with pytest.raises(ValueError, match="Linearization failed"):
            jax.grad(lambda p: jnp.sum(jax_dit_forward(
                p, jnp.zeros((1, 4, 8, 8)), jnp.ones((1,)),
                jnp.zeros((1,), jnp.int32), jcfg, jq)))(params)
