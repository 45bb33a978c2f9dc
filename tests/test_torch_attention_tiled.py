"""The port's split q/k/v top-k attention at long sequences (the plain
version that kernels K3 and K4 share, and ``attention.topk_attention``'s
dispatch) against the JAX package's query-tiled kernel path
(``fused_topk_attention`` with N or S over 512) in interpret mode.

Inputs are made with numpy from a seed: B = 1, H = 2, D = 72, q and k
scaled by 2 (tests/test_torch_attention_split.py's reasons), at
  * N = S = 640, which JAX pads to three query tiles of 256 rows, as its own
    tests/test_fused_attention_kernel.py does;
  * N = 640 queries against S = 120 keys with a caption-mask bias;
  * N = 200 queries against S = 640 keys.
The criterion is tests/test_torch_attention.py's ``check_rows``: every
query row within 2e-5, except rows whose probabilities, read through a
probe (v set to the identity), differ from JAX's by at most two
probabilities of one grid step each, in at most 1% of the rows.  The probe
needs v as wide as S, and D < S here, so only the rows outside the
tolerance are probed: those queries alone against the same keys, with v
replaced by ceil(S / D) identity slices stacked along the batch.  Queries
are independent, and JAX's tiled path pads every query tile to 256 rows,
so a probed row meets the same shapes as in the full call.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mx_quantization_tpu import finalize_mx_specs
from mx_quantization_tpu.attention import \
    TopKAttentionConfig as JaxAttnConfig
from mx_quantization_tpu.attention import topk_attention as jax_topk
from mx_quantization_tpu.ops.kernels.topk_attention import \
    fused_topk_attention as jax_kernel

from mx_quantization_tpu_torch.attention import (TopKAttentionConfig,
                                                 topk_attention)
from mx_quantization_tpu_torch.ops.kernels.topk_attention import (
    MAX_TILED_KEYS, fused_topk_attention, fused_topk_attention_ref,
    fused_topk_attention_tiled)
from mx_quantization_tpu_torch.workloads.pixart import pixart_mx_specs
from test_torch_attention import TOL, check_rows
from test_torch_attention_split import PIXART, split_inputs

D = 72
SHAPES = {  # name: (N, S, with_bias)
    "640x640": (640, 640, False),
    "640x120_bias": (640, 120, True),
    "200x640": (200, 640, False),
}
MODES = {  # name: (k, keyword arguments); None: k = S (dense)
    "none": (77, dict(approx=False, key_bits=32)),
    "ex_pred": (77, dict(pred_mode="ex_pred", key_bits=8)),
    "two_step": (77, dict(pred_mode="two_step_leading_ones", key_bits=32)),
    "dense": (None, dict()),
}


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


def long_inputs(shape, seed, dtype=np.float32):
    N, S, with_bias = SHAPES[shape]
    q, k, v, bias = split_inputs(S, seed, with_bias, n=N, b=1)
    return (q.astype(dtype), k.astype(dtype), v.astype(dtype), bias)


def _probe_rows(fn, q, k, v, bias, rows):
    """fn's probabilities (cells, len(rows), S) for the query rows
    ``rows``: those queries against k with v replaced by identity slices
    (slice i holds keys i*D .. i*D + D), stacked along the batch."""
    B, H, _, d = q.shape
    S = k.shape[2]
    n_sl = -(-S // d)
    eye = np.eye(S, n_sl * d, dtype=np.float32).astype(v.dtype).reshape(
        S, n_sl, d)
    vv = np.broadcast_to(eye.transpose(1, 0, 2)[:, None, None],
                         (n_sl, B, H, S, d)).reshape(n_sl * B, H, S, d)

    def rep(a):
        return None if a is None else np.concatenate([a] * n_sl)

    out = np.asarray(fn(rep(q[:, :, rows]), rep(k), vv, rep(bias)),
                     np.float32).reshape(n_sl, B * H, len(rows), d)
    return out.transpose(1, 2, 0, 3).reshape(B * H, len(rows), -1)[..., :S]


def assert_long_matches_jax(port, jax_fn, q, k, v, bias, mbits=8,
                            contract="exact", out_bf16=False, block_size=32):
    """port, jax_fn: (q, k, v, bias) numpy arrays -> (B, H, N, D); the
    criterion of the module docstring."""
    B, H, N, _ = q.shape
    S = k.shape[2]

    def run(fn):
        return np.asarray(fn(q, k, v, bias), np.float32).reshape(B * H, N, -1)

    got, want = run(port), run(jax_fn)
    tol = dict(rtol=2.0 ** -8, atol=2e-5) if out_bf16 else TOL
    rows = np.flatnonzero(~np.isclose(got, want, **tol).all(-1).all(0))
    pg = np.zeros((B * H, N, S), np.float32)
    pw = np.zeros((B * H, N, S), np.float32)
    if rows.size:
        pg[:, rows] = _probe_rows(port, q, k, v, bias, rows)
        pw[:, rows] = _probe_rows(jax_fn, q, k, v, bias, rows)
    vmax = np.abs(v.astype(np.float32)).max(axis=(2, 3)).reshape(B * H)
    check_rows(got, want, pg, pw, vmax, mbits, contract, out_bf16,
               block_size)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a, np.float32)
                                                   ).to(_TORCH[a.dtype])


def _j(a):
    return None if a is None else jnp.asarray(a)


_TORCH = {np.dtype(np.float32): torch.float32,
          np.dtype(jnp.bfloat16): torch.bfloat16}


def _port_and_jax(**kw):
    def port(*a):
        return fused_topk_attention_ref(*map(_t, a), **kw).float()

    def jax_fn(*a):
        return jax_kernel(*map(_j, a), **kw).astype(jnp.float32)
    return port, jax_fn


# each shape with three of the four modes, each mode in both tiers (an
# interpret-mode call of JAX's tiled kernel takes about a second)
CASES = [("ex_pred", "640x640", "exact"), ("ex_pred", "640x640", "serving"),
         ("two_step", "640x640", "exact"), ("dense", "640x640", "exact"),
         ("none", "640x120_bias", "serving"),
         ("two_step", "640x120_bias", "exact"),
         ("dense", "640x120_bias", "serving"),
         ("ex_pred", "200x640", "serving"), ("two_step", "200x640", "serving"),
         ("none", "200x640", "exact")]


@pytest.mark.parametrize("mode,shape,contract", CASES)
def test_plain_matches_jax_tiled_kernel(mode, shape, contract):
    """PixArt's elementwise settings: f32 input, bfloat 32 (0 to the
    kernels), subnormal flush."""
    k, extra = MODES[mode]
    q, kk, v, bias = long_inputs(shape, seed=len(mode) + len(shape))
    S = kk.shape[2]
    kw = dict(k=S if k is None else k, scale=D ** -0.5, flush=True,
              contract=contract, **extra)
    assert_long_matches_jax(*_port_and_jax(**kw), q, kk, v, bias,
                            contract=contract)


@pytest.mark.parametrize("contract", ["exact", "serving"])
def test_dit512_settings_bf16(contract):
    """DiT-XL/2 512^2's settings: bf16 input, bfloat 16, ex_pred top-k
    k = 154 at key_bits 8.  The f32 output is held to JAX's under the
    criterion; the bf16 output of each is its f32 output cast to bf16 (RNE).
    The bf16 outputs are not compared with each other: in the serving tier
    the PV sums are f32 sums taken in another order (key order here, XLA's
    dot there), and where two such sums, within 2e-5 of each other,
    straddle a bf16 rounding midpoint the casts land one bf16 step apart."""
    q, kk, v, bias = long_inputs("640x640", seed=3, dtype=jnp.bfloat16)
    kw = dict(k=154, scale=D ** -0.5, key_bits=8, bfloat=16,
              pred_mode="ex_pred", contract=contract)
    want = jax_kernel(*map(_j, (q, kk, v)), **kw)
    port, jax_fn = _port_and_jax(**kw)
    assert_long_matches_jax(
        port, lambda *a: want if a[0] is q else jax_fn(*a), q, kk, v, bias,
        contract=contract)
    got = fused_topk_attention_ref(*map(_t, (q, kk, v)), **kw)
    assert torch.equal(fused_topk_attention_ref(
        *map(_t, (q, kk, v)), out_dtype=torch.bfloat16, **kw),
        got.to(torch.bfloat16))
    np.testing.assert_array_equal(
        np.asarray(jax_kernel(*map(_j, (q, kk, v)), out_dtype=jnp.bfloat16,
                              **kw), np.float32),
        np.asarray(want.astype(jnp.bfloat16), np.float32))


def test_subnormal_blocks_flush():
    q, k, v, bias = long_inputs("640x120_bias", seed=4)
    k[0, 1, 5, :32] = 1e-39    # a k block of subnormals
    q[0, 0, 600, 32:64] = -2e-40
    v[0, 0, 64:96, 4] = 3e-39  # a v block (32 keys of one column)
    kw = dict(k=20, scale=D ** -0.5, key_bits=16, flush=True,
              pred_mode="two_step_leading_ones")
    assert_long_matches_jax(*_port_and_jax(**kw), q, k, v, bias)


def test_wrappers_use_plain_only_on_cpu():
    q, k, v, bias = map(_t, long_inputs("640x120_bias", seed=5))
    kw = dict(k=20, scale=0.125, pred_mode="two_step_leading_ones")
    before = (fused_topk_attention.launches,
              fused_topk_attention_tiled.launches)
    want = fused_topk_attention_ref(q, k, v, bias, **kw)
    assert torch.equal(fused_topk_attention(q, k, v, bias, **kw), want)
    assert torch.equal(fused_topk_attention_tiled(q, k, v, bias, **kw), want)
    assert (fused_topk_attention.launches,
            fused_topk_attention_tiled.launches) == before
    meta = torch.empty(1, 1, 640, 72, device="meta")
    with pytest.raises(ValueError):
        fused_topk_attention_tiled(meta, meta, meta, k=5, scale=0.125)
    # every predictor of the TPU kernels is K4's; a name outside them is not
    with pytest.raises(ValueError, match="unknown pred_mode"):
        fused_topk_attention_tiled(q, k, v, k=5, scale=0.125,
                                   pred_mode="sanger")
    got = fused_topk_attention_tiled(q, k, v, bias, k=20, scale=0.125,
                                     pred_mode="MXINT4")
    assert torch.equal(got, fused_topk_attention_ref(
        q, k, v, bias, k=20, scale=0.125, pred_mode="MXINT4"))


def test_topk_entry_matches_jax_at_640():
    """``attention.topk_attention`` no longer refuses N = 640: it takes the
    kernel path (K4 on the card) where JAX takes its tiled kernel."""
    q, k, v, _ = long_inputs("640x640", seed=6)
    cfg = dict(mx_quant=True, top_k=True, k=77, approx_flag=True,
               pred_mode="ex_pred", key_bits=8)
    assert_long_matches_jax(
        lambda *a: topk_attention(*map(_t, a[:3]), D ** -0.5,
                                  pixart_mx_specs(),
                                  TopKAttentionConfig(**cfg))[0],
        lambda *a: jax_topk(*map(_j, a[:3]), D ** -0.5,
                            finalize_mx_specs(PIXART),
                            JaxAttnConfig(**cfg))[0], q, k, v, None)


def test_topk_entry_refuses_past_the_kernel_key_limit():
    """Past MAX_TILED_KEYS keys JAX leaves its kernels for the XLA path:
    the port's kernel entry refuses them and ``topk_attention`` takes the
    port's XLA path instead (the masked-softmax fallback for top-k, the
    emulation's dense attention without), as JAX does."""
    from mx_quantization_tpu_torch.attention import _xla_topk_dense
    rng = np.random.RandomState(5)
    # the key count decides the route; few queries keep the test quick
    q = torch.from_numpy(rng.randn(1, 1, 8, D).astype(np.float32))
    k = torch.from_numpy(rng.randn(1, 1, MAX_TILED_KEYS + 1, D)
                         .astype(np.float32))
    cfg = TopKAttentionConfig(k=77)
    out, idx = topk_attention(q, k, k, D ** -0.5, pixart_mx_specs(), cfg)
    assert idx is None and torch.equal(out, _xla_topk_dense(
        q, k, k, D ** -0.5, pixart_mx_specs(), cfg))
    out, _ = topk_attention(q, k, k, D ** -0.5, pixart_mx_specs(),
                            TopKAttentionConfig(top_k=False))
    assert out.shape == q.shape and torch.isfinite(out).all()
