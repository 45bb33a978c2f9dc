"""The port's ``ops/resize.py`` against ``jax.image.resize`` on the CPU:
"nearest", "bilinear" and "bicubic" (Keys a = -0.5), up and down, odd
sizes, JAX's default antialiasing when downscaling, on [0, 1] data.

Tolerances: nearest equal; the weight matrices equal to those of JAX's
jitted resize within 3e-7 (XLA fuses the sample point into one multiply-add,
which the port follows; its kernel and renormalization stay XLA's own
fusions); the resized images within 2e-6 absolute.  One pinned
difference: on a 300 -> 224 bilinear downscale XLA's fused weights of
some output columns sum to 1 + 7.6e-6 where the port's sum to 1 within
1.2e-7, so there the images differ by up to 7e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax._src.image.scale import (_fill_keys_cubic_kernel,
                                  _fill_triangle_kernel, compute_weight_mat)

from mx_quantization_tpu_torch.ops.resize import resize, weight_matrix

CASES = [((7, 9), (15, 4)), ((13, 11), (5, 23)), ((5, 3), (11, 17)),
         ((32, 32), (64, 64)), ((37, 50), (224, 302)),
         ((96, 96), (299, 299)), ((256, 256), (299, 299)),
         ((1024, 1024), (299, 299))]
KERNELS = {"bilinear": _fill_triangle_kernel,
           "bicubic": _fill_keys_cubic_kernel}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax(x, shape, method):
    return np.asarray(jax.image.resize(jnp.asarray(x), shape, method))


@pytest.mark.parametrize("method", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("src,dst", CASES)
def test_resize_matches_jax(method, src, dst):
    x = np.random.RandomState(sum(src)).rand(2, 3, *src).astype(np.float32)
    shape = (2, 3, *dst)
    got = resize(torch.from_numpy(x), shape, method).numpy()
    want = _jax(x, shape, method)
    assert got.shape == want.shape
    if method == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("m,n", [(96, 299), (256, 299), (1024, 299),
                                 (7, 9), (13, 5)])
def test_weights_match_jitted_jax(method, m, n):
    want = np.asarray(jax.jit(lambda: compute_weight_mat(
        m, n, n / m, 0., KERNELS[method], True))())
    np.testing.assert_allclose(weight_matrix(m, n, method), want, rtol=0,
                               atol=3e-7)


def test_channels_last_uint8_and_identity_axes():
    """CLIP's layout (N, H, W, 3), uint8 promoted to f32 as JAX promotes
    it; an axis whose size is kept is left as it is."""
    x = np.random.RandomState(1).randint(0, 256, (2, 40, 30, 3), np.uint8)
    got = resize(torch.from_numpy(x), (2, 25, 30, 3), "bicubic").numpy()
    want = _jax(x, (2, 25, 30, 3), "bicubic")
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * 255)


def test_xla_bilinear_normalization_pinned():
    """The pinned difference: XLA's fused normalization of a 300 -> 224
    bilinear downscale."""
    jw = np.asarray(jax.jit(lambda: compute_weight_mat(
        300, 224, 224 / 300, 0., _fill_triangle_kernel, True))())
    pw = weight_matrix(300, 224, "bilinear")
    assert np.abs(jw.sum(0) - 1).max() > 5e-6
    assert np.abs(pw.sum(0) - 1).max() <= 1.2e-7
    x = np.random.RandomState(2).rand(1, 1, 300, 301).astype(np.float32)
    got = resize(torch.from_numpy(x), (1, 1, 224, 224), "bilinear").numpy()
    np.testing.assert_allclose(got, _jax(x, (1, 1, 224, 224), "bilinear"),
                               rtol=0, atol=7e-6)
