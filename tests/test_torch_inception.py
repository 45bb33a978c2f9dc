"""The port's FID Inception (``evaluation/inception.py``) against the JAX
package's on the CPU: a full random state dict with pt_inception's names
and random batch-norm statistics, through both loaders (the batch-norm
fold included) and through ``extract_features_batched`` on one 96 x 96 and
one 256 x 256 uint8 image (each resized to 299 x 299 bilinearly).

The state dict is ``chip_smoke.random_pt_inception``'s, which the card's
end-task run writes too.

Tolerances: the loaders equal, key for key (the same float32 fold); the
features within 1e-4 of each output's largest magnitude (f32 convs summed
in another order than XLA's, through 94 convs) and the softmax within
1e-6 absolute.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mx_quantization_tpu.evaluation.inception as jax_inc

from chip_smoke import random_pt_inception
from mx_quantization_tpu_torch.evaluation import inception as inc
from mx_quantization_tpu_torch.utils.checkpoint import \
    inception_params_from_jax


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = tmp_path_factory.mktemp("inception") / "pt_inception.pth"
    torch.save(random_pt_inception(0), path)
    got = inc.load_inception_checkpoint(str(path))
    want = jax_inc.load_inception_checkpoint(str(path))
    return str(path), got, want


def test_loader_matches_jax(weights):
    _, got, want = weights
    assert set(got) == set(inc.InceptionV3("cpu").state_dict())
    for name, value in got.items():
        node = want
        for key in name.split("."):
            node = node[key]
        np.testing.assert_array_equal(value.numpy(), node, err_msg=name)


def test_features_match_jax(weights):
    _, got, want = weights
    model = inc.InceptionV3("cpu")
    model.load_state_dict(got)
    # the JAX tree carried over gives the same module
    carried = inception_params_from_jax(want, "cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(carried.state_dict()[k], v), k
    params = jax.tree.map(jnp.asarray, want)
    rng = np.random.RandomState(0)
    for size in (96, 256):
        imgs = rng.randint(0, 256, (1, size, size, 3)).astype(np.uint8)
        out = inc.extract_features_batched(model, imgs)
        ref = jax_inc.extract_features_batched(params, imgs)
        assert out["pool3"].shape == (1, 2048)
        assert out["spatial"].shape == (1, 7 * 17 * 17)
        assert out["pred"].shape == (1, inc.NUM_CLASSES)
        for key in ("pool3", "spatial"):
            np.testing.assert_allclose(
                out[key], ref[key], rtol=0,
                atol=1e-4 * np.abs(ref[key]).max(), err_msg=key)
        np.testing.assert_allclose(out["pred"], ref["pred"], rtol=0,
                                   atol=1e-6)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where no CUDA device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inc.InceptionV3()
