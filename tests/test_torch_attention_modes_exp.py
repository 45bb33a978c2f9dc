"""K3's and K4's partial_K and true_ex predictors on the short path, the
plain version against JAX's interpret-mode kernel, each in both tiers, at
tests/test_torch_attention_modes.py's shapes and criterion (that module's
docstring)."""

import pytest

from test_torch_attention_modes import SHAPES, check_mode


@pytest.mark.parametrize("mode", ["partial_K", "true_ex"])
@pytest.mark.parametrize("S,with_bias", SHAPES)
@pytest.mark.parametrize("contract", ["exact", "serving"])
def test_plain_matches_jax_kernel(mode, S, with_bias, contract):
    check_mode(mode, S, with_bias, contract)
