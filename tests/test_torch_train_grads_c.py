"""The port's training forward, loss and gradients against the JAX
package's for xlstm-125m and the cross-attention archs' reduced configs
(`test_torch_train_grads_a.py` holds the checks and their tolerances; the
gates are set to 0.5, so the gated layers are no identity)."""

import pytest

from repro_torch.configs import ARCHS
from test_torch_train_grads_a import check_arch


@pytest.mark.parametrize("arch", ARCHS[7:])
def test_loss_and_gradients_match_jax(arch):
    check_arch(arch)
