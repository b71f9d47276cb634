"""The port's training forward, loss and gradients against the JAX
package's for the MoE, MLA and recurrent archs' reduced configs
(`test_torch_train_grads_a.py` holds the checks and their tolerances)."""

import pytest

from repro_torch.configs import ARCHS
from test_torch_train_grads_a import check_arch


@pytest.mark.parametrize("arch", ARCHS[4:7])
def test_loss_and_gradients_match_jax(arch):
    check_arch(arch)
