"""The port's LM loss (`repro_torch.models.lm.model.loss_fn`) and its
gradients against the JAX package's on the recurrent, SSM and enc-dec archs
at their reduced configs in f32, on JAX's weights carried across; and the
port's `_remat` "full" and "dots" bitwise equal to "none". Tolerances and
the JAX compilation: `tests/torch_lm_train_cases.py`."""
import pytest

from tests.torch_lm_parity import one_torch_thread  # noqa: F401
from tests.torch_lm_train_cases import check_loss_and_grads

ARCHS = ("recurrentgemma-2b", "mamba2-1.3b", "seamless-m4t-large-v2")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)
