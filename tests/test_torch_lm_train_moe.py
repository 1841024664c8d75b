"""The port's LM loss (`repro_torch.models.lm.model.loss_fn`) and its
gradients against the JAX package's on the MoE archs and the VLM at their
reduced configs in f32, on JAX's weights carried across; and the port's
`_remat` "full" and "dots" bitwise equal to "none". Tolerances and the JAX
compilation: `tests/torch_lm_train_cases.py`."""
import pytest

from tests.torch_lm_parity import one_torch_thread  # noqa: F401
from tests.torch_lm_train_cases import check_loss_and_grads

ARCHS = ("arctic-480b", "qwen2-moe-a2.7b", "phi-3-vision-4.2b")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)
