"""The port's LM loss (`repro_torch.models.lm.model.loss_fn`) and its
gradients against the JAX package's on the dense archs at their reduced
configs in f32 (Llama-3.2-1B also in its own bf16), on JAX's weights
carried across; and the port's `_remat` "full" and "dots" bitwise equal to
"none". Tolerances and the JAX compilation:
`tests/torch_lm_train_cases.py`."""
import pytest

from tests.torch_lm_parity import one_torch_thread  # noqa: F401
from tests.torch_lm_train_cases import check_loss_and_grads

ARCHS = ("llama3.2-1b", "granite-3-2b", "codeqwen1.5-7b", "qwen3-32b")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)


def test_llama_bf16_loss_and_grads_match_jax():
    check_loss_and_grads("llama3.2-1b", "bfloat16")
