"""The port's LM against the JAX package's on the MoE archs (arctic-480b:
top-2 with a dense residual MLP; qwen2-moe-a2.7b: top-2 of 8 at the
reduced config, with shared experts) and the VLM stub (phi-3-vision-4.2b:
precomputed patch embeddings projected and prepended), at their reduced
configs, in f32 and in their own bf16. What is checked, the tolerances and
the JAX compilation: `tests/torch_lm_parity.py`."""
import pytest

from tests.torch_lm_parity import arch_checks, one_torch_thread  # noqa: F401

ARCHS = ("arctic-480b", "qwen2-moe-a2.7b", "phi-3-vision-4.2b")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_arch_matches_jax(arch, dtype):
    arch_checks(arch, dtype)
