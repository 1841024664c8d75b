"""The port's LM (`repro_torch.models.lm.model`) against the JAX package's
on the dense archs at their reduced configs, in f32 and in their own
bf16: `init_params`' tree, `forward_train`, `prefill`, greedy decode steps,
both caches and the greedy tokens (f32), on JAX's weights carried across.
Llama-3.2-1B also with W8 and W4 linears and with the int8 KV cache.
Tolerances and the JAX compilation: `tests/torch_lm_parity.py`."""
import pytest

from tests.torch_lm_parity import arch_checks, one_torch_thread  # noqa: F401

ARCHS = ("llama3.2-1b", "granite-3-2b", "codeqwen1.5-7b", "qwen3-32b")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_arch_matches_jax(arch, dtype):
    arch_checks(arch, dtype)


@pytest.mark.parametrize("over", [dict(quant_bits=8), dict(quant_bits=4),
                                  dict(kv_bits=8)],
                         ids=["w8", "w4", "kv8"])
def test_llama_quantized_matches_jax(over):
    arch_checks("llama3.2-1b", "float32", **over)
