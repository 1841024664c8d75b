"""The port's LM against the JAX package's on the archs with carried state
or a second stack: recurrentgemma-2b (RG-LRU blocks and local attention
over a ring cache, 1 : 2), mamba2-1.3b (SSD chunks, attention-free) and
seamless-m4t-large-v2 (encoder-decoder over precomputed frames, cross K/V
cached at prefill), at their reduced configs, in f32 and in their own
bf16 (the chunked RG-LRU scan: `tests/test_torch_lm_blocks.py`). What is
checked, the tolerances and the JAX compilation:
`tests/torch_lm_parity.py`."""
import pytest

from tests.torch_lm_parity import arch_checks, one_torch_thread  # noqa: F401

ARCHS = ("recurrentgemma-2b", "mamba2-1.3b", "seamless-m4t-large-v2")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_arch_matches_jax(arch, dtype):
    arch_checks(arch, dtype)

