"""llama3.2-1b [dense]: small llama3.

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256
[hf:meta-llama/Llama-3.2-1B; unverified]

Counterpart of `repro/configs/llama32_1b.py`, the same values.
"""
from repro_torch.models.lm.config import LMConfig


def get_config(**kw) -> LMConfig:
    return LMConfig(
        name="llama3.2-1b",
        family="dense",
        n_layers=16,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab=128256,
        rope_theta=500000.0,
        tie_embeddings=True,
        **kw,
    )
