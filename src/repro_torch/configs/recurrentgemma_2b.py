"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 1 attn : 2 rec.

26L d_model=2560 10H (GQA kv=1 == MQA) d_ff=7680 vocab=256000
[arXiv:2402.19427; hf]

Counterpart of `repro/configs/recurrentgemma_2b.py`, the same values.
"""
from repro_torch.models.lm.config import LMConfig


def get_config(**kw) -> LMConfig:
    return LMConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab=256000,
        block_pattern=("rec", "rec", "attn"),
        lru_width=2560,
        conv_width=4,
        local_window=2048,
        tie_embeddings=True,
        **kw,
    )
