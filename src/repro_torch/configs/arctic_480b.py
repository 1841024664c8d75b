"""arctic-480b [moe]: 128 experts top-2 + dense residual MLP.

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2
[hf:Snowflake/snowflake-arctic-base; hf]

Counterpart of `repro/configs/arctic_480b.py`, the same values.
"""
from repro_torch.models.lm.config import LMConfig


def get_config(**kw) -> LMConfig:
    return LMConfig(
        name="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=4864,  # the parallel dense-residual MLP
        vocab=32000,
        n_experts=128,
        top_k=2,
        moe_d_ff=4864,
        dense_residual=True,
        **kw,
    )
