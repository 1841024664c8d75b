"""qwen2-moe-a2.7b [moe]: 4 shared + 60 routed experts, top-4.

24L d_model=2048 16H (kv=16, MHA) d_ff=1408 vocab=151936, MoE 60e top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

Counterpart of `repro/configs/qwen2_moe_a27b.py`, the same values.
"""
from repro_torch.models.lm.config import LMConfig


def get_config(**kw) -> LMConfig:
    return LMConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab=151936,
        n_experts=60,
        top_k=4,
        moe_d_ff=1408,
        n_shared_experts=4,
        shared_d_ff=4 * 1408,  # shared experts fused into one wide MLP
        **kw,
    )
