"""mamba2-1.3b [ssm]: SSD (state-space duality), attention-free.

48L d_model=2048 d_ff=0 vocab=50280, ssm_state=128
[arXiv:2405.21060; unverified]

Counterpart of `repro/configs/mamba2_13b.py`, the same values.
"""
from repro_torch.models.lm.config import LMConfig


def get_config(**kw) -> LMConfig:
    return LMConfig(
        name="mamba2-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=32,  # d_inner / ssm_head_dim = 4096 / 128
        n_kv_heads=32,
        d_ff=0,
        vocab=50280,
        ssm_state=128,
        ssm_head_dim=128,
        ssm_expand=2,
        ssm_chunk=256,
        conv_width=4,
        tie_embeddings=True,
        **kw,
    )
