"""phi-3-vision-4.2b [vlm]: phi3-mini backbone + CLIP frontend (STUB).

32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064
[hf:microsoft/Phi-3-vision-128k-instruct; hf]

The CLIP vision tower is a modality-frontend stub: precomputed patch
embeddings [B, 576, d_model] (24x24 patches), passed as `embeds`, are
projected by a single learned matrix and prepended to the token sequence.

Counterpart of `repro/configs/phi3_vision_42b.py`, the same values.
"""
from repro_torch.models.lm.config import LMConfig


def get_config(**kw) -> LMConfig:
    return LMConfig(
        name="phi-3-vision-4.2b",
        family="vlm",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        head_dim=96,
        d_ff=8192,
        vocab=32064,
        frontend="vision",
        frontend_len=576,
        **kw,
    )
