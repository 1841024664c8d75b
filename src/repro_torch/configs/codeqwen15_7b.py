"""codeqwen1.5-7b [dense]: qwen1.5 architecture (MHA).

32L d_model=4096 32H (kv=32) d_ff=13440 vocab=92416
[hf:Qwen/CodeQwen1.5-7B; hf]

Counterpart of `repro/configs/codeqwen15_7b.py`, the same values.
"""
from repro_torch.models.lm.config import LMConfig


def get_config(**kw) -> LMConfig:
    return LMConfig(
        name="codeqwen1.5-7b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        head_dim=128,
        d_ff=13440,
        vocab=92416,
        **kw,
    )
