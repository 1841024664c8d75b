"""seamless-m4t-large-v2 [audio]: encoder-decoder, multimodal backbone.

24L d_model=1024 16H (kv=16) d_ff=8192 vocab=256206, enc-dec
[arXiv:2308.11596; hf]

The speech frontend (w2v-BERT conformer) is a STUB: precomputed frame
embeddings [B, S_enc, d_model] are passed as `enc_inputs`. The text/unit
backbone is modelled: 24 encoder + 24 decoder transformer layers.

Counterpart of `repro/configs/seamless_m4t_large_v2.py`, the same values.
"""
from repro_torch.models.lm.config import LMConfig


def get_config(**kw) -> LMConfig:
    return LMConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        n_layers=48,  # 24 enc + 24 dec
        n_enc_layers=24,
        n_dec_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=8192,
        vocab=256206,
        frontend="audio",
        frontend_len=1024,
        **kw,
    )
