"""Architecture registry: --arch <id> -> LMConfig / NetSpec.

Counterpart of `repro/configs/registry.py`. `get_config(arch)` returns the
full published configuration; `reduced_config(arch)` a structure-preserving
shrunken one (same family, flags and layer pattern, tiny dims) for CPU
tests and quick runs. The 1-D streaming DS-CNNs are NetSpec archs: their
build record round-trips through `core.qnet.build_netspec`.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.lm.config import LMConfig

# arch id -> module path (LM archs) — the paper's own DSCNNs are separate
ARCHS = {
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a27b",
    "qwen3-32b": "repro_torch.configs.qwen3_32b",
    "llama3.2-1b": "repro_torch.configs.llama32_1b",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "codeqwen1.5-7b": "repro_torch.configs.codeqwen15_7b",
    "phi-3-vision-4.2b": "repro_torch.configs.phi3_vision_42b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "mamba2-1.3b": "repro_torch.configs.mamba2_13b",
}

CNN_ARCHS = ("mobilenet-v2", "efficientnet-compact")

# 1-D streaming DSCNN archs: arch id -> (build-record model family, builder
# defaults). A `.qnet` artifact saved with `build=netspec_build_record(arch)`
# is self-describing: `load_qnet(path)` alone rebuilds the graph.
DSCNN_ARCHS = {
    "dscnn_kws": ("dscnn_kws",
                  dict(input_t=49, input_ch=10, channels=64, n_blocks=4,
                       kernel=3, bits=8, num_classes=12)),
    "dscnn_har": ("dscnn_har",
                  dict(input_t=128, input_ch=3, stem_channels=48,
                       channels=[96, 128, 160], kernel=5, bits=8,
                       num_classes=12)),
}


def netspec_build_record(arch: str, **kw) -> dict:
    """Build record for a registered NetSpec arch (builder knob overrides
    in `kw`). Feed to `save_qnet(build=...)`; `build_netspec` inverts it."""
    if arch not in DSCNN_ARCHS:
        raise KeyError(
            f"unknown netspec arch {arch!r}; known: {sorted(DSCNN_ARCHS)}")
    model, defaults = DSCNN_ARCHS[arch]
    rec = {"model": model, **defaults}
    rec.update(kw)
    return rec


def get_netspec(arch: str, **kw):
    """Registered arch id -> built NetSpec (knob overrides in `kw`)."""
    from repro_torch.core.qnet import build_netspec
    return build_netspec(netspec_build_record(arch, **kw))


def get_config(arch: str, **kw) -> LMConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)} + "
                       f"{CNN_ARCHS} + {tuple(sorted(DSCNN_ARCHS))}")
    mod = importlib.import_module(ARCHS[arch])
    return mod.get_config(**kw)


def reduced_config(arch: str, **kw) -> LMConfig:
    """Shrink dims, keep structure (family, pattern, flags, divisibility)."""
    cfg = get_config(arch, **kw)
    r = dict(
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
    )
    if cfg.family == "hybrid":
        r.update(n_layers=max(len(cfg.block_pattern),
                              len(cfg.block_pattern)
                              + cfg.n_layers % len(cfg.block_pattern)),
                 lru_width=64, local_window=32)
    elif cfg.family in ("encdec", "audio"):
        r.update(n_layers=4, n_enc_layers=2, n_dec_layers=2, frontend_len=16)
    elif cfg.family == "ssm":
        r.update(n_layers=2, ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
    else:
        r.update(n_layers=2)
    if cfg.family == "moe":
        # capacity_factor = n_experts makes routing lossless (cap == T), so
        # prefill/decode equal the teacher-forced forward
        r.update(n_experts=min(cfg.n_experts, 8), top_k=min(cfg.top_k, 2),
                 moe_d_ff=64, capacity_factor=8.0,
                 shared_d_ff=64 if cfg.n_shared_experts else 0)
    if cfg.family == "vlm":
        r.update(frontend_len=8)
    return dataclasses.replace(cfg, **r)


__all__ = ["ARCHS", "CNN_ARCHS", "DSCNN_ARCHS", "get_config",
           "reduced_config", "get_netspec", "netspec_build_record"]
