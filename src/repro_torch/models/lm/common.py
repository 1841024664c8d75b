"""Transformer building blocks shared by the LM architectures.

Counterpart of `repro/models/lm/common.py`. Only the int8 KV cache is here
so far — `kv_quant` and `kv_dequant`, which make the cache and its bf16
per-(position, kv-head) scales exactly as the LM does — since the kernel
ops' `decode_attend` reads such a cache. Linear, norm, rope and attention
come with the LM model and engine (ROADMAP queue 1 item 12).
"""
from __future__ import annotations

import torch

F32 = torch.float32


def kv_quant(x: torch.Tensor):
    """[..., dh] float -> (int8 [..., dh], bf16 scale [...]): symmetric
    per-row scale max(amax / 127, 1e-8), values rounded half to even."""
    xf = x.to(F32)
    amax = xf.abs().amax(dim=-1)
    # a 0-dim device tensor, not a Python number: PyTorch's CUDA division
    # by a host scalar multiplies by its reciprocal, which can round
    # differently from the reference's true division
    scale = torch.clamp_min(amax / torch.full((), 127.0, dtype=F32,
                                              device=x.device), 1e-8)
    q = torch.round(xf / scale[..., None]).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def kv_dequant(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.to(F32) * scale[..., None].to(F32)).to(dtype)


__all__ = ["kv_quant", "kv_dequant"]
