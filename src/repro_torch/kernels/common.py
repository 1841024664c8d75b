"""Shared epilogue of the quantized kernels (paper Fig. 8, Approximator &
Clip), plain PyTorch version.

Counterpart of `repro/kernels/common.py::requant_clip`. On the card the same
function is `requant_clip` in `csrc/common.cuh`, a `__device__` function
every kernel of this package calls:

    y = clip( round((acc + zpc) * mult) + bias_q, 0, qmax )

`zpc` is the integer zero-point correction int32(z_x) * wsum, the form the
reference interpreter `core/cu.py` uses (the JAX Pallas kernels' float
correction round(acc * mult + zcorr) rounds differently: ROADMAP F4).
Rounding is half to even; the multiply is one f32 rounding.

Also here: the SAME padding arithmetic the kernels and the reference ops
share, and the argument checks every kernel wrapper makes.
"""
from __future__ import annotations

import torch


def same_pad_amount(size: int, kernel: int, stride: int):
    """SAME padding (lo, hi) for one spatial dim, and the output size."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    lo = total // 2
    return lo, total - lo, out


def requant_clip(acc: torch.Tensor, mult: torch.Tensor, bias_q: torch.Tensor,
                 qmax: int, *, zpc=0) -> torch.Tensor:
    """acc: int32 [..., C]; mult: f32 [C]; zpc/bias_q: int32 [C]."""
    y = torch.round((acc + zpc).to(torch.float32) * mult).to(torch.int32)
    return torch.clamp(y + bias_q, 0, qmax)


def check_tensor(t: torch.Tensor, dtype, name: str, device=None,
                 numel=None) -> None:
    """Refuse what a kernel does not take: another type, device or size, or
    a non-contiguous layout."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: {t.dtype}, the kernel takes {dtype}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name}: {t.numel()} values, expected {numel}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


__all__ = ["requant_clip", "same_pad_amount", "check_tensor"]
