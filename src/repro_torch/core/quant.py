"""Symmetric weight ranges and int4 packing.

Counterpart of `repro/core/quant.py`, only what the weight-only quantized
matmul needs: the narrow-range symmetric integer range of a bit-width
(`QuantConfig.qmin`/`qmax` with `symmetric=True`: [-127, 127] at 8 bits,
[-7, 7] at 4, keeping 0 exact) and `pack_int4`/`unpack_int4`, two signed
nibbles a byte along the last axis. The fake-quant and QAT half of that
module comes with the training front end (ROADMAP queue 1 item 10).
"""
from __future__ import annotations

from typing import Tuple

import torch


def symmetric_range(bits: int) -> Tuple[int, int]:
    """(qmin, qmax) of narrow-range symmetric quantization at `bits`."""
    qmax = 2 ** (bits - 1) - 1
    return -qmax, qmax


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack integer values in [0, 15] (or [-8, 7]) pairwise into uint8
    along the last axis, which must be even. Low nibble = even index, high
    nibble = odd index."""
    if q.shape[-1] % 2:
        raise ValueError(
            f"last axis must be even for int4 packing: {tuple(q.shape)}")
    u = q.to(torch.int32) & 0xF
    return (u[..., 0::2] | (u[..., 1::2] << 4)).to(torch.uint8)


def unpack_int4(p: torch.Tensor, signed: bool = False) -> torch.Tensor:
    """uint8 [..., n] -> int32 [..., 2n]; `signed` sign-extends each nibble
    (q >= 8 -> q - 16)."""
    p = p.to(torch.int32)
    q = torch.stack([p & 0xF, (p >> 4) & 0xF], dim=-1).reshape(
        *p.shape[:-1], p.shape[-1] * 2)
    if signed:
        q = torch.where(q >= 8, q - 16, q)
    return q


__all__ = ["symmetric_range", "pack_int4", "unpack_int4"]
