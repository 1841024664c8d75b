"""Range-based linear quantization (DeepDive front end, Sec. 3.2).

Counterpart of `repro/core/quant.py`: the paper's quantizer family

  * asymmetric:  [min_x, max_x] -> [0, 2^BW - 1]           (Eq. 7 mapping)
  * symmetric :  [-max|x|, max|x|] -> [-(2^(BW-1) - 1), 2^(BW-1) - 1]

per tensor or per output channel, the fake-quantization operator
(quantize -> dequantize) that quantization-aware training runs with a
clipped straight-through estimator, and int4 packing.

The convention follows Eq. 7 of the paper: x = S * (x_q + m_zp).

Every division here divides by a tensor on the operand's device: PyTorch's
CUDA division by a host scalar multiplies by its reciprocal, which can
round differently from the true division the reference computes, so the
card and the CPU would disagree.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static configuration of one quantizer."""

    bits: int = 4
    symmetric: bool = False
    # axis over which separate (scale, zp) pairs are kept; None = per tensor.
    # For conv weights [K, K, N, M] the paper's per-output-channel mode is -1.
    channel_axis: Optional[int] = None

    @property
    def qmin(self) -> int:
        # symmetric is narrow range, [-(2^(BW-1) - 1), 2^(BW-1) - 1], keeping
        # 0 exact (the reference's default; the port has no wide range)
        if self.symmetric:
            return -(2 ** (self.bits - 1)) + 1
        return 0

    @property
    def qmax(self) -> int:
        if self.symmetric:
            return 2 ** (self.bits - 1) - 1
        return 2**self.bits - 1

    @property
    def levels(self) -> int:
        return self.qmax - self.qmin


def symmetric_range(bits: int) -> Tuple[int, int]:
    """(qmin, qmax) of narrow-range symmetric quantization at `bits`."""
    cfg = QuantConfig(bits, symmetric=True)
    return cfg.qmin, cfg.qmax


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as IEEE division on any device (see the module docstring)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _reduce_dims(x: torch.Tensor, channel_axis: Optional[int]
                 ) -> Tuple[int, ...]:
    if channel_axis is None:
        return tuple(range(x.ndim))
    axis = channel_axis % x.ndim
    return tuple(a for a in range(x.ndim) if a != axis)


def compute_scale_zp(min_x: torch.Tensor, max_x: torch.Tensor,
                     cfg: QuantConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, m_zp) from observed ranges: float scale and an integer-valued
    (float-typed) zero point with dequant(q) = S * (q + m_zp) and 0.0
    representable exactly."""
    zero = torch.zeros((), dtype=min_x.dtype, device=min_x.device)
    min_x = torch.minimum(min_x, zero)  # the range must include 0
    max_x = torch.maximum(max_x, zero)
    one = torch.ones((), dtype=min_x.dtype, device=min_x.device)
    if cfg.symmetric:
        amax = torch.maximum(min_x.abs(), max_x.abs())
        scale = true_div(amax, cfg.qmax)
        scale = torch.where(scale <= 0, one, scale)
        return scale, torch.zeros_like(scale)
    scale = true_div(max_x - min_x, cfg.levels)
    scale = torch.where(scale <= 0, one, scale)
    # x = S * (x_q + m_zp); x = min at x_q = qmin = 0  =>  m_zp = min_x / S
    return scale, torch.round(min_x / scale)


def observe_range(x: torch.Tensor, cfg: QuantConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min/max over everything but the channel axis."""
    dims = _reduce_dims(x, cfg.channel_axis)
    if not dims:  # torch reads an empty dim list as "all dims"
        return x.clone(), x.clone()
    return torch.amin(x, dim=dims), torch.amax(x, dim=dims)


def _broadcast_qparams(x: torch.Tensor, scale: torch.Tensor,
                       zp: torch.Tensor, cfg: QuantConfig):
    if cfg.channel_axis is None:
        return scale, zp
    shape = [1] * x.ndim
    shape[cfg.channel_axis % x.ndim] = -1
    return scale.reshape(shape), zp.reshape(shape)


def quantize(x: torch.Tensor, scale: torch.Tensor, zp: torch.Tensor,
             cfg: QuantConfig) -> torch.Tensor:
    """h: T -> Q, as int32 (round half to even, as `jnp.round`)."""
    s, z = _broadcast_qparams(x, scale, zp, cfg)
    q = torch.round(x / s - z)
    return torch.clamp(q, cfg.qmin, cfg.qmax).to(torch.int32)


def dequantize(q: torch.Tensor, scale: torch.Tensor, zp: torch.Tensor,
               cfg: QuantConfig) -> torch.Tensor:
    s, z = _broadcast_qparams(q, scale, zp, cfg)
    return (q.to(s.dtype) + z) * s


class _FakeQuant(torch.autograd.Function):
    """Quantize -> dequantize; the backward is the clipped STE: the
    gradient reaches x inside [(qmin + z) * s, (qmax + z) * s] and is zero
    outside; scale and zero point get none."""

    @staticmethod
    def forward(ctx, x, scale, zp, cfg):
        s, z = _broadcast_qparams(x, scale, zp, cfg)
        lo = (cfg.qmin + z) * s
        hi = (cfg.qmax + z) * s
        ctx.save_for_backward((x >= lo) & (x <= hi))
        return dequantize(quantize(x, scale, zp, cfg), scale, zp, cfg)

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return torch.where(mask, g, torch.zeros((), dtype=g.dtype,
                                                device=g.device)), \
            None, None, None


def fake_quant(x: torch.Tensor, scale: torch.Tensor, zp: torch.Tensor,
               cfg: QuantConfig) -> torch.Tensor:
    """The online-quantization op: forward emulates the integer datapath,
    backward is the clipped straight-through estimator."""
    return _FakeQuant.apply(x, scale, zp, cfg)


def fake_quant_minmax(x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Fake quant over the tensor's own (detached) dynamic range."""
    mn, mx = observe_range(x.detach(), cfg)
    scale, zp = compute_scale_zp(mn, mx, cfg)
    return fake_quant(x, scale, zp, cfg)


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


def packed_nbytes(shape: Tuple[int, ...], bits: int) -> int:
    """Model-size accounting the paper uses (parameters in Mbit)."""
    n = int(np.prod(shape))
    return (n * bits + 7) // 8


__all__ = [
    "QuantConfig",
    "symmetric_range",
    "true_div",
    "compute_scale_zp",
    "observe_range",
    "quantize",
    "dequantize",
    "fake_quant",
    "fake_quant_minmax",
    "pack_int4",
    "unpack_int4",
    "packed_nbytes",
]
