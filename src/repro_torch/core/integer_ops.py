"""Integer inference arithmetic — the Approximator & Clip unit (Sec. 4.1),
float-multiplier mode, in PyTorch.

Counterpart of `repro/core/integer_ops.py`. The number system is the same:

    y_q = clip( round( M[c] * (acc[c] + z_x * wsum[c]) ) + b_q[c], 0, qmax )

with acc = sum x_q * w_q (int32), M the f32 requant multiplier and
round() half to even (`torch.round`, like `jnp.round`).

The accumulators are integers, but CUDA has no int32 matmul or convolution
in PyTorch, so `int_conv2d` and `int_pointwise` compute them in floating
point where that is exact: float64 always is (|acc| < 2^53), float32 is when
`f32_accum_exact` holds (every partial sum below 2^24). The float32 route
refuses to run with TF32 matmuls enabled, which would round the products.
The depthwise accumulation is int32 shifted multiply-adds on any device.

Fixed-point mode (the FPGA's integer mantissa/shift requant) and the 1-D ops
are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.common import same_pad_amount


def requantize_float(acc: torch.Tensor, mult: torch.Tensor) -> torch.Tensor:
    return torch.round(acc.to(torch.float32) * mult).to(torch.int32)


def clip_act(y_q: torch.Tensor, qmax: int) -> torch.Tensor:
    """The Clip unit == fused ReLU6 (h^pq maps [0,6] onto [0, qmax])."""
    return torch.clamp(y_q, 0, qmax)


def int_conv2d(x_q: torch.Tensor, w_hwio: torch.Tensor,
               stride: int = 1) -> torch.Tensor:
    """Integer convolution, SAME padding, NHWC in and out. `w_hwio` is the
    HWIO weight in float64, so the accumulation is exact on any device."""
    _, h, w, _ = x_q.shape
    k = w_hwio.shape[0]
    ph_lo, ph_hi, _ = same_pad_amount(h, k, stride)
    pw_lo, pw_hi, _ = same_pad_amount(w, k, stride)
    xt = F.pad(x_q.to(w_hwio.dtype).permute(0, 3, 1, 2),
               (pw_lo, pw_hi, ph_lo, ph_hi))
    y = F.conv2d(xt, w_hwio.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1).to(torch.int32).contiguous()


def int_pointwise(x_q: torch.Tensor, w_acc: torch.Tensor) -> torch.Tensor:
    """Pointwise conv == matmul over the channel axis. `w_acc` is [Cin, Cout]
    in the accumulation type: float64, or float32 when `f32_accum_exact`
    holds for the weights and the input range."""
    if w_acc.dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "int_pointwise: float32 accumulation is exact only without TF32 "
            "(torch.backends.cuda.matmul.allow_tf32 is True)")
    return torch.matmul(x_q.to(w_acc.dtype), w_acc).to(torch.int32)


def int_depthwise_shifts(x_q: torch.Tensor, w_q: torch.Tensor,
                         stride: int = 1) -> torch.Tensor:
    """Depthwise conv as K x K shifted int32 multiply-adds, SAME padding.

    x_q: [B, H, W, C] int32; w_q: [K, K, C]. Bit-identical to a grouped
    integer convolution."""
    b, h, w, c = x_q.shape
    kernel = w_q.shape[0]
    ph_lo, ph_hi, h_out = same_pad_amount(h, kernel, stride)
    pw_lo, pw_hi, w_out = same_pad_amount(w, kernel, stride)
    xp = F.pad(x_q.to(torch.int32), (0, 0, pw_lo, pw_hi, ph_lo, ph_hi))
    w3 = w_q.to(torch.int32)
    acc = torch.zeros((b, h_out, w_out, c), dtype=torch.int32,
                      device=x_q.device)
    for ki in range(kernel):
        for kj in range(kernel):
            patch = xp[:, ki:ki + (h_out - 1) * stride + 1:stride,
                       kj:kj + (w_out - 1) * stride + 1:stride, :]
            acc += patch * w3[ki, kj]
    return acc


def f32_accum_exact(w_q: np.ndarray, in_qmax: int) -> bool:
    """True when an f32 accumulation over `w_q`'s reduction axes is exact:
    activations lie in [0, in_qmax], so every partial sum is at most
    in_qmax * max_n(sum_k |w_q[..., n]|), and integers below 2^24 are exact
    in f32 whatever the summation order."""
    w = np.abs(np.asarray(w_q, np.int64))
    red = tuple(range(w.ndim - 1))
    colsum = w.sum(axis=red).max() if w.size else 0
    return int(in_qmax) * int(colsum) < 2**24


def quantized_op_epilogue(acc: torch.Tensor, zpc: torch.Tensor,
                          bias_q: torch.Tensor, mult: torch.Tensor,
                          qmax: int) -> torch.Tensor:
    """acc -> +z_x*wsum (integer, `zpc`) -> requant -> +bias -> clip.

    bias_q is in output-quant units with the output zero point folded in,
    so the result is clipped to [0, qmax] for linear ops too."""
    y = requantize_float(acc + zpc, mult) + bias_q
    return clip_act(y, qmax)


__all__ = [
    "requantize_float",
    "clip_act",
    "int_conv2d",
    "int_pointwise",
    "int_depthwise_shifts",
    "f32_accum_exact",
    "quantized_op_epilogue",
]
