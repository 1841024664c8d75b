"""Integer inference arithmetic — the Approximator & Clip unit (Sec. 4.1),
in PyTorch.

Counterpart of `repro/core/integer_ops.py`. The number system is the same:

    y_q = clip( round( M[c] * (acc[c] + z_x * wsum[c]) ) + b_q[c], 0, qmax )

with acc = sum x_q * w_q (int32), M the f32 requant multiplier and
round() half to even (`torch.round`, like `jnp.round`). Fixed-point mode
replaces the multiply by the FPGA's integer one: M ~= mantissa * 2^-shift,
acc * mantissa in int64, rounded half away from zero by the shift.

The accumulators are integers, but CUDA has no int32 matmul or convolution
in PyTorch, so `int_conv2d`, `int_conv1d` and `int_pointwise` compute them
in floating point where that is exact: float64 always is (every product and
partial sum of int8 weights and uint8 activations is an integer far below
2^53), float32 is when `f32_accum_exact` holds (every partial sum below
2^24). So the port's `int_ref` formulation (the JAX package's int32 XLA
ops) is the float64 one, and `int_f32` the float32 one. The float32 matmul
refuses to run with TF32 matmuls enabled, which would round the products;
cuDNN's TF32 is switched off around the float32 convolutions
(`int_conv2d_f32`, `int_conv1d_f32`). The 1-D convolutions take NTC
activations and explicit `(lo, hi)` pads for the streaming engine's edge
segments. `groups=C` turns either convolution into the depthwise one (the
DW `int_ref` route); the default depthwise accumulations are int32 shifted
multiply-adds on any device.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.common import same_pad_amount


def quantize_multiplier(m: np.ndarray, bits: int = 31
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Decompose positive float multiplier(s) M into (mantissa, shift) with
    M ~= mantissa * 2^-shift, mantissa in [2^(bits-1), 2^bits)."""
    m = np.asarray(m, np.float64)
    if np.any(m <= 0):
        raise ValueError("requant multiplier must be positive")
    exp = np.ceil(np.log2(m))
    mant = m / np.exp2(exp)  # in (0.5, 1]
    mantissa = np.round(mant * (1 << bits)).astype(np.int64)
    # mant == 1.0 rounds up to 2^bits
    overflow = mantissa == (1 << bits)
    mantissa = np.where(overflow, mantissa >> 1, mantissa)
    exp = np.where(overflow, exp + 1, exp)
    shift = (bits - exp).astype(np.int32)
    return mantissa, shift


def requantize_fixedpoint(acc: torch.Tensor, mantissa: torch.Tensor,
                          shift: torch.Tensor) -> torch.Tensor:
    """round(acc * mantissa * 2^-shift) in integer arithmetic, int64 wide,
    rounded half away from zero (the FPGA 'Approximator'). The rounding
    bias is sign * 2^(shift-1), built from a non-negative shift; `>>` on
    int64 is arithmetic on the CPU and on CUDA."""
    wide = acc.to(torch.int64) * mantissa.to(torch.int64)
    sh = shift.to(torch.int64)
    one = torch.ones_like(sh)
    half = torch.where(sh > 0, torch.bitwise_left_shift(
        one, torch.clamp(sh - 1, min=0)), torch.zeros_like(sh))
    sign = torch.where(wide >= 0, 1, -1).to(torch.int64)
    return torch.bitwise_right_shift(wide + sign * half, sh).to(torch.int32)


def requantize_float(acc: torch.Tensor, mult: torch.Tensor) -> torch.Tensor:
    return torch.round(acc.to(torch.float32) * mult).to(torch.int32)


def clip_act(y_q: torch.Tensor, qmax: int) -> torch.Tensor:
    """The Clip unit == fused ReLU6 (h^pq maps [0,6] onto [0, qmax])."""
    return torch.clamp(y_q, 0, qmax)


@contextlib.contextmanager
def _cudnn_without_tf32():
    """cuDNN's float32 convolutions with TF32 off (it defaults to on), which
    would round the products of an exact integer accumulation."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _conv2d(x_q: torch.Tensor, w_hwio: torch.Tensor, stride: int,
            groups: int) -> torch.Tensor:
    _, h, w, _ = x_q.shape
    k = w_hwio.shape[0]
    ph_lo, ph_hi, _ = same_pad_amount(h, k, stride)
    pw_lo, pw_hi, _ = same_pad_amount(w, k, stride)
    xt = F.pad(x_q.to(w_hwio.dtype).permute(0, 3, 1, 2),
               (pw_lo, pw_hi, ph_lo, ph_hi))
    y = F.conv2d(xt, w_hwio.permute(3, 2, 0, 1), stride=stride,
                 groups=groups)
    return y.permute(0, 2, 3, 1).to(torch.int32).contiguous()


def int_conv2d(x_q: torch.Tensor, w_hwio: torch.Tensor, stride: int = 1,
               groups: int = 1) -> torch.Tensor:
    """Integer convolution, SAME padding, NHWC in and out, in float64 (exact
    on any device). `w_hwio` is [K, K, Cin/groups, Cout]; `groups=C` with a
    [K, K, 1, C] weight is the depthwise convolution."""
    return _conv2d(x_q, w_hwio.to(torch.float64), stride, groups)


def int_conv2d_f32(x_q: torch.Tensor, w_hwio: torch.Tensor,
                   stride: int = 1) -> torch.Tensor:
    """`int_conv2d` in float32: exact only where `f32_accum_exact` holds
    for the weights and the input range, and run with cuDNN's TF32 off."""
    with _cudnn_without_tf32():
        return _conv2d(x_q, w_hwio.to(torch.float32), stride, 1)


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


def _conv1d_pads(t: int, kernel: int, stride: int,
                 padding) -> Tuple[int, int]:
    """(lo, hi) zero frames of a 1-D conv: "SAME", "VALID" or an explicit
    (lo, hi) pair (the streaming engine's edge segments)."""
    if isinstance(padding, str):
        if padding == "SAME":
            lo, hi, _ = same_pad_amount(t, kernel, stride)
            return lo, hi
        if padding == "VALID":
            return 0, 0
        raise ValueError(padding)
    return int(padding[0]), int(padding[1])


def _conv1d(x_q: torch.Tensor, w_kio: torch.Tensor, stride: int,
            padding, groups: int = 1) -> torch.Tensor:
    k = w_kio.shape[0]
    lo, hi = _conv1d_pads(x_q.shape[1], k, stride, padding)
    xt = F.pad(x_q.to(w_kio.dtype).permute(0, 2, 1), (lo, hi))
    y = F.conv1d(xt, w_kio.permute(2, 1, 0), stride=stride, groups=groups)
    return y.permute(0, 2, 1).to(torch.int32).contiguous()


def int_conv1d(x_q: torch.Tensor, w_kio: torch.Tensor, stride: int = 1,
               padding="SAME", groups: int = 1) -> torch.Tensor:
    """Integer temporal convolution, NTC in and out, in float64 (exact on
    any device). `w_kio` is [K, Cin/groups, Cout]; `groups=C` with a
    [K, 1, C] weight is the depthwise one. `padding` is "SAME", "VALID" or
    (lo, hi)."""
    return _conv1d(x_q, w_kio.to(torch.float64), stride, padding, groups)


def int_conv1d_f32(x_q: torch.Tensor, w_kio: torch.Tensor, stride: int = 1,
                   padding="SAME") -> torch.Tensor:
    """`int_conv1d` in float32: exact only where `f32_accum_exact` holds
    for the weights and the input range, and run with cuDNN's TF32 off."""
    with _cudnn_without_tf32():
        return _conv1d(x_q, w_kio.to(torch.float32), stride, padding)


def int_depthwise1d_shifts(x_q: torch.Tensor, w_q: torch.Tensor,
                           stride: int = 1, padding="SAME") -> torch.Tensor:
    """Depthwise temporal conv as K shifted int32 multiply-adds.

    x_q: [B, T, C] int32; w_q: [K, C]. Bit-identical to a grouped integer
    convolution. `padding` is "SAME", "VALID" or (lo, hi)."""
    b, t, c = x_q.shape
    kernel = w_q.shape[0]
    lo, hi = _conv1d_pads(t, kernel, stride, padding)
    t_out = (t + lo + hi - kernel) // stride + 1
    xp = F.pad(x_q.to(torch.int32), (0, 0, lo, hi))
    w2 = w_q.to(torch.int32)
    acc = torch.zeros((b, t_out, c), dtype=torch.int32, device=x_q.device)
    for ki in range(kernel):
        acc += xp[:, ki:ki + (t_out - 1) * stride + 1:stride, :] * w2[ki]
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


# 14-bit mantissas keep every term of the integer skip-add below 2^24, so it
# is exact in int32 (255 * 2^14 * 2 + |c| < 2^31).
RESIDUAL_MANT_BITS = 14


def residual_fixed_consts(a_s: float, a_z: float, b_s: float, b_z: float,
                          y_s: float, y_z: float):
    """Fold the skip-add rescale into integer constants (host side, once):
    (m_a, m_b, c, shift, zy) with
    y_q = round_shift(a_q*m_a + b_q*m_b + c, shift) - zy."""
    r_a, r_b = a_s / y_s, b_s / y_s
    _, shift = quantize_multiplier(max(r_a, r_b), bits=RESIDUAL_MANT_BITS)
    shift = int(shift)
    m_a = int(round(r_a * 2.0**shift))
    m_b = int(round(r_b * 2.0**shift))
    c = int(round((a_z * r_a + b_z * r_b) * 2.0**shift))
    return m_a, m_b, c, shift, int(round(y_z))


def int_residual_add(a_q: torch.Tensor, b_q: torch.Tensor, consts,
                     qmax: int) -> torch.Tensor:
    """Integer skip-line add, int32 throughout:
    y = clip(round_shift(a*m_a + b*m_b + c, shift) - zy, 0, qmax), rounded
    half away from zero like `requantize_fixedpoint`."""
    m_a, m_b, c, shift, zy = consts
    wide = a_q.to(torch.int32) * m_a + b_q.to(torch.int32) * m_b + c
    if shift > 0:
        sign = torch.where(wide >= 0, 1, -1).to(torch.int32)
        wide = wide + sign * (1 << (shift - 1))
    y = torch.bitwise_right_shift(wide, shift) - zy
    return clip_act(y, qmax).to(torch.int32)


def quantized_op_epilogue(acc: torch.Tensor, zpc: torch.Tensor,
                          bias_q: torch.Tensor, mult: torch.Tensor,
                          qmax: int, *, fixed_point: bool = False,
                          mantissa=None, shift=None) -> torch.Tensor:
    """acc -> +z_x*wsum (integer, `zpc`) -> requant -> +bias -> clip.

    The requant is the f32 multiplier, or with `fixed_point` the integer
    (mantissa, shift) pair. bias_q is in output-quant units with the output
    zero point folded in, so the result is clipped to [0, qmax] for linear
    ops too."""
    if fixed_point:
        y = requantize_fixedpoint(acc + zpc, mantissa, shift)
    else:
        y = requantize_float(acc + zpc, mult)
    return clip_act(y + bias_q, qmax)


__all__ = [
    "quantize_multiplier",
    "requantize_fixedpoint",
    "requantize_float",
    "clip_act",
    "int_conv2d",
    "int_conv2d_f32",
    "int_conv1d",
    "int_conv1d_f32",
    "int_pointwise",
    "int_depthwise_shifts",
    "int_depthwise1d_shifts",
    "f32_accum_exact",
    "RESIDUAL_MANT_BITS",
    "residual_fixed_consts",
    "int_residual_add",
    "quantized_op_epilogue",
]
