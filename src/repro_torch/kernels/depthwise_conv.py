"""Quantized K x K depthwise convolution (paper Sec. 4.1.1).

Counterpart of `repro/kernels/depthwise_conv.py`: SAME padding done inside
the kernel (no padded copy in device memory), stride 1 or 2, and the
epilogue y = clip(round((acc + zpc) * mult) + bias_q, 0, qmax) with the
reference interpreter's integer zero-point correction `zpc`, which is
bit-exact with `core/cu.py` (the JAX kernel's float correction `zcorr` is
not: ROADMAP F4; with zpc = 0 and zcorr = 0 the two coincide).

`depthwise_conv_q` launches `csrc/depthwise_conv.cu` for a CUDA tensor and
runs the plain PyTorch version `depthwise_conv_q_plain` for a CPU tensor;
it raises for anything else. `depthwise_conv_q.launches` counts launches.
On the card a thread computes a 2 x 4 patch of outputs for 4 channels
(16-byte loads; one channel where C % 4 != 0), with 32-bit offsets within
an image: an image of x or of the output must hold fewer than 2^31 values.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.integer_ops import int_depthwise_shifts
from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    check_tensor as _check,
    device_guard as _device_guard,
    raw_stream as _raw_stream,
    requant_clip,
    same_pad_amount,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 11 + [_P]


def depthwise_conv_q_plain(x_q, w_q, mult, zpc, bias_q, *, kernel: int = 3,
                           stride: int = 1, qmax: int = 15) -> torch.Tensor:
    """The same function in plain PyTorch (int32 shifted multiply-adds)."""
    if tuple(w_q.shape[:2]) != (kernel, kernel):
        raise ValueError(f"w_q {tuple(w_q.shape)} is not {kernel}x{kernel}")
    acc = int_depthwise_shifts(x_q, w_q, stride=stride)
    return requant_clip(acc, mult, bias_q, qmax, zpc=zpc)


def depthwise_conv_q(x_q: torch.Tensor, w_q: torch.Tensor, mult: torch.Tensor,
                     zpc: torch.Tensor, bias_q: torch.Tensor, *,
                     kernel: int = 3, stride: int = 1,
                     qmax: int = 15) -> torch.Tensor:
    """x_q [B, H, W, C] int32, w_q [K, K, C] int8, mult f32 and zpc, bias_q
    int32 [C] -> int32 [B, ceil(H/s), ceil(W/s), C]."""
    if x_q.device.type == "cpu":
        return depthwise_conv_q_plain(x_q, w_q, mult, zpc, bias_q,
                                      kernel=kernel, stride=stride, qmax=qmax)
    if x_q.device.type != "cuda":
        raise ValueError(f"depthwise_conv_q: no kernel for {x_q.device}")
    b, h, w, c = x_q.shape
    if tuple(w_q.shape) != (kernel, kernel, c):
        raise ValueError(f"w_q {tuple(w_q.shape)} != {(kernel, kernel, c)}")
    dev = x_q.device
    _check(x_q, torch.int32, "x_q")
    _check(w_q, torch.int8, "w_q", dev)
    _check(mult, torch.float32, "mult", dev, c)
    _check(zpc, torch.int32, "zpc", dev, c)
    _check(bias_q, torch.int32, "bias_q", dev, c)
    pad_t, _, ho = same_pad_amount(h, kernel, stride)
    pad_l, _, wo = same_pad_amount(w, kernel, stride)
    if max(h * w, ho * wo) * c >= 2 ** 31:
        raise ValueError(f"depthwise_conv_q: an image of {h}x{w}x{c} "
                         f"exceeds 32-bit offsets")
    out = x_q.new_empty((b, ho, wo, c))  # int32, as x_q: checked above
    fn = _build.function("depthwise_conv", "depthwise_conv_q_launch",
                         _ARGTYPES)
    with _device_guard(x_q):
        err = fn(x_q.data_ptr(), w_q.data_ptr(), mult.data_ptr(),
                 zpc.data_ptr(), bias_q.data_ptr(), out.data_ptr(), b, h, w,
                 c, ho, wo, pad_t, pad_l, kernel, stride, qmax,
                 _raw_stream(x_q))
    if err:
        raise RuntimeError(f"depthwise_conv_q launch failed: CUDA error {err}")
    depthwise_conv_q.launches += 1
    return out


depthwise_conv_q.launches = 0


__all__ = ["depthwise_conv_q", "depthwise_conv_q_plain"]
