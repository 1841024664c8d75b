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
share, the argument checks every kernel wrapper makes, and what a wrapper
hands its launch: the current stream, the device guard, and a workspace
reused across calls.
"""
from __future__ import annotations

import contextlib

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


def raw_stream(t: torch.Tensor) -> int:
    """The current CUDA stream of `t`'s device, as the handle a launch
    takes (`torch.cuda.current_stream(...).cuda_stream` without building a
    Stream object: a few microseconds a call less)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


_NO_GUARD = contextlib.nullcontext()


def device_guard(t: torch.Tensor):
    """Make `t`'s device current for a launch. The launchers read the
    current device (`cudaGetDevice`, for the shared-memory attribute and
    the SM count) while `raw_stream` hands them the stream of `t`'s device,
    so a launch on a tensor of another device than the current one needs
    it. The guard is entered only then: on one card a launch pays no host
    time for it."""
    if t.get_device() == torch.cuda.current_device():
        return _NO_GUARD
    return torch.cuda.device(t.device)


_workspaces: dict = {}


def workspace(kernel: str, dtype, numel: int, t: torch.Tensor,
              stream: int) -> torch.Tensor:
    """A buffer of at least `numel` values of `dtype` on `t`'s device for
    the launches of `kernel` on `stream`. The kernel is done with it before
    the next launch on that stream begins, so one buffer a (kernel, device,
    stream) serves every call, and a call allocates nothing once it is
    large enough. It grows and is kept; it never shrinks."""
    key = (kernel, t.get_device(), stream)
    buf = _workspaces.get(key)
    if buf is None or buf.numel() < numel:
        buf = _workspaces[key] = torch.empty(numel, dtype=dtype,
                                             device=t.device)
    return buf


__all__ = ["requant_clip", "same_pad_amount", "check_tensor", "raw_stream",
           "device_guard", "workspace"]
