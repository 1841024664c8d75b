"""Fused inverted-residual block — the Body CU (paper Sec. 4.2.3).

Counterpart of `repro/kernels/fused_irb.py`: PW expand -> requant -> K x K
depthwise (SAME) -> requant -> PW project -> requant -> optional residual,
with the expanded tensor kept in shared memory (`csrc/fused_irb.cu`).

Unlike the JAX kernel, every stage takes the reference interpreter's
integer zero-point correction `zpc` (round((acc + zpc) * mult)), and the
residual is `core/cu.py::residual_add`'s form, so the result is bit-exact
with `cu.run_block` (the JAX kernel's float forms are not: ROADMAP F4).
With zpc = 0 and no residual it equals the JAX `fused_irb_q` with zcorr = 0.

`fused_irb_q` launches the CUDA kernel for a CUDA tensor and runs the plain
PyTorch version `fused_irb_q_plain` for a CPU tensor; it raises for
anything else. `fused_irb_q.launches` counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.cu import residual_add
from repro_torch.kernels import _build
from repro_torch.kernels.common import check_tensor as _check, same_pad_amount
from repro_torch.kernels.depthwise_conv import depthwise_conv_q_plain
from repro_torch.kernels.pointwise_conv import pointwise_conv_q_plain

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = ([_P] * 14 + [_I] * 17 + [_F] * 4 + [_I, _P])
THREADS = 256
NACCS = (4, 8, 16, 32, 64)  # output values a thread accumulates, compiled

# (a_s, a_z, b_s, b_z, y_s, y_z): the block input's, the projection's and
# the sum's quantizers
ResQ = Tuple[float, float, float, float, float, float]


def fused_irb_q_plain(x_q, w1, m1, z1, b1, w2, m2, z2, b2, w3, m3, z3, b3, *,
                      kernel: int = 3, stride: int = 1, qmax: int = 15,
                      residual: bool = False,
                      res_q: Optional[ResQ] = None) -> torch.Tensor:
    """The same function in plain PyTorch: the three ops one after another,
    with the expanded tensor in memory."""
    e = pointwise_conv_q_plain(x_q, w1, m1, z1, b1, qmax=qmax)
    d = depthwise_conv_q_plain(e, w2, m2, z2, b2, kernel=kernel,
                               stride=stride, qmax=qmax)
    y = pointwise_conv_q_plain(d, w3, m3, z3, b3, qmax=qmax)
    if residual:
        a_s, a_z, b_s, b_z, y_s, y_z = res_q
        y = residual_add(x_q, a_s, a_z, y, b_s, b_z, y_s, y_z, qmax)
    return y


def default_tile(ho: int, wo: int, c_out: int) -> Tuple[int, int]:
    """Output tile (rows, cols) of one block: up to 8 x 8, shrunk until a
    thread holds at most max(NACCS) projection accumulators."""
    th, tw = min(8, ho), min(8, wo)
    while th * tw * c_out > NACCS[-1] * THREADS and th * tw > 1:
        if th >= tw:
            th -= 1
        else:
            tw -= 1
    return th, tw


def fused_irb_q(x_q, w1, m1, z1, b1, w2, m2, z2, b2, w3, m3, z3, b3, *,
                kernel: int = 3, stride: int = 1, qmax: int = 15,
                residual: bool = False,
                res_q: Optional[ResQ] = None) -> torch.Tensor:
    """x_q [B, H, W, C] int32; w1 [C, E], w2 [K, K, E], w3 [E, Co] int8;
    m* f32 and z*, b* int32 per output channel of each stage ->
    int32 [B, ceil(H/s), ceil(W/s), Co]. Activations must lie in [0, 255].
    One thread block computes a `default_tile` of the output."""
    if x_q.device.type == "cpu":
        return fused_irb_q_plain(x_q, w1, m1, z1, b1, w2, m2, z2, b2, w3, m3,
                                 z3, b3, kernel=kernel, stride=stride,
                                 qmax=qmax, residual=residual, res_q=res_q)
    if x_q.device.type != "cuda":
        raise ValueError(f"fused_irb_q: no kernel for {x_q.device}")
    b, h, w, c = x_q.shape
    e_ch, c_out = w1.shape[1], w3.shape[1]
    if (tuple(w1.shape) != (c, e_ch) or tuple(w2.shape) != (kernel, kernel, e_ch)
            or tuple(w3.shape) != (e_ch, c_out)):
        raise ValueError(f"weights {tuple(w1.shape)}, {tuple(w2.shape)}, "
                         f"{tuple(w3.shape)} do not chain from {c} channels")
    if qmax > 255:
        raise ValueError("fused_irb_q keeps activations as uint8: qmax <= 255")
    if residual and (stride != 1 or c != c_out):
        raise ValueError("a residual block needs stride 1 and C == C_out")
    dev = x_q.device
    _check(x_q, torch.int32, "x_q")
    for name, t, n in (("w1", w1, None), ("w2", w2, None), ("w3", w3, None)):
        _check(t, torch.int8, name, dev, n)
    for name, t, n in (("m1", m1, e_ch), ("m2", m2, e_ch), ("m3", m3, c_out)):
        _check(t, torch.float32, name, dev, n)
    for name, t, n in (("z1", z1, e_ch), ("b1", b1, e_ch), ("z2", z2, e_ch),
                       ("b2", b2, e_ch), ("z3", z3, c_out),
                       ("b3", b3, c_out)):
        _check(t, torch.int32, name, dev, n)
    pad_t, _, ho = same_pad_amount(h, kernel, stride)
    pad_l, _, wo = same_pad_amount(w, kernel, stride)
    th, tw = default_tile(ho, wo, c_out)
    nacc = next((n for n in NACCS if th * tw * c_out <= n * THREADS), None)
    if nacc is None:
        raise ValueError(f"{c_out} output channels need more than "
                         f"{NACCS[-1]} accumulators a thread")
    a_z = ra = b_z = rb = 0.0
    ryz = 0
    if residual:
        a_s, a_z, b_s, b_z, y_s, y_z = res_q
        ra, rb, ryz = a_s / y_s, b_s / y_s, round(y_z)
    out = torch.empty((b, ho, wo, c_out), dtype=torch.int32, device=dev)
    fn = _build.function("fused_irb", "fused_irb_q_launch", _ARGTYPES)
    err = fn(x_q.data_ptr(), w1.data_ptr(), m1.data_ptr(), z1.data_ptr(),
             b1.data_ptr(), w2.data_ptr(), m2.data_ptr(), z2.data_ptr(),
             b2.data_ptr(), w3.data_ptr(), m3.data_ptr(), z3.data_ptr(),
             b3.data_ptr(), out.data_ptr(), b, h, w, c, e_ch, c_out, ho, wo,
             pad_t, pad_l, th, tw, kernel, stride, qmax, nacc, int(residual),
             a_z, ra, b_z, rb, ryz,
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"fused_irb_q launch failed: CUDA error {err}")
    fused_irb_q.launches += 1
    return out


fused_irb_q.launches = 0


__all__ = ["fused_irb_q", "fused_irb_q_plain", "default_tile"]
