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

`plan(b, h, w, c, e, c_out, kernel, stride)` decides a launch in plain
Python: the output tile of a block (`default_tile`), and how many slices E
is cut into. Where the tiles of the batch leave more than half the SMs
idle (MobileNetV2's 14x14 and 7x7 blocks), each block takes one slice of E
and writes its int32 partial projections to a workspace kept across calls
(`common.workspace`); a second pass adds them and runs the epilogue.
`fused_irb_q.variants` counts launches as "single" or "split_e".
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.cu import residual_add
from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    check_tensor as _check, device_guard as _device_guard,
    raw_stream as _raw_stream, same_pad_amount,
    workspace as _workspace)
from repro_torch.kernels.depthwise_conv import depthwise_conv_q_plain
from repro_torch.kernels.pointwise_conv import SMS, pointwise_conv_q_plain

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = ([_P] * 15 + [_I] * 20 + [_F] * 4 + [_I, _P])
THREADS = 256
NACCS = (4, 8, 16, 32, 64)  # output values a thread accumulates, compiled
CHUNK = 32  # expanded channels a block walks at a time
SMEM_MAX = 232448  # shared memory a block may have on an H100 (227 KB)

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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class Plan(NamedTuple):
    """The output tile (rows, cols) of a block, the projection accumulators
    `nacc` a thread holds, and E cut into `splits` slices of `eslice`
    channels (whole chunks; the last one shorter)."""
    tile: Tuple[int, int]
    nacc: int
    splits: int
    eslice: int

    def workspace_numel(self, m: int, n: int) -> int:
        """The int32 partials of `m` output pixels x `n` channels a launch
        needs: none for one slice."""
        return self.splits * m * n if self.splits > 1 else 0

    def smem_bytes(self, c: int, c_out: int, kernel: int,
                   stride: int) -> int:
        """Shared memory of a block: the input patch as u8, a chunk's
        w1/w2/w3 and its expanded and depthwise tiles
        (`csrc/fused_irb.cu` smem_bytes; the launch refuses another)."""
        (th, tw), xw = self.tile, _cdiv(c, 4)
        p = ((th - 1) * stride + kernel) * ((tw - 1) * stride + kernel)
        return 4 * (p * xw + CHUNK * (xw | 1) + kernel * kernel * CHUNK
                    + c_out * (CHUNK // 4 + 1) + th * tw * CHUNK // 4
                    ) + p * CHUNK


@functools.lru_cache(maxsize=4096)  # called on every launch
def plan(b: int, h: int, w: int, c: int, e: int, c_out: int, kernel: int,
         stride: int) -> Plan:
    """The tile and the E slices of a launch on a [b, h, w, c] input. E is
    split where the tiles of the batch cover at most half the SMs, into
    enough slices for about two blocks an SM."""
    ho, wo = _cdiv(h, stride), _cdiv(w, stride)
    th, tw = default_tile(ho, wo, c_out)
    nacc = next((n for n in NACCS if th * tw * c_out <= n * THREADS), None)
    if nacc is None:
        raise ValueError(f"{c_out} output channels need more than "
                         f"{NACCS[-1]} accumulators a thread")
    blocks = _cdiv(ho, th) * _cdiv(wo, tw) * b
    chunks = _cdiv(e, CHUNK)
    splits = min(chunks, _cdiv(2 * SMS, blocks)) if 2 * blocks <= SMS else 1
    per = _cdiv(chunks, splits)
    return Plan((th, tw), nacc, _cdiv(chunks, per), per * CHUNK)


def fused_irb_q(x_q, w1, m1, z1, b1, w2, m2, z2, b2, w3, m3, z3, b3, *,
                kernel: int = 3, stride: int = 1, qmax: int = 15,
                residual: bool = False,
                res_q: Optional[ResQ] = None) -> torch.Tensor:
    """x_q [B, H, W, C] int32; w1 [C, E], w2 [K, K, E], w3 [E, Co] int8;
    m* f32 and z*, b* int32 per output channel of each stage ->
    int32 [B, ceil(H/s), ceil(W/s), Co]. Activations must lie in [0, 255].
    One thread block computes a `default_tile` of the output over one
    slice of E (`plan`)."""
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
    p = plan(b, h, w, c, e_ch, c_out, kernel, stride)
    smem = p.smem_bytes(c, c_out, kernel, stride)
    if smem > SMEM_MAX:
        raise ValueError(f"fused_irb_q: {smem} bytes of shared memory a "
                         f"block, the card allows {SMEM_MAX}")
    a_z = ra = b_z = rb = 0.0
    ryz = 0
    if residual:
        a_s, a_z, b_s, b_z, y_s, y_z = res_q
        ra, rb, ryz = a_s / y_s, b_s / y_s, round(y_z)
    out = x_q.new_empty((b, ho, wo, c_out))  # int32, as x_q: checked above
    stream = _raw_stream(x_q)
    work = _workspace("fused_irb_q", torch.int32,
                      p.workspace_numel(b * ho * wo, c_out), x_q,
                      stream).data_ptr() if p.splits > 1 else None
    fn = _build.function("fused_irb", "fused_irb_q_launch", _ARGTYPES)
    with _device_guard(x_q):
        err = fn(x_q.data_ptr(), w1.data_ptr(), m1.data_ptr(), z1.data_ptr(),
                 b1.data_ptr(), w2.data_ptr(), m2.data_ptr(), z2.data_ptr(),
                 b2.data_ptr(), w3.data_ptr(), m3.data_ptr(), z3.data_ptr(),
                 b3.data_ptr(), out.data_ptr(), work, b, h, w, c, e_ch, c_out,
                 ho, wo, pad_t, pad_l, *p.tile, kernel, stride, qmax, p.nacc,
                 p.splits, p.eslice, smem, int(residual), a_z, ra, b_z, rb,
                 ryz, stream)
    if err:
        raise RuntimeError(f"fused_irb_q launch failed: CUDA error {err}")
    fused_irb_q.launches += 1
    fused_irb_q.variants["split_e" if p.splits > 1 else "single"] += 1
    return out


fused_irb_q.launches = 0
fused_irb_q.variants = {"single": 0, "split_e": 0}


__all__ = ["fused_irb_q", "fused_irb_q_plain", "default_tile", "plan",
           "Plan"]
