"""Quantized pointwise convolution / dense layer (paper Sec. 4.1.3).

Counterpart of `repro/kernels/pointwise_conv.py`: the int GEMM
[M = B*H*W, C_in] x [C_in, C_out] with int32 accumulation and the fused
epilogue y = clip(round((acc + zpc) * mult) + bias_q, 0, qmax), which is
operation for operation the reference interpreter's, so the kernel is
bit-exact with `int_pointwise` + `quantized_op_epilogue`.

`pointwise_conv_q` launches the CUDA kernel `csrc/pointwise_conv.cu` for a
CUDA tensor and runs the plain PyTorch version `pointwise_conv_q_plain` for
a CPU tensor; it raises for anything else. The kernel runs on the integer
tensor cores with the activations narrowed to u8, so its domain is x in
[0, 255] (every act4/act8 activation of a `.qnet` lies there: the served
route's inputs to this kernel are checked by the tests
`test_pointwise_inputs_lie_in_kernel_domain*`); the wrapper does not read
x back to check it.

`plan(m, k, n)` picks the tile and how many slices K is cut into (plain
Python): with few rows the tiles leave SMs idle, so K is split across
blocks, and a second pass adds the int32 partials and runs the epilogue.
The partials go to a workspace kept across calls (`common.workspace`).
`pointwise_conv_q.launches` counts calls (one each, that pass included)
and `pointwise_conv_q.variants` counts them as "single" or "split_k".
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    check_tensor as _check, device_guard as _device_guard,
    raw_stream as _raw_stream, requant_clip,
    workspace as _workspace)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 7 + [_I] * 9 + [_P]
BLOCKS_M, BLOCKS_N, BLOCKS_K = (16, 64, 128), (16, 64), (32, 128)
SMS = 132  # streaming multiprocessors of an H100 SXM


def pointwise_conv_q_plain(x_q, w_q, mult, zpc, bias_q, *,
                           qmax: int) -> torch.Tensor:
    """The same function in plain PyTorch (float64 matmul: exact)."""
    acc = torch.matmul(x_q.to(torch.float64), w_q.to(torch.float64))
    return requant_clip(acc.to(torch.int32), mult, bias_q, qmax, zpc=zpc)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class Plan(NamedTuple):
    """The tile (block_m, block_n, block_k), and K cut into `splits` slices
    of `ksplit` rows (whole block_k steps; the last one shorter)."""
    tile: Tuple[int, int, int]
    splits: int
    ksplit: int

    def workspace_numel(self, m: int, n: int) -> int:
        """The int32 partials a launch needs: none for one slice."""
        return self.splits * m * n if self.splits > 1 else 0


@functools.lru_cache(maxsize=4096)  # called on every launch
def plan(m: int, k: int, n: int, *, block_m=None, block_n=None,
         block_k=None) -> Plan:
    """The tile and the K slices of an [m, k] x [k, n] product; `block_*`
    override the tile. K is split when the tiles cover fewer than two
    blocks an SM."""
    bm = block_m or (16 if m <= 512 else 64)  # the faster on the card
    bn = block_n or (16 if n <= 16 else 64)
    bk = block_k or (32 if k <= 32 else 128)
    if bm not in BLOCKS_M or bn not in BLOCKS_N or bk not in BLOCKS_K:
        raise ValueError(f"unsupported tile ({bm}, {bn}, {bk})")
    tiles = _cdiv(m, bm) * _cdiv(n, bn)
    splits = min(_cdiv(k, bk), _cdiv(2 * SMS, tiles)) if tiles < SMS else 1
    ksplit = _cdiv(_cdiv(k, bk), splits) * bk
    return Plan((bm, bn, bk), _cdiv(k, ksplit), ksplit)


def pointwise_conv_q(x_q: torch.Tensor, w_q: torch.Tensor, mult: torch.Tensor,
                     zpc: torch.Tensor, bias_q: torch.Tensor, *, qmax: int,
                     block_m=None, block_n=None,
                     block_k=None) -> torch.Tensor:
    """x_q [..., C_in] int32, w_q [C_in, C_out] int8, mult f32 / zpc, bias_q
    int32 [C_out] -> int32 [..., C_out]. `block_m/n/k` pick the kernel's
    tile (see `BLOCKS_*`); any tile gives the same bits."""
    if not x_q.is_cuda:
        if x_q.device.type == "cpu":
            return pointwise_conv_q_plain(x_q, w_q, mult, zpc, bias_q,
                                          qmax=qmax)
        raise ValueError(f"pointwise_conv_q: no kernel for {x_q.device}")
    k, n = w_q.shape
    lead = x_q.shape[:-1]
    if x_q.shape[-1] != k:
        raise ValueError(f"x has {x_q.shape[-1]} channels, w expects {k}")
    dev = x_q.device
    _check(x_q, torch.int32, "x_q")
    _check(w_q, torch.int8, "w_q", dev)
    _check(mult, torch.float32, "mult", dev, n)
    _check(zpc, torch.int32, "zpc", dev, n)
    _check(bias_q, torch.int32, "bias_q", dev, n)
    m = x_q.numel() // k
    p = plan(m, k, n, block_m=block_m, block_n=block_n, block_k=block_k)
    out = x_q.new_empty((*lead, n))  # int32, as x_q: checked above
    if out.numel() == 0:
        return out
    stream = _raw_stream(x_q)
    work = _workspace("pointwise_conv_q", torch.int32,
                      p.workspace_numel(m, n), x_q,
                      stream).data_ptr() if p.splits > 1 else None
    fn = _build.function("pointwise_conv", "pointwise_conv_q_launch",
                         _ARGTYPES)
    with _device_guard(x_q):
        err = fn(x_q.data_ptr(), w_q.data_ptr(), mult.data_ptr(),
                 zpc.data_ptr(), bias_q.data_ptr(), out.data_ptr(), work, m,
                 k, n, qmax, *p.tile, p.splits, p.ksplit, stream)
    if err:
        raise RuntimeError(f"pointwise_conv_q launch failed: CUDA error {err}")
    pointwise_conv_q.launches += 1
    pointwise_conv_q.variants["split_k" if p.splits > 1 else "single"] += 1
    return out


pointwise_conv_q.launches = 0
pointwise_conv_q.variants = {"single": 0, "split_k": 0}


__all__ = ["pointwise_conv_q", "pointwise_conv_q_plain", "plan", "Plan"]
