"""Quantized pointwise convolution / dense layer (paper Sec. 4.1.3).

Counterpart of `repro/kernels/pointwise_conv.py`: the int GEMM
[M = B*H*W, C_in] x [C_in, C_out] with int32 accumulation and the fused
epilogue y = clip(round((acc + zpc) * mult) + bias_q, 0, qmax), which is
operation for operation the reference interpreter's, so the kernel is
bit-exact with `int_pointwise` + `quantized_op_epilogue`.

`pointwise_conv_q` launches the CUDA kernel `csrc/pointwise_conv.cu` for a
CUDA tensor and runs the plain PyTorch version `pointwise_conv_q_plain` for
a CPU tensor; it raises for anything else. `pointwise_conv_q.launches`
counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_tensor as _check, requant_clip

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 7 + [_P]
BLOCKS_M, BLOCKS_N, BLOCKS_K = (16, 64, 128), (16, 64), (16, 32)


def pointwise_conv_q_plain(x_q, w_q, mult, zpc, bias_q, *,
                           qmax: int) -> torch.Tensor:
    """The same function in plain PyTorch (float64 matmul: exact)."""
    acc = torch.matmul(x_q.to(torch.float64), w_q.to(torch.float64))
    return requant_clip(acc.to(torch.int32), mult, bias_q, qmax, zpc=zpc)


def default_blocks(m: int, n: int):
    """(block_m, block_n, block_k) for an [m, k] x [k, n] product."""
    bm = 128 if m >= 8192 else (64 if m >= 64 else 16)
    return bm, (16 if n <= 16 else 64), 32


def pointwise_conv_q(x_q: torch.Tensor, w_q: torch.Tensor, mult: torch.Tensor,
                     zpc: torch.Tensor, bias_q: torch.Tensor, *, qmax: int,
                     block_m=None, block_n=None,
                     block_k=None) -> torch.Tensor:
    """x_q [..., C_in] int32, w_q [C_in, C_out] int8, mult f32 / zpc, bias_q
    int32 [C_out] -> int32 [..., C_out]. `block_m/n/k` pick the kernel's
    tile (see `BLOCKS_*`); any tile gives the same bits."""
    if x_q.device.type == "cpu":
        return pointwise_conv_q_plain(x_q, w_q, mult, zpc, bias_q, qmax=qmax)
    if x_q.device.type != "cuda":
        raise ValueError(f"pointwise_conv_q: no kernel for {x_q.device}")
    k, n = w_q.shape
    lead = x_q.shape[:-1]
    if x_q.shape[-1] != k:
        raise ValueError(f"x has {x_q.shape[-1]} channels, w expects {k}")
    _check(x_q, torch.int32, "x_q")
    _check(w_q, torch.int8, "w_q", x_q.device)
    _check(mult, torch.float32, "mult", x_q.device, n)
    _check(zpc, torch.int32, "zpc", x_q.device, n)
    _check(bias_q, torch.int32, "bias_q", x_q.device, n)
    m = x_q.numel() // k
    dm, dn, dk = default_blocks(m, n)
    bm, bn, bk = block_m or dm, block_n or dn, block_k or dk
    if bm not in BLOCKS_M or bn not in BLOCKS_N or bk not in BLOCKS_K:
        raise ValueError(f"unsupported tile ({bm}, {bn}, {bk})")
    out = torch.empty((*lead, n), dtype=torch.int32, device=x_q.device)
    fn = _build.function("pointwise_conv", "pointwise_conv_q_launch",
                         _ARGTYPES)
    err = fn(x_q.data_ptr(), w_q.data_ptr(), mult.data_ptr(), zpc.data_ptr(),
             bias_q.data_ptr(), out.data_ptr(), m, k, n, qmax, bm, bn, bk,
             torch.cuda.current_stream(x_q.device).cuda_stream)
    if err:
        raise RuntimeError(f"pointwise_conv_q launch failed: CUDA error {err}")
    pointwise_conv_q.launches += 1
    return out


pointwise_conv_q.launches = 0


__all__ = ["pointwise_conv_q", "pointwise_conv_q_plain", "default_blocks"]
