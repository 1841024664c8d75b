"""Weight-only quantized matmul (paper Sec. 4.1.3 + Sec. 3.2), K5.

Counterpart of `repro/kernels/quant_matmul.py`: y = x @ (w_q * scale) with
x float [M, K] (f32 or bf16), w_q int8 [K, N] (8 bits) or two signed
nibbles a byte packed along N, uint8 [K, N/2] (4 bits; low nibble = even
column), and one scale per (k-group, n), [G, N] f32 or bf16, G dividing K.
The weight is dequantized in f32 before the dot, and the sum is f32.

`quant_matmul` launches the CUDA kernel `csrc/quant_matmul.cu` for a CUDA
tensor and runs the plain PyTorch version `quant_matmul_plain` (the JAX
oracle's: dequantize to f32, then one f32 matmul) for a CPU tensor; it
raises for anything else. `quant_matmul.launches` counts the kernel's
launches. The JAX wrapper's block-size arithmetic is TPU tiling and has no
counterpart here: the kernel masks ragged edges itself.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import unpack_int4
from repro_torch.kernels import _build
from repro_torch.kernels.common import check_tensor as _check

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 7 + [_P]
_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _shapes(x, w_q, w_scale, bits):
    """(M, K, N, G), with the checks the JAX kernel makes."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, not {bits}")
    if x.dim() != 2 or w_q.dim() != 2 or w_scale.dim() != 2:
        raise ValueError("x, w_q and w_scale must be 2-D")
    m, k = x.shape
    n = w_q.shape[1] * (2 if bits == 4 else 1)
    g = w_scale.shape[0]
    if w_q.shape[0] != k:
        raise ValueError(f"x has K={k}, w_q has {w_q.shape[0]} rows")
    if w_scale.shape[1] != n:
        raise ValueError(f"w_scale has {w_scale.shape[1]} columns, N={n}")
    if g < 1 or k % g:
        raise ValueError(f"K={k} not divisible by scale groups G={g}")
    return m, k, n, g


def dequantize(w_q: torch.Tensor, w_scale: torch.Tensor, *,
               bits: int) -> torch.Tensor:
    """w_q * scale in f32, [K, N]: each scale row covers K/G rows of w."""
    q = unpack_int4(w_q, signed=True) if bits == 4 else w_q.to(torch.int32)
    k, n = q.shape
    g = w_scale.shape[0]
    return (q.to(torch.float32).reshape(g, k // g, n)
            * w_scale.to(torch.float32)[:, None, :]).reshape(k, n)


def quant_matmul_plain(x, w_q, w_scale, *, bits: int) -> torch.Tensor:
    """The same function in plain PyTorch: dequantize, then f32 matmul."""
    _shapes(x, w_q, w_scale, bits)
    return torch.matmul(x.to(torch.float32),
                        dequantize(w_q, w_scale, bits=bits))


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                 *, bits: int) -> torch.Tensor:
    """x [M, K] f32/bf16, w_q int8 [K, N] or uint8 [K, N/2], w_scale [G, N]
    f32/bf16 -> f32 [M, N]."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w_q, w_scale, bits=bits)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: no kernel for {x.device}")
    m, k, n, g = _shapes(x, w_q, w_scale, bits)
    if x.dtype not in _CODE or w_scale.dtype not in _CODE:
        raise TypeError(f"x {x.dtype}, w_scale {w_scale.dtype}: the kernel "
                        f"takes float32 or bfloat16")
    _check(x, x.dtype, "x")
    _check(w_q, torch.uint8 if bits == 4 else torch.int8, "w_q", x.device)
    _check(w_scale, w_scale.dtype, "w_scale", x.device)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    fn = _build.function("quant_matmul", "quant_matmul_launch", _ARGTYPES)
    err = fn(x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
             m, k, n, k // g, bits, _CODE[x.dtype], _CODE[w_scale.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"quant_matmul launch failed: CUDA error {err}")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0


__all__ = ["quant_matmul", "quant_matmul_plain", "dequantize"]
