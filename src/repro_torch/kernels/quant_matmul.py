"""Weight-only quantized matmul (paper Sec. 4.1.3 + Sec. 3.2), K5.

Counterpart of `repro/kernels/quant_matmul.py`: y = x @ (w_q * scale) with
x float [M, K] (f32 or bf16), w_q int8 [K, N] (8 bits) or two signed
nibbles a byte packed along N, uint8 [K, N/2] (4 bits; low nibble = even
column), and one scale per (k-group, n), [G, N] f32 or bf16, G dividing K.
The weight is dequantized in f32 before the dot, and the sum is f32.

`quant_matmul` launches the CUDA kernels of `csrc/quant_matmul.cu` for a
CUDA tensor and runs the plain PyTorch version `quant_matmul_plain` (the
JAX oracle's: dequantize to f32, then one f32 matmul) for a CPU tensor; it
raises for anything else. The JAX wrapper's block-size arithmetic is TPU
tiling and has no counterpart here: the kernels mask ragged edges
themselves.

The card has three hand-written variants, and `plan` picks one from the
shapes alone (see the source for each design):

    decode  M <= DECODE_MAX_M: split-K GEMV streaming the weight bytes,
            bf16 tensor cores over 16 x 256 tiles
    mma     M > DECODE_MAX_M: bf16 tensor cores over 128 x 128 tiles
    tiled   the rest: the first port's f32 tiled GEMM on the CUDA cores

decode and mma sum each scale group's exact products in f32 and multiply
that partial sum by the group's scale, so they need every group boundary
on a 16-deep k step (group % 16 == 0, or one group) and K % 8 == 0; tiled
takes weight rows that are not a multiple of 16 bytes and groups such as
8.

decode and mma also need 16-byte aligned x, w_q and out. Where they split
K, the partials go to an f32 workspace of splits * M * N values, kept
across calls (`common.workspace`), and a second pass adds them in a
fixed order, so equal inputs give equal bits.
`quant_matmul.launches` counts calls that launched (one each, a reduce
pass included) and `quant_matmul.variants` counts them by variant.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core.quant import unpack_int4
from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    check_tensor as _check, device_guard as _device_guard,
    raw_stream as _raw_stream,
    workspace as _workspace)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 5 + [_I] * 10 + [_P]
_CODE = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = ("tiled", "decode", "mma")  # the kernel's variant codes 0, 1, 2
_VARIANT = {v: i for i, v in enumerate(VARIANTS)}
SMS = 132  # streaming multiprocessors of an H100 SXM
DECODE_MAX_M = 16
DECODE_BN, MMA_BM, MMA_BN, K_STEP = 256, 128, 128, 32  # tiles, k a step
DECODE_MIN_KSPLIT, MMA_MIN_KSPLIT = 128, 512


class Plan(NamedTuple):
    """Which variant runs, and K cut into `splits` slices of `ksplit` rows
    (the last one shorter)."""
    variant: str
    splits: int = 1
    ksplit: int = 0

    def workspace_numel(self, m: int, n: int) -> int:
        """The f32 partials a launch needs: none for one split."""
        return self.splits * m * n if self.splits > 1 else 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _slices(k: int, splits: int, step: int):
    """(splits, ksplit): ksplit a whole number of `step`s, every slice
    non-empty."""
    ksplit = _cdiv(_cdiv(k, splits), step) * step
    return _cdiv(k, ksplit), ksplit


@functools.lru_cache(maxsize=4096)  # called on every launch
def plan(m: int, k: int, n: int, group: int, bits: int, x_dtype, *,
         aligned: bool = True) -> Plan:
    """The variant for x [m, k] @ w [k, n] with scale groups of `group`
    rows, `bits`-bit weights and x of `x_dtype` (plain Python, no device).

    K is split so that the grid has about two blocks an SM for decode, and
    one for mma where its tiles leave SMs idle, in slices of whole k steps
    and at least 128 (decode) or 512 (mma) rows. `aligned`: x, w_q and out
    start on 16 bytes."""
    del x_dtype  # both f32 (three bf16 terms) and bf16 take the tensor cores
    if not (aligned and (n * bits // 8) % 16 == 0 and k % 8 == 0
            and (group == k or group % 16 == 0)):
        return Plan("tiled")
    if m <= DECODE_MAX_M:
        splits = min(_cdiv(2 * SMS, _cdiv(n, DECODE_BN)),
                     k // DECODE_MIN_KSPLIT)
        return Plan("decode", *_slices(k, max(1, splits), K_STEP))
    splits = min(_cdiv(SMS, _cdiv(m, MMA_BM) * _cdiv(n, MMA_BN)),
                 k // MMA_MIN_KSPLIT)
    return Plan("mma", *_slices(k, max(1, splits), K_STEP))


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
    if not x.is_cuda:
        if x.device.type == "cpu":
            return quant_matmul_plain(x, w_q, w_scale, bits=bits)
        raise ValueError(f"quant_matmul: no kernel for {x.device}")
    m, k, n, g = _shapes(x, w_q, w_scale, bits)
    if x.dtype not in _CODE or w_scale.dtype not in _CODE:
        raise TypeError(f"x {x.dtype}, w_scale {w_scale.dtype}: the kernel "
                        f"takes float32 or bfloat16")
    dev = x.device
    _check(x, x.dtype, "x")
    _check(w_q, torch.uint8 if bits == 4 else torch.int8, "w_q", dev)
    _check(w_scale, w_scale.dtype, "w_scale", dev)
    out = x.new_empty((m, n), dtype=torch.float32)
    if m == 0 or n == 0:
        return out
    xp, wp, op = x.data_ptr(), w_q.data_ptr(), out.data_ptr()
    p = plan(m, k, n, k // g, bits, x.dtype, aligned=(xp | wp | op) % 16 == 0)
    stream = _raw_stream(x)
    work = _workspace("quant_matmul", torch.float32, p.workspace_numel(m, n),
                      x, stream).data_ptr() if p.splits > 1 else None
    fn = _build.function("quant_matmul", "quant_matmul_launch", _ARGTYPES)
    with _device_guard(x):
        err = fn(xp, wp, w_scale.data_ptr(), op, work, m, k, n, k // g, bits,
                 _CODE[x.dtype], _CODE[w_scale.dtype], _VARIANT[p.variant],
                 p.splits, p.ksplit, stream)
    if err:
        raise RuntimeError(f"quant_matmul launch failed: CUDA error {err}")
    quant_matmul.launches += 1
    quant_matmul.variants[p.variant] += 1
    return out


quant_matmul.launches = 0
quant_matmul.variants = dict.fromkeys(VARIANTS, 0)


__all__ = ["quant_matmul", "quant_matmul_plain", "dequantize", "plan",
           "Plan"]
