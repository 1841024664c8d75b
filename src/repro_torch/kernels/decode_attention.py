"""Flash-decode attention over a grouped (GQA) KV cache, K6.

Counterpart of `repro/kernels/decode_attention.py`: for each (batch, kv
head), the `rep` query heads of the group attend over the cache positions
[0, kv_len) with scale dh**-0.5; positions at or past `kv_len` are masked
to -1e30 and the softmax is taken online, as (m, l, acc). An int8 cache
is dequantized by its per-(position, kv head) scales.

    q [B, KV, rep, dh] f32/bf16; caches [B, S, KV, dh] int8 (with scales
    [B, S, KV], bf16 as `kv_quant` makes them, or f32) or bf16/f32;
    kv_len a Python int or a 0-dim int32 tensor -> [B, KV, rep, dh] in
    q's dtype

`decode_attention` launches `csrc/decode_attention.cu` for CUDA tensors and
runs the plain PyTorch version `decode_attention_plain` (the JAX oracle's:
dequantize, scores, mask, softmax, weighted sum) for CPU tensors; it raises
for anything else. The kernel reads a tensor `kv_len` from device memory,
so the call does not wait for the device. `kv_len < 1` leaves no position
to attend to, and neither the TPU kernel nor its oracle defines an answer
there: it is refused where the host can see it (an int, a CPU tensor).
`decode_attention.launches` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_tensor as _check

NEG = -1e30
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 7 + [_I] * 9 + [ctypes.c_float, _P]
_FLOAT = {torch.float32: 0, torch.bfloat16: 1}
_CACHE = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}

KvLen = Union[int, torch.Tensor]


def _check_len(kv_len: KvLen) -> None:
    if isinstance(kv_len, torch.Tensor):
        if kv_len.dim() != 0:
            raise ValueError("kv_len must be a 0-dim tensor")
        if kv_len.device.type != "cpu":
            return  # read by the kernel on the device
        kv_len = int(kv_len)
    if kv_len < 1:
        raise ValueError(f"kv_len={kv_len}: no cache position to attend to")


def _shapes(q, k_cache, v_cache, k_scale, v_scale):
    if q.dim() != 4 or k_cache.dim() != 4:
        raise ValueError("q and the caches must be 4-D")
    b, kv, rep, dh = q.shape
    s = k_cache.shape[1]
    if tuple(k_cache.shape) != (b, s, kv, dh) or \
            v_cache.shape != k_cache.shape:
        raise ValueError(f"caches {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}: expected [B, S, KV, dh]")
    quant = k_cache.dtype == torch.int8
    if quant:
        if k_scale is None or v_scale is None:
            raise ValueError("an int8 cache needs k_scale and v_scale")
        for sc in (k_scale, v_scale):
            if tuple(sc.shape) != (b, s, kv):
                raise ValueError(f"scale {tuple(sc.shape)} is not "
                                 f"{(b, s, kv)}")
    return b, kv, rep, dh, s, quant


def decode_attention_plain(q, k_cache, v_cache, kv_len: KvLen, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    """The same function in plain PyTorch, all in f32."""
    _check_len(kv_len)
    b, kv, rep, dh, s, quant = _shapes(q, k_cache, v_cache, k_scale, v_scale)
    k, v = k_cache.to(torch.float32), v_cache.to(torch.float32)
    if quant:
        k = k * k_scale.to(torch.float32)[..., None]
        v = v * v_scale.to(torch.float32)[..., None]
    scores = torch.einsum("bgrd,bsgd->bgrs", q.to(torch.float32),
                          k) * dh ** -0.5
    pos = torch.arange(s, device=q.device)
    scores = torch.where(pos < kv_len, scores, NEG)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bgrs,bsgd->bgrd", w, v).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: KvLen,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped decode attention; see the module docstring for shapes."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, kv_len, k_scale,
                                      v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    _check_len(kv_len)
    b, kv, rep, dh, s, quant = _shapes(q, k_cache, v_cache, k_scale, v_scale)
    if q.dtype not in _FLOAT:
        raise TypeError(f"q: {q.dtype}, the kernel takes float32 or "
                        f"bfloat16")
    if k_cache.dtype not in _CACHE:
        raise TypeError(f"k_cache: {k_cache.dtype}, the kernel takes int8, "
                        f"bfloat16 or float32")
    _check(q, q.dtype, "q")
    _check(k_cache, k_cache.dtype, "k_cache", q.device)
    _check(v_cache, k_cache.dtype, "v_cache", q.device)
    sc_code = 0
    if quant:
        if k_scale.dtype not in _FLOAT:
            raise TypeError(f"k_scale: {k_scale.dtype}, the kernel takes "
                            f"float32 or bfloat16")
        _check(k_scale, k_scale.dtype, "k_scale", q.device)
        _check(v_scale, k_scale.dtype, "v_scale", q.device)
        sc_code = _FLOAT[k_scale.dtype]
    len_ptr, len_val = 0, 0
    if isinstance(kv_len, torch.Tensor):
        _check(kv_len, torch.int32, "kv_len", q.device)
        len_ptr = kv_len.data_ptr()
    else:
        len_val = int(kv_len)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _build.function("decode_attention", "decode_attention_launch",
                         _ARGTYPES)
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             k_scale.data_ptr() if quant else 0,
             v_scale.data_ptr() if quant else 0, len_ptr, out.data_ptr(),
             len_val, b, kv, rep, dh, s, _FLOAT[q.dtype],
             _CACHE[k_cache.dtype], sc_code, dh ** -0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


__all__ = ["decode_attention", "decode_attention_plain"]
