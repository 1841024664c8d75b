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

`plan(b, kv, rep, dh, s, cache_dtype, *, aligned)` decides a launch in
plain Python from the shapes alone, never from `kv_len` (a device tensor
the host cannot read): where the blocks of (batch, kv heads, q rows) leave
SMs idle, S is cut into `splits` slices of `per_split` positions, one
block each, whose unnormalised (m, l, acc) go to an f32 workspace kept
across calls (`common.workspace`); a second kernel adds them in split
order, so equal inputs give equal bits (`split_s`). Otherwise one block
walks all of S (`single`). A block walks its slice in tiles of `tile`
positions. `layout` says how the kernel reads the cache: 16-byte loads
where k and v are 16-byte aligned and dh fills whole loads, with as many
adjacent kv heads a warp as make 128 contiguous bytes, else scalar loads.
The launcher takes the layout as it is given and only checks it (it
refuses a layout it has no instantiation for, 16-byte loads of pointers
that are not aligned, another `blocks_per_sm` than its launch bounds, or
another shared-memory size). `launch_plan(q, k_cache, v_cache)` is the
(plan, layout) a call launches with.
`decode_attention.launches` counts calls that launched (one each, the merge
included) and `decode_attention.variants` counts them by variant.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    check_tensor as _check, device_guard as _device_guard,
    raw_stream as _raw_stream,
    workspace as _workspace)

NEG = -1e30
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 8 + [_I] * 18 + [ctypes.c_float, _P]
_FLOAT = {torch.float32: 0, torch.bfloat16: 1}
_CACHE = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
_ESZ = {torch.int8: 1, torch.bfloat16: 2, torch.float32: 4}
# the kernel's constants (csrc/decode_attention.cu NT, NW, NS)
THREADS, WARPS, STAGES = 64, 2, 4
SMS = 132  # streaming multiprocessors of an H100 SXM
SMEM_SM = 233472  # shared memory of an SM, 1 KB of it kept a block
SMEM_MAX = 232448  # shared memory a block may have on an H100 (227 KB)
# the plan's choices, tuned on the [lm] shapes of chip_smoke.py
WAVES = 2  # rounds of the blocks the SMs hold, where S is split
MIN_SPLIT = 256  # the fewest positions a split takes
TILE_MAX = 256  # positions a block walks between its warps' rescales
MIN_BYTES = 128  # contiguous bytes a warp reads of a position, where it can

KvLen = Union[int, torch.Tensor]


class Plan(NamedTuple):
    """`single` or `split_s`; S cut into `splits` slices of `per_split`
    positions (the last one shorter), each walked in tiles of `tile`
    positions (whole warp steps of its layout, `Layout.tile_step`); the
    block's shared memory."""
    variant: str
    splits: int
    per_split: int
    tile: int
    smem_bytes: int

    def workspace_numel(self, b: int, kv: int, rep: int, dh: int) -> int:
        """The f32 (m, l, acc) of every split: none for one split."""
        return self.splits * b * kv * rep * (dh + 2) if self.splits > 1 \
            else 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _lanes(values: int, dh: int) -> int:
    """Lanes that share a (position, head): a power of two."""
    lanes = 1
    while lanes * values < dh:
        lanes *= 2
    return lanes


def _blocks_per_sm(values: int, rows: int) -> int:
    """Thread blocks an SM holds at the registers the split kernel's launch
    bounds give it (`csrc/decode_attention.cu` blocks_per_sm, which the
    launcher holds this to)."""
    return 4 if values == 16 or rows == 8 else 6


class Layout(NamedTuple):
    """How the kernel (`decode_attention_launch`) reads the cache: 16-byte
    loads (`vec`) or scalar ones, `values` of a row a lane, q rows a block
    (`rows`), kv heads a block (`heads`), positions a lane takes a step
    (`slots`: 4 for int8, 2 else), and thread blocks an SM holds at its
    registers (`blocks_per_sm`)."""
    vec: bool
    values: int
    rows: int
    heads: int
    slots: int
    blocks_per_sm: int

    def tile_step(self, dh: int) -> int:
        """Positions a tile is a multiple of: whole warp steps, and 64 a
        warp."""
        pps = 32 // (_lanes(self.values, dh) * self.heads)
        return WARPS * max(64, self.slots * pps)

    def grid(self, b: int, kv: int, rep: int) -> int:
        """Blocks a split: (kv heads, row chunks) by batch."""
        return b * (kv // self.heads) * _cdiv(rep, self.rows)


@functools.lru_cache(maxsize=4096)  # called on every launch
def layout(kv: int, rep: int, dh: int, cache_dtype,
           aligned: bool = True) -> Layout:
    """16-byte loads where k and v are aligned and dh fills whole loads of
    at most 32 lanes a position: 16 int8 or 8 bf16/f32 values a lane (else
    scalar loads of 16). q rows in chunks of 1, 4 or 8 (4 at 16 values a
    lane), each a block. With 16-byte loads a warp reads `heads` adjacent
    kv heads of a position, so that it reads MIN_BYTES contiguous bytes
    where KV allows: the 64-byte rows of an int8 head at dh 64, read
    alone, stream markedly slower."""
    esz = _ESZ[cache_dtype]
    e_vec = 16 if cache_dtype == torch.int8 else 8
    vec = aligned and (dh * esz) % 16 == 0 and dh <= 32 * e_vec
    e = e_vec if vec else 16
    rows = 1 if rep == 1 else 4 if rep <= 4 else (4 if e == 16 else 8)
    lanes = _lanes(e, dh)
    heads = 1
    while (vec and heads * dh * esz < MIN_BYTES and kv % (2 * heads) == 0
           and 2 * heads * lanes <= 32 and 2 * heads * rows <= 32):
        heads *= 2
    return Layout(vec, e, rows, heads, 4 if cache_dtype == torch.int8 else 2,
                  _blocks_per_sm(e, rows))


def smem_bytes(lay: Layout, esz: int, dh: int, tile: int,
               quant: bool) -> int:
    """Shared memory of a block: each lane's ring slots, then the larger of
    the warps' tile space (partial dots, scores, an int8 cache's scales)
    and their (m, l, acc) at the merge (`csrc/decode_attention.cu`
    smem_bytes; the launch refuses another)."""
    lanes = _lanes(lay.values, dh)
    ring = STAGES * lay.slots * THREADS * lay.values * esz if lay.vec else 0
    ne = tile // WARPS * lay.heads
    work = WARPS * ne * ((lay.rows + 1) * lanes + lay.rows
                         + (2 if quant else 0))
    return ring + 4 * max(work, WARPS * lay.heads * lay.rows * (dh + 2))


@functools.lru_cache(maxsize=4096)  # called on every launch
def plan(b: int, kv: int, rep: int, dh: int, s: int, cache_dtype, *,
         aligned: bool = True) -> Plan:
    """The split of S for q [b, kv, rep, dh] over a cache of s positions
    (plain Python, no device; the same for every kv_len). Where the
    (batch, kv heads, row chunk) blocks leave SMs idle, S is cut into
    enough slices for about WAVES rounds of the blocks the SMs hold, each
    a multiple of 32 positions and at least MIN_SPLIT.
    `aligned`: k and v start on 16 bytes."""
    lay = layout(kv, rep, dh, cache_dtype, aligned)
    if dh > 32 * lay.values:
        raise ValueError(f"dh={dh}: the kernel takes at most "
                         f"{32 * lay.values}")
    base = lay.grid(b, kv, rep)
    held = lay.blocks_per_sm * SMS  # blocks the card holds at once
    splits, per = WAVES * held // base, s
    if base < held and s > MIN_SPLIT:
        per = max(MIN_SPLIT, _cdiv(_cdiv(s, splits), 32) * 32)
        splits = _cdiv(s, per)
    if splits < 2 or per >= s:
        splits, per = 1, s
    # the largest tile (whole steps) that lets an SM hold blocks_per_sm
    # blocks
    step = lay.tile_step(dh)
    tile = max(step, min(TILE_MAX // step * step, _cdiv(per, step) * step))
    smem = functools.partial(smem_bytes, lay, _ESZ[cache_dtype], dh,
                             quant=cache_dtype == torch.int8)
    while tile > step and smem(tile) > SMEM_SM // lay.blocks_per_sm - 1024:
        tile -= step
    return Plan("split_s" if splits > 1 else "single", splits, per, tile,
                smem(tile))


def launch_plan(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor) -> Tuple[Plan, Layout]:
    """The plan and layout `decode_attention` launches with for these
    tensors: 16-byte loads only where k and v start on 16 bytes."""
    b, kv, rep, dh = q.shape
    aligned = (k_cache.data_ptr() | v_cache.data_ptr()) % 16 == 0
    return (plan(b, kv, rep, dh, k_cache.shape[1], k_cache.dtype,
                 aligned=aligned),
            layout(kv, rep, dh, k_cache.dtype, aligned))


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
    out = q.new_empty(q.shape)
    if out.numel() == 0:
        return out
    p, lay = launch_plan(q, k_cache, v_cache)
    if p.smem_bytes > SMEM_MAX:
        raise ValueError(f"decode_attention: {p.smem_bytes} bytes of shared "
                         f"memory a block, the card allows {SMEM_MAX}")
    stream = _raw_stream(q)
    work = _workspace("decode_attention", torch.float32,
                      p.workspace_numel(b, kv, rep, dh), q,
                      stream).data_ptr() if p.splits > 1 else None
    fn = _build.function("decode_attention", "decode_attention_launch",
                         _ARGTYPES)
    with _device_guard(q):
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 k_scale.data_ptr() if quant else None,
                 v_scale.data_ptr() if quant else None, len_ptr or None,
                 out.data_ptr(), work, len_val, b, kv, rep, dh, s,
                 _FLOAT[q.dtype], _CACHE[k_cache.dtype], sc_code, p.splits,
                 p.per_split, p.tile, int(lay.vec), lay.values, lay.rows,
                 lay.heads, lay.blocks_per_sm, p.smem_bytes, dh ** -0.5,
                 stream)
    if err:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err}")
    decode_attention.launches += 1
    decode_attention.variants[p.variant] += 1
    return out


decode_attention.launches = 0
decode_attention.variants = {"single": 0, "split_s": 0}


__all__ = ["decode_attention", "decode_attention_plain", "launch_plan",
           "layout", "plan", "Layout", "Plan"]
