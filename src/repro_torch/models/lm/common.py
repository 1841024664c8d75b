"""Transformer building blocks shared by the LM architectures.

Counterpart of `repro/models/lm/common.py`, in plain PyTorch functions over
nested dicts of tensors with the JAX trees' keys, so that a JAX parameter
tree carries across leaf for leaf (`repro_torch.convert.params_from_reference`).
Every `init_*` takes a `torch.Generator` (its device is where the draws are
made) and returns `(params, logical)`, `logical` mirroring `params` with
tuples of logical axis names, as in the JAX package.

Quantized linears (`cfg.quant_bits` 8 or 4) store int8 (or packed int4)
weights with per-output-channel scales and dequantize next to the product,
as the JAX model does: the LM never reaches the hand-written kernels.

The arithmetic follows the JAX functions: attention scores and the softmax
run in f32 on operands upcast from their storage type (the JAX einsums'
`preferred_element_type=F32`), masked scores are -1e30, and a KV cache
(bf16, or int8 with bf16 per-(position, kv head) scales) is written at the
clamped index `jax.lax.dynamic_update_slice` would use. A KV cache is
written in place (the positions of this call only) and returned; the JAX
model returns a new cache, which XLA updates in place under jit.

`attention_spmd` (self-, windowed and cross-attention) and `mlp_spmd` are
the blocks partitioned over a mesh (`Spmd`: the layout GSPMD makes of the
reference's annotations, written out).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.quant import pack_int4, unpack_int4
from repro_torch.models.lm.config import LMConfig

F32 = torch.float32
NEG = -1e30  # the masked score of the JAX model (not -inf)
BLOCKWISE_FROM = 8192  # self-attention over more keys runs blockwise


def dt(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class MetaGenerator:
    """Stands for a generator on the meta device, which has none: a draw
    there is a tensor of the shape and type, without values (the
    reference's `jax.eval_shape` of an init)."""

    device = torch.device("meta")


def _draws(gen):
    return None if isinstance(gen, MetaGenerator) else gen


def normal(gen: torch.Generator, shape, std: float = 1.0) -> torch.Tensor:
    """f32 N(0, std^2) drawn on the generator's device."""
    return std * torch.randn(shape, generator=_draws(gen), device=gen.device,
                             dtype=F32)


def uniform(gen: torch.Generator, shape, lo: float, hi: float):
    """f32 U[lo, hi) drawn on the generator's device."""
    u = torch.rand(shape, generator=_draws(gen), device=gen.device,
                   dtype=F32)
    return lo + (hi - lo) * u


# ---------------------------------------------------------------------------
# elementwise functions of jax.nn, in its own form: each op in the input's
# type, so a bf16 input is rounded where the JAX package rounds it
# ---------------------------------------------------------------------------


def sigmoid(x):
    """`jax.nn.sigmoid` as XLA expands it: 1 / (1 + exp(-x))."""
    return 1 / (1 + torch.exp(-x))


def silu(x):
    return x * sigmoid(x)


def softplus(x):
    """`jnp.logaddexp(x, 0)`."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def gelu(x):
    """`jax.nn.gelu`'s default tanh approximation, its constants in x's
    type as there."""
    def c(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    inner = c(math.sqrt(2 / math.pi)) * (x + c(0.044715) * x ** 3)
    return x * (c(0.5) * (c(1.0) + torch.tanh(inner)))


# ---------------------------------------------------------------------------
# linear (+ weight-only quantization), norm, rope
# ---------------------------------------------------------------------------


def init_linear(gen, d_in: int, d_out: int, ax_in, ax_out, cfg: LMConfig,
                std: Optional[float] = None):
    std = std if std is not None else d_in**-0.5
    w = normal(gen, (d_in, d_out), std)
    if cfg.quant_bits in (4, 8):
        qmax = 2 ** (cfg.quant_bits - 1) - 1
        amax = w.abs().amax(dim=0, keepdim=True)
        scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
        q = torch.clamp(torch.round(w / scale), -qmax, qmax).to(torch.int8)
        if cfg.quant_bits == 4:
            q = pack_int4(q)
        p = {"w_q": q, "scale": scale.to(dt(cfg))}
        return p, {"w_q": (ax_in, ax_out), "scale": (None, ax_out)}
    return {"w": w.to(dt(cfg))}, {"w": (ax_in, ax_out)}


def linear(x, p):
    if "w" in p:
        return x @ p["w"].to(x.dtype)
    w_q = p["w_q"]
    if w_q.dtype == torch.uint8:  # packed int4
        q = unpack_int4(w_q, signed=True)
    else:
        q = w_q.to(torch.int32)
    w = q.to(x.dtype) * p["scale"].to(x.dtype)
    return x @ w


def init_norm(gen, d: int, cfg: LMConfig):
    return ({"scale": torch.ones((d,), dtype=dt(cfg), device=gen.device)},
            {"scale": (None,)})


def rms_norm(x, p, eps: float = 1e-6):
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(F32)).to(x.dtype)


def rope(x, positions, theta: float):
    """x: [B, S, H, dh]; positions: [B, S] or [S] integer tensor."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=F32, device=x.device)
                      / half)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(F32) * freqs  # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA; full / blockwise-flash / local-window / cross / decode)
# ---------------------------------------------------------------------------


def init_attention(gen, cfg: LMConfig, d_model: Optional[int] = None):
    d = d_model or cfg.d_model
    hd = cfg.head_dim
    p, lg = {}, {}
    p["wq"], lg["wq"] = init_linear(gen, d, cfg.n_heads * hd, "embed",
                                    "heads", cfg)
    p["wk"], lg["wk"] = init_linear(gen, d, cfg.n_kv_heads * hd, "embed",
                                    "heads", cfg)
    p["wv"], lg["wv"] = init_linear(gen, d, cfg.n_kv_heads * hd, "embed",
                                    "heads", cfg)
    p["wo"], lg["wo"] = init_linear(gen, cfg.n_heads * hd, d, "heads",
                                    "embed", cfg)
    if cfg.qk_norm:
        p["qnorm"], lg["qnorm"] = init_norm(gen, hd, cfg)
        p["knorm"], lg["knorm"] = init_norm(gen, hd, cfg)
    return p, lg


def kv_quant(x: torch.Tensor):
    """[..., dh] float -> (int8 [..., dh], bf16 scale [...]): symmetric
    per-row scale max(amax / 127, 1e-8), values rounded half to even."""
    xf = x.to(F32)
    amax = xf.abs().amax(dim=-1)
    # a 0-dim device tensor, not a Python number: PyTorch's CUDA division
    # by a host scalar multiplies by its reciprocal, which can round
    # differently from the reference's true division
    scale = torch.clamp_min(amax / torch.full((), 127.0, dtype=F32,
                                              device=x.device), 1e-8)
    q = torch.round(xf / scale[..., None]).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def kv_dequant(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.to(F32) * scale[..., None].to(F32)).to(dtype)


def _attn_core(q, k, v, mask, scale):
    """q [B,Sq,H,dh]; k/v [B,Sk,KV,dh] (KV <= H); mask [.,1,Sq,Sk].

    Grouped over [KV, rep], as the JAX model. Operands are upcast to f32
    before each product: the JAX einsums take bf16 operands with f32
    accumulation, whose bf16 x bf16 products are exact in f32. The softmax
    weights are rounded to v's type before the second product, as there."""
    b, sq, h, dh = q.shape
    kv = k.shape[2]
    rep = h // kv
    qf, kf, vf = q.to(F32), k.to(F32), v.to(F32)
    if rep == 1:
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
        s = torch.where(mask, s, NEG)
        w = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype).to(F32), vf)
    qg = qf.reshape(b, sq, kv, rep, dh)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kf) * scale
    s = torch.where(mask[:, :, None] if mask.ndim == 4 else mask, s, NEG)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", w.to(v.dtype).to(F32), vf)
    return out.reshape(b, sq, h, dh)


def full_attention(q, k, v, *, causal: bool, window: int = 0,
                   kv_offset: int = 0, kv_len=None):
    """Direct attention. kv_offset = absolute position of q[0] minus k[0]
    (for decode with a cache, q position = kv_offset + i)."""
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    qpos = kv_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    mask = mask[None, None]
    if kv_len is not None:  # [B] valid cache lengths
        mask = mask & (kpos[None, None, None, :]
                       < kv_len[:, None, None, None])
    out = _attn_core(q, k, v, mask, dh**-0.5)
    return out.to(q.dtype)


def pos_attention(q, k, v, kpos, q_pos: int, window: int = 0):
    """Attention over a ring cache with explicit absolute key positions.

    kpos: [Sk] int32 (-1 = empty slot); q_pos: absolute position of q."""
    b, sq, h, dh = q.shape
    qpos = q_pos + torch.arange(sq, device=q.device)
    mask = (kpos[None, :] >= 0) & (kpos[None, :] <= qpos[:, None])
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    out = _attn_core(q, k, v, mask[None, None], dh**-0.5)
    return out.to(q.dtype)


def blockwise_attention(q, k, v, *, causal: bool, window: int = 0,
                        block_k: int = 1024):
    """Flash-style online softmax over KV blocks (a loop over blocks) —
    keeps the S x S score matrix out of memory for long-context prefill."""
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    kv = k.shape[2]
    rep = h // kv
    pad = (-sk) % block_k  # ragged tail
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    nb = (sk + pad) // block_k
    qf = q.to(F32).reshape(b, sq, kv, rep, dh)
    scale = dh**-0.5
    qpos = torch.arange(sq, device=q.device)
    m = torch.full((b, kv, rep, sq), -math.inf, dtype=F32, device=q.device)
    l = torch.zeros((b, kv, rep, sq), dtype=F32, device=q.device)
    acc = torch.zeros((b, kv, rep, sq, dh), dtype=F32, device=q.device)
    for bi in range(nb):
        kblk = k[:, bi * block_k:(bi + 1) * block_k].to(F32)
        vblk = v[:, bi * block_k:(bi + 1) * block_k].to(F32)
        kpos = bi * block_k + torch.arange(block_k, device=q.device)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qf, kblk) * scale
        mask = (kpos[None, :] < sk).expand(sq, block_k)  # ragged padding
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        s = torch.where(mask[None, None, None], s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bgrqk,bkgd->bgrqd", p,
                                                   vblk)
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    # [b, kv, rep, sq, dh] -> [b, sq, h, dh]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)


def update_slice(buf, upd, idx: int, dim: int):
    """`jax.lax.dynamic_update_slice_in_dim` written into `buf`, which is
    returned: the start index is clamped so that the update fits, as
    there."""
    n = upd.shape[dim]
    idx = min(max(int(idx), 0), buf.shape[dim] - n)
    buf.narrow(dim, idx, n).copy_(upd.to(buf.dtype))
    return buf


def attention_block(p, x, cfg: LMConfig, positions, *, causal=True,
                    window: int = 0, kv_cache=None, cache_pos=None,
                    xk=None):
    """Self- or cross-attention with an optional KV cache.

    Returns (out, new_cache); `kv_cache`'s tensors are written in place and
    come back in new_cache. kv_cache: dict(k=[B,Smax,KV,dh], v=...
    [, k_scale, v_scale] for the int8 cache [, pos=[Smax] for the ring of
    local attention]). cache_pos: int, the write position for decode (None
    for prefill). xk: memory for cross-attention (keys/values from xk)."""
    hd = cfg.head_dim
    src = x if xk is None else xk
    q = linear(x, p["wq"]).reshape(*x.shape[:-1], cfg.n_heads, hd)
    k = linear(src, p["wk"]).reshape(*src.shape[:-1], cfg.n_kv_heads, hd)
    v = linear(src, p["wv"]).reshape(*src.shape[:-1], cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["qnorm"], cfg.norm_eps)
        k = rms_norm(k, p["knorm"], cfg.norm_eps)
    if xk is None:  # self-attention: rope
        q = rope(q, positions, cfg.rope_theta)
        if cache_pos is None:
            kpos = positions
        else:
            kpos = cache_pos + torch.arange(k.shape[1], device=x.device)
        k = rope(k, kpos, cfg.rope_theta)

    out, new_cache = attend(q, k, v, causal=causal, window=window,
                            kv_cache=kv_cache, cache_pos=cache_pos,
                            cross=xk is not None)
    out = out.reshape(*x.shape[:-1], cfg.n_heads * hd)
    return linear(out, p["wo"]), new_cache


def attend(q, k, v, *, causal=True, window: int = 0, kv_cache=None,
           cache_pos=None, cross: bool = False, kv_heads=None):
    """The attention of `attention_block` after its projections: q
    [B, S, H, dh] against k/v [B, S, KV, dh], through the KV cache where
    there is one (written in place as there). `kv_heads` (a slice) keeps
    those KV heads of k, v or the cache for the attention itself: the
    groups of the q heads a device holds under tensor parallelism."""
    def pick(t):
        return t if kv_heads is None else t[:, :, kv_heads]

    new_cache = kv_cache
    quant = kv_cache is not None and "k_scale" in kv_cache

    def _store(x_new, cache_q, cache_s, idx):
        if quant:
            qv, sv = kv_quant(x_new)
            return (update_slice(cache_q, qv, idx, 1),
                    update_slice(cache_s, sv, idx, 1))
        return update_slice(cache_q, x_new, idx, 1), cache_s

    def _read(cache_q, cache_s):
        if quant:
            return kv_dequant(cache_q, cache_s, q.dtype)
        return cache_q

    if kv_cache is not None:
        if cache_pos is not None:  # decode: insert this step's k/v
            size = kv_cache["k"].shape[1]
            ring = "pos" in kv_cache  # windowed ring buffer (local attention)
            idx = cache_pos % size if ring else cache_pos
            kc, ks = _store(k, kv_cache["k"], kv_cache.get("k_scale"), idx)
            vc, vs = _store(v, kv_cache["v"], kv_cache.get("v_scale"), idx)
            new_cache = {"k": kc, "v": vc}
            if quant:
                new_cache.update(k_scale=ks, v_scale=vs)
            kd, vd = _read(kc, ks), _read(vc, vs)
            if ring:
                posc = update_slice(
                    kv_cache["pos"],
                    cache_pos + torch.arange(k.shape[1], dtype=torch.int32,
                                             device=q.device), idx, 0)
                new_cache["pos"] = posc
                out = pos_attention(q, pick(kd), pick(vd), posc, cache_pos,
                                    window)
            else:
                kv_len = torch.full((q.shape[0],), cache_pos + k.shape[1],
                                    dtype=torch.int32, device=q.device)
                out = full_attention(q, pick(kd), pick(vd), causal=False,
                                     window=window, kv_offset=cache_pos,
                                     kv_len=kv_len)
        else:  # prefill: fill the cache from 0
            size = kv_cache["k"].shape[1]
            s = k.shape[1]
            if "pos" in kv_cache:  # ring: keep only the last `size` positions
                take = min(s, size)
                kc, ks = _store(k[:, -take:], kv_cache["k"],
                                kv_cache.get("k_scale"), 0)
                vc, vs = _store(v[:, -take:], kv_cache["v"],
                                kv_cache.get("v_scale"), 0)
                # as in the JAX model, the ring-slot alignment assumes
                # size | s (window 2048 divides the long prefills)
                posc = update_slice(
                    kv_cache["pos"],
                    torch.arange(s - take, s, dtype=torch.int32,
                                 device=q.device), 0, 0)
                new_cache = {"k": kc, "v": vc, "pos": posc}
            else:
                kc, ks = _store(k, kv_cache["k"], kv_cache.get("k_scale"), 0)
                vc, vs = _store(v, kv_cache["v"], kv_cache.get("v_scale"), 0)
                new_cache = {"k": kc, "v": vc}
            if quant:
                new_cache.update(k_scale=ks, v_scale=vs)
            out = _self_attn(q, pick(k), pick(v), causal, window)
    elif not cross:
        out = _self_attn(q, pick(k), pick(v), causal, window)
    else:
        out = full_attention(q, pick(k), pick(v), causal=False)
    return out, new_cache


def _self_attn(q, k, v, causal, window):
    if k.shape[1] > BLOCKWISE_FROM:
        return blockwise_attention(q, k, v, causal=causal, window=window)
    return full_attention(q, k, v, causal=causal, window=window)


# ---------------------------------------------------------------------------
# SwiGLU MLP + dense decoder block
# ---------------------------------------------------------------------------


def init_mlp(gen, cfg: LMConfig, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p, lg = {}, {}
    p["wi"], lg["wi"] = init_linear(gen, d, f, "embed", "ffn", cfg)
    p["wg"], lg["wg"] = init_linear(gen, d, f, "embed", "ffn", cfg)
    p["wo"], lg["wo"] = init_linear(gen, f, d, "ffn", "embed", cfg)
    return p, lg


def mlp(p, x):
    h = silu(linear(x, p["wg"])) * linear(x, p["wi"])
    return linear(h, p["wo"])


def init_dense_block(gen, cfg: LMConfig):
    p, lg = {}, {}
    p["ln1"], lg["ln1"] = init_norm(gen, cfg.d_model, cfg)
    p["attn"], lg["attn"] = init_attention(gen, cfg)
    p["ln2"], lg["ln2"] = init_norm(gen, cfg.d_model, cfg)
    p["mlp"], lg["mlp"] = init_mlp(gen, cfg)
    return p, lg


def dense_block(p, x, cfg: LMConfig, positions, *, kv_cache=None,
                cache_pos=None, window: int = 0):
    h, new_cache = attention_block(
        p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg, positions,
        causal=True, window=window, kv_cache=kv_cache, cache_pos=cache_pos)
    x = x + h
    x = x + mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))
    return x, new_cache


# ---------------------------------------------------------------------------
# the blocks partitioned over a mesh (explicit SPMD): what GSPMD makes of
# the JAX model's `shard` annotations, written out
# ---------------------------------------------------------------------------


class Spmd:
    """One partitioned program on `mesh` (see `dist/sharding.py`): every
    per-device value is a list, one block an executed device, in mesh
    order; `map` runs a function on each device's blocks.

    Tensor parallelism over 'model' (Megatron's layout, the one GSPMD
    derives from the reference's annotations): `wq`, `wk`, `wv`, `wi` and
    `wg` split their output columns, `wo` its input rows, followed by a
    psum; a replicated input enters the split work through `enter`, whose
    backward sums the devices' partial cotangents. FSDP: weights split on
    'embed' over 'data' are all-gathered before use (`local`), their
    gradients reduce-scattered by the gather's backward. The batch rows
    split over the data axes ('pod', 'data'), or, where they do not
    divide them (`rows_split` False: a batch of one), every data group
    computes every row, as GSPMD replicates them: then nothing is summed
    over the data axes, and an FSDP gather's backward keeps each device's
    own block of its (whole) cotangent."""

    def __init__(self, mesh):
        from repro_torch.dist import sharding as S

        self.S, self.mesh = S, mesh
        sizes = dict(mesh.shape)
        self.tp = int(sizes.get("model", 1))
        self.n = len(mesh.executed)
        self.rank = [int(mesh.coords(i).get("model", 0))
                     for i in mesh.executed]
        self.data_axes = tuple(a for a in ("pod", "data") if a in sizes)
        self.rows_split = True

    def map(self, fn, *args) -> list:
        """`fn` on each device's blocks: list arguments are per device,
        any other argument is every device's."""
        return [fn(*(a[k] if isinstance(a, list) else a for a in args))
                for k in range(self.n)]

    def splits(self, n: int) -> bool:
        """Do the placements split a width of `n` over 'model'? (They
        split whatever divides, `_fit_spec_to_shape`.)"""
        return self.tp > 1 and n % self.tp == 0

    def enter_model(self, xs) -> list:
        return self.S.enter(xs, self.mesh, ("model",))

    def psum_model(self, xs) -> list:
        return self.S.psum(xs, self.mesh, ("model",))

    def psum_split(self, xs) -> list:
        """A sum over 'model' that split work consumes (each device its
        own part of it): the backward sums the partial cotangents too."""
        return self.enter_model(self.psum_model(xs))

    def column_in(self, hs) -> list:
        """A replicated input entering column-parallel products (`linear`
        on each device's columns): its cotangent sums the devices'
        partial ones."""
        return list(hs) if self.tp == 1 else self.enter_model(hs)

    def row(self, xs, ps) -> list:
        """A row-parallel product summed over 'model' in xs' type, as
        GSPMD sums the partial products of the reference's layout."""
        part = self.map(linear, xs, ps)
        return part if self.tp == 1 else self.psum_model(part)

    def own(self, xs, dim: int) -> list:
        """Each device's block, along `dim`, of a value every device holds
        whole (split evenly over 'model')."""
        size = xs[0].shape[dim] // self.tp
        return [x.narrow(dim, r * size, size)
                for x, r in zip(xs, self.rank)]

    def gather_cols(self, xs) -> list:
        """Column blocks split over 'model' joined on every device."""
        return self.S.all_gather(xs, self.mesh, "model", -1)

    def entered_linear(self, ps) -> list:
        """A linear's weights, whole on every device, used by split work:
        their floating leaves entered, so their gradient sums the
        devices' partial ones."""
        keys = list(ps[0])
        cols = {k: (self.enter_model([p[k] for p in ps])
                    if ps[0][k].is_floating_point() else [p[k] for p in ps])
                for k in keys}
        return [{k: cols[k][i] for k in keys} for i in range(self.n)]

    def local(self, tree) -> list:
        """A tree of placed values -> one tree of blocks a device, every
        block split over 'data' (FSDP) all-gathered first."""
        S = self.S

        def one(x):
            if not isinstance(x, S.Sharded):
                return [x] * self.n
            parts = list(x.parts)
            for d, e in enumerate(x.sharding.spec):
                if e is not None and "data" in S._names(e):
                    if e != "data":
                        raise NotImplementedError(
                            f"a weight split over {e!r}: FSDP splits "
                            f"weights over 'data' alone")
                    parts = S.all_gather(parts, self.mesh, "data", d,
                                         whole=not self.rows_split)
            return parts

        def build(t, k):
            if isinstance(t, dict):
                return {key: build(v, k) for key, v in t.items()}
            return t[k]

        def walk(t):
            if isinstance(t, dict):
                return {key: walk(v) for key, v in t.items()}
            return one(t)

        gathered = walk(tree)
        return [build(gathered, k) for k in range(self.n)]


def write_state(dst: dict, src: dict) -> None:
    """Copy a block's new state into its cache slot `dst`, leaf by leaf."""
    for k in dst:
        if src[k] is not dst[k]:
            dst[k].copy_(src[k])


def each_device(sp: Spmd, block, ps, hs, cfg: LMConfig, states) -> list:
    """`block(p, h, cfg, state=)` (a recurrent block) on every device's
    whole blocks, where no width of it splits over 'model': each new state
    written into that device's cache slot (`states`, or Nones)."""
    outs = sp.map(lambda p, h, st: block(p, h, cfg, state=st), ps, hs,
                  states)
    for st, (_, new) in zip(states, outs):
        if st is not None:
            write_state(st, new)
    return [o for o, _ in outs]


def _kv_group(cfg: LMConfig, tp: int, rank: int) -> Optional[slice]:
    """The KV heads that the q heads of device `rank` attend with, where
    every device holds every KV head (n_kv_heads does not divide tp): a
    contiguous run, each serving the same number of local q heads; None
    where they do not group so."""
    nq = cfg.n_heads // tp
    rep = cfg.n_heads // cfg.n_kv_heads
    q0 = rank * nq
    kv = [(q0 + i) // rep for i in range(nq)]
    first, n = kv[0], kv[-1] - kv[0] + 1
    if nq % n or any(kv[i] - first != i // (nq // n) for i in range(nq)):
        return None
    return slice(first, first + n)


def _kv_cols(sp: Spmd, tp: int, src, ps, w: str, cfg: LMConfig) -> list:
    """Each device's K (or V) projection: its own KV heads where they
    divide the 'model' axis, else every KV head (its column block
    all-gathered, or, where the columns stay whole, the whole weight)."""
    if tp == 1 or cfg.n_kv_heads % tp == 0:
        return [linear(x, p[w]) for x, p in zip(src, ps)]
    if sp.splits(cfg.n_kv_heads * cfg.head_dim):
        return sp.gather_cols([linear(x, p[w]) for x, p in zip(src, ps)])
    return sp.map(linear, src, sp.entered_linear([p[w] for p in ps]))


def cross_kv_spmd(sp: Spmd, ps, memory, cfg: LMConfig):
    """The cross-attention K and V of the encoder's `memory` (replicated
    over 'model'), as `attention_spmd` lays them out and the cross cache
    holds them: each device its own KV heads, or every one."""
    tp = sp.tp if sp.splits(cfg.n_heads * cfg.head_dim) else 1
    src = memory if tp == 1 else sp.enter_model(memory)
    b, s = memory[0].shape[:2]
    k, v = (_kv_cols(sp, tp, src, ps, w, cfg) for w in ("wk", "wv"))
    return ([t.reshape(b, s, -1, cfg.head_dim) for t in k],
            [t.reshape(b, s, -1, cfg.head_dim) for t in v])


def attention_spmd(sp: Spmd, ps, hs, cfg: LMConfig, positions, *,
                   causal: bool = True, window: int = 0, kv_caches=None,
                   cache_pos=None, memory=None, kv=None):
    """`attention_block` partitioned: `ps` each device's attention weights
    (local blocks), `hs` its normed hidden [b, S, D], replicated over
    'model', `positions` its positions. Self-attention (causal or not,
    `window`), cross-attention on the encoder's `memory` (each device's,
    replicated over 'model'), or on precomputed cross K/V (`kv`, each
    device's (k, v) as `cross_kv_spmd` gives them; q alone normed, as the
    reference's `_cross_from_cache`).

    Each device projects its q heads' columns and its share of the K/V
    columns; where the KV heads do not divide the 'model' axis the
    projected K and V are all-gathered (the reference constrains them to
    replicated heads), so each device holds every KV head and its q heads
    meet their own group (`_kv_group`). Where the q columns split off the
    head boundaries (10 heads of 256 over 16 devices) or the local heads
    do not group, q is all-gathered too and every device attends with
    every head, then takes its own rows of the attention output into the
    row-parallel `wo`. The output projection is row-parallel, its partial
    sums psummed; where the placements leave `wo`'s rows whole (the heads'
    columns do not divide the axis), every device runs the whole block.
    Returns each device's output [b, S, D]; `kv_caches` (each device's
    dict) are written in place."""
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    tp = sp.tp if sp.splits(nh * hd) else 1
    b, s = hs[0].shape[:2]
    groups, all_heads = [None] * sp.n, False
    if tp > 1 and nkv % tp:
        if nh % tp == 0:
            groups = [_kv_group(cfg, tp, r) for r in sp.rank]
        all_heads = nh % tp != 0 or None in groups
        if all_heads:
            groups = [None] * sp.n
    if tp > 1:
        hs = sp.enter_model(hs)
    q = [linear(h, p["wq"]) for h, p in zip(hs, ps)]
    if all_heads:
        q = sp.gather_cols(q)
    q = [t.reshape(b, s, -1, hd) for t in q]
    if kv is None:
        src = hs if memory is None else (
            memory if tp == 1 else sp.enter_model(memory))
        sk = src[0].shape[1]
        k, v = ([t.reshape(b, sk, -1, hd)
                 for t in _kv_cols(sp, tp, src, ps, w, cfg)]
                for w in ("wk", "wv"))
    else:
        k, v = kv
    if cfg.qk_norm:  # replicated scales on split heads: partial gradients
        def scales(name):
            w = [p[name]["scale"].to(F32) for p in ps]
            return w if tp == 1 else sp.enter_model(w)

        q = sp.map(lambda t, w: rms_norm(t, {"scale": w}, cfg.norm_eps), q,
                   scales("qnorm"))
        if kv is None:
            k = sp.map(lambda t, w: rms_norm(t, {"scale": w}, cfg.norm_eps),
                       k, scales("knorm"))
    cross = memory is not None or kv is not None
    if not cross:  # self-attention: rope
        q = sp.map(lambda t, pos: rope(t, pos, cfg.rope_theta), q,
                   positions)
        kpos = positions if cache_pos is None else [
            cache_pos + torch.arange(s, device=t.device) for t in k]
        k = sp.map(lambda t, pos: rope(t, pos, cfg.rope_theta), k, kpos)
    caches = kv_caches or [None] * sp.n
    att = sp.map(lambda q_, k_, v_, c, g: attend(
        q_, k_, v_, causal=causal, window=window, kv_cache=c,
        cache_pos=cache_pos, cross=cross, kv_heads=g),
        q, k, v, caches, groups)
    out = [o[0].reshape(b, s, -1) for o in att]
    if all_heads:
        out = sp.own(out, -1)
    wo = [p["wo"] for p in ps]
    if tp == 1:
        return sp.map(linear, out, wo)
    return sp.row(out, wo)


def mlp_spmd(sp: Spmd, ps, hs, cfg: LMConfig, d_ff: Optional[int] = None):
    """`mlp` partitioned: `wi` and `wg` column-parallel on a replicated
    input, `wo` row-parallel, its partial sums psummed; where its width
    (`d_ff`, default cfg.d_ff) does not divide the 'model' axis (the
    placements leave it whole), every device runs the whole block."""
    if not sp.splits(d_ff or cfg.d_ff):
        return sp.map(mlp, ps, hs)
    hs = sp.column_in(hs)
    h = [silu(linear(x, p["wg"])) * linear(x, p["wi"])
         for x, p in zip(hs, ps)]
    return sp.row(h, [p["wo"] for p in ps])


__all__ = [
    "init_linear", "linear", "init_norm", "rms_norm", "rope",
    "init_attention", "attention_block", "full_attention", "pos_attention",
    "blockwise_attention", "init_mlp", "mlp", "init_dense_block",
    "dense_block", "dt", "kv_quant", "kv_dequant", "sigmoid", "silu",
    "softplus", "gelu", "attend", "MetaGenerator", "Spmd",
    "attention_spmd", "mlp_spmd", "cross_kv_spmd", "write_state",
    "each_device",
]
