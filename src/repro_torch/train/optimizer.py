"""AdamW and learning-rate schedules (own implementation, no optimizer
library).

Counterpart of `repro/train/optimizer.py`: AdamW with decoupled weight
decay and global-norm clipping, state that mirrors the parameter tree, and
optional 8-bit state (m int8 symmetric per row; v uint8 in log space per
row). Only floating-point leaves are trained (and decayed); integer leaves
are held.

Functional: `apply_updates` returns new tensors and leaves its inputs as
they are. Every division divides by a tensor (see `core/quant.true_div`).

On placed parameters (`dist.sharding.Sharded` leaves, the partitioned
trainer's) AdamW runs on each device's block: the moments take the
parameter's placement, the global gradient norm sums each leaf's squares
over the axes it is split on, and the 8-bit state's per-row statistics
(m's absolute max, v's log range) are reduced over the axes that split a
row, so each block is quantized as the whole row is. Its per-row scale
keeps the parameter's first-axis split alone (the reference dry-run's
`_opt_state_shardings`).

The 8-bit v state takes a logarithm to quantize and an exponential to
dequantize. The reference's are XLA's float32 `log` and `exp` on the CPU,
Cephes polynomials with fused multiply-adds, which differ from torch's in
the last place on a few percent of inputs; `_log_f32`/`_exp_f32` evaluate
the same polynomials in the same order (each fused multiply-add in float64,
where the product is exact, rounded once to float32), so the 8-bit state
is the reference's bit for bit on every device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.quant import true_div
from repro_torch.dist import sharding as S
from repro_torch.train import tree as T

F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"  # cosine | linear | constant
    # 8-bit optimizer state: m int8 symmetric per row, v uint8 in log space
    # per row (2 bytes a parameter instead of 8)
    state_bits: Optional[int] = None


def _trainable(leaf) -> bool:
    return leaf.is_floating_point()


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=F32, device=like.device)


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine or linear decay (or constant), as a
    float32 tensor on the step's device."""
    step = step.to(F32)
    one = _scalar(1.0, step)
    warm = torch.minimum(true_div(step, max(cfg.warmup_steps, 1)), one)
    frac = torch.clamp(
        true_div(step - cfg.warmup_steps,
                 max(cfg.total_steps - cfg.warmup_steps, 1)), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - frac
    else:
        decay = one
    return cfg.lr * warm * decay


def _red_dims(x):
    return tuple(range(1, x.ndim)) if x.ndim > 1 else (0,)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """round_f32(a * b + c) with one rounding: the product of two float32
    values is exact in float64, and so is the sum up to one rounding."""
    d = torch.float64
    b = b.to(d) if isinstance(b, torch.Tensor) else b
    c = c.to(d) if isinstance(c, torch.Tensor) else c
    return (a.to(d) * b + c).to(F32)


_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)
_LN2_HI, _LN2_LO = 0.693359375, -2.12194440e-4


def _f(v: float) -> float:
    """A constant rounded to float32 (the polynomials' coefficients are
    float32 literals)."""
    return torch.tensor(v, dtype=F32).item()


def _log_f32(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive normal float32 values, XLA's CPU polynomial:
    x = m * 2^e with m in [sqrt(1/2), sqrt(2)), log(1 + (m - 1)) by a
    degree-9 polynomial, plus e * ln 2 in two parts."""
    x = torch.clamp(x, min=torch.finfo(F32).tiny)
    bits = x.view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 0x7F
    m = ((bits & ~0x7F800000) | 0x3F000000).view(F32)  # in [0.5, 1)
    e = 1.0 + e.to(F32)
    small = m < _f(0.707106781186547524)
    tmp = torch.where(small, m, torch.zeros_like(m))
    m = m - 1.0
    e = e - small.to(F32)
    m = m + tmp
    x2 = m * m
    x3 = x2 * m
    p = [_f(c) for c in _LOG_P]
    y = _fma(m, p[0], p[1])
    y1 = _fma(m, p[3], p[4])
    y2 = _fma(m, p[6], p[7])
    y = _fma(y, m, p[2])
    y1 = _fma(y1, m, p[5])
    y2 = _fma(y2, m, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, _f(_LN2_LO) * e)
    m = _fma(-x2, 0.5, m)
    m = m + y
    return _fma(e, _f(_LN2_HI), m)


def _exp_f32(x: torch.Tensor) -> torch.Tensor:
    """exp of float32 values, XLA's CPU polynomial: n = floor(x log2(e) +
    1/2), a = x - n ln 2 (in two parts), e^a by a degree-5 polynomial,
    times 2^n built in the exponent bits (0 below 2^-126)."""
    x = torch.clamp(x, _f(-87.8), _f(88.8))
    n = torch.floor(_fma(x, _f(1.4426950408889634), 0.5))
    n = torch.clamp(n, -127.0, 127.0)
    x = _fma(n, -_f(_LN2_HI), x)
    x = _fma(n, -_f(_LN2_LO), x)
    p = [_f(c) for c in _EXP_P]
    z = _fma(x, p[0], p[1])
    for c in p[2:]:
        z = _fma(z, x, c)
    z = _fma(z, x * x, x)
    z = 1.0 + z
    pow2 = ((n.to(torch.int32) + 0x7F) << 23).view(F32)
    return z * pow2


def _row_amax(x):
    return torch.amax(x.abs(), dim=_red_dims(x), keepdim=True)


def _quantize_state_leaf(x, amax=None):
    """First moment m: linear symmetric int8 with a per-row scale (`amax`:
    the rows' absolute max, where x is a block of them)."""
    amax = _row_amax(x) if amax is None else amax
    scale = torch.maximum(true_div(amax, 127.0), _scalar(1e-12, x))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.to(F32)}


def _dq8(leaf):
    return leaf["q"].to(F32) * leaf["scale"]


_VLOG_FLOOR = 1e-24


def _log_v(v):
    return _log_f32(v + _VLOG_FLOOR)


def _quantize_v_leaf(v, lo=None, hi=None):
    """Second moment v >= 0: uint8 in log space, per-row asymmetric (linear
    int8 would flush v's small entries to 0 and blow their updates up).
    `lo`, `hi`: the rows' log range, where v is a block of them."""
    red = _red_dims(v)
    lv = _log_v(v)
    if lo is None:
        lo = torch.amin(lv, dim=red, keepdim=True)
        hi = torch.amax(lv, dim=red, keepdim=True)
    scale = torch.maximum(true_div(hi - lo, 255.0), _scalar(1e-8, v))
    q = torch.clamp(torch.round((lv - lo) / scale), 0, 255).to(torch.uint8)
    return {"q": q, "scale": scale.to(F32), "zero": lo.to(F32)}


def _dq8_v(leaf):
    return _exp_f32(leaf["q"].to(F32) * leaf["scale"] + leaf["zero"]) \
        - _VLOG_FLOOR


def _is_qleaf(x) -> bool:
    return isinstance(x, dict) and set(x) in ({"q", "scale"},
                                              {"q", "scale", "zero"})


def _state_sharding(p_sh, nd: int):
    """The placement of an 8-bit state's per-row scale: the parameter's
    first-axis split alone."""
    spec = p_sh.spec
    first = spec[0] if len(spec) else None
    return S.NamedSharding(p_sh.mesh, S.P(first, *([None] * (nd - 1)))
                           if nd else S.P())


def init_state(params, state_bits: Optional[int] = None) -> AdamWState:
    """Zero moments mirroring the tree (a float32 scalar for a frozen
    leaf); step 0 as int32 on the first leaf's device. A placed leaf's
    moments are placed as it is (8-bit: `q` so, its scales by the first
    axis)."""
    def zero(p, quantizer):
        if isinstance(p, S.Sharded):
            if not _trainable(p.parts[0]):
                return S.leafwise(lambda t: torch.zeros(
                    (), dtype=F32, device=t.device), p)
            if state_bits != 8:
                return S.leafwise(lambda t: torch.zeros_like(t, dtype=F32),
                                  p)
            blocks = [quantizer(torch.zeros(t.shape, dtype=F32,
                                            device=t.device))
                      for t in p.parts]
            return {key: S.Sharded(
                [b[key] for b in blocks],
                p.sharding if key == "q" else _state_sharding(
                    p.sharding, blocks[0][key].ndim)) for key in blocks[0]}
        if not _trainable(p):
            return torch.zeros((), dtype=F32, device=p.device)
        if state_bits == 8:
            return quantizer(torch.zeros(p.shape, dtype=F32, device=p.device))
        return torch.zeros_like(p, dtype=F32)

    first = S.parts_of(T.leaves(params)[0])[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        m=T.tree_map(lambda p: zero(p, _quantize_state_leaf), params),
        v=T.tree_map(lambda p: zero(p, _quantize_v_leaf), params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, leaves in tree
    order (on placed leaves, each device's copy: `_sharded_norm`)."""
    flat = T.leaves(tree)
    if isinstance(flat[0], S.Sharded):
        return _sharded_norm(flat)
    total = 0
    for x in flat:
        total = total + torch.sum(torch.square(x.to(F32)))
    return torch.sqrt(total)


def _sharded_norm(flat) -> "S.Sharded":
    """The global norm of placed leaves, replicated: each leaf's block sums
    psummed over the axes it is split on, added in leaf order."""
    mesh = flat[0].mesh
    total = [0] * len(flat[0].parts)
    for x in flat:
        sq = S.psum([torch.sum(torch.square(t.to(F32))) for t in x.parts],
                    mesh, S.spec_axes(x.sharding.spec))
        total = [a + b for a, b in zip(total, sq)]
    return S.Sharded([torch.sqrt(t) for t in total], S.replicated(mesh))


def _adam(p, g, m, v, scale, lr, b1c, b2c, cfg: AdamWConfig):
    """The AdamW update of one block: (new p, new m, new v), moments in
    float32."""
    g = g.to(F32) * scale
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
    mh = m / b1c
    vh = v / b2c
    delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.to(F32)
    return (p.to(F32) - lr * delta).to(p.dtype), m, v


def _sharded_update(p, g, m, v, consts, cfg: AdamWConfig):
    """`_adam` on every device's block of a placed leaf; 8-bit state
    requantized with its row statistics reduced over the axes that split
    a row."""
    if not _trainable(p.parts[0]):
        return p, m, v
    quant = _is_qleaf(m)
    outs = []
    for k, (pk, gk) in enumerate(zip(p.parts, g.parts)):
        mk = _dq8({key: m[key].parts[k] for key in m}) if quant \
            else m.parts[k]
        vk = _dq8_v({key: v[key].parts[k] for key in v}) if quant \
            else v.parts[k]
        outs.append(_adam(pk, gk, mk, vk, *consts[k], cfg))
    new_p = S.Sharded([o[0] for o in outs], p.sharding)
    if not quant:
        return (new_p, S.Sharded([o[1] for o in outs], p.sharding),
                S.Sharded([o[2] for o in outs], p.sharding))
    mesh, row = p.mesh, S.spec_axes(p.sharding.spec[1:])
    amax = S.pmax([_row_amax(o[1]) for o in outs], mesh, row)
    lvs = [_log_v(o[2]) for o in outs]
    red = _red_dims(lvs[0])
    hi = S.pmax([torch.amax(t, dim=red, keepdim=True) for t in lvs], mesh,
                row)
    lo = [-t for t in S.pmax([-torch.amin(t, dim=red, keepdim=True)
                              for t in lvs], mesh, row)]
    m8 = [_quantize_state_leaf(o[1], a) for o, a in zip(outs, amax)]
    v8 = [_quantize_v_leaf(o[2], a, b) for o, a, b in zip(outs, lo, hi)]

    def placed(blocks, like):
        return {key: S.Sharded([b[key] for b in blocks],
                               like[key].sharding) for key in blocks[0]}

    return new_p, placed(m8, m), placed(v8, v)


def apply_updates(params, grads, state: AdamWState, cfg: AdamWConfig):
    """One AdamW step. Returns (new_params, new_state, metrics)."""
    step = state.step + 1
    gnorm = global_norm(grads)
    norms = S.parts_of(gnorm)

    def clip(norm):
        if not cfg.grad_clip:
            return 1.0
        return torch.minimum(
            _scalar(1.0, norm), _scalar(cfg.grad_clip, norm)
            / torch.maximum(norm, _scalar(1e-9, norm)))

    def consts(norm):
        """(clip scale, lr, bias corrections) on the norm's device."""
        st = step.to(norm.device)
        lr = lr_at(cfg, st)
        stepf = st.to(F32)
        return (clip(norm), lr, 1 - torch.pow(_scalar(cfg.b1, stepf), stepf),
                1 - torch.pow(_scalar(cfg.b2, stepf), stepf))

    per_dev = [consts(nm) for nm in norms]
    scale, lr, b1c, b2c = per_dev[0]
    if isinstance(gnorm, S.Sharded):
        gnorm = norms[0]

    def upd(p, g, m, v):
        if isinstance(p, S.Sharded):
            return _sharded_update(p, g, m, v, per_dev, cfg)
        if not _trainable(p):
            return p, m, v
        quant = _is_qleaf(m)
        if quant:
            m = _dq8(m)
            v = _dq8_v(v)
        new_p, m, v = _adam(p, g, m, v, scale, lr, b1c, b2c, cfg)
        if quant:
            return new_p, _quantize_state_leaf(m), _quantize_v_leaf(v)
        return new_p, m, v

    flat_p, treedef = T.flatten(params)
    flat_g = T.flatten_up_to(treedef, grads)
    flat_m = T.flatten_up_to(treedef, state.m)
    flat_v = T.flatten_up_to(treedef, state.v)
    out = [upd(p, g, m, v) for p, g, m, v in
           zip(flat_p, flat_g, flat_m, flat_v)]
    new_p = T.unflatten(treedef, [o[0] for o in out])
    new_m = T.unflatten(treedef, [o[1] for o in out])
    new_v = T.unflatten(treedef, [o[2] for o in out])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, AdamWState(step, new_m, new_v), metrics


__all__ = ["AdamWConfig", "AdamWState", "init_state", "apply_updates",
           "lr_at", "global_norm"]
