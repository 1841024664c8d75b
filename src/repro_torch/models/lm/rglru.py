"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Counterpart of `repro/models/lm/rglru.py`. Recurrence (diagonal linear RNN
with input and recurrence gates):

    r_t = sigmoid(W_a x_t + b_a)                (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)                (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)      (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Block: two parallel input projections (value branch + gelu gate branch);
the value branch passes a short causal depthwise conv1d then the RG-LRU;
output = W_o (h * gelu(gate)). Prefill evaluates the recurrence with
`associative_scan`, the odd/even recursion of `jax.lax.associative_scan`
(so its products and sums are taken in the same order); decode is an O(1)
state update.

`rglru_spmd` is the block partitioned over a mesh, 'ffn' (the RG-LRU
width) over 'model' (the reference's `shard(xv, "batch", None, "ffn")`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.lm.common import (dt, each_device, gelu,
                                          init_linear, linear, normal,
                                          sigmoid, softplus, uniform,
                                          write_state)
from repro_torch.models.lm.config import LMConfig

F32 = torch.float32
_C = 8.0


def init_rglru_block(gen, cfg: LMConfig):
    d, r = cfg.d_model, cfg.lru_width
    p, lg = {}, {}
    p["wx"], lg["wx"] = init_linear(gen, d, r, "embed", "ffn", cfg)
    p["wgate"], lg["wgate"] = init_linear(gen, d, r, "embed", "ffn", cfg)
    p["conv_w"] = normal(gen, (cfg.conv_width, r), 0.1).to(dt(cfg))
    lg["conv_w"] = (None, "ffn")
    if cfg.rglru_diagonal_gates:
        # per-dimension gates (elementwise)
        p["wa"] = normal(gen, (r,), 0.05).to(dt(cfg))
        p["wi"] = normal(gen, (r,), 0.05).to(dt(cfg))
        lg["wa"] = ("ffn",)
        lg["wi"] = ("ffn",)
    else:
        p["wa"], lg["wa"] = init_linear(gen, r, r, "ffn", None, cfg, std=0.05)
        p["wi"], lg["wi"] = init_linear(gen, r, r, "ffn", None, cfg, std=0.05)
    # Lambda parameterized so that a_t starts in [0.9, 0.999]
    u = uniform(gen, (r,), 0.9, 0.999)
    p["lam"] = torch.log(torch.expm1(-torch.log(u) / _C))
    lg["lam"] = ("ffn",)
    p["wo"], lg["wo"] = init_linear(gen, r, d, "ffn", "embed", cfg)
    return p, lg


def causal_conv1d(x, w, state=None):
    """x: [B, S, R]; w: [K, R] depthwise. state: [B, K-1, R] for decode."""
    kw = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, kw - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
            for i in range(kw))
    new_state = xp[:, -(kw - 1):, :] if kw > 1 else None
    return y, new_state


def _gate_inputs(p, xc):
    """The recurrence and input gates' pre-activations."""
    if not isinstance(p["wa"], dict):  # diagonal gates
        return xc * p["wa"], xc * p["wi"]
    return linear(xc, p["wa"]), linear(xc, p["wi"])


def _rglru_gates(p, xc, pre=None):
    """(a, b) of the recurrence; `pre` the gates' pre-activations where
    the caller has them (`_gate_inputs` otherwise)."""
    ra, ia = _gate_inputs(p, xc) if pre is None else pre
    r_gate = sigmoid(ra.to(F32))
    i_gate = sigmoid(ia.to(F32))
    log_a = -_C * softplus(p["lam"]) * r_gate  # [B, S, R]
    a = torch.exp(log_a)
    gated_x = i_gate * xc.to(F32)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * gated_x
    return a, b


def _comb(left, right):
    al, bl = left
    ar, br = right
    return al * ar, bl * ar + br


def _interleave(even, odd, dim: int):
    n = even.shape[dim] + odd.shape[dim]
    shape = list(even.shape)
    shape[dim] = n
    out = even.new_empty(shape)
    idx = torch.arange(n, device=even.device)
    out.index_copy_(dim, idx[0::2], even)
    out.index_copy_(dim, idx[1::2], odd)
    return out


def associative_scan(fn, elems, dim: int):
    """Inclusive scan of the tuple `elems` along `dim` with the associative
    `fn(earlier, later)`, in `jax.lax.associative_scan`'s order: pairs are
    combined, the half-length sequence is scanned recursively, and the
    even elements are completed from the odd ones."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(e, start, stop=None, step=1):
        idx = [slice(None)] * e.ndim
        idx[dim] = slice(start, stop, step)
        return e[tuple(idx)]

    reduced = fn(tuple(sl(e, 0, -1, 2) for e in elems),
                 tuple(sl(e, 1, None, 2) for e in elems))
    odd = associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn(tuple(sl(e, 0, -1) for e in odd),
                  tuple(sl(e, 2, None, 2) for e in elems))
    else:
        even = fn(odd, tuple(sl(e, 2, None, 2) for e in elems))
    even = tuple(torch.cat([sl(e, 0, 1), r], dim=dim)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))


def rglru_scan(p, xc, chunk: int = 0, pre=None):
    """Parallel evaluation of h_t = a_t h_{t-1} + b_t over the sequence.

    chunk == 0: one associative scan over the whole sequence. chunk > 0: an
    associative scan within chunks and a loop carrying the chunk-boundary
    state."""
    a, b = _rglru_gates(p, xc, pre)
    if not chunk or xc.shape[1] <= chunk:
        _, h = associative_scan(_comb, (a, b), dim=1)
        return h.to(xc.dtype), h[:, -1].to(F32)

    bsz, s, r = xc.shape
    pad = (-s) % chunk
    if pad:  # a=1, b=0 is recurrence-neutral
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        b = F.pad(b, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    ac = a.reshape(bsz, nc, chunk, r)
    bc = b.reshape(bsz, nc, chunk, r)
    h0 = torch.zeros((bsz, r), dtype=F32, device=xc.device)
    hs = []
    for c in range(nc):
        a_cum, b_cum = associative_scan(_comb, (ac[:, c], bc[:, c]), dim=1)
        h = a_cum * h0[:, None, :] + b_cum  # fold in the carried state
        h0 = h[:, -1]
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(bsz, nc * chunk, r)[:, :s]
    return h.to(xc.dtype), h0.to(F32)


def rglru_step(p, xc, h_prev, pre=None):
    """One decode step. xc: [B, 1, R]; h_prev: [B, R] f32."""
    a, b = _rglru_gates(p, xc, pre)
    h = a[:, 0] * h_prev + b[:, 0]
    return h[:, None, :].to(xc.dtype), h


def rglru_block(p, x, cfg: LMConfig, state: Optional[dict] = None):
    """Full recurrent block. state: {'conv': [B,K-1,R], 'h': [B,R]} or None.

    Returns (out, new_state)."""
    xv = linear(x, p["wx"])
    g = gelu(linear(x, p["wgate"]))
    # decode = single-token step against carried state; prefill = scan
    # (prefill passes a zero-initialized state, which the scan assumes)
    decode = state is not None and x.shape[1] == 1
    conv_state = state["conv"] if decode else None
    xc, new_conv = causal_conv1d(xv, p["conv_w"].to(F32), conv_state)
    if decode:
        h, h_last = rglru_step(p, xc, state["h"])
    else:
        h, h_last = rglru_scan(p, xc, chunk=cfg.rglru_chunk)
    out = linear(h.to(g.dtype) * g, p["wo"])
    new_state = {
        "conv": (new_conv if new_conv is not None else torch.zeros(
            (x.shape[0], cfg.conv_width - 1, cfg.lru_width), dtype=dt(cfg),
            device=x.device)),
        "h": h_last,
    }
    return out, new_state


def rglru_spmd(sp, ps, hs, cfg: LMConfig, states=None):
    """`rglru_block` partitioned (`common.Spmd`): `ps` each device's block
    weights, `hs` its normed hidden [b, S, D], replicated over 'model';
    `states` each device's blocks of the layer's placed cache ({'conv',
    'h'}), written in place, or None. Returns each device's output.

    `wx` and `wgate` are column-parallel over the RG-LRU width; `conv_w`,
    `lam`, the conv state and `h` split the same way, aligned, and the
    scan runs channel by channel, so all of it is local. The [R, R] gates
    `wa` and `wi` split their input rows ('ffn', None): each device's
    partial products are reduce-scattered over 'model' (the psum, then
    the device's own R block); diagonal gates are local. `wo` is
    row-parallel, its partial sums psummed. Where the width does not
    divide the 'model' axis, every device runs the whole block."""
    states = states or [None] * sp.n
    if not sp.splits(cfg.lru_width):  # every width of the block whole
        return each_device(sp, rglru_block, ps, hs, cfg, states)
    hs = sp.enter_model(hs)
    decode = states[0] is not None and hs[0].shape[1] == 1
    xv = [linear(h, p["wx"]) for h, p in zip(hs, ps)]
    g = [gelu(linear(h, p["wgate"])) for h, p in zip(hs, ps)]
    conv = sp.map(lambda x, p, st: causal_conv1d(
        x, p["conv_w"].to(F32), st["conv"] if decode else None),
        xv, ps, states)
    xc = [c for c, _ in conv]
    if isinstance(ps[0]["wa"], dict):  # [R, R] gates: rows split
        pre = list(zip(*(sp.S.reduce_scatter(
            sp.map(linear, xc, [p[w] for p in ps]), sp.mesh, "model", -1)
            for w in ("wa", "wi"))))
    else:
        pre = [None] * sp.n
    if decode:
        hh = sp.map(lambda p, x, st, q: rglru_step(p, x, st["h"], q),
                    ps, xc, states, pre)
    else:
        hh = sp.map(lambda p, x, q: rglru_scan(p, x, chunk=cfg.rglru_chunk,
                                               pre=q), ps, xc, pre)
    out = sp.row([h.to(gg.dtype) * gg for (h, _), gg in zip(hh, g)],
                 [p["wo"] for p in ps])
    for st, (_, new_conv), (_, h_last) in zip(states, conv, hh):
        if st is not None:
            write_state(st, {"conv": new_conv, "h": h_last})
    return out


__all__ = ["init_rglru_block", "rglru_block", "rglru_scan", "rglru_step",
           "causal_conv1d", "associative_scan", "rglru_spmd"]
