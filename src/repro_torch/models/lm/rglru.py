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
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.lm.common import (dt, gelu, init_linear, linear,
                                          normal, sigmoid, softplus,
                                          uniform)
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


def _rglru_gates(p, xc):
    if not isinstance(p["wa"], dict):  # diagonal gates
        r_gate = sigmoid((xc * p["wa"]).to(F32))
        i_gate = sigmoid((xc * p["wi"]).to(F32))
    else:
        r_gate = sigmoid(linear(xc, p["wa"]).to(F32))
        i_gate = sigmoid(linear(xc, p["wi"]).to(F32))
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


def rglru_scan(p, xc, chunk: int = 0):
    """Parallel evaluation of h_t = a_t h_{t-1} + b_t over the sequence.

    chunk == 0: one associative scan over the whole sequence. chunk > 0: an
    associative scan within chunks and a loop carrying the chunk-boundary
    state."""
    a, b = _rglru_gates(p, xc)
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


def rglru_step(p, xc, h_prev):
    """One decode step. xc: [B, 1, R]; h_prev: [B, R] f32."""
    a, b = _rglru_gates(p, xc)
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


__all__ = ["init_rglru_block", "rglru_block", "rglru_scan", "rglru_step",
           "causal_conv1d", "associative_scan"]
