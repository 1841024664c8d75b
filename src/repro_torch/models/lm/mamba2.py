"""Mamba-2 block via the SSD (state-space duality) algorithm (arXiv:2405.21060).

Counterpart of `repro/models/lm/mamba2.py`. The selective SSM

    h_t = exp(dt_t * A) h_{t-1} + dt_t * (B_t  x_t^T)        (per head)
    y_t = C_t^T h_t + D * x_t

is evaluated chunk by chunk: intra-chunk terms as an attention-like
quadratic form, inter-chunk terms as a short loop over chunk states (the
JAX model's `lax.scan`). Decode carries O(H * P * N) state per sequence.

`mamba2_spmd` is the block partitioned over a mesh, heads over 'model'
(the reference's `shard(xh, "batch", None, "heads", None)`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.lm.common import (F32, dt, each_device, init_linear,
                                          init_norm, linear, normal,
                                          rms_norm, silu, softplus, uniform,
                                          write_state)
from repro_torch.models.lm.config import LMConfig


def dims(cfg: LMConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    n_heads = d_in // cfg.ssm_head_dim
    return d_in, n_heads, cfg.ssm_head_dim, cfg.ssm_state


def init_mamba2_block(gen, cfg: LMConfig):
    d = cfg.d_model
    d_in, nh, hp, ns = dims(cfg)
    dev = gen.device
    p, lg = {}, {}
    # fused input projection: [z (gate), x, B, C, dt]
    proj_out = 2 * d_in + 2 * ns + nh
    p["in_proj"], lg["in_proj"] = init_linear(gen, d, proj_out, "embed",
                                              "ffn", cfg)
    p["conv_w"] = normal(gen, (cfg.conv_width, d_in + 2 * ns), 0.1).to(
        dt(cfg))
    lg["conv_w"] = (None, "ffn")
    p["A_log"] = torch.log(torch.linspace(1.0, 16.0, nh, dtype=F32,
                                          device=dev))
    lg["A_log"] = ("heads",)
    p["D"] = torch.ones((nh,), dtype=F32, device=dev)
    lg["D"] = ("heads",)
    p["dt_bias"] = torch.log(torch.expm1(torch.exp(uniform(
        gen, (nh,), math.log(1e-3), math.log(1e-1)))))
    lg["dt_bias"] = ("heads",)
    p["norm"], lg["norm"] = init_norm(gen, d_in, cfg)
    p["out_proj"], lg["out_proj"] = init_linear(gen, d_in, d, "ffn", "embed",
                                                cfg)
    return p, lg


def _segsum(dtA):
    """dtA: [..., Q] -> cumulative decay matrix log L[i, j] = sum_{j<k<=i}
    dtA_k (lower-triangular; -inf above the diagonal)."""
    q = dtA.shape[-1]
    cs = torch.cumsum(dtA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]  # [..., i, j] = sum_(j, i]
    ii = torch.arange(q, device=dtA.device)
    mask = ii[:, None] >= ii[None, :]
    return torch.where(mask, diff, -math.inf)


def ssd_chunked(x, dtv, A, B, C, chunk: int):
    """Chunked SSD scan.

    x  : [b, s, h, p]    (pre-discretized input)
    dtv: [b, s, h]       softplus'd step sizes
    A  : [h]             negative decay rates
    B,C: [b, s, n]       (single group, broadcast over heads)
    Returns y [b, s, h, p], final_state [b, h, n, p].
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:  # ragged tail: dt=0 is state-neutral (decay 1, update 0)
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dtv = F.pad(dtv, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    s_pad = s + pad
    nc = s_pad // q

    xr = x.reshape(b, nc, q, h, p).to(F32)
    dtr = dtv.reshape(b, nc, q, h).to(F32)
    Br = B.reshape(b, nc, q, n).to(F32)
    Cr = C.reshape(b, nc, q, n).to(F32)

    dtA = dtr * A[None, None, None, :]  # [b, nc, q, h]  (A < 0)
    # intra-chunk (attention-like, causal with decay):
    L = torch.exp(_segsum(dtA.permute(0, 1, 3, 2)))  # [b, nc, h, q, q]
    scores = torch.einsum("bcin,bcjn->bcij", Cr, Br)  # [b, nc, q, q]
    att = scores[:, :, None] * L  # [b, nc, h, i, j]
    y_intra = torch.einsum("bchij,bcjh,bcjhp->bcihp", att, dtr, xr)

    # chunk states: S_c = sum_j exp(sum_{j<k<q} dtA) * dt_j * B_j x_j^T
    cum = torch.cumsum(dtA, dim=2)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # [b, nc, q, h]
    states = torch.einsum("bcjh,bcjn,bcjhp->bchnp", decay_to_end * dtr, Br,
                          xr)  # [b, nc, h, n, p]

    # inter-chunk recurrence S_out = S_in * decay + S_c, one chunk at a time
    chunk_decay = torch.exp(torch.sum(dtA, dim=2))  # [b, nc, h]
    carry = torch.zeros((b, h, n, p), dtype=F32, device=x.device)
    entering = []  # the state entering each chunk
    for c in range(nc):
        entering.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    entering = torch.stack(entering, dim=1)  # [b, nc, h, n, p]

    # contribution of the entering state to each position in the chunk
    decay_from_start = torch.exp(cum)  # [b, nc, q, h]
    y_inter = torch.einsum("bcin,bchnp,bcih->bcihp", Cr, entering,
                           decay_from_start)
    y = (y_intra + y_inter).reshape(b, s_pad, h, p)[:, :s]
    return y, carry


def ssd_step(x, dtv, A, B, C, state):
    """One decode step. x: [b, 1, h, p]; state: [b, h, n, p] f32."""
    dtA = dtv[:, 0].to(F32) * A[None, :]  # [b, h]
    dec = torch.exp(dtA)
    upd = torch.einsum("bn,bhp->bhnp", B[:, 0].to(F32),
                       dtv[:, 0, :, None].to(F32) * x[:, 0].to(F32))
    new_state = state * dec[..., None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", C[:, 0].to(F32), new_state)
    return y[:, None], new_state


def mamba2_block(p, x, cfg: LMConfig, state: Optional[dict] = None):
    """Full block. state: {'conv': [B, K-1, d_conv_in], 'ssd': [B,H,N,P]}."""
    from repro_torch.models.lm.rglru import causal_conv1d

    b, s, d = x.shape
    d_in, nh, hp, ns = dims(cfg)
    zxbcdt = linear(x, p["in_proj"])
    z, xin, Bc, Cc, dtv = torch.split(zxbcdt, [d_in, d_in, ns, ns, nh],
                                      dim=-1)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    decode = state is not None and s == 1
    conv_state = state["conv"] if decode else None
    conv_out, new_conv = causal_conv1d(conv_in, p["conv_w"].to(F32),
                                       conv_state)
    conv_out = silu(conv_out).to(x.dtype)
    xin, Bc, Cc = torch.split(conv_out, [d_in, ns, ns], dim=-1)
    xh = xin.reshape(b, s, nh, hp)
    dtv = softplus(dtv.to(F32) + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])
    if decode:
        y, ssd_state = ssd_step(xh, dtv, A, Bc, Cc, state["ssd"])
    else:
        y, ssd_state = ssd_chunked(xh, dtv, A, Bc, Cc, cfg.ssm_chunk)
    y = y + p["D"][None, None, :, None] * xh.to(F32)
    y = y.reshape(b, s, d_in).to(x.dtype)
    y = rms_norm(y * silu(z), p["norm"], cfg.norm_eps)
    out = linear(y, p["out_proj"])
    new_state = {
        "conv": (new_conv if new_conv is not None else torch.zeros(
            (b, cfg.conv_width - 1, d_in + 2 * ns), dtype=dt(cfg),
            device=x.device)),
        "ssd": ssd_state,
    }
    return out, new_state


def _conv_state(conv_in, state, width: int):
    """The conv cache after `conv_in` [B, S, C] (after `state` [B, K-1, C],
    or zeros): its last K-1 inputs, as `causal_conv1d` keeps them."""
    if state is None:
        xp = F.pad(conv_in, (0, 0, width - 1, 0))
    else:
        xp = torch.cat([state.to(conv_in.dtype), conv_in], dim=1)
    return xp[:, -(width - 1):, :]


def mamba2_spmd(sp, ps, hs, cfg: LMConfig, states=None):
    """`mamba2_block` partitioned (`common.Spmd`): `ps` each device's
    block weights, `hs` its normed hidden [b, S, D], replicated over
    'model'; `states` each device's blocks of the layer's placed cache
    ({'conv', 'ssd'}), written in place, or None. Returns each device's
    output [b, S, D].

    The heads split over 'model' (`A_log`, `D`, `dt_bias`, the SSD state,
    `out_proj`'s rows). `in_proj`'s columns [z | x | B | C | dt] and
    `conv_w`'s channels [x | B | C] split evenly by count, off those
    segments (530 of 8480 columns a device at full width over 16), so
    both are all-gathered over 'model': each device then takes z, x and
    dt of its own heads and all of B and C, whose cotangents the gathers'
    backward sums over the heads. The conv cache splits by count the same
    way: a decode step gathers it, and every device writes back its own
    block of the new one. The gated RMSNorm over d_in psums the local
    sums of squares; `out_proj` is row-parallel, its partial sums
    psummed."""
    from repro_torch.models.lm.rglru import causal_conv1d

    d_in, nh, hp, ns = dims(cfg)
    n_conv = d_in + 2 * ns
    states = states or [None] * sp.n
    if sp.tp == 1:
        return each_device(sp, mamba2_block, ps, hs, cfg, states)
    if nh % sp.tp:
        raise NotImplementedError(
            f"{nh} SSD heads over a 'model' axis of {sp.tp}: the port "
            f"splits mamba2 by whole heads")
    b, s = hs[0].shape[:2]
    nl = nh // sp.tp
    dl = nl * hp
    decode = states[0] is not None and s == 1
    hs = sp.enter_model(hs)
    proj = [p["in_proj"] for p in ps]
    if sp.splits(2 * d_in + 2 * ns + nh):
        zx = sp.gather_cols(sp.map(linear, hs, proj))
    else:
        zx = sp.map(linear, hs, sp.entered_linear(proj))
    conv_w = [p["conv_w"] for p in ps]
    conv_w = (sp.gather_cols(conv_w) if sp.splits(n_conv)
              else sp.enter_model(conv_w))
    conv_in = [t[..., d_in:d_in + n_conv] for t in zx]  # [x | B | C]
    conv_state = [None] * sp.n
    if decode:
        conv_state = [st["conv"] for st in states]
        if sp.splits(n_conv):
            conv_state = sp.gather_cols(conv_state)

    def one(p, t, x_all, w, cst, st, r):
        idx = torch.cat([
            torch.arange(r * dl, (r + 1) * dl, device=t.device),
            torch.arange(d_in, n_conv, device=t.device)])
        conv_out, _ = causal_conv1d(
            x_all.index_select(-1, idx), w.index_select(-1, idx).to(F32),
            None if cst is None else cst.index_select(-1, idx))
        xin, Bc, Cc = torch.split(silu(conv_out).to(t.dtype), [dl, ns, ns],
                                  dim=-1)
        xh = xin.reshape(b, s, nl, hp)
        dtv = t[..., 2 * d_in + 2 * ns + r * nl:][..., :nl]
        dtv = softplus(dtv.to(F32) + p["dt_bias"][None, None, :])
        A = -torch.exp(p["A_log"])
        if decode:
            y, ssd = ssd_step(xh, dtv, A, Bc, Cc, st["ssd"])
        else:
            y, ssd = ssd_chunked(xh, dtv, A, Bc, Cc, cfg.ssm_chunk)
        y = y + p["D"][None, None, :, None] * xh.to(F32)
        z = t[..., r * dl:(r + 1) * dl]
        return (y.reshape(b, s, dl).to(t.dtype) * silu(z)).to(F32), ssd

    outs = sp.map(one, ps, zx, conv_in, conv_w, conv_state, states,
                  sp.rank)
    gs = [g for g, _ in outs]
    # the gated RMSNorm over all of d_in: the local sums of squares psummed
    var = [t / d_in for t in
           sp.psum_split([(g * g).sum(dim=-1, keepdim=True) for g in gs])]
    scale = sp.own(sp.enter_model([p["norm"]["scale"] for p in ps]), -1)
    ys = [(g * torch.rsqrt(v + cfg.norm_eps) * w.to(F32)).to(h.dtype)
          for g, v, w, h in zip(gs, var, scale, hs)]
    if states[0] is not None:
        with torch.no_grad():
            new = [_conv_state(x, c, cfg.conv_width)
                   for x, c in zip(conv_in, conv_state)]
            if sp.splits(n_conv):
                new = sp.own(new, -1)
            for st, c, (_, ssd) in zip(states, new, outs):
                write_state(st, {"conv": c, "ssd": ssd})
    return sp.row(ys, [p["out_proj"] for p in ps])


__all__ = ["init_mamba2_block", "mamba2_block", "ssd_chunked", "ssd_step",
           "dims", "mamba2_spmd"]
