"""Mixture-of-Experts FFN with capacity-based dispatch (GShard-style).

Counterpart of `repro/models/lm/moe.py`. Used by arctic-480b (128 routed
experts, top-2, plus a dense residual MLP in parallel) and qwen2-moe-a2.7b
(60 routed experts, top-4, plus shared experts). Tokens are scattered into
an expert buffer [E, C, D] of static capacity C; a (token, choice) past its
expert's capacity is dropped, as in the JAX model.

Ties in the router: `jax.lax.top_k` takes the lower expert index first;
`torch.topk` promises no order among equal values, so the top k are the
first k of a stable descending sort.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.lm.common import dt, init_mlp, mlp, normal, silu
from repro_torch.models.lm.config import LMConfig

F32 = torch.float32


def init_moe(gen, cfg: LMConfig):
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    std = d**-0.5
    p = {
        "router": {"w": normal(gen, (d, e), std).to(dt(cfg))},
        "wi": normal(gen, (e, d, f), std).to(dt(cfg)),
        "wg": normal(gen, (e, d, f), std).to(dt(cfg)),
        "wo": normal(gen, (e, f, d), f**-0.5).to(dt(cfg)),
    }
    lg = {
        "router": {"w": ("embed", None)},
        "wi": ("experts", "embed", None),
        "wg": ("experts", "embed", None),
        "wo": ("experts", None, "embed"),
    }
    if cfg.n_shared_experts:
        p["shared"], lg["shared"] = init_mlp(gen, cfg, d_ff=cfg.shared_d_ff)
    if cfg.dense_residual:
        p["dense"], lg["dense"] = init_mlp(gen, cfg, d_ff=cfg.d_ff)
    return p, lg


def top_k(probs, k: int):
    """(values, indices) of the k largest along the last axis, equal
    values in ascending index order (`jax.lax.top_k`)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(p, x, cfg: LMConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (y, aux_loss). Capacity-dropped top-k routing."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xt = x.reshape(t, d)

    logits = (xt @ p["router"]["w"].to(xt.dtype)).to(F32)  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate, idx = top_k(probs, k)  # [T, k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(0)
    flat_e = idx.reshape(-1)  # [T*k], token-major order
    ce = torch.zeros((e,), dtype=F32, device=x.device).index_add_(
        0, flat_e, torch.ones(flat_e.shape, dtype=F32, device=x.device))
    ce = ce / (t * k)
    aux = e * torch.sum(me * ce)

    # capacity per expert (Python's round, as the JAX model)
    cap = int(max(1, round(k * t * cfg.capacity_factor / e)))
    cap = min(cap, t)

    # position of each (token, choice) within its expert's buffer
    onehot = torch.nn.functional.one_hot(flat_e, e).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0) - 1  # positions per expert
    flat_pos = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    keep = flat_pos < cap
    safe_pos = torch.where(keep, flat_pos, 0).to(torch.int64)

    # dispatch: scatter tokens into the expert buffer [E, C, D]
    xk = torch.repeat_interleave(xt, k, dim=0)  # [T*k, D], token-major
    contrib = torch.where(keep[:, None], xk, 0)
    buf = torch.zeros((e, cap, d), dtype=xt.dtype, device=x.device)
    buf.index_put_((flat_e, safe_pos), torch.where(keep[:, None], contrib, 0),
                   accumulate=True)

    # expert compute (batched over E)
    h = silu(torch.einsum("ecd,edf->ecf", buf, p["wg"].to(buf.dtype)))
    h = h * torch.einsum("ecd,edf->ecf", buf, p["wi"].to(buf.dtype))
    out_buf = torch.einsum("ecf,efd->ecd", h, p["wo"].to(buf.dtype))

    # combine: gather back and weight by the gate
    y_tk = out_buf[flat_e, safe_pos]  # [T*k, D]
    y_tk = torch.where(keep[:, None], y_tk, 0)
    y = (y_tk.reshape(t, k, d) * gate[..., None].to(xt.dtype)).sum(1)

    if cfg.n_shared_experts:
        y = y + mlp(p["shared"], xt)
    if cfg.dense_residual:
        y = y + mlp(p["dense"], xt)
    return y.reshape(b, s, d), aux


__all__ = ["init_moe", "moe_ffn", "top_k"]
