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

import contextlib
import math
from typing import Tuple

import torch

from repro_torch.models.lm.common import (
    dt,
    init_mlp,
    mlp,
    mlp_spmd,
    normal,
    silu,
)
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


def _route(p, xt, k: int):
    """The router on tokens `xt` [T, D]: (probs [T, E] float32, gate and
    idx [T, k]), the gate renormalized over the k chosen."""
    logits = (xt @ p["w"].to(xt.dtype)).to(F32)  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate, idx = top_k(probs, k)  # [T, k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    return probs, gate, idx


def capacity(cfg: LMConfig, t: int) -> int:
    """Slots an expert has for a batch of `t` tokens (Python's round, as
    the JAX model)."""
    cap = int(max(1, round(cfg.top_k * t * cfg.capacity_factor
                           / cfg.n_experts)))
    return min(cap, t)


def _slots(flat_e, e: int):
    """Each (token, choice)'s position among its expert's, counted from 0
    in token-major order, and each expert's count [E] (int64)."""
    onehot = torch.nn.functional.one_hot(flat_e, e).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0) - 1  # positions per expert
    return (torch.gather(pos, 1, flat_e[:, None])[:, 0],
            onehot.sum(0).to(torch.int64))


def _experts(p, xt, flat_e, slot, mine, gate, n_exp: int, cap: int):
    """The (token, choice) pairs `mine` scattered into an expert buffer
    [n_exp, cap, D] at (`flat_e`, `slot`), the experts `p` (blocks of
    n_exp) run over it, and each pair's output gathered back and weighted
    by its gate: [T, k, D] in xt's type, zeros where not `mine`."""
    t, d = xt.shape
    k = gate.shape[-1]
    e_s = torch.where(mine, flat_e, 0)
    s_s = torch.where(mine, slot, 0).to(torch.int64)

    # dispatch: scatter tokens into the expert buffer [E, C, D]
    xk = torch.repeat_interleave(xt, k, dim=0)  # [T*k, D], token-major
    contrib = torch.where(mine[:, None], xk, 0)
    buf = torch.zeros((n_exp, cap, d), dtype=xt.dtype, device=xt.device)
    buf.index_put_((e_s, s_s), contrib, accumulate=True)

    # expert compute (batched over E)
    h = silu(torch.einsum("ecd,edf->ecf", buf, p["wg"].to(buf.dtype)))
    h = h * torch.einsum("ecd,edf->ecf", buf, p["wi"].to(buf.dtype))
    out_buf = torch.einsum("ecf,efd->ecd", h, p["wo"].to(buf.dtype))

    # combine: gather back and weight by the gate
    y_tk = torch.where(mine[:, None], out_buf[e_s, s_s], 0)  # [T*k, D]
    return y_tk.reshape(t, k, d) * gate[..., None].to(xt.dtype)


def moe_ffn(p, x, cfg: LMConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (y, aux_loss). Capacity-dropped top-k routing."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xt = x.reshape(t, d)
    probs, gate, idx = _route(p["router"], xt, k)

    # position of each (token, choice) within its expert's buffer
    flat_e = idx.reshape(-1)  # [T*k], token-major order
    cap = capacity(cfg, t)
    slot, counts = _slots(flat_e, e)
    keep = slot < cap

    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(0)
    ce = counts.to(F32) / (t * k)
    aux = e * torch.sum(me * ce)
    _record([idx], [keep])
    y = _experts(p, xt, flat_e, slot, keep, gate, e, cap).sum(1)

    if cfg.n_shared_experts:
        y = y + mlp(p["shared"], xt)
    if cfg.dense_residual:
        y = y + mlp(p["dense"], xt)
    return y.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# partitioned over a mesh (explicit SPMD; `models/lm/model.py`)
# ---------------------------------------------------------------------------


def _row_groups(sp):
    """(the data axes the batch rows split over, the number of row
    blocks, each executed device's block index in the order of the rows:
    mesh order over those axes)."""
    axes = sp.S._axes(sp.mesh, sp.data_axes) if sp.rows_split else ()
    if not axes:
        return (), 1, [0] * sp.n
    sizes = dict(sp.mesh.shape)
    n = math.prod(sizes[a] for a in axes)
    if sp.mesh.symmetric:
        return axes, n, [0]
    groups = sp.mesh.groups(axes)
    return axes, n, [groups[i].index(i) for i in sp.mesh.executed]


def moe_spmd(sp, ps, hs, cfg: LMConfig):
    """`moe_ffn` partitioned, on the global batch as GSPMD runs the
    reference: `ps` each device's MoE weights (local blocks), `hs` its
    normed hidden [b, S, D], replicated over 'model'. Returns (each
    device's output, each device's aux loss: the global one).

    Each device routes its own rows (the router whole, FSDP-gathered).
    Capacity is the global batch's: T counts every row, and a (token,
    choice) keeps its place in token-major order over the whole batch,
    its position among its expert's offset by the counts of the row
    blocks before its own (every block's counts psummed over the data
    axes the rows split over, in the order of the rows). The aux loss
    takes the mean probabilities and the counts over all T tokens, each
    summed over those axes before the product. Where the rows are
    replicated there (a batch of one row) each group holds the whole
    batch: nothing is summed.

    Experts over 'model' (EP): where the placements split the experts,
    each device runs its own block of them on the slots its rows hold
    (a buffer of min(capacity, its tokens) slots an expert: its pairs
    start at their offset), its partial outputs stay float32 until their
    psum over 'model', and the tokens and the gate enter that split work.
    Where the experts do not divide the axis they stay whole, and every
    device runs all of them for its rows. The shared experts and the
    dense residual follow as `mlp_spmd`, in the reference's order."""
    S, mesh = sp.S, sp.mesh
    e, k = cfg.n_experts, cfg.top_k
    b, s, d = hs[0].shape
    t = b * s
    axes, n_blk, blk = _row_groups(sp)
    t_all = t * n_blk
    xt = [h.reshape(t, d) for h in hs]
    routes = sp.map(lambda p, x: _route(p["router"], x, k), ps, xt)
    probs, gate, idx = ([r[i] for r in routes] for i in range(3))
    flat_e = [i.reshape(-1) for i in idx]
    slot, counts = (list(x) for x in zip(*(_slots(f, e) for f in flat_e)))
    psum_p = [pr.sum(0) for pr in probs]
    if n_blk > 1:
        with torch.no_grad():
            rows = [torch.zeros((n_blk, e), dtype=torch.int64,
                                device=c.device).index_copy_(
                0, torch.tensor([g], device=c.device), c[None])
                for c, g in zip(counts, blk)]
            rows = S.psum(rows, mesh, axes)
        offset = [r[:g].sum(0) for r, g in zip(rows, blk)]
        counts = [r.sum(0) for r in rows]
        psum_p = S.psum(psum_p, mesh, axes)
    else:
        offset = [torch.zeros_like(c) for c in counts]
    aux = [e * torch.sum((pr / t_all) * (c.to(F32) / (t_all * k)))
           for pr, c in zip(psum_p, counts)]
    cap = capacity(cfg, t_all)
    keep = [sl + off[f] < cap for sl, off, f in zip(slot, offset, flat_e)]
    _record_spmd(sp, blk, n_blk, idx, keep)
    cap_loc = min(cap, t)  # a block's pairs: at most one a token
    if sp.splits(e):
        el = e // sp.tp

        def part(p, x, f, sl, kp, g, r):
            mine = kp & (torch.div(f, el, rounding_mode="floor") == r)
            return _experts(p, x, f - r * el, sl, mine, g, el,
                            cap_loc).to(F32).sum(1)

        ys = sp.psum_model(sp.map(part, ps, sp.enter_model(xt), flat_e,
                                  slot, keep, sp.enter_model(gate),
                                  sp.rank))
        ys = [y.to(x.dtype) for y, x in zip(ys, xt)]
    else:
        ys = sp.map(lambda p, x, f, sl, kp, g: _experts(
            p, x, f, sl, kp, g, e, cap_loc).sum(1), ps, xt, flat_e, slot,
            keep, gate)
    for key, width, on in (("shared", cfg.shared_d_ff, cfg.n_shared_experts),
                           ("dense", cfg.d_ff, cfg.dense_residual)):
        if on:
            ys = sp.map(torch.add, ys, mlp_spmd(sp, [p[key] for p in ps],
                                                xt, cfg, d_ff=width))
    return [y.reshape(b, s, d) for y in ys], aux


# ---------------------------------------------------------------------------
# routing records: what the router chose and what capacity kept
# ---------------------------------------------------------------------------

_OPEN = []  # the records open now


@contextlib.contextmanager
def record_routes():
    """Collect every MoE layer call's routing while open: a list with one
    dict a call, `idx` [T, k] (the chosen experts over the whole batch,
    token-major) and `keep` [T * k] (the (token, choice) pairs within
    capacity), on the CPU. A partitioned call records its row blocks
    joined in the order of the rows (meta meshes record nothing)."""
    rec = []
    _OPEN.append(rec)
    try:
        yield rec
    finally:
        _OPEN.remove(rec)


def _record(idx, keep) -> None:
    for rec in _OPEN:
        rec.append({"idx": torch.cat([i.detach().cpu() for i in idx]),
                    "keep": torch.cat([k.detach().cpu() for k in keep])})


def _record_spmd(sp, blk, n_blk: int, idx, keep) -> None:
    if not _OPEN or sp.mesh.symmetric:
        return
    first = [blk.index(g) for g in range(n_blk)]  # a device a row block
    _record([idx[j] for j in first], [keep[j] for j in first])


__all__ = ["init_moe", "moe_ffn", "moe_spmd", "top_k", "capacity",
           "record_routes"]
