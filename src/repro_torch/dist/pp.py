"""Pipeline parallelism over a mesh axis (GPipe-style, minimal).

Counterpart of `repro/dist/pp.py`. The repeated-layer stack is split into
`n_stages` contiguous stages; stage s's layers and activations live on the
s-th device of the mesh along `axis_name`. The loss streams `n_micro`
microbatches through the stages with the reference's tick schedule: at
tick t, stage 0 takes microbatch t, every stage applies its layers, the
last stage's output is collected as microbatch t - (n_stages - 1), and
each stage hands its activations to the next. The reference's hand-off is
`jax.lax.ppermute` inside a `shard_map` body, one body a device; here one
process drives every stage, and the hand-off is a `.to()` onto the next
stage's device, which autograd differentiates, so one `backward()` trains
every stage. The reference runs every stage at every tick, also on the
zeros or stale activations it holds while the pipeline fills and drains;
those results are never collected, and here a stage with no microbatch at
a tick runs nothing.

Only uniform-layer families (a single repeating block kind, no unrolled
tail) are supported, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.lm import model as M
from repro_torch.models.lm.config import LMConfig

F32 = torch.float32


def split_stage_params(layers, n_stages: int):
    """[L, ...]-stacked layer params -> [S, L/S, ...] (stage-major)."""

    def split(x):
        n_layers = x.shape[0]
        if n_layers % n_stages:
            raise ValueError(
                f"{n_layers} layers not divisible into {n_stages} stages")
        return x.reshape(n_stages, n_layers // n_stages, *x.shape[1:])

    return M.tree_map(split, layers)


def stage_devices(mesh, axis_name: str, n_stages: int):
    """The devices along `axis_name` (every other axis at index 0)."""
    if axis_name not in mesh.axis_names:
        raise ValueError(f"mesh has no {axis_name!r} axis: "
                         f"{mesh.axis_names}")
    ax = mesh.axis_names.index(axis_name)
    index = [0] * len(mesh.axis_names)
    devs = []
    for s in range(mesh.devices.shape[ax]):
        index[ax] = s
        devs.append(mesh.devices[tuple(index)])
    if len(devs) != n_stages:
        raise ValueError(f"{n_stages} stages on a {axis_name!r} axis of "
                         f"{len(devs)} devices")
    return devs


def make_pp_loss(cfg: LMConfig, n_stages: int, n_micro: int,
                 axis_name: str = "pod"):
    """Build loss(params, tokens, mesh).

    Expects params["layers"] stage-split (see `split_stage_params`), on any
    device: stage s's chunk is moved to its device by `.to()`, and so is
    every other param where a stage needs it (the embedding on stage 0,
    the final norm and head on the last stage).
    tokens: [B, S] with B divisible by n_micro. Returns the scalar
    next-token loss (no aux) on the last stage's device."""
    kinds = M.layer_kinds(cfg)
    pat, _, tail = M._kind_groups(kinds)
    if len(pat) != 1 or tail:
        raise NotImplementedError(
            "pipeline parallelism requires a uniform layer stack")
    kind = pat[0]

    per_stage = cfg.n_layers // n_stages

    def stage_apply(layers_p, x, positions):
        for j in range(per_stage):
            x, _, _ = M._apply_layer(M._index(layers_p, j), x, cfg, kind,
                                     positions)
        return x

    def loss(params: Dict[str, Any], tokens: torch.Tensor, mesh):
        devs = stage_devices(mesh, axis_name, n_stages)
        last = n_stages - 1
        # stage s's chunk on its device: [S, L/S, ...] -> [L/S, ...]
        stage_p = [M.tree_map(lambda x, s=s: x[s].to(devs[s]),
                              params["layers"]) for s in range(n_stages)]
        head_p = {k: v if k == "layers" else M.tree_map(
            lambda x: x.to(devs[last]), v) for k, v in params.items()}
        embed_p = {"embed": params["embed"].to(devs[0])}

        tokens = tokens.to(devs[0])
        x = M.embed_tokens(embed_p, cfg, tokens)
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by n_micro={n_micro}")
        micro = x.reshape(n_micro, b // n_micro, *x.shape[1:])
        positions = [torch.arange(tokens.shape[1], device=d) for d in devs]

        bufs = [None] * n_stages  # the microbatch each stage holds
        outs = [None] * n_micro
        n_ticks = n_micro + n_stages - 1
        for t in range(n_ticks):
            if t < n_micro:  # stage 0 injects microbatch t
                bufs[0] = micro[t]
            bufs = [None if buf is None else
                    stage_apply(stage_p[s], buf, positions[s])
                    for s, buf in enumerate(bufs)]
            m = t - (n_stages - 1)  # microbatch leaving the last stage
            if m >= 0:
                outs[m] = bufs[last]
            if t < n_ticks - 1:  # hand activations to the next stage
                bufs = [None] + [None if buf is None else
                                 buf.to(devs[s + 1])
                                 for s, buf in enumerate(bufs[:-1])]

        # next-token cross-entropy on the last stage's outputs
        hidden = torch.cat(outs).reshape(b, *x.shape[1:])
        logits = M.logits_from_hidden(head_p, cfg, hidden)
        lp = torch.log_softmax(logits[:, :-1].to(F32), dim=-1)
        tgt = tokens[:, 1:].to(devs[last]).long()
        return -torch.gather(lp, -1, tgt[..., None])[..., 0].mean()

    return loss


__all__ = ["split_stage_params", "stage_devices", "make_pp_loss"]
