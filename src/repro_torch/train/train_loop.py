"""Train-step builder: microbatched gradients + AdamW (+ int8 gradient
compression).

Counterpart of `repro/train/train_loop.py`, with its signature:
`make_train_step(cfg, opt_cfg, grad_accum=, loss_fn=, compress=,
accum_dtype=, has_aux=)` returns

    train_step(params, opt_state, batch) -> (params, opt_state, metrics)

(with `compress`: `train_step(params, opt_state, batch, err_state) ->
(params, opt_state, err_state, metrics)`), for the LM's loss (`cfg`) or a
caller's (`loss_fn`, the vision trainer's).

Microbatches are contiguous slices of the batch (the reference's
`_split_microbatches` reshape), gradients accumulate in `accum_dtype`
(float32 unless the caller asks; the dry-run's arctic plan asks for
bfloat16) in microbatch order and are scaled by 1 / grad_accum, and aux
values (the BN batch moments) are averaged the same way.

On placed parameters and a placed batch (a mesh of several devices: the
partitioned LM, `models/lm/model.py`) the step is the SPMD one:
each device differentiates the replicated loss on its blocks, a
microbatch is a contiguous slice of each device's rows (so no row
moves: the rows of the reference's microbatch of the batch reordered
device by device), each microbatch's gradients of parameters replicated
over the data axes ('pod', 'data') are psummed over those the rows split
over (a batch that does not divide them is every device's) before they
are cast to `accum_dtype` and accumulated, as GSPMD orders the
reference's (FSDP's are reduce-scattered over 'data' by autograd), and
AdamW updates each block (`train/optimizer.py`). With `compress` the
reduced gradients are compressed where they lie, as the reference
compresses its whole reduced tree: each leaf's one scale taken over its
blocks, the residual placed like its parameter
(`grad_compress.compress_tree`). The step runs inside
`layers.exact_f32()`: float32 without TF32 and deterministic cuDNN, so a
restart from a checkpoint repeats the straight run bit for bit on the card.
Only floating-point leaves get gradients; integer leaves (the W8/W4 `w_q`
codes) get zeros, which the optimizer holds. The reference's own step
refuses such trees (`jax.grad` takes no int8 input).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from repro_torch.dist import sharding as S
from repro_torch.models.layers import exact_f32
from repro_torch.models.lm import model as M
from repro_torch.models.lm.config import LMConfig
from repro_torch.train import grad_compress as GC
from repro_torch.train import optimizer as O
from repro_torch.train import tree as T

F32 = torch.float32


def _split_microbatches(batch, n: int):
    """[n] list of microbatch trees: row block i of every leaf (of every
    device's rows, for a placed leaf)."""
    def sp(x):
        b = x.shape[0]
        assert b % n == 0, f"batch {b} % grad_accum {n}"
        return S.leafwise(lambda t: t.reshape(n, t.shape[0] // n,
                                              *t.shape[1:]), x)
    split = T.tree_map(sp, batch)
    return [T.tree_map(lambda x, i=i: S.leafwise(lambda t: t[i], x), split)
            for i in range(n)]


def _live(x):
    """A leaf to differentiate: detached, floating blocks requiring grad."""
    def one(t):
        return t.detach().requires_grad_(t.is_floating_point())
    return S.leafwise(one, x)


def value_and_grad(loss_fn: Callable, params, batch, has_aux: bool = False):
    """(loss, aux, grads): grads of every floating leaf (zeros where the
    loss does not reach it, as in JAX), aux detached. Placed leaves get
    placed gradients; a placed (replicated) loss is differentiated on
    every device with a cotangent of 1, and its first device's copy is
    the loss returned."""
    flat, treedef = T.flatten(params)
    live = [_live(x) for x in flat]
    out = loss_fn(T.unflatten(treedef, live), batch)
    loss, aux = out if has_aux else (out, None)
    wrt = [t for x in live for t in S.parts_of(x) if t.requires_grad]
    if isinstance(loss, S.Sharded):
        got = iter(torch.autograd.grad(
            list(loss.parts), wrt,
            grad_outputs=[torch.ones_like(t) for t in loss.parts],
            allow_unused=True))
        loss = loss.parts[0]
    else:
        got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))

    def grad(t):
        g = next(got) if t.requires_grad else None
        return torch.zeros_like(t) if g is None else g

    grads = [S.leafwise(grad, x) for x in live]
    if aux is not None:
        aux = T.tree_map(lambda a: a.detach(), aux)
    return loss.detach(), aux, T.unflatten(treedef, grads)


def _psum_data(grads, rows=("pod", "data")):
    """Placed gradients psummed over the data axes their parameter is
    replicated on and the batch rows split over (`rows`; rows replicated
    over an axis leave every device there the whole gradient)."""
    def one(g):
        if not isinstance(g, S.Sharded):
            return g
        axes = [a for a in rows if a not in S.spec_axes(g.sharding.spec)]
        return S.Sharded(S.psum(list(g.parts), g.mesh, axes), g.sharding)

    with torch.no_grad():
        return T.tree_map(one, grads)


def row_axes(batch):
    """The mesh axes a placed batch's rows split over."""
    lead = next(x for x in T.leaves(batch) if isinstance(x, S.Sharded))
    return S.spec_axes(lead.sharding.spec[:1])


def make_train_step(
    cfg: Optional[LMConfig],
    opt_cfg: O.AdamWConfig,
    grad_accum: int = 1,
    loss_fn: Optional[Callable] = None,
    compress: bool = False,
    accum_dtype=F32,
    has_aux: bool = False,
):
    """The reference's signature. `cfg` alone trains the LM's next-token
    loss (`models/lm/model.loss_fn`); `cfg=None` needs `loss_fn(params,
    batch) -> loss` (or `(loss, aux)` with `has_aux`; the vision trainer
    passes its own), and the aux tree is microbatch-averaged into
    metrics['aux']. With `compress` the gradients pass through int8
    compression with error feedback (`train/grad_compress.py`) and the
    step is `train_step(params, opt_state, batch, err_state) -> (params,
    opt_state, err_state, metrics)`. `accum_dtype`: the type gradients
    accumulate in over microbatches (a torch dtype)."""
    if loss_fn is None:
        if cfg is None:
            raise ValueError("need an LMConfig or an explicit loss_fn")
        loss_fn = functools.partial(_lm_loss, cfg)

    def grads_of(params, batch):
        def vg(mb):
            loss, aux, grads = value_and_grad(loss_fn, params, mb, has_aux)
            if isinstance(T.leaves(params)[0], S.Sharded):
                grads = _psum_data(grads, row_axes(mb))
            return loss, aux, grads

        if grad_accum == 1:
            return vg(batch)
        acc = T.tree_map(lambda p: S.leafwise(lambda t: torch.zeros(
            t.shape, dtype=accum_dtype, device=t.device), p), params)
        loss_sum = torch.zeros((), dtype=F32)
        aux_sum = None
        for mb in _split_microbatches(batch, grad_accum):
            loss, aux, grads = vg(mb)
            acc = T.tree_map(lambda a, g: S.leafwise(
                lambda a_, g_: a_ + g_.to(accum_dtype), a, g), acc, grads)
            loss_sum = loss_sum.to(loss.device) + loss
            if has_aux:
                if aux_sum is None:
                    aux_sum = T.tree_map(torch.zeros_like, aux)
                aux_sum = T.tree_map(lambda a, x: a + x, aux_sum, aux)
        inv = 1.0 / grad_accum
        aux_mean = (T.tree_map(lambda a: a * inv, aux_sum)
                    if has_aux else None)
        return loss_sum * inv, aux_mean, T.tree_map(
            lambda g: S.leafwise(lambda t: t * inv, g), acc)

    def train_step(params, opt_state, batch, err_state=None):
        with exact_f32():
            loss, aux, grads = grads_of(params, batch)
            with torch.no_grad():
                if compress:
                    grads, err_state = GC.compress_tree(grads, err_state)
                params, opt_state, metrics = O.apply_updates(
                    params, grads, opt_state, opt_cfg)
        metrics = dict(metrics, loss=loss)
        if has_aux:
            metrics["aux"] = aux
        if compress:
            return params, opt_state, err_state, metrics
        return params, opt_state, metrics

    return train_step


def _lm_loss(cfg: LMConfig, params, batch):
    return M.loss_fn(params, cfg, batch)


def make_eval_step(cfg: LMConfig):
    """`eval_step(params, batch) -> loss`: the LM's loss without
    gradients."""
    def eval_step(params, batch):
        with exact_f32(), torch.no_grad():
            return M.loss_fn(params, cfg, batch)

    return eval_step


__all__ = ["make_train_step", "make_eval_step", "value_and_grad"]
