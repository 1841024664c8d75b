"""Train-step builder: microbatched gradients + AdamW.

Counterpart of `repro/train/train_loop.py` for a caller-supplied loss (the
vision trainer's). `make_train_step(opt_cfg, loss_fn=, grad_accum=,
has_aux=)` returns

    train_step(params, opt_state, batch) -> (params, opt_state, metrics)

Microbatches are contiguous slices of the batch (the reference's
`_split_microbatches` reshape), gradients accumulate in float32 in
microbatch order and are scaled by 1 / grad_accum, and aux values (the BN
batch moments) are averaged the same way. The step runs inside
`layers.exact_f32()`: float32 without TF32 and deterministic cuDNN, so a
restart from a checkpoint repeats the straight run bit for bit on the card.

Not ported yet: the LM loss (the reference's `cfg`, ROADMAP queue 1 item
12) and gradient compression (`compress=`, item 11).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.layers import exact_f32
from repro_torch.train import optimizer as O
from repro_torch.train import tree as T

F32 = torch.float32


def _split_microbatches(batch, n: int):
    """[n] list of microbatch trees: row block i of every leaf."""
    def sp(x):
        b = x.shape[0]
        assert b % n == 0, f"batch {b} % grad_accum {n}"
        return x.reshape(n, b // n, *x.shape[1:])
    split = T.tree_map(sp, batch)
    return [T.tree_map(lambda x, i=i: x[i], split) for i in range(n)]


def value_and_grad(loss_fn: Callable, params, batch, has_aux: bool = False):
    """(loss, aux, grads): grads of every floating leaf (zeros where the
    loss does not reach it, as in JAX), aux detached."""
    flat, treedef = T.flatten(params)
    live = [x.detach().requires_grad_(x.is_floating_point()) for x in flat]
    out = loss_fn(T.unflatten(treedef, live), batch)
    loss, aux = out if has_aux else (out, None)
    wrt = [x for x in live if x.requires_grad]
    got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = []
    for x in live:
        g = next(got) if x.requires_grad else None
        grads.append(torch.zeros_like(x) if g is None else g)
    if aux is not None:
        aux = T.tree_map(lambda a: a.detach(), aux)
    return loss.detach(), aux, T.unflatten(treedef, grads)


def make_train_step(
    opt_cfg: O.AdamWConfig,
    *,
    loss_fn: Callable,
    grad_accum: int = 1,
    has_aux: bool = False,
):
    """`loss_fn(params, batch) -> loss` (or `(loss, aux)` with `has_aux`);
    the aux tree is microbatch-averaged into metrics['aux']."""

    def grads_of(params, batch):
        if grad_accum == 1:
            return value_and_grad(loss_fn, params, batch, has_aux)
        acc = T.tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                               device=p.device), params)
        loss_sum = torch.zeros((), dtype=F32)
        aux_sum = None
        for mb in _split_microbatches(batch, grad_accum):
            loss, aux, grads = value_and_grad(loss_fn, params, mb, has_aux)
            acc = T.tree_map(lambda a, g: a + g.to(F32), acc, grads)
            loss_sum = loss_sum.to(loss.device) + loss
            if has_aux:
                if aux_sum is None:
                    aux_sum = T.tree_map(torch.zeros_like, aux)
                aux_sum = T.tree_map(lambda a, x: a + x, aux_sum, aux)
        inv = 1.0 / grad_accum
        aux_mean = (T.tree_map(lambda a: a * inv, aux_sum)
                    if has_aux else None)
        return loss_sum * inv, aux_mean, T.tree_map(lambda g: g * inv, acc)

    def train_step(params, opt_state, batch):
        with exact_f32():
            loss, aux, grads = grads_of(params, batch)
            with torch.no_grad():
                params, opt_state, metrics = O.apply_updates(
                    params, grads, opt_state, opt_cfg)
        metrics = dict(metrics, loss=loss)
        if has_aux:
            metrics["aux"] = aux
        return params, opt_state, metrics

    return train_step


__all__ = ["make_train_step", "value_and_grad"]
