"""Shared parts of the port's LM training tests
(`tests/test_torch_lm_train_*.py`): the JAX package's and the port's
loss, gradients and train steps on the same weights (JAX's own
`init_params` draws, carried across by `convert.params_from_reference`)
and the same numpy-seeded batches.

The JAX programs are compiled once each (`jax_compiled`) with
`xla_allow_excess_precision` off (`tests/torch_lm_parity.py`) and with
XLA's algebraic simplifier off (ROADMAP F7: inside a jit it turns each
division by a constant into a multiplication by the reciprocal, which
eager JAX and the port do not).

Tolerances (each measured first; the measured values are in CHANGES.md):

  * f32: loss rtol 1e-5; each gradient leaf within 1e-4 in relative L2
    distance; one train step under `train/parity.py`'s `LM_*` bounds;
  * bf16 (llama3.2-1b): loss rtol BF16_LOSS_RTOL, each gradient leaf
    within BF16_GRAD_L2 in relative L2;
  * `_remat` "full" and "dots" against "none": bitwise.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.lm import model as JM
from repro_torch.convert import params_from_reference
from repro_torch.models.lm import model as TM
from repro_torch.train import tree as PT
from repro_torch.train.parity import _as_tensor, _leaf_names, _rel_l2
from repro_torch.train.train_loop import value_and_grad
from tests.torch_lm_parity import (
    COMPILER_OPTIONS,
    configs,
    inputs,
    jax_compiled,
)

TRAIN_OPTIONS = {**COMPILER_OPTIONS, "xla_disable_hlo_passes": "algsimp"}
F32_LOSS_RTOL, F32_GRAD_L2 = 1e-5, 1e-4
BF16_LOSS_RTOL, BF16_GRAD_L2 = 1e-4, 2e-2


def batch_np(cfg, seed: int = 0):
    tokens, extra = inputs(cfg, seed)
    return {"tokens": tokens, **extra}


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def torch_batch(b, device="cpu"):
    return {k: torch.from_numpy(v).to(device).long() if k == "tokens"
            else torch.from_numpy(v).to(device) for k, v in b.items()}


def to_numpy_tree(tree):
    """A JAX tree as the same nested dicts of numpy arrays."""
    return jax.tree.map(np.asarray, tree)


def jax_params(jcfg, seed: int = 0):
    params, _ = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return params


def port_grads(tcfg, params, batch):
    loss, _, grads = value_and_grad(
        lambda p, b: TM.loss_fn(p, tcfg, b), params, batch)
    return loss, grads


def loss_grad_case(arch: str, dtype: str):
    """The JAX loss and gradients against the port's on one arch's reduced
    config; the port's `_remat` "full" and "dots" against "none".
    Returns (loss rel err, worst leaf rel L2 err, its name, remat equal)."""
    jcfg, tcfg = configs(arch, dtype)
    params = jax_params(jcfg)
    b = batch_np(jcfg)
    _, (loss, grads) = jax_compiled(
        jax.value_and_grad(lambda p, bb: JM.loss_fn(p, jcfg, bb)),
        params, jax_batch(b), options=TRAIN_OPTIONS)
    tparams = params_from_reference(to_numpy_tree(params), device="cpu")
    tb = torch_batch(b)
    tloss, tgrads = port_grads(tcfg, tparams, tb)
    loss_err = abs(float(tloss) - float(loss)) / abs(float(loss))
    worst, where = 0.0, ""
    for name, a, g in zip(_leaf_names(tparams), jax.tree.leaves(grads),
                          PT.leaves(tgrads)):
        e = _rel_l2(_as_tensor(a, "cpu"), _as_tensor(g, "cpu"))
        if e > worst:
            worst, where = e, name
    remat_equal = True
    for mode in ("full", "dots"):
        rl, rg = port_grads(dataclasses.replace(tcfg, remat=mode), tparams,
                            tb)
        remat_equal &= torch.equal(rl, tloss) and all(
            torch.equal(x, y) for x, y in zip(PT.leaves(rg),
                                              PT.leaves(tgrads)))
    return loss_err, worst, where, remat_equal


def check_loss_and_grads(arch: str, dtype: str = "float32"):
    loss_err, grad_err, where, remat_equal = loss_grad_case(arch, dtype)
    f32 = dtype == "float32"
    loss_tol = F32_LOSS_RTOL if f32 else BF16_LOSS_RTOL
    grad_tol = F32_GRAD_L2 if f32 else BF16_GRAD_L2
    assert loss_err <= loss_tol, (arch, dtype, loss_err)
    assert grad_err <= grad_tol, (arch, dtype, where, grad_err)
    assert remat_equal, (arch, dtype, "remat changed the numbers")
    return loss_err, grad_err, where
