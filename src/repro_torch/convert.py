"""Hand parameters from the JAX package to the port, and back.

`qnet_from_reference` takes the JAX package's in-memory `QNet` (its spec
dataclasses, numpy arrays and floats) and rebuilds it with the port's own
dataclasses, so both sides compute from identical parameters. It reads the
object by attribute only and imports nothing of the JAX package.

`params_from_reference` carries a float parameter tree (the JAX package's
`{op: {"w", "b"[, "bn": {...}]}}`, as arrays) onto a device as the port's
tensors, with the same names and layouts; `params_to_reference` is the way
back (numpy arrays). It also carries the gradient-compression residuals
(`train/grad_compress.init_error`'s tree). `opt_state_from_reference`
carries an AdamW state: the step, and `m` and `v` mirroring the
parameters (8-bit state: `{"q", "scale"[, "zero"]}` dicts in a trained
leaf's place; a frozen leaf's float32 scalar). `observers_from_reference`
rebuilds calibration observers (`ActObserver`s) the same way.

`lm_from_reference` carries LM tensors across: a quantized linear (the
`{"w_q", "scale"}` dict `init_linear` builds, or the `(w_q, scale)` tuple
of `quantize_weight_for_matmul`) or a KV cache (`{"k", "v"[, "k_scale",
"v_scale"]}`), as arrays, onto a device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import graph as G
from repro_torch.core.calibrate import ActObserver
from repro_torch.core.cu import resolve_device
from repro_torch.core.qnet import QNet, QOp
from repro_torch.train.optimizer import AdamWState


def _op_spec(op) -> G.OpSpec:
    return G.OpSpec(**{f.name: getattr(op, f.name)
                       for f in dataclasses.fields(G.OpSpec)})


def _block_spec(b) -> G.BlockSpec:
    se = None
    if b.se is not None:
        se = G.SESpec(channels=b.se.channels, reduced=b.se.reduced,
                      bits=b.se.bits, prefix=b.se.prefix)
    return G.BlockSpec(name=b.name, ops=tuple(_op_spec(op) for op in b.ops),
                       residual=b.residual, se=se, se_after=b.se_after,
                       avgpool=b.avgpool)


def netspec_from_reference(net) -> G.NetSpec:
    return G.NetSpec(name=net.name,
                     blocks=tuple(_block_spec(b) for b in net.blocks),
                     input_hw=net.input_hw, input_ch=net.input_ch,
                     num_classes=net.num_classes)


def qnet_from_reference(ref_qnet) -> QNet:
    """The port's `QNet` holding the same spec, arrays and floats."""
    spec = netspec_from_reference(ref_qnet.spec)
    specs = {op.name: op for _, op in spec.all_ops()}
    ops = {}
    for name, q in ref_qnet.ops.items():
        ops[name] = QOp(
            spec=specs[name],
            **{f: np.asarray(getattr(q, f)) for f in (
                "w_q", "w_scale", "wsum", "bias_q", "mult", "mantissa",
                "shift")},
            **{f: float(getattr(q, f)) for f in (
                "in_scale", "in_zp", "out_scale", "out_zp")},
            clip=bool(q.clip),
        )
    res_q = {k: (float(s), float(z)) for k, (s, z) in ref_qnet.res_q.items()}
    return QNet(spec, ops, res_q)


def _tensor(a, device: torch.device) -> torch.Tensor:
    """An array (numpy, or anything `np.asarray` takes) as a tensor with the
    same values and type. numpy has no bfloat16 of its own: JAX's bf16
    arrays come out as `ml_dtypes.bfloat16`, which `torch.from_numpy`
    refuses, so they go through float32 (exact) and back to bfloat16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def params_from_reference(tree, device=None):
    """A nested dict of arrays (any depth: op -> {"w", "b", "bn" -> {...}})
    as the same dict of tensors on `device` (CUDA unless named)."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return _tensor(t, dev)

    return conv(tree)


def params_to_reference(tree):
    """The port's tree of tensors as the same dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_reference(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def opt_state_from_reference(state, device=None) -> AdamWState:
    """The JAX package's `AdamWState` (its fields read by name) as the
    port's, on `device` (CUDA unless named)."""
    dev = resolve_device(device)
    return AdamWState(step=_tensor(state.step, dev),
                      m=params_from_reference(state.m, dev),
                      v=params_from_reference(state.v, dev))


def observers_from_reference(observers, device=None):
    """{name: ActObserver} of the JAX package (arrays in `min_val`,
    `max_val`, a `momentum`) as the port's observers on `device`."""
    dev = resolve_device(device)
    return {k: ActObserver(_tensor(o.min_val, dev), _tensor(o.max_val, dev),
                           o.momentum) for k, o in observers.items()}


_LINEAR_KEYS = {"w_q", "scale"}
_KV_KEYS = {"k", "v", "k_scale", "v_scale"}


def lm_from_reference(src, device=None):
    """The port's tensors for a quantized linear or a KV cache of the JAX
    LM, on `device` (CUDA unless the caller names another):

      * `{"w_q", "scale"}` -> the same dict of tensors;
      * `(w_q, scale)` -> the same tuple of tensors;
      * `{"k", "v"[, "k_scale", "v_scale"]}` -> the same dict of tensors.
    """
    dev = resolve_device(device)
    if isinstance(src, tuple) and len(src) == 2:
        return tuple(_tensor(a, dev) for a in src)
    if isinstance(src, dict):
        keys = set(src)
        if keys == _LINEAR_KEYS or keys in ({"k", "v"}, _KV_KEYS):
            return {k: _tensor(a, dev) for k, a in src.items()}
    raise ValueError("expected {'w_q', 'scale'}, (w_q, scale) or "
                     "{'k', 'v'[, 'k_scale', 'v_scale']}, got "
                     f"{sorted(src) if isinstance(src, dict) else type(src)}")


__all__ = ["qnet_from_reference", "netspec_from_reference",
           "params_from_reference", "params_to_reference",
           "opt_state_from_reference",
           "observers_from_reference", "lm_from_reference"]
