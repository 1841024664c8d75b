"""Hand a QNet from the JAX package to the port, field by field.

`qnet_from_reference` takes the JAX package's in-memory `QNet` (its spec
dataclasses, numpy arrays and floats) and rebuilds it with the port's own
dataclasses, so both sides compute from identical parameters. It reads the
object by attribute only and imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import graph as G
from repro_torch.core.qnet import QNet, QOp


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


__all__ = ["qnet_from_reference", "netspec_from_reference"]
