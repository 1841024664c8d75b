"""QNet — the deployment artifact, read with numpy alone.

Counterpart of `repro/core/qnet.py` for serving: the dataclasses that hold a
quantized network (`QOp`, `QNet`) and the `.qnet` reader. The file format is
an 8-byte little-endian header length, then the JSON header (per-op
quantizers, residual quantizers, build record, provenance), then an npz
payload with every op's integer weights and folded constants.

Quantization itself (`quantize_net`) and the writer stay in the JAX package:
the port serves artifacts, it does not produce them yet.
"""
from __future__ import annotations

import dataclasses
import io
import json
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core import graph as G


@dataclasses.dataclass
class QOp:
    """One quantized operator + all folded metadata (per-channel)."""

    spec: G.OpSpec
    w_q: np.ndarray  # int8, original weight shape
    w_scale: np.ndarray  # [M]
    wsum: np.ndarray  # [M] int32 — sum of w_q over reduction axes
    bias_q: np.ndarray  # [M] int32 — round(b / S_y - z_y)
    in_scale: float
    in_zp: float
    out_scale: float
    out_zp: float
    mult: np.ndarray  # [M] float — S_x * S_w / S_y
    mantissa: np.ndarray  # [M] int64 fixed-point mantissa
    shift: np.ndarray  # [M] int32 fixed-point shift
    clip: bool  # True when ReLU6 is fused (clip == activation)

    @property
    def qmax(self) -> int:
        return 2**self.spec.act_bits - 1


@dataclasses.dataclass
class QNet:
    spec: G.NetSpec
    ops: Dict[str, QOp]
    # per residual block: (out_scale, out_zp) of the post-add tensor
    res_q: Dict[str, Tuple[float, float]] = dataclasses.field(default_factory=dict)


def build_netspec(build: Dict) -> G.NetSpec:
    """Rebuild a NetSpec from a `.qnet` build record.

    The record names the model family plus its construction knobs; `act_bits`
    (when it differs from `bits`) and `op_act_bits` (a per-op allocation)
    are applied on top, as in the JAX package."""
    kind = build.get("model")
    kw = {k: v for k, v in build.items()
          if k not in ("model", "act_bits", "op_act_bits")}
    if kind == "mobilenet_v2":
        from repro_torch.models import mobilenet_v2 as mnv2
        net = mnv2.build(**kw)
    elif kind == "efficientnet_compact":
        from repro_torch.models import efficientnet as effn
        net = effn.build_compact(**kw)
    elif kind == "dscnn_kws":
        from repro_torch.models import dscnn1d
        net = dscnn1d.build_kws(**kw)
    elif kind == "dscnn_har":
        from repro_torch.models import dscnn1d
        net = dscnn1d.build_har(**kw)
    else:
        raise ValueError(f"model family not supported by the port: {kind!r}")
    act_bits = build.get("act_bits")
    if act_bits is not None and act_bits != build.get("bits"):
        net = G.with_act_bits(net, act_bits)
    alloc = build.get("op_act_bits")
    if alloc:
        net = G.with_op_act_bits(net, {str(k): int(v)
                                       for k, v in alloc.items()})
    return net


def read_qnet_meta(path: str) -> Dict:
    """The artifact's JSON header without the weight payload."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        return json.loads(f.read(n).decode())


def load_qnet(path: str, net: Optional[G.NetSpec] = None) -> QNet:
    """Load a serialized QNet. `net=None` rebuilds the NetSpec from the
    artifact's own build record; record-less fixtures pass it explicitly."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        meta = json.loads(f.read(n).decode())
        arrays = np.load(io.BytesIO(f.read()))
    if net is None:
        if "build" not in meta:
            raise ValueError(
                f"{path} carries no build record; pass the NetSpec explicitly")
        net = build_netspec(meta["build"])
    specs = {op.name: op for _, op in net.all_ops()}
    qops = {}
    for name, m in meta["ops"].items():
        key = name.replace("/", "__")
        qops[name] = QOp(
            spec=specs[name],
            w_q=arrays[f"{key}.w_q"],
            w_scale=arrays[f"{key}.w_scale"],
            wsum=arrays[f"{key}.wsum"],
            bias_q=arrays[f"{key}.bias_q"],
            in_scale=m["in_scale"],
            in_zp=m["in_zp"],
            out_scale=m["out_scale"],
            out_zp=m["out_zp"],
            mult=arrays[f"{key}.mult"],
            mantissa=arrays[f"{key}.mantissa"],
            shift=arrays[f"{key}.shift"],
            clip=m["clip"],
        )
    res_q = {k: tuple(v) for k, v in meta.get("res_q", {}).items()}
    return QNet(net, qops, res_q)


__all__ = ["QOp", "QNet", "build_netspec", "read_qnet_meta", "load_qnet"]
