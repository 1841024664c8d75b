"""QNet — the front end's output artifact (Fig. 1, Fig. 4).

Counterpart of `repro/core/qnet.py`: the dataclasses that hold a quantized
network (`QOp`, `QNet`), `quantize_net` (float params + calibration
observers -> integer weights, per-channel multipliers, folded constants and
ReLU6-fused activation quantizers), and the `.qnet` writer and reader. The
file format is an 8-byte little-endian header length, then the JSON header
(per-op quantizers, residual quantizers, build record, provenance), then an
npz payload with every op's integer weights and folded constants; the JAX
package's `load_qnet` reads what `save_qnet` writes, and the other way
round.

`quantize_net` computes as the reference does: the weight quantizer and the
activation qparams in float32 (its `jnp` ops on float32 arrays), the
multipliers and biases in float64 numpy.
"""
from __future__ import annotations

import dataclasses
import io
import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import graph as G
from repro_torch.core.calibrate import ActObserver, relu6_fused_qparams
from repro_torch.core.integer_ops import quantize_multiplier
from repro_torch.core.quant import (
    QuantConfig,
    compute_scale_zp,
    observe_range,
    packed_nbytes,
    quantize,
)


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

    def model_bytes(self) -> int:
        """Packed model size in bytes (weights at their BW + int32 bias)."""
        return sum(packed_nbytes(q.w_q.shape, q.spec.bits) + q.bias_q.size * 4
                   for q in self.ops.values())


def _host_array(x) -> np.ndarray:
    """A tensor (any device) or array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _weight_qparams(w: np.ndarray, op: G.OpSpec
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-channel weight quantizer at the op's BW, in
    float32 (the reference runs it in `jnp` on float32 arrays)."""
    cfg = QuantConfig(op.bits, symmetric=True, channel_axis=-1)
    w32 = torch.from_numpy(np.asarray(w, np.float32))
    mn, mx = observe_range(w32, cfg)
    scale, zp = compute_scale_zp(mn, mx, cfg)
    q = quantize(w32, scale, zp, cfg)
    return q.numpy().astype(np.int8), scale.numpy()


def _act_qparams(op: G.OpSpec, observer: Optional[ActObserver]
                 ) -> Tuple[float, float]:
    """Output activation quantizer: ReLU6-fused for relu6 ops (h^pq), the
    exact [0, 1] range for the hsigmoid gate, calibration-derived
    asymmetric for linear outputs."""
    acfg = QuantConfig(op.act_bits, symmetric=False, channel_axis=None)
    if op.act == G.RELU6:
        s, z = relu6_fused_qparams(acfg)
        return float(s), float(z)
    if op.act == G.HSIGMOID:
        return 1.0 / acfg.qmax, 0.0  # gate output range is exactly [0, 1]
    if observer is None:
        raise ValueError(f"calibration observer required for linear op {op.name}")
    return _observer_qparams(observer, acfg)


def _observer_qparams(obs: ActObserver, acfg: QuantConfig
                      ) -> Tuple[float, float]:
    """An observer's asymmetric qparams, computed on the host."""
    s, z = compute_scale_zp(obs.min_val.detach().cpu(),
                            obs.max_val.detach().cpu(), acfg)
    return float(s), float(z)


def quantize_net(
    params,
    net: G.NetSpec,
    observers: Dict[str, ActObserver],
    input_range: Tuple[float, float] = (-1.0, 1.0),
    input_bits: int = 8,
) -> QNet:
    """Post-training model quantization: float params (a tree of tensors
    or arrays keyed by op name, BN already fused) + calibration observers
    -> QNet. Runs on the host whatever device the params live on."""
    qops: Dict[str, QOp] = {}
    res_q: Dict[str, Tuple[float, float]] = {}
    in_cfg = QuantConfig(input_bits, symmetric=False, channel_axis=None)
    in_scale, in_zp = compute_scale_zp(
        torch.tensor(input_range[0], dtype=torch.float32),
        torch.tensor(input_range[1], dtype=torch.float32), in_cfg)
    cur_scale, cur_zp = float(in_scale), float(in_zp)

    for block in net.blocks:
        for op in block.ops:
            cur_scale, cur_zp = _quantize_op(
                qops, params, op, cur_scale, cur_zp, observers)
            if block.se is not None and block.se_after == op.name:
                # SE branch: squeeze reads the dw output quantizer; excite
                # reads squeeze's; the hsigmoid gate output is [0, 1] and
                # the gated tensor keeps the dw quantizer
                s1, z1 = _quantize_op(
                    qops, params, block.se.squeeze, cur_scale, cur_zp,
                    observers)
                _quantize_op(qops, params, block.se.excite, s1, z1, observers)
        if block.residual:
            obs = observers.get(block.name + "/residual")
            if obs is None:
                raise ValueError(
                    f"residual block {block.name} needs a '/residual' observer")
            acfg = QuantConfig(block.ops[-1].act_bits, symmetric=False,
                               channel_axis=None)
            s, z = _observer_qparams(obs, acfg)
            res_q[block.name] = (s, z)
            cur_scale, cur_zp = s, z
    return QNet(net, qops, res_q)


def _quantize_op(qops, params, op: G.OpSpec, in_scale, in_zp, observers):
    w = np.asarray(_host_array(params[op.name]["w"]), np.float64)
    b = np.asarray(_host_array(params[op.name]["b"]), np.float64)
    w_q, w_scale = _weight_qparams(w, op)
    out_scale, out_zp = _act_qparams(op, observers.get(op.name))
    red_axes = tuple(range(w_q.ndim - 1))
    wsum = w_q.astype(np.int64).sum(axis=red_axes).astype(np.int32)
    # the output zero point folds into the bias (one rounding fewer)
    bias_q = np.round(b / out_scale - out_zp).astype(np.int32)
    mult = np.asarray(in_scale * w_scale.astype(np.float64) / out_scale)
    mantissa, shift = quantize_multiplier(mult)
    qops[op.name] = QOp(
        spec=op, w_q=w_q, w_scale=w_scale, wsum=wsum, bias_q=bias_q,
        in_scale=float(in_scale), in_zp=float(in_zp),
        out_scale=float(out_scale), out_zp=float(out_zp),
        mult=mult, mantissa=mantissa, shift=shift,
        clip=op.act in (G.RELU6, G.HSIGMOID))
    return float(out_scale), float(out_zp)


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


def save_qnet(qnet: QNet, path: str, build: Optional[Dict] = None,
              provenance: Optional[Dict] = None) -> None:
    """Write the deployment artifact. `build` (model family + builder
    kwargs, see `build_netspec`) makes it loadable with `load_qnet(path)`
    alone; `provenance` is free-form training metadata carried verbatim."""
    arrays = {}
    meta = {"net": qnet.spec.name, "ops": {}}
    if build is not None:
        meta["build"] = dict(build)
    if provenance is not None:
        meta["provenance"] = dict(provenance)
    for name, q in qnet.ops.items():
        key = name.replace("/", "__")
        arrays[f"{key}.w_q"] = q.w_q
        arrays[f"{key}.w_scale"] = np.asarray(q.w_scale)
        arrays[f"{key}.wsum"] = q.wsum
        arrays[f"{key}.bias_q"] = q.bias_q
        arrays[f"{key}.mult"] = np.asarray(q.mult)
        arrays[f"{key}.mantissa"] = q.mantissa
        arrays[f"{key}.shift"] = q.shift
        meta["ops"][name] = {
            "in_scale": q.in_scale,
            "in_zp": q.in_zp,
            "out_scale": q.out_scale,
            "out_zp": q.out_zp,
            "clip": q.clip,
            "bits": q.spec.bits,
        }
    meta["res_q"] = qnet.res_q
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    header = json.dumps(meta)
    with open(path, "wb") as f:
        f.write(len(header).to_bytes(8, "little"))
        f.write(header.encode())
        f.write(buf.getvalue())


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


__all__ = ["QOp", "QNet", "quantize_net", "save_qnet", "load_qnet",
           "build_netspec", "read_qnet_meta"]
