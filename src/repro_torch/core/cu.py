"""Heterogeneous Compute Unit runners — integer QNet execution (Sec. 4).

Counterpart of `repro/core/cu.py`: the port's reference interpreter. Every
op is plain PyTorch (`core/integer_ops`); the hand-written kernels are
reached through `kernels/ops.py` and the stage compiler, and are held
against this module.

`prepare_qnet(qnet, device=)` lowers a `QNet` to a `PreparedQNet` whose
constants (weights in their accumulation and kernel layouts, multipliers,
integer zero-point corrections, biases, the input scale) live on the device
once, so a CU invocation copies only its input batch to the card. Entry
points run on CUDA unless the caller passes `device="cpu"`; without a card
and without that, they raise.

Two requant modes, as in the reference: the f32 multiplier (default) and
`fixed_point=True`, the FPGA's integer mantissa/shift requant, where the
residual skip-add is integer too (`res_fixed`). The hard-sigmoid gate stays
float in both. Activations are NHWC for the 2-D nets and NTC for the 1-D
(CONV1D/DW1D) ones; pooling and the SE gate reduce over whichever spatial
axes the tensor has.

Routes (`prepare_qnet(tuned=, routes=)`, `PreparedQNet.routes`): a measured
route selection from a `repro_torch.tune.TunedPlan` makes each routed op run
one of its alternate formulations of the same int32 accumulator — `int_ref`
(float64 torch ops), `int_f32` (float32, under the 2^24 bound), `dw_shifts`,
or the kernels K2 (`pallas_pw`) and K3 (`pallas_dw`) — so a route can move
the wall clock, never a bit. Routes are float-requant only: `fixed_point`
ignores them, and the hard-sigmoid gate never takes one.

Replicas (`prepare_qnet(mesh=)`, `replicate_prepared`): on a mesh of
several devices (`repro_torch.dist.sharding.data_mesh`) each replica gets
its own `PreparedQNet` on its own device, constants, routes and exactness
flags copied from one preparation: a `ReplicatedQNet`, the multi-replica
analogue of DeepDive's per-CU weight buffers. A mesh of one device is that
device.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import graph as G
from repro_torch.core.integer_ops import (
    f32_accum_exact,
    int_conv1d,
    int_conv1d_f32,
    int_conv2d,
    int_conv2d_f32,
    int_depthwise1d_shifts,
    int_depthwise_shifts,
    int_pointwise,
    int_residual_add,
    quantized_op_epilogue,
    residual_fixed_consts,
)
from repro_torch.core.qnet import QNet, QOp


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and absent —
    there is no silent fall back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def quantize_input(x: torch.Tensor, scale: torch.Tensor, zp: float,
                   bits: int = 8) -> torch.Tensor:
    """round(x / scale - zp), clipped to [0, 2^bits - 1]. `scale` is a 0-dim
    float32 tensor on x's device: PyTorch's CUDA division by a host scalar
    multiplies by its reciprocal, which can round differently from the
    reference's true division."""
    q = torch.round(x / scale - zp)
    return torch.clamp(q, 0, 2**bits - 1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class PreparedQOp:
    """One QOp with every constant its runners need already on the device."""

    spec: G.OpSpec
    w_acc: torch.Tensor  # torch-op weights: conv HWIO f64; dw [K,K,C] i32;
    #                      dw1d [K,C] i32; conv1d [K,Cin,Cout] and pw/dense
    #                      [Cin,Cout] f32 (when exact) or f64
    w_kern: Optional[torch.Tensor]  # int8 kernel layout: dw [K,K,C];
    #                                 dw1d [K,C]; pw/dense [Cin,Cout];
    #                                 None for conv and conv1d
    w_scale: torch.Tensor  # [M] f32
    wsum: torch.Tensor  # [M] i32
    bias_q: torch.Tensor  # [M] i32
    mult: torch.Tensor  # [M] f32
    zpc: torch.Tensor  # [M] i32 — int32(in_zp) * wsum
    mantissa: torch.Tensor  # [M] i64 — fixed-point mantissa
    shift: torch.Tensor  # [M] i32 — fixed-point shift
    in_scale: float
    in_zp: float
    out_scale: float
    out_zp: float
    f32_exact: bool = False  # f32 accumulation provably exact for this op
    # w_acc in the other float type (float64, or float32 for the stem
    # conv), kept where an attached route accumulates in it
    w_alt: Optional[torch.Tensor] = None

    @property
    def qmax(self) -> int:
        return 2**self.spec.act_bits - 1


Routes = Dict[str, Tuple[str, Dict[str, int]]]


@dataclasses.dataclass(frozen=True)
class PreparedQNet:
    """A QNet lowered for serving on one device, with the integer skip-add
    constants of every residual block (`res_fixed`, fixed-point mode) and
    the attached route selection (`routes`: op name -> (route, params);
    ops absent from it take the default formulation, so a partial or empty
    map is always safe)."""

    qnet: QNet
    ops: Dict[str, PreparedQOp]
    device: torch.device
    input_scale: torch.Tensor  # 0-dim f32: the network input quantizer scale
    res_fixed: Dict[str, Tuple[int, int, int, int, int]]
    routes: Routes = dataclasses.field(default_factory=dict)

    @property
    def spec(self) -> G.NetSpec:
        return self.qnet.spec

    @property
    def res_q(self) -> Dict[str, Tuple[float, float]]:
        return self.qnet.res_q


def _prepare_qop(qop: QOp, in_qmax: int, device: torch.device) -> PreparedQOp:
    kind = qop.spec.kind
    w_np = np.asarray(qop.w_q)
    f32_exact = f32_accum_exact(w_np, in_qmax)
    if kind == G.DW:
        w_kern = w_np.reshape(w_np.shape[0], w_np.shape[1], w_np.shape[-1])
        w_acc = w_kern.astype(np.int32)
    elif kind == G.DW1D:
        w_kern = w_np.reshape(w_np.shape[0], w_np.shape[-1])
        w_acc = w_kern.astype(np.int32)
    elif kind in (G.PW, G.DENSE):
        w_kern = w_np[0, 0] if w_np.ndim == 4 else w_np
        w_acc = w_kern.astype(np.float32 if f32_exact else np.float64)
    elif kind == G.CONV1D:
        w_kern = None
        w_acc = w_np.astype(np.float32 if f32_exact else np.float64)
    elif kind == G.CONV:
        w_kern, w_acc = None, w_np.astype(np.float64)
    else:
        raise ValueError(f"op kind {kind!r} is not supported by the port")

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    return PreparedQOp(
        spec=qop.spec,
        w_acc=torch.as_tensor(w_acc, device=device),
        w_kern=None if w_kern is None else put(w_kern, np.int8),
        w_scale=put(qop.w_scale, np.float32),
        wsum=put(qop.wsum, np.int32),
        bias_q=put(qop.bias_q, np.int32),
        mult=put(qop.mult, np.float32),
        zpc=put(np.int32(qop.in_zp) * np.asarray(qop.wsum, np.int32),
                np.int32),
        mantissa=put(qop.mantissa, np.int64),
        shift=put(qop.shift, np.int32),
        in_scale=float(qop.in_scale),
        in_zp=float(qop.in_zp),
        out_scale=float(qop.out_scale),
        out_zp=float(qop.out_zp),
        f32_exact=f32_exact,
    )


# the routes each op kind can take (the JAX package's `_accumulate` and
# `_run_qop` dispatch)
OP_ROUTES = {
    G.CONV: ("int_ref", "int_f32"),
    G.CONV1D: ("int_ref", "int_f32"),
    G.DW: ("int_ref", "dw_shifts", "pallas_dw"),
    G.DW1D: ("int_ref", "dw_shifts"),
    G.PW: ("int_ref", "int_f32", "pallas_pw"),
    G.DENSE: ("int_ref", "int_f32", "pallas_pw"),
}


def _kernel_params(route: str, params: Dict[str, int]) -> Dict[str, int]:
    """The params of `route` that the port's kernel takes. K2 takes the
    tile sizes of `pointwise_conv.BLOCKS_*` and drops others (the JAX
    package's caches carry Pallas tiles such as block_m=256); K3 has one
    layout and drops every param (the Pallas `block_h`). Any tile gives the
    same bits, so dropping one moves no result."""
    if route != "pallas_pw":
        return {}
    from repro_torch.kernels.pointwise_conv import (
        BLOCKS_K, BLOCKS_M, BLOCKS_N)

    legal = {"block_m": BLOCKS_M, "block_n": BLOCKS_N, "block_k": BLOCKS_K}
    return {k: int(v) for k, v in params.items() if v in legal.get(k, ())}


def _validate_routes(op_routes, ops: Dict[str, PreparedQOp]) -> Routes:
    """Attach-time validation of resolved routes against the actual
    prepared constants, so that serving never raises on a cache: unknown
    op names, hard-sigmoid gates and routes the op's kind cannot take are
    dropped; an `int_f32` route whose op fails the 2^24 exactness bound
    here (other weights than the tuned net's) is dropped rather than run
    inexactly; kernel params the port's kernel cannot take are dropped
    (`_kernel_params`)."""
    routes: Routes = {}
    for name, (route, params) in op_routes.items():
        pop = ops.get(name)
        if (pop is None or pop.spec.act == G.HSIGMOID
                or route not in OP_ROUTES.get(pop.spec.kind, ())):
            continue
        if route == "int_f32" and not pop.f32_exact:
            continue
        routes[name] = (route, _kernel_params(route, dict(params)))
    return routes


def _route_ready(pop: PreparedQOp, route: str) -> PreparedQOp:
    """`pop` with the weights `route` accumulates in kept on the device
    (`w_alt`), so a routed call converts nothing."""
    dtype = {"int_ref": torch.float64, "int_f32": torch.float32}.get(route)
    if dtype is None or pop.w_acc.dtype == dtype or (
            pop.w_alt is not None and pop.w_alt.dtype == dtype):
        return pop
    return dataclasses.replace(pop, w_alt=pop.w_acc.to(dtype))


def _attach_routes(pq: PreparedQNet, op_routes) -> PreparedQNet:
    routes = _validate_routes(op_routes, pq.ops)
    ops = dict(pq.ops)
    for name, (route, _) in routes.items():
        ops[name] = _route_ready(ops[name], route)
    return dataclasses.replace(pq, ops=ops, routes=routes)


def _resolve_tuned_routes(tuned, pq: PreparedQNet) -> Routes:
    """Project a `TunedPlan` onto a prepared net, for its device's backend
    (op name -> (route, params), not yet validated)."""
    op_routes, _ = tuned.resolve(pq.spec, backend=pq.device.type)
    return op_routes


def prepare_qnet(qnet: Union[QNet, PreparedQNet, ReplicatedQNet],
                 input_bits: int = 8, device=None, tuned=None, routes=None,
                 mesh=None) -> Union[PreparedQNet, ReplicatedQNet]:
    """Lower a QNet to its device-resident serving form (one-time cost).

    Walks the graph to bound each op's input activations (the f32
    exactness gate) and uploads every constant once. An already-prepared
    net is returned as it is when it lives on `device`.

    `tuned` (a `repro_torch.tune.TunedPlan`) attaches its measured route
    selection for this device's backend; callers that resolved a plan
    already (the stage compiler) pass the op-name-keyed `routes` instead.
    Either replaces the routes an already-prepared net carries, and both
    are validated against the prepared constants (`_validate_routes`).

    `mesh` (a `data_mesh`) prepares the net once on the mesh's first device
    (which `device`, if given, must be) and re-places the constants on
    every device of the mesh (`replicate_prepared`): the routes are
    resolved once and attached to every replica. An already-prepared net
    is re-placed the same way."""
    if mesh is not None:
        base = mesh_base(qnet, mesh, device)
        pq = prepare_qnet(base, input_bits, device=mesh.device_list[0],
                          tuned=tuned, routes=routes)
        if (isinstance(qnet, ReplicatedQNet) and pq is base
                and qnet.mesh == mesh):
            return qnet
        return replicate_prepared(pq, mesh)
    if isinstance(qnet, ReplicatedQNet):
        if tuned is None and routes is None:
            return qnet
        return prepare_qnet(qnet, input_bits, device=device, tuned=tuned,
                            routes=routes, mesh=qnet.mesh)
    dev = resolve_device(device)
    if isinstance(qnet, PreparedQNet):
        if qnet.device != dev:
            raise ValueError(
                f"net prepared for {qnet.device}, asked for {dev}")
        if routes is not None:
            return _attach_routes(qnet, routes)
        if tuned is not None:
            return _attach_routes(qnet, _resolve_tuned_routes(tuned, qnet))
        return qnet
    ops: Dict[str, PreparedQOp] = {}
    res_fixed: Dict[str, Tuple[int, int, int, int, int]] = {}
    cur_bits = input_bits
    for block in qnet.spec.blocks:
        for op in block.ops:
            ops[op.name] = _prepare_qop(qnet.ops[op.name], 2**cur_bits - 1,
                                        dev)
            cur_bits = op.act_bits
            if block.se is not None and block.se_after == op.name:
                sq, ex = block.se.squeeze, block.se.excite
                # squeeze reads the (pooled) dw output; excite reads squeeze
                ops[sq.name] = _prepare_qop(
                    qnet.ops[sq.name], 2**cur_bits - 1, dev)
                ops[ex.name] = _prepare_qop(
                    qnet.ops[ex.name], 2**sq.act_bits - 1, dev)
        if block.residual:
            a = qnet.ops[block.ops[0].name]
            b = qnet.ops[block.ops[-1].name]
            res_fixed[block.name] = residual_fixed_consts(
                a.in_scale, a.in_zp, b.out_scale, b.out_zp,
                *qnet.res_q[block.name])
    first = qnet.ops[qnet.spec.blocks[0].ops[0].name]
    pq = PreparedQNet(
        qnet=qnet, ops=ops, device=dev,
        input_scale=torch.tensor(first.in_scale, dtype=torch.float32,
                                 device=dev),
        res_fixed=res_fixed)
    if routes is None and tuned is not None:
        routes = _resolve_tuned_routes(tuned, pq)
    return pq if routes is None else _attach_routes(pq, routes)


@dataclasses.dataclass(frozen=True)
class ReplicatedQNet:
    """One `PreparedQNet` for each device of `mesh` (flat order), each with
    its own copy of the constants and the same routes. Its metadata (spec,
    quantizers, routes, the first device) reads the first replica."""

    mesh: object  # a repro_torch.dist.sharding.Mesh
    replicas: Tuple[PreparedQNet, ...]

    @property
    def qnet(self) -> QNet:
        return self.replicas[0].qnet

    @property
    def spec(self) -> G.NetSpec:
        return self.replicas[0].spec

    @property
    def ops(self) -> Dict[str, PreparedQOp]:
        return self.replicas[0].ops

    @property
    def res_q(self) -> Dict[str, Tuple[float, float]]:
        return self.replicas[0].res_q

    @property
    def routes(self) -> Routes:
        return self.replicas[0].routes

    @property
    def device(self) -> torch.device:
        return self.replicas[0].device


_CONSTANTS = ("w_acc", "w_kern", "w_scale", "wsum", "bias_q", "mult", "zpc",
              "mantissa", "shift", "w_alt")


def _place_prepared(pq: PreparedQNet, dev: torch.device) -> PreparedQNet:
    """`pq` with a copy of every constant on `dev` (its own storage also
    where a constant lies on `dev` already: one buffer a replica)."""
    def put(t):
        return None if t is None else t.to(dev, copy=True)

    ops = {name: dataclasses.replace(
               pop, **{f: put(getattr(pop, f)) for f in _CONSTANTS})
           for name, pop in pq.ops.items()}
    return dataclasses.replace(pq, ops=ops, device=dev,
                               input_scale=put(pq.input_scale))


def mesh_base(qnet, mesh, device=None):
    """What a mesh's replicas are prepared from: the net itself, the first
    replica of a replicated net, a prepared net re-placed on the mesh's
    first device where it lies elsewhere. `device`, if given, must name
    that first device."""
    first = mesh.device_list[0]
    if device is not None and resolve_device(device) != first:
        raise ValueError(f"device={device} and a mesh whose first device "
                         f"is {first} disagree")
    if isinstance(qnet, ReplicatedQNet):
        qnet = qnet.replicas[0]
    if isinstance(qnet, PreparedQNet) and qnet.device != first:
        qnet = _place_prepared(qnet, first)
    return qnet


def replicate_prepared(pq: Union[PreparedQNet, ReplicatedQNet], mesh
                       ) -> Union[PreparedQNet, ReplicatedQNet]:
    """Re-place a prepared net's constants on every device of `mesh`: a
    `ReplicatedQNet` whose replicas carry the routes and exactness flags
    of `pq` (of its first replica, if it is replicated already). On a mesh
    of one device, the net on that device. Replica 0 keeps `pq`'s own
    constants where they lie on its device already."""
    if isinstance(pq, ReplicatedQNet):
        if pq.mesh == mesh:
            return pq
        pq = pq.replicas[0]
    devices = mesh.device_list
    reps = [pq if i == 0 and dev == pq.device else _place_prepared(pq, dev)
            for i, dev in enumerate(devices)]
    if len(reps) == 1:
        return reps[0]
    return ReplicatedQNet(mesh=mesh, replicas=tuple(reps))


def _weight(pop: PreparedQOp, dtype: torch.dtype) -> torch.Tensor:
    """The op's accumulation weights in `dtype` (w_acc's layout)."""
    if pop.w_acc.dtype == dtype:
        return pop.w_acc
    if pop.w_alt is not None and pop.w_alt.dtype == dtype:
        return pop.w_alt
    return pop.w_acc.to(dtype)


def _accumulate_route(x_q: torch.Tensor, pop: PreparedQOp,
                      route: str) -> torch.Tensor:
    """The int32 accumulator through one torch-op route (`OP_ROUTES`)."""
    kind, stride = pop.spec.kind, pop.spec.stride
    if route not in OP_ROUTES.get(kind, ()) or route.startswith("pallas"):
        raise ValueError(f"no route {route!r} for {pop.spec.name} ({kind})")
    if route == "dw_shifts":
        if kind == G.DW1D:
            return int_depthwise1d_shifts(x_q, pop.w_acc, stride=stride)
        return int_depthwise_shifts(x_q, pop.w_acc, stride=stride)
    if route == "int_f32":
        w = _weight(pop, torch.float32)
        if kind == G.CONV:
            return int_conv2d_f32(x_q, w, stride=stride)
        if kind == G.CONV1D:
            return int_conv1d_f32(x_q, w, stride=stride)
        return int_pointwise(x_q, w)
    w = _weight(pop, torch.float64)  # int_ref
    if kind == G.CONV:
        return int_conv2d(x_q, w, stride=stride)
    if kind == G.DW:
        return int_conv2d(x_q, w.unsqueeze(2), stride=stride,
                          groups=pop.spec.in_ch)
    if kind == G.CONV1D:
        return int_conv1d(x_q, w, stride=stride)
    if kind == G.DW1D:
        return int_conv1d(x_q, w.unsqueeze(1), stride=stride,
                          groups=pop.spec.in_ch)
    return int_pointwise(x_q, w)


def _accumulate(x_q: torch.Tensor, pop: PreparedQOp,
                route: Optional[str] = None) -> torch.Tensor:
    """Int32 accumulator for one op (exact; see core/integer_ops): the
    default formulation, or the torch-op `route` named."""
    if route is not None:
        return _accumulate_route(x_q, pop, route)
    kind = pop.spec.kind
    if kind == G.DW:
        return int_depthwise_shifts(x_q, pop.w_acc, stride=pop.spec.stride)
    if kind == G.DW1D:
        return int_depthwise1d_shifts(x_q, pop.w_acc, stride=pop.spec.stride)
    if kind in (G.PW, G.DENSE):
        return int_pointwise(x_q, pop.w_acc)
    if kind == G.CONV1D:
        conv = int_conv1d_f32 if pop.w_acc.dtype == torch.float32 \
            else int_conv1d
        return conv(x_q, pop.w_acc, stride=pop.spec.stride)
    if kind == G.CONV:
        return int_conv2d(x_q, pop.w_acc, stride=pop.spec.stride)
    raise ValueError(kind)


@functools.cache
def _kernel_ops():
    """`kernels/ops.py`, imported at first use (it imports this module)."""
    from repro_torch.kernels import ops
    return ops


def run_qop(x_q: torch.Tensor, pop: PreparedQOp, fixed_point: bool = False,
            route: Optional[Tuple[str, Dict[str, int]]] = None
            ) -> torch.Tensor:
    """One op: accumulate, then the requant epilogue (the f32 multiplier,
    or the integer mantissa/shift with `fixed_point`). The hard-sigmoid gate
    is float in both modes, as in the reference.

    `route` (name, params) runs the op through that route: `pallas_pw` /
    `pallas_dw` through K2 / K3 (`kernels/ops.py`, which run their plain
    versions on a CPU tensor), the others through `_accumulate`. It is
    ignored with `fixed_point` and on the hard-sigmoid gate."""
    if route is not None and pop.spec.act != G.HSIGMOID and not fixed_point:
        name, params = route
        if name == "pallas_dw":
            return _kernel_ops().run_dw_qop(x_q, pop)
        if name == "pallas_pw":
            return _kernel_ops().run_pw_qop(x_q, pop, **params)
        acc = _accumulate(x_q, pop, name)
    else:
        acc = _accumulate(x_q, pop)
    if pop.spec.act == G.HSIGMOID:
        # gate: y = relu6(x + 3)/6 quantized to [0, qmax] with S=1/qmax.
        # dequant the accumulator (S_x*S_w), apply hsigmoid, requantize with
        # ONE constant folded in double, as the reference does.
        y_fp = ((acc.to(torch.float32) + pop.in_zp * pop.wsum.to(torch.float32))
                * (pop.in_scale * pop.w_scale))
        y_fp = y_fp + pop.bias_q.to(torch.float32) * pop.out_scale
        requant = float(np.float32(1.0 / (6.0 * pop.out_scale)))
        gate6 = torch.clamp(y_fp + 3.0, 0.0, 6.0)
        return torch.round(gate6 * requant).to(torch.int32)
    return quantized_op_epilogue(acc, pop.zpc, pop.bias_q, pop.mult, pop.qmax,
                                 fixed_point=fixed_point,
                                 mantissa=pop.mantissa, shift=pop.shift)


def residual_add(a_q, a_s, a_z, b_q, b_s, b_z, y_s, y_z, qmax: int,
                 fixed_consts=None) -> torch.Tensor:
    """Skip-line add: rescale both operands into the output domain in f32,
    round, subtract round(y_z), clip — the reference's operation order.
    With `fixed_consts` (fixed-point mode; `PreparedQNet.res_fixed`) the
    add is the integer `int_residual_add` instead."""
    if fixed_consts is not None:
        return int_residual_add(a_q, b_q, fixed_consts, qmax)
    a = (a_q.to(torch.float32) + a_z) * (a_s / y_s)
    b = (b_q.to(torch.float32) + b_z) * (b_s / y_s)
    return torch.clamp(torch.round(a + b) - round(y_z), 0, qmax).to(torch.int32)


def mean_round(y: torch.Tensor) -> torch.Tensor:
    """round(mean) over the spatial axes (T of NTC, H and W of NHWC), in
    f32: the integer sum is exact in f32 below 2^24, and dividing by a
    tensor keeps true division on the card (`Tensor.mean` multiplies by 1/N
    there)."""
    s = y.to(torch.float32).sum(dim=tuple(range(1, y.ndim - 1)))
    n = math.prod(y.shape[1:-1])
    return torch.round(s / torch.full_like(s, n)).to(torch.int32)


def se_gate(y: torch.Tensor, block: G.BlockSpec, pq: PreparedQNet,
            fixed_point: bool = False) -> torch.Tensor:
    """Squeeze-excitation on the dw output: pool, PW-squeeze (through its
    attached route, if any), hsigmoid excite, gate. The gated tensor keeps
    the dw quantizer (z == 0, ReLU6 fused)."""
    sq, ex = pq.ops[block.se.squeeze.name], pq.ops[block.se.excite.name]
    pooled = mean_round(y)
    s = run_qop(pooled, sq, fixed_point, route=pq.routes.get(sq.spec.name))
    gate_q = run_qop(s, ex)  # [B, C] in [0, qmax], S = 1/qmax
    gate_b = gate_q.reshape(gate_q.shape[0], *([1] * (y.ndim - 2)),
                            gate_q.shape[-1])
    return torch.round(
        y.to(torch.float32) * gate_b.to(torch.float32)
        * ex.out_scale).to(torch.int32)


def run_block(
    x_q: torch.Tensor,
    block: G.BlockSpec,
    pq: PreparedQNet,
    in_s: float,
    in_z: float,
    fixed_point: bool = False,
) -> Tuple[torch.Tensor, float, float]:
    """Execute one block (one CU invocation) in integer math. The net's
    attached `routes` run their ops (the SE squeeze included) through the
    named routes (not in fixed point); every other op takes its default
    formulation."""
    routes = pq.routes if not fixed_point else {}
    y = x_q
    cur_s, cur_z = in_s, in_z
    for op in block.ops:
        pop = pq.ops[op.name]
        y = run_qop(y, pop, fixed_point, route=routes.get(op.name))
        cur_s, cur_z = pop.out_scale, pop.out_zp
        if block.se is not None and block.se_after == op.name:
            y = se_gate(y, block, pq, fixed_point=fixed_point)
    if block.residual:
        y_s, y_z = pq.res_q[block.name]
        qmax = 2 ** block.ops[-1].act_bits - 1
        y = residual_add(
            x_q, in_s, in_z, y, cur_s, cur_z, y_s, y_z, qmax,
            fixed_consts=pq.res_fixed[block.name] if fixed_point else None)
        cur_s, cur_z = y_s, y_z
    if block.avgpool:
        y = mean_round(y)
    return y, cur_s, cur_z


def run_blocks(x_q: torch.Tensor, blocks, pq: PreparedQNet, in_s: float,
               in_z: float, fixed_point: bool = False
               ) -> Tuple[torch.Tensor, float, float]:
    """Execute a contiguous block sequence (e.g. one CU stage's blocks)."""
    y, cur_s, cur_z = x_q, in_s, in_z
    for block in blocks:
        y, cur_s, cur_z = run_block(y, block, pq, cur_s, cur_z, fixed_point)
    return y, cur_s, cur_z


def propagate_qparams(blocks, qnet: Union[QNet, PreparedQNet], in_s: float,
                      in_z: float):
    """(scale, zp) of the tensor leaving `blocks`, from metadata alone."""
    cur_s, cur_z = in_s, in_z
    for block in blocks:
        for op in block.ops:
            qop = qnet.ops[op.name]
            cur_s, cur_z = qop.out_scale, qop.out_zp
        if block.residual:
            cur_s, cur_z = qnet.res_q[block.name]
    return cur_s, cur_z


def input_qparams(qnet: Union[QNet, PreparedQNet]) -> Tuple[float, float]:
    """The network input quantizer (the first op's input activation)."""
    first = qnet.ops[qnet.spec.blocks[0].ops[0].name]
    return first.in_scale, first.in_zp


def dequantize(y: torch.Tensor, s: float, z: float) -> torch.Tensor:
    """Float logits from the integer output: (y + z) * s in f32."""
    return (y.to(torch.float32) + z) * s


def as_input(x, device: torch.device) -> torch.Tensor:
    """A float32 input batch (images or frame windows) on `device`: numpy
    arrays are copied there, a tensor must already lie on it."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.asarray(x, np.float32)).to(device)
    if x.device != device:
        raise ValueError(f"input on {x.device}, net prepared for {device}")
    return x.to(torch.float32)


def run_qnet(qnet: Union[QNet, PreparedQNet, ReplicatedQNet], x,
             input_bits: int = 8, device=None,
             fixed_point: bool = False) -> torch.Tensor:
    """Full integer inference. Returns float32 logits on the net's device.

    A `QNet` is prepared on `device` first (CUDA unless the caller passes
    another); a `PreparedQNet` runs where it was prepared, a
    `ReplicatedQNet` on its first replica. `fixed_point` selects the
    integer mantissa/shift requant."""
    if isinstance(qnet, ReplicatedQNet):
        qnet = qnet.replicas[0]
    pq = qnet if isinstance(qnet, PreparedQNet) else prepare_qnet(
        qnet, input_bits=input_bits, device=device)
    in_s, in_z = input_qparams(pq)
    y = quantize_input(as_input(x, pq.device), pq.input_scale, in_z,
                       input_bits)
    y, cur_s, cur_z = run_blocks(y, pq.spec.blocks, pq, in_s, in_z,
                                 fixed_point)
    return dequantize(y, cur_s, cur_z)


__all__ = [
    "resolve_device",
    "quantize_input",
    "PreparedQOp",
    "PreparedQNet",
    "ReplicatedQNet",
    "OP_ROUTES",
    "prepare_qnet",
    "mesh_base",
    "replicate_prepared",
    "run_qop",
    "residual_add",
    "mean_round",
    "se_gate",
    "run_block",
    "run_blocks",
    "propagate_qparams",
    "input_qparams",
    "dequantize",
    "run_qnet",
]
