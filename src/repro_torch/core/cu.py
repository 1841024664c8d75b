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
"""
from __future__ import annotations

import dataclasses
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

    @property
    def qmax(self) -> int:
        return 2**self.spec.act_bits - 1


@dataclasses.dataclass(frozen=True)
class PreparedQNet:
    """A QNet lowered for serving on one device, with the integer skip-add
    constants of every residual block (`res_fixed`, fixed-point mode)."""

    qnet: QNet
    ops: Dict[str, PreparedQOp]
    device: torch.device
    input_scale: torch.Tensor  # 0-dim f32: the network input quantizer scale
    res_fixed: Dict[str, Tuple[int, int, int, int, int]]

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
    )


def prepare_qnet(qnet: Union[QNet, PreparedQNet], input_bits: int = 8,
                 device=None) -> PreparedQNet:
    """Lower a QNet to its device-resident serving form (one-time cost).

    Walks the graph to bound each op's input activations (the f32
    exactness gate) and uploads every constant once. An already-prepared
    net is returned as it is when it lives on `device`."""
    dev = resolve_device(device)
    if isinstance(qnet, PreparedQNet):
        if qnet.device != dev:
            raise ValueError(
                f"net prepared for {qnet.device}, asked for {dev}")
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
    return PreparedQNet(
        qnet=qnet, ops=ops, device=dev,
        input_scale=torch.tensor(first.in_scale, dtype=torch.float32,
                                 device=dev),
        res_fixed=res_fixed)


def _accumulate(x_q: torch.Tensor, pop: PreparedQOp) -> torch.Tensor:
    """Int32 accumulator for one op (exact; see core/integer_ops)."""
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


def run_qop(x_q: torch.Tensor, pop: PreparedQOp,
            fixed_point: bool = False) -> torch.Tensor:
    """One op: accumulate, then the requant epilogue (the f32 multiplier,
    or the integer mantissa/shift with `fixed_point`). The hard-sigmoid gate
    is float in both modes, as in the reference."""
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
            run_pw=None, fixed_point: bool = False) -> torch.Tensor:
    """Squeeze-excitation on the dw output: pool, PW-squeeze (through
    `run_pw` when given), hsigmoid excite, gate. The gated tensor keeps the
    dw quantizer (z == 0, ReLU6 fused)."""
    sq, ex = pq.ops[block.se.squeeze.name], pq.ops[block.se.excite.name]
    pooled = mean_round(y)
    s = (run_pw(pooled, sq) if run_pw is not None
         else run_qop(pooled, sq, fixed_point))
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
    """Execute one block (one CU invocation) in integer math."""
    y = x_q
    cur_s, cur_z = in_s, in_z
    for op in block.ops:
        pop = pq.ops[op.name]
        y = run_qop(y, pop, fixed_point)
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


def run_qnet(qnet: Union[QNet, PreparedQNet], x, input_bits: int = 8,
             device=None, fixed_point: bool = False) -> torch.Tensor:
    """Full integer inference. Returns float32 logits on the net's device.

    A `QNet` is prepared on `device` first (CUDA unless the caller passes
    another); a `PreparedQNet` runs where it was prepared. `fixed_point`
    selects the integer mantissa/shift requant."""
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
    "prepare_qnet",
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
