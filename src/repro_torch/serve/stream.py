"""Streaming 1-D DSCNN serving: ring-buffer incremental inference.

Counterpart of `repro/serve/stream.py`. The production shape for edge-sensor
DSCNNs (keyword spotting, HAR) is a stream of *overlapping* windows: hop H
over window W, so naive serving recomputes (W - H)/W of every window. Each
session keeps the integer activation buffer of every temporal operator, and
a new window recomputes only the frames that SAME-padding edge effects and
the H new input frames can reach — everything else is served from the
cached buffer of the previous window, bit-exact with `cu.run_qnet` on the
full window.

Halo math (per temporal op: kernel k, stride s, SAME pad (pl, pr), input
length Tin, output length Tout, input hop Hin with s | Hin, Hout = Hin/s).
Let [0, Lin) and [Tin - Rin, Tin) be the input regions whose values differ
from the previous window's buffer shifted by Hin (base case at the raw
input: Lin = 0, Rin = H). Output j of the new window reads input taps
[j*s - pl, j*s - pl + k); it equals cached output j + Hout iff

  * every tap lands at or right of Lin        (j*s - pl >= Lin),
  * no tap lands in [Tin - Rin, Tin)          (j*s - pl + k <= Tin - Rin,
    vacuous when Rin == 0; taps in the right SAME padding are zero in both
    windows, so they never invalidate),
  * the cached output exists                  (j < Tout - Hout).

Hence Lout = ceil((Lin + pl) / s) and Rout = Tout - min(Tout - Hout,
floor((Tin - Rin - k + pl) / s) + 1). Pointwise ops pass the regions
through unchanged, so the halo grows only on the cheap depthwise and stem
convs. Integer arithmetic is order-free, so the recomputed edge segments
(explicit-pad convolutions over buffer slices) are bit-identical to the
full-window op.

Batched stepping: every session of one (net, hop) pair has buffers of the
same shapes, so one prime or step over a leading session axis advances a
group of them (every op is row-independent and exact, so each row is the
single-session result bit for bit). `StreamEngine.drain()` groups the
ready sessions into bucketed batch sizes (full max-bucket chunks, the tail
padded up to the smallest covering bucket); a group of one takes the
single-session path.

The ring buffers are uint8 tensors on the engine's device (activations
never exceed 8 bits); the frames a session has not consumed yet stay host
numpy until a prime or a step takes them. Everything runs as eager torch
ops on the device.

Observability and energy, as in the reference: `tracer=` records each
prime and step as a span and each session's lifetime as an async span,
`metrics=` counts sessions, frames computed and reused, windows, batch
sizes and padding, and `stats()` reports the modeled joules a step
(`energy_j_per_window()`: the measured step time at the device's busy
watts plus the step's activation bytes at DRAM pJ/byte), the modeled
watts and windows a second a watt, on `power_model=` or the device's
default power curve. Under an injected clock all of them replay
identically.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import cu
from repro_torch.core import graph as G
from repro_torch.core.integer_ops import (
    int_conv1d,
    int_conv1d_f32,
    int_depthwise1d_shifts,
    int_pointwise,
    quantized_op_epilogue,
)
from repro_torch.core.qnet import QNet
from repro_torch.energy import model as EM
from repro_torch.energy.power import PowerModel, default_power_model
from repro_torch.kernels.common import same_pad_amount
from repro_torch.obs import metrics as OM
from repro_torch.obs import trace as OT

Buffers = Dict[str, torch.Tensor]


class StreamError(ValueError):
    """A net/hop combination the streaming planner refuses."""


# ---------------------------------------------------------------------------
# static stream plan: per-op ring-buffer geometry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SegSpec:
    """One edge segment to recompute: input slice [lo, hi) of the op's
    (updated) input buffer, explicit zero pad, and the output count."""

    lo: int
    hi: int
    pad: Tuple[int, int]
    n_out: int


@dataclasses.dataclass(frozen=True)
class MergedSeg:
    """Fused left+right edge recompute: both input slices concatenated
    with `gap` zero frames between them so one op call covers both edges.
    The gap is sized so (a) the left segment's tail taps read zeros
    exactly where its overflow pad would be, and (b) the first right
    output lands on output index `j0` with its receptive field aligned to
    the right slice's stride phase — outputs in [lout, j0) are discarded
    seam garbage."""

    gap: int   # zero frames inserted between the two input slices
    j0: int    # output index where the right segment's outputs begin
    pad: Tuple[int, int]  # explicit pad of the fused conv


@dataclasses.dataclass(frozen=True)
class OpStream:
    """Ring-buffer geometry of one temporal op (or residual pseudo-op)."""

    name: str
    tin: int
    tout: int
    hout: int  # buffer shift per step, in output frames
    lout: int  # left invalid (recomputed) outputs
    rout: int  # right invalid (recomputed) outputs
    left: Optional[SegSpec]
    right: Optional[SegSpec]
    merged: Optional[MergedSeg] = None


@dataclasses.dataclass(frozen=True)
class BlockStream:
    block: G.BlockSpec
    ops: Tuple[OpStream, ...]
    res: Optional[OpStream]  # elementwise skip-add region (residual blocks)
    in_s: float
    in_z: float


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """Static per-(net, window, hop) geometry driving `prime`/`step`."""

    window: int
    hop: int
    blocks: Tuple[BlockStream, ...]  # temporal blocks (incl. the pool block)
    post_blocks: Tuple[G.BlockSpec, ...]  # after the global pool (classifier)
    pool_s: float  # quantizer of the tensor entering the post blocks
    pool_z: float
    frames_full: int  # conv output frames computed per full-window inference
    frames_step: int  # conv output frames computed per streaming step
    macs_full: int
    macs_step: int
    buffer_bytes: int  # uint8 ring buffers per session
    # activation traffic per window: bytes written + raw input read
    bytes_full: int = 0
    bytes_step: int = 0

    @property
    def reuse_fraction(self) -> float:
        return 1.0 - self.frames_step / max(self.frames_full, 1)


def _op_geometry(op: G.OpSpec, tin: int, lin: int, rin: int,
                 hin: int) -> Tuple[OpStream, int, int, int, int]:
    """Apply the halo recurrence to one op; returns (OpStream, tout, lout,
    rout, hout)."""
    if op.kind in (G.DW1D, G.CONV1D):
        k, s = op.kernel, op.stride
        pl, _pr, tout = same_pad_amount(tin, k, s)
    elif op.kind == G.PW:
        k, s, pl, tout = 1, 1, 0, tin
    else:
        raise StreamError(
            f"op {op.name} ({op.kind}) is not streamable before the pool")
    if hin % s:
        raise StreamError(
            f"op {op.name}: stride {s} does not divide the layer hop {hin} "
            f"— pick a hop divisible by the cumulative stride")
    hout = hin // s
    lout = -(-(lin + pl) // s)  # ceil
    first_bad = tout - hout
    if rin > 0:
        first_bad = min(first_bad, (tin - rin - k + pl) // s + 1)
    rout = tout - first_bad
    if lout + rout >= tout:
        # degenerate geometry (halo covers the buffer): recompute everything
        lout, rout = tout, 0
    left = None
    if lout > 0:
        a_hi = (lout - 1) * s - pl + k
        left = SegSpec(0, min(tin, a_hi), (pl, max(0, a_hi - tin)), lout)
    right = None
    if rout > 0:
        a_lo = (tout - rout) * s - pl
        a_hi = (tout - 1) * s - pl + k
        right = SegSpec(max(0, a_lo), min(tin, a_hi),
                        (max(0, -a_lo), max(0, a_hi - tin)), rout)
    merged = None
    if left is not None and right is not None and right.pad[0] == 0:
        ll = left.hi - left.lo
        j0 = max(lout, -(-(ll + left.pad[1] + pl) // s))  # ceil
        gap = j0 * s - pl - ll  # >= left.pad[1] by construction
        rl = right.hi - right.lo
        tout_m = (ll + gap + rl + pl + right.pad[1] - k) // s + 1
        assert tout_m == j0 + rout, (op.name, tout_m, j0, rout)
        merged = MergedSeg(gap=gap, j0=j0, pad=(pl, right.pad[1]))
    return (OpStream(op.name, tin, tout, hout, lout, rout, left, right,
                     merged),
            tout, lout, rout, hout)


def plan_stream(qnet: Union[QNet, cu.PreparedQNet], hop: int) -> StreamPlan:
    """Derive the static ring-buffer plan for `qnet` at the given hop.

    Refuses anything the bit-exactness argument does not cover: 2-D nets,
    SE branches, hops the cumulative stride does not divide, nets without
    a global-pool boundary."""
    spec = qnet.spec
    if spec.spatial_rank != 1:
        raise StreamError(
            f"streaming requires a 1-D (temporal) net; {spec.name} is "
            f"rank {spec.spatial_rank}")
    window = spec.input_hw
    if not 1 <= hop <= window:
        raise StreamError(f"hop {hop} outside [1, window={window}]")

    block_streams: List[BlockStream] = []
    post: List[G.BlockSpec] = []
    t, lin, rin, hin = window, 0, hop, hop
    cur_s, cur_z = cu.input_qparams(qnet)
    pool_s = pool_z = None
    pooled = False
    frames_full = frames_step = macs_full = macs_step = 0
    # activation bytes per window: raw input frames read + every op's
    # output frames written (1 byte a value: uint8 ring buffers)
    bytes_full = window * spec.input_ch
    bytes_step = hop * spec.input_ch
    buffer_bytes = window * spec.input_ch
    for block in spec.blocks:
        if pooled:
            post.append(block)
            for op in block.ops:
                macs_full += op.macs(1, 1)
                macs_step += op.macs(1, 1)
                bytes_full += op.out_ch
                bytes_step += op.out_ch
            continue
        if block.se is not None:
            raise StreamError(
                f"block {block.name} has a squeeze-excitation branch — "
                f"SE pools over the whole window, so no frame is reusable")
        if all(op.kind == G.DENSE for op in block.ops):
            raise StreamError(
                f"dense block {block.name} before the global pool — "
                f"streaming needs a pool boundary to collapse time")
        if block.residual and any(op.stride != 1 for op in block.ops):
            raise StreamError(f"residual block {block.name} has stride != 1")
        in_s, in_z = cur_s, cur_z
        ops: List[OpStream] = []
        for op in block.ops:
            if op.act == G.HSIGMOID:
                raise StreamError(f"op {op.name}: hsigmoid is not streamable")
            os_, t, lin, rin, hin = _op_geometry(op, t, lin, rin, hin)
            ops.append(os_)
            per_frame = op.macs(1, 1)
            # merged edge compute also pays for the seam-garbage outputs
            step_frames = (os_.merged.j0 + os_.rout if os_.merged
                           else os_.lout + os_.rout)
            frames_full += os_.tout
            frames_step += step_frames
            macs_full += os_.tout * per_frame
            macs_step += step_frames * per_frame
            buffer_bytes += os_.tout * op.out_ch
            bytes_full += os_.tout * op.out_ch
            bytes_step += step_frames * op.out_ch
            qop = qnet.ops[op.name]
            cur_s, cur_z = qop.out_scale, qop.out_zp
        res = None
        if block.residual:
            last = ops[-1]
            res = OpStream(block.name + "/residual", last.tout, last.tout,
                           last.hout, last.lout, last.rout, None, None)
            buffer_bytes += last.tout * block.out_ch
            bytes_full += last.tout * block.out_ch
            bytes_step += (last.lout + last.rout) * block.out_ch
            cur_s, cur_z = qnet.res_q[block.name]
        block_streams.append(BlockStream(block, tuple(ops), res, in_s, in_z))
        if block.avgpool:
            pooled = True
            pool_s, pool_z = cur_s, cur_z
    if not pooled:
        raise StreamError(
            f"{spec.name} has no global-pool block — streaming needs the "
            f"temporal/collapsed boundary")
    return StreamPlan(
        window=window, hop=hop, blocks=tuple(block_streams),
        post_blocks=tuple(post), pool_s=pool_s, pool_z=pool_z,
        frames_full=frames_full, frames_step=frames_step,
        macs_full=macs_full, macs_step=macs_step, buffer_bytes=buffer_bytes,
        bytes_full=bytes_full, bytes_step=bytes_step)


# ---------------------------------------------------------------------------
# compute: full-window prime + incremental step, over a leading session axis
# ---------------------------------------------------------------------------


def _pad_qop(x: torch.Tensor, pop: cu.PreparedQOp, pad: Tuple[int, int],
             fixed_point: bool) -> torch.Tensor:
    """Apply one op to an int32 edge slice with an explicit pad, then the
    epilogue of `cu.run_qop` (no hard-sigmoid op streams). Integer
    accumulation is order-free, so each output frame equals the
    corresponding frame of the full-window op."""
    op = pop.spec
    if op.kind == G.DW1D:
        acc = int_depthwise1d_shifts(x, pop.w_acc, stride=op.stride,
                                     padding=pad)
    elif op.kind == G.CONV1D:
        conv = int_conv1d_f32 if pop.w_acc.dtype == torch.float32 \
            else int_conv1d
        acc = conv(x, pop.w_acc, stride=op.stride, padding=pad)
    elif op.kind == G.PW:
        assert pad == (0, 0)
        acc = int_pointwise(x, pop.w_acc)
    else:
        raise StreamError(op.kind)
    return quantized_op_epilogue(acc, pop.zpc, pop.bias_q, pop.mult,
                                 pop.qmax, fixed_point=fixed_point,
                                 mantissa=pop.mantissa, shift=pop.shift)


def _seg_qop(x_buf: torch.Tensor, pop: cu.PreparedQOp, seg: SegSpec,
             fixed_point: bool) -> torch.Tensor:
    """Recompute one edge segment from the op's (already updated, uint8)
    input buffer."""
    x = x_buf[:, seg.lo:seg.hi].to(torch.int32)
    return _pad_qop(x, pop, seg.pad, fixed_point)


def _merged_qop(x_buf: torch.Tensor, pop: cu.PreparedQOp, os_: OpStream,
                fixed_point: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recompute BOTH edge segments with one op call (see `MergedSeg`):
    concatenate the two input slices around the seam gap, run the op once,
    slice out the two valid output ranges."""
    m = os_.merged
    xl = x_buf[:, os_.left.lo:os_.left.hi]
    xr = x_buf[:, os_.right.lo:os_.right.hi]
    parts = [xl, xr] if m.gap == 0 else [
        xl, xl.new_zeros((xl.shape[0], m.gap, xl.shape[2])), xr]
    y = _pad_qop(torch.cat(parts, dim=1).to(torch.int32), pop, m.pad,
                 fixed_point)
    return y[:, :os_.lout], y[:, m.j0:m.j0 + os_.rout]


def _pool_stream(plan: StreamPlan) -> Tuple[OpStream, bool]:
    """(final pre-pool OpStream, whether the global mean can be updated
    incrementally). Incremental pooling carries the per-channel integer
    sum of the final ring buffer across steps and adjusts it with the
    edge slices only. It reproduces `round(mean(...))` bit for bit as
    long as every partial sum stays below 2**24: all intermediate f32
    sums are then exact integers, so summation order cannot change the
    quotient fed to round(). Past that bound the full reduce is taken
    every step, and its bits are then only as exact as the reference's
    own f32 mean."""
    bs = plan.blocks[-1]
    fs = bs.res if bs.res is not None else bs.ops[-1]
    qmax = 2 ** bs.block.ops[-1].act_bits - 1
    return fs, fs.tout * qmax < 2 ** 24


def _channel_sum(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=1, dtype=torch.int32)


def _residual_args(bs: BlockStream, pq: cu.PreparedQNet) -> Tuple:
    last = pq.ops[bs.block.ops[-1].name]
    y_s, y_z = pq.res_q[bs.block.name]
    qmax = 2 ** bs.block.ops[-1].act_bits - 1
    return last.out_scale, last.out_zp, y_s, y_z, qmax


def _finish(pooled: torch.Tensor, plan: StreamPlan, pq: cu.PreparedQNet,
            fixed_point: bool) -> torch.Tensor:
    y, s, z = cu.run_blocks(pooled, plan.post_blocks, pq, plan.pool_s,
                            plan.pool_z, fixed_point)
    return cu.dequantize(y, s, z)


def _prime_impl(x: torch.Tensor, plan: StreamPlan, pq: cu.PreparedQNet,
                in_z: float, input_bits: int, fixed_point: bool
                ) -> Tuple[torch.Tensor, Buffers]:
    """Full-window pass over [B, window, C] float frames that also captures
    every ring buffer. The op walk mirrors `cu.run_block` (no SE by plan
    construction), so the logits equal `cu.run_qnet` bit for bit."""
    bufs: Buffers = {}
    y = cu.quantize_input(x, pq.input_scale, in_z, input_bits)
    bufs["input"] = y.to(torch.uint8)
    for bs in plan.blocks:
        x_block = y
        for op in bs.block.ops:
            y = cu.run_qop(y, pq.ops[op.name], fixed_point)
            bufs[op.name] = y.to(torch.uint8)
        if bs.res is not None:
            c_s, c_z, y_s, y_z, qmax = _residual_args(bs, pq)
            fixed = pq.res_fixed[bs.block.name] if fixed_point else None
            y = cu.residual_add(x_block, bs.in_s, bs.in_z, y, c_s, c_z,
                                y_s, y_z, qmax, fixed_consts=fixed)
            bufs[bs.res.name] = y.to(torch.uint8)
    _, pool_inc = _pool_stream(plan)
    if pool_inc:
        bufs["pool_sum"] = _channel_sum(y)
    return _finish(cu.mean_round(y), plan, pq, fixed_point), bufs


def _step_impl(bufs: Buffers, new: torch.Tensor, plan: StreamPlan,
               pq: cu.PreparedQNet, in_z: float, input_bits: int,
               fixed_point: bool) -> Tuple[torch.Tensor, Buffers]:
    """One hop over [B, hop, C] new float frames: quantize them, shift
    every ring buffer by its per-layer hop, recompute only the invalid
    edge segments, and finish from the final buffer."""
    out: Buffers = {}
    new_q = cu.quantize_input(new, pq.input_scale, in_z, input_bits)
    y = torch.cat([bufs["input"][:, plan.hop:], new_q.to(torch.uint8)], dim=1)
    out["input"] = y

    def assemble(os_: OpStream, left, right, old):
        # edge segments come out of the epilogue as int32 already clipped
        # to [0, qmax] and narrow to the uint8 buffers losslessly
        pieces = []
        if left is not None:
            pieces.append(left.to(torch.uint8))
        mid_lo, mid_hi = os_.lout + os_.hout, os_.tout - os_.rout + os_.hout
        if mid_hi > mid_lo:
            pieces.append(old[:, mid_lo:mid_hi])
        if right is not None:
            pieces.append(right.to(torch.uint8))
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1)

    for bs in plan.blocks:
        x_block = y
        for os_ in bs.ops:
            pop = pq.ops[os_.name]
            if os_.merged is not None:
                left, right = _merged_qop(y, pop, os_, fixed_point)
            else:
                left = (_seg_qop(y, pop, os_.left, fixed_point)
                        if os_.left is not None else None)
                right = (_seg_qop(y, pop, os_.right, fixed_point)
                         if os_.right is not None else None)
            y = assemble(os_, left, right, bufs[os_.name])
            out[os_.name] = y
        if bs.res is not None:
            rs = bs.res
            c_s, c_z, y_s, y_z, qmax = _residual_args(bs, pq)
            fixed = pq.res_fixed[bs.block.name] if fixed_point else None

            def radd(a, b):
                return cu.residual_add(a.to(torch.int32), bs.in_s, bs.in_z,
                                       b.to(torch.int32), c_s, c_z, y_s, y_z,
                                       qmax, fixed_consts=fixed)

            left = (radd(x_block[:, :rs.lout], y[:, :rs.lout])
                    if rs.lout > 0 else None)
            right = (radd(x_block[:, rs.tin - rs.rout:rs.tin],
                          y[:, rs.tin - rs.rout:rs.tin])
                     if rs.rout > 0 else None)
            y = assemble(rs, left, right, bufs[rs.name])
            out[rs.name] = y
    fs, pool_inc = _pool_stream(plan)
    if pool_inc:
        # the mid region of the final buffer holds unchanged VALUES
        # (shifted positions), so the channel sum moves only by the
        # frames that left and the edges that were recomputed
        old = bufs[fs.name]
        mid_lo = min(fs.lout + fs.hout, fs.tout)
        mid_hi = max(fs.tout - fs.rout + fs.hout, mid_lo)
        s_new = (bufs["pool_sum"]
                 - _channel_sum(old[:, :mid_lo])
                 - _channel_sum(old[:, mid_hi:])
                 + _channel_sum(y[:, :fs.lout])
                 + _channel_sum(y[:, fs.tout - fs.rout:]))
        out["pool_sum"] = s_new
        sf = s_new.to(torch.float32)
        # true division by a tensor: CUDA divides by a host scalar through
        # its reciprocal, which can flip round()
        pooled = torch.round(sf / torch.full_like(sf, fs.tout)).to(
            torch.int32)
    else:
        pooled = cu.mean_round(y)
    return _finish(pooled, plan, pq, fixed_point), out


def _stack(bufs_list: Sequence[Buffers]) -> Buffers:
    """Per-session [1, ...] buffers -> one [B, ...] buffer a key."""
    return {k: torch.cat([bl[k] for bl in bufs_list], dim=0)
            for k in bufs_list[0]}


def _split_rows(bufs: Buffers, b: int) -> List[Buffers]:
    """A stacked buffer dict back into per-session [1, ...] rows (views)."""
    return [{k: v[i:i + 1] for k, v in bufs.items()} for i in range(b)]


def reference_windows(qnet, frames: np.ndarray, window: int, hop: int,
                      fixed_point: bool = False, input_bits: int = 8,
                      device=None) -> np.ndarray:
    """Full-window logits for every hop-aligned window of a frame stream —
    the oracle the streaming route is held against: `cu.run_qnet` over the
    stacked windows (rows are independent, so one call equals one call a
    window). A `QNet` is prepared on `device` (CUDA unless the caller names
    another)."""
    n = (len(frames) - window) // hop + 1
    if n <= 0:
        return np.zeros((0, qnet.spec.num_classes), np.float32)
    x = np.stack([frames[i * hop:i * hop + window] for i in range(n)])
    return cu.run_qnet(qnet, x, input_bits=input_bits, device=device,
                       fixed_point=fixed_point).cpu().numpy()


# ---------------------------------------------------------------------------
# session table + engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StreamResult:
    """Logits for one completed window of one session."""

    sid: str
    window: int  # per-session window index (0 == the priming window)
    logits: np.ndarray  # [num_classes] dequantized
    streamed: bool  # False for the priming (full) window


@dataclasses.dataclass
class _Session:
    sid: str
    buffers: Optional[Buffers]
    pending: np.ndarray  # raw frames not yet consumed, [n, C]
    last_used: float
    windows: int
    span_id: int


class StreamEngine:
    """Stateful streaming front end over a prepared 1-D QNet, on one device
    (CUDA unless `device=` names another).

    Grows a session table (LRU eviction at `max_sessions`); each session
    owns the per-layer integer ring buffers. `push(sid, frames)` consumes
    arbitrary-length frame chunks and returns one `StreamResult` per
    completed window: the first window of a session runs the full `prime`
    pass, every later one the O(hop + halo) `step` pass. Outputs are
    bit-exact with `cu.run_qnet` on each window.

    Fleet mode: `push(sid, frames, defer=True)` stages frames without
    advancing, and `drain()` advances every ready session — priming
    windows and incremental steps alike — in batches that stack whole
    session groups on a leading axis (`batch_buckets` bounds the batch
    shapes). `step_many(sids)` is the explicit one-hop batched advance.
    Batched rows are bit-exact with the single-session path.
    """

    def __init__(
        self,
        qnet: Union[QNet, cu.PreparedQNet],
        hop: int,
        *,
        fixed_point: bool = False,
        input_bits: int = 8,
        max_sessions: int = 64,
        batch_buckets: Sequence[int] = (2, 4, 8),
        clock=None,
        device=None,
        tracer: Optional[OT.Tracer] = None,
        metrics: Optional[OM.MetricsRegistry] = None,
        name: str = "default",
        power_model: Optional[PowerModel] = None,
    ):
        if max_sessions < 1:
            raise ValueError(f"max_sessions {max_sessions} < 1")
        if any(int(b) < 1 for b in batch_buckets):
            raise ValueError(f"bad batch_buckets {batch_buckets}")
        self.pq = cu.prepare_qnet(qnet, input_bits=input_bits, device=device)
        self.device = self.pq.device
        self.qnet = self.pq.qnet
        self.plan = plan_stream(self.pq, hop)
        self.window, self.hop = self.plan.window, int(hop)
        self.input_ch = self.qnet.spec.input_ch
        self.fixed_point = fixed_point
        self.input_bits = input_bits
        self.max_sessions = max_sessions
        # bucket 1 is implicit — a group of one takes the single-session
        # path (no padding)
        self.batch_buckets = tuple(sorted(
            {int(b) for b in batch_buckets if int(b) > 1}))
        self.name = name
        self._clock = time.perf_counter if clock is None else clock
        self.tracer = tracer if tracer is not None else OT.NULL
        self._reg = metrics if metrics is not None else OM.NULL_REGISTRY
        # the device's power curve for the modeled J/window and FPS/Watt in
        # stats(); injectable for determinism
        self.power = (power_model if power_model is not None
                      else default_power_model(self.device.type))
        _, self._in_z = cu.input_qparams(self.qnet)

        plan, pq, in_z = self.plan, self.pq, self._in_z
        self._prime = lambda x: _prime_impl(x, plan, pq, in_z, input_bits,
                                            fixed_point)
        self._step = lambda bufs, new: _step_impl(
            bufs, new, plan, pq, in_z, input_bits, fixed_point)
        # the batched programs run so far, (prime | step) x batch size:
        # eager torch has nothing to trace, so `batched_traces` counts
        # their first runs, bounded by 2 * len(batch_buckets) as in the
        # reference's jit cache
        self._batched_seen: set = set()

        self._sessions: "OrderedDict[str, _Session]" = OrderedDict()
        self._sid_counter = itertools.count()
        self._span_ids = itertools.count(1)
        self._windows = 0
        self._primes = 0
        self._evicted = 0
        self._prime_s = 0.0
        self._step_s = 0.0
        self._frames_computed = 0
        self._frames_reused = 0
        self._windows_batched = 0
        self._batched_calls = 0
        self._pad_rows = 0
        self._init_obs()

    def _init_obs(self) -> None:
        lbl = {"model": self.name}
        self._m_active = self._reg.gauge(
            "stream_sessions_active", "open streaming sessions", labels=lbl)
        self._m_computed = self._reg.counter(
            "stream_frames_computed_total",
            "conv output frames actually computed", labels=lbl)
        self._m_reused = self._reg.counter(
            "stream_frames_reused_total",
            "conv output frames served from ring buffers", labels=lbl)
        self._m_windows = self._reg.counter(
            "stream_windows_total", "windows answered with logits",
            labels=lbl)
        self._m_evicted = self._reg.counter(
            "stream_sessions_evicted_total", "LRU session evictions",
            labels=lbl)
        self._m_batch = self._reg.histogram(
            "stream_batch_size",
            "real sessions advanced per jitted prime/step dispatch",
            labels=lbl, buckets=(1, 2, 4, 8, 16, 32, 64))
        self._m_pad = self._reg.counter(
            "stream_pad_rows_total",
            "bucket-padding waste rows in batched prime/step calls",
            labels=lbl)
        self._m_fpw = self._reg.gauge(
            "stream_fps_per_watt",
            "modeled windows per second per watt (calibrated energy model)",
            labels=lbl)
        self._m_watts = self._reg.gauge(
            "stream_watts",
            "modeled average device watts at the achieved window rate",
            labels=lbl)
        self.tracer.name_track(OT.TID_ENGINE, f"stream:{self.name}")

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            self.device)

    def _prime_many(self, x: torch.Tensor) -> Tuple[torch.Tensor,
                                                    List[Buffers]]:
        b = x.shape[0]
        self._batched_seen.add(("prime", b))
        logits, bufs = self._prime(x)
        return logits, _split_rows(bufs, b)

    def _step_many(self, bufs_list: Sequence[Buffers], new: torch.Tensor
                   ) -> Tuple[torch.Tensor, List[Buffers]]:
        b = len(bufs_list)
        self._batched_seen.add(("step", b))
        logits, out = self._step(_stack(bufs_list), new)
        return logits, _split_rows(out, b)

    def warm(self, batches: Sequence[int] = ()) -> None:
        """Run prime + step once at one session, and at each of the batch
        sizes `batches`, outside any session: the first call of each shape
        pays the device's first-run costs (library handles, allocator)."""
        zeros = np.zeros((1, self.window, self.input_ch), np.float32)
        _, bufs = self._prime(self._to_device(zeros))
        self._step(bufs, self._to_device(zeros[:, :self.hop]))[0].cpu()
        for b in sorted({int(x) for x in batches}):
            if b < 2:
                continue
            xb = self._to_device(np.zeros((b, self.window, self.input_ch),
                                          np.float32))
            _, outs = self._prime_many(xb)
            self._step_many(outs, xb[:, :self.hop])[0].cpu()

    # -- session lifecycle ------------------------------------------------

    def open_session(self, sid: Optional[str] = None) -> str:
        """Open (or re-open) a session; evicts the LRU session when full."""
        if sid is None:
            # skip counter values that collide with user-supplied sids
            sid = f"s{next(self._sid_counter)}"
            while sid in self._sessions:
                sid = f"s{next(self._sid_counter)}"
        if sid in self._sessions:
            self._sessions.move_to_end(sid)
            self._sessions[sid].last_used = self._clock()
            return sid
        while len(self._sessions) >= self.max_sessions:
            old_sid, old = self._sessions.popitem(last=False)
            self._evicted += 1
            self._m_evicted.inc()
            self.tracer.async_end(f"stream_session:{self.name}",
                                  old.span_id, args={"sid": old_sid,
                                                     "evicted": True})
            self._m_active.set(len(self._sessions))
        span_id = next(self._span_ids)
        self.tracer.async_begin(f"stream_session:{self.name}", span_id,
                                args={"sid": sid})
        self._sessions[sid] = _Session(
            sid=sid, buffers=None,
            pending=np.zeros((0, self.input_ch), np.float32),
            last_used=self._clock(), windows=0, span_id=span_id)
        self._m_active.set(len(self._sessions))
        return sid

    def close_session(self, sid: str) -> None:
        sess = self._sessions.pop(sid, None)
        if sess is None:
            raise KeyError(f"unknown session {sid!r}")
        self.tracer.async_end(f"stream_session:{self.name}", sess.span_id,
                              args={"sid": sid, "evicted": False})
        self._m_active.set(len(self._sessions))

    @property
    def sessions_active(self) -> int:
        return len(self._sessions)

    def session_table_buffer_bytes(self) -> int:
        """Resident ring-buffer bytes across primed sessions."""
        return sum(self.plan.buffer_bytes for s in self._sessions.values()
                   if s.buffers is not None)

    def session_table_pending_bytes(self) -> int:
        """float32 staging frames awaiting a full window/hop, all sessions
        (a cold session holds up to window-1 frames here)."""
        return sum(s.pending.nbytes for s in self._sessions.values())

    def session_table_bytes(self) -> int:
        """Primed ring buffers plus the pending staging arrays."""
        return (self.session_table_buffer_bytes()
                + self.session_table_pending_bytes())

    # -- inference --------------------------------------------------------

    def push(self, sid: str, frames: np.ndarray, *,
             defer: bool = False) -> List[StreamResult]:
        """Feed raw frames ([n, C] float, calibrated input range) into a
        session; returns a result per window completed by this chunk.

        With `defer=True` the frames are only staged (returns []) — a
        later `drain()` / `step_many()` advances the session. Frame
        consumption is transactional: if a prime or step raises, the
        staged frames stay pending and the session stays consistent."""
        sess = self._sessions.get(sid)
        if sess is None:
            raise KeyError(f"unknown session {sid!r}; open_session first")
        frames = np.asarray(frames, np.float32)
        if frames.ndim != 2 or frames.shape[1] != self.input_ch:
            raise ValueError(
                f"frames shape {frames.shape} != (n, {self.input_ch})")
        self._sessions.move_to_end(sid)
        sess.last_used = self._clock()
        sess.pending = np.concatenate([sess.pending, frames], axis=0)
        if defer:
            return []
        results: List[StreamResult] = []
        while True:
            if sess.buffers is None:
                if len(sess.pending) < self.window:
                    break
                results += self._prime_sessions((sid,), 0)
            else:
                if len(sess.pending) < self.hop:
                    break
                results += self._step_sessions((sid,), 0)
        return results

    # -- batched stepping --------------------------------------------------

    def _buckets_of(self, sids: Sequence[str]
                    ) -> List[Tuple[Tuple[str, ...], int]]:
        """Split ready sids into (group, pad) calls: full max-bucket
        chunks, then the tail rounded UP to the smallest covering bucket.
        A tail of one takes the single-session path instead of padding."""
        sids = tuple(sids)
        bs = self.batch_buckets
        if not bs:
            return [((sid,), 0) for sid in sids]
        groups: List[Tuple[Tuple[str, ...], int]] = []
        i, n = 0, len(sids)
        maxb = bs[-1]
        while n - i >= maxb:
            groups.append((sids[i:i + maxb], 0))
            i += maxb
        rem = n - i
        if rem == 1:
            groups.append((sids[i:], 0))
        elif rem > 1:
            cover = min(x for x in bs if x >= rem)
            groups.append((sids[i:], cover - rem))
        return groups

    def _note_window(self, sess: _Session,
                     logits_row: np.ndarray) -> StreamResult:
        self._windows += 1
        self._m_windows.inc()
        r = StreamResult(sid=sess.sid, window=sess.windows,
                         logits=logits_row, streamed=sess.windows > 0)
        sess.windows += 1
        return r

    def _account(self, group: Sequence[str], b: int, pad: int,
                 frames: int, t0: float, t1: float, kind: str) -> None:
        """Batch counters, metrics and the call's span (`stream_<kind>`
        for one session, `stream_<kind>_batched` for a group)."""
        self._m_batch.observe(len(group))
        if b > 1:
            self._batched_calls += 1
            self._windows_batched += len(group)
        if pad:
            self._pad_rows += pad
            self._m_pad.inc(pad)
        if b == 1:
            self.tracer.complete(
                f"stream_{kind}", t0, t1, cat="stream", tid=OT.TID_ENGINE,
                args={"sid": group[0], "frames": frames})
        else:
            self.tracer.complete(
                f"stream_{kind}_batched", t0, t1, cat="stream",
                tid=OT.TID_ENGINE,
                args={"sids": list(group), "batch": len(group), "pad": pad,
                      "frames": frames})

    def _prime_sessions(self, group: Sequence[str],
                        pad: int) -> List[StreamResult]:
        """Run the priming window for a group of sessions in one call
        (`pad` extra zero rows round the batch up to a bucket)."""
        sess = [self._sessions[sid] for sid in group]
        b = len(sess) + pad
        xs = [s.pending[:self.window] for s in sess]
        xs += [np.zeros((self.window, self.input_ch), np.float32)] * pad
        x = self._to_device(np.stack(xs))
        t0 = self._clock()
        if b == 1:
            logits, bufs = self._prime(x)
            outs = [bufs]
        else:
            logits, outs = self._prime_many(x)
        logits = logits.cpu().numpy()
        t1 = self._clock()
        results = []
        for i, s in enumerate(sess):
            # consume ONLY after the call returned: a failed prime must not
            # lose frames
            s.pending = s.pending[self.window:]
            s.buffers = outs[i]
            self._sessions.move_to_end(s.sid)
            s.last_used = t1
            results.append(self._note_window(s, logits[i]))
        self._primes += len(sess)
        self._prime_s += t1 - t0
        frames = self.plan.frames_full * b
        self._frames_computed += frames
        self._m_computed.inc(frames)
        self._account(group, b, pad, frames, t0, t1, "prime")
        return results

    def _step_sessions(self, group: Sequence[str],
                       pad: int) -> List[StreamResult]:
        """Advance a group of primed sessions by one hop in one call.
        Padding rows replicate the first session's buffers; their outputs
        are discarded (rows are independent)."""
        sess = [self._sessions[sid] for sid in group]
        b = len(sess) + pad
        news = [s.pending[:self.hop] for s in sess]
        news += [np.zeros((self.hop, self.input_ch), np.float32)] * pad
        new = self._to_device(np.stack(news))
        t0 = self._clock()
        if b == 1:
            logits, out = self._step(sess[0].buffers, new)
            outs = [out]
        else:
            bufs_list = [s.buffers for s in sess] + [sess[0].buffers] * pad
            logits, outs = self._step_many(bufs_list, new)
        logits = logits.cpu().numpy()
        t1 = self._clock()
        results = []
        for i, s in enumerate(sess):
            s.pending = s.pending[self.hop:]  # transactional: after success
            s.buffers = outs[i]
            self._sessions.move_to_end(s.sid)
            s.last_used = t1
            results.append(self._note_window(s, logits[i]))
        self._step_s += t1 - t0
        frames = self.plan.frames_step * b
        reused = (self.plan.frames_full - self.plan.frames_step) * len(sess)
        self._frames_computed += frames
        self._frames_reused += reused
        self._m_computed.inc(frames)
        self._m_reused.inc(reused)
        self._account(group, b, pad, frames, t0, t1, "step")
        return results

    def _ready_sids(self) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
        primes, steps = [], []
        for sid, s in self._sessions.items():
            if s.buffers is None:
                if len(s.pending) >= self.window:
                    primes.append(sid)
            elif len(s.pending) >= self.hop:
                steps.append(sid)
        return tuple(primes), tuple(steps)

    def step_many(self, sids: Sequence[str]) -> List[StreamResult]:
        """Advance each named session by ONE hop, grouped into bucketed
        batched steps. Sessions that are unprimed or hold fewer than `hop`
        pending frames are skipped; unknown sids raise KeyError."""
        ready, seen = [], set()
        for sid in sids:
            sess = self._sessions.get(sid)
            if sess is None:
                raise KeyError(f"unknown session {sid!r}; open_session first")
            if sid in seen:
                continue
            seen.add(sid)
            if sess.buffers is not None and len(sess.pending) >= self.hop:
                ready.append(sid)
        results: List[StreamResult] = []
        for group, pad in self._buckets_of(ready):
            results += self._step_sessions(group, pad)
        return results

    def drain(self) -> List[StreamResult]:
        """Advance EVERY ready session until none can move: each round
        groups the sessions ready to prime and those ready to step into
        bucketed batched calls (a session primed in round k steps in round
        k+1 if it still holds a hop of frames). Returns all completed
        windows; per session they are in window order."""
        results: List[StreamResult] = []
        while True:
            primes, steps = self._ready_sids()
            if not primes and not steps:
                break
            for group, pad in self._buckets_of(primes):
                results += self._prime_sessions(group, pad)
            for group, pad in self._buckets_of(steps):
                results += self._step_sessions(group, pad)
        return results

    # -- reporting --------------------------------------------------------

    def energy_j_per_window(self) -> float:
        """Modeled energy of one steady-state streaming step.

        Compute term: the measured average step wall time priced at the
        device's busy watts (falling back to analytic pJ/MAC over the
        plan's per-step MACs before any step has run); memory term: the
        plan's per-step activation traffic at DRAM pJ/byte. The same
        accounting as `repro_torch.energy.estimate_energy`, specialized to
        the ring-buffer step geometry."""
        mem_j = self.plan.bytes_step * EM.PJ_PER_BYTE * 1e-12
        steps = self._windows - self._primes
        if steps and self._step_s > 0:
            return self.power.busy_w * (self._step_s / steps) + mem_j
        bits = max((op.bits for b in self.qnet.spec.blocks for op in b.ops),
                   default=8)
        pj = EM.PJ_PER_MAC.get(bits, EM.PJ_PER_MAC_DEFAULT)
        return self.plan.macs_step * pj * 1e-12 + mem_j

    def stats(self) -> Dict[str, float]:
        steps = self._windows - self._primes
        wps = (steps / self._step_s
               if steps and self._step_s > 0 else 0.0)
        energy_j = self.energy_j_per_window()
        watts = self.power.idle_w + energy_j * wps
        fps_per_watt = wps / watts if watts > 0 else 0.0
        self._m_fpw.set(fps_per_watt)
        self._m_watts.set(watts)
        return {
            "sessions_active": float(len(self._sessions)),
            "sessions_evicted": float(self._evicted),
            "windows": float(self._windows),
            "primes": float(self._primes),
            "steps": float(steps),
            # fleet mode: windows advanced through batched (B>1) calls,
            # how many such calls ran, how many distinct batched programs
            # ran (bounded by 2 * len(batch_buckets)), and the padding
            "windows_batched": float(self._windows_batched),
            "batched_calls": float(self._batched_calls),
            "batched_traces": float(len(self._batched_seen)),
            "pad_rows": float(self._pad_rows),
            "frames_computed_total": float(self._frames_computed),
            "frames_reused_total": float(self._frames_reused),
            "frames_per_window_full": float(self.plan.frames_full),
            "frames_per_window_step": float(self.plan.frames_step),
            "reuse_fraction": self.plan.reuse_fraction,
            "macs_per_window_full": float(self.plan.macs_full),
            "macs_per_window_step": float(self.plan.macs_step),
            "session_buffer_bytes": float(self.plan.buffer_bytes),
            "session_table_buffer_bytes":
                float(self.session_table_buffer_bytes()),
            "session_table_pending_bytes":
                float(self.session_table_pending_bytes()),
            "session_table_bytes": float(self.session_table_bytes()),
            "prime_s": self._prime_s,
            "step_s": self._step_s,
            "fps_streamed": wps,
            # calibrated energy model: per-step modeled joules, average
            # modeled draw at the achieved window rate, and the paper's
            # headline windows-per-second-per-watt
            "bytes_per_window_full": float(self.plan.bytes_full),
            "bytes_per_window_step": float(self.plan.bytes_step),
            "energy_j_per_window_step": energy_j,
            "watts": watts,
            "fps_per_watt": fps_per_watt,
        }


def frames_for_windows(n_windows: int, window: int, hop: int) -> int:
    """Stream length that yields exactly `n_windows` hop-aligned windows."""
    return window + (n_windows - 1) * hop


__all__ = [
    "StreamError",
    "SegSpec",
    "MergedSeg",
    "OpStream",
    "BlockStream",
    "StreamPlan",
    "StreamEngine",
    "StreamResult",
    "plan_stream",
    "reference_windows",
    "frames_for_windows",
]
