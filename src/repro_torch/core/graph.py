"""Network graph IR consumed by the Network Compiler (Sec. 4.2).

The front-end emits, and the back-end consumes, a tiny layer IR: a network is
a sequence of blocks; each block is a sequence of convolutional operators plus
optional residual / squeeze-excitation / pooling structure. The compiler
(`core/compiler.py`) partitions blocks into Head / Body / Tail / Classifier
CUs based on their recurrence pattern, exactly like the paper's Network SoC
Compiler ("Depending on the recurrence of the convolutional operators, they
are mapped to the Head, Body, Tail, and Classifier CU").

The same IR drives:
  * float inference & QAT        (models/layers.py interpreter)
  * op/param counting            (Table 2 reproduction)
  * quantization to QNet         (core/qnet.py)
  * fused integer CU execution   (core/cu.py)
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

# Operator kinds
CONV = "conv"  # normal convolution (spatial + channel reduction)
DW = "dw"  # depthwise convolution (spatial only, groups == channels)
PW = "pw"  # pointwise convolution (1x1, channel only)
DENSE = "dense"  # classifier matmul
# 1-D (temporal) variants for streaming DSCNNs ([B, T, C] activations).
# PW and DENSE are rank-agnostic (channel-only mixing), so only the ops
# with a spatial/temporal window get dedicated kinds.
CONV1D = "conv1d"  # normal temporal convolution (stem of a 1-D DSCNN)
DW1D = "dw1d"  # depthwise temporal convolution

# op kinds that fix the activation rank to 1 (a net containing any of these
# runs on [B, T, C] tensors; see `spatial_rank`)
RANK1_KINDS = (CONV1D, DW1D)

# Activations
RELU6 = "relu6"
NONE = "none"  # linear (projection convs, classifier)
HSIGMOID = "hsigmoid"  # hard sigmoid, Eq. 1 (EfficientNet SE gate)


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """One convolutional operator (paper Sec. 4.1)."""

    name: str
    kind: str  # CONV | DW | PW | DENSE
    in_ch: int
    out_ch: int
    kernel: int = 1
    stride: int = 1
    act: str = RELU6
    bits: int = 4  # BW of this operator's datapath
    act_bits: int = 4  # BW of its output activation tensor

    def weight_shape(self) -> Tuple[int, ...]:
        if self.kind == DW:
            # HWIO with feature_group_count == C: [K, K, 1, C]; out channel last,
            # matching the per-channel quantization axis of every other op.
            return (self.kernel, self.kernel, 1, self.in_ch)
        if self.kind == DW1D:
            # WIO with feature_group_count == C: [K, 1, C]; out channel last.
            return (self.kernel, 1, self.in_ch)
        if self.kind == CONV1D:
            return (self.kernel, self.in_ch, self.out_ch)
        if self.kind == DENSE:
            return (self.in_ch, self.out_ch)
        return (self.kernel, self.kernel, self.in_ch, self.out_ch)

    def n_params(self, with_bias: bool = True) -> int:
        n = 1
        for d in self.weight_shape():
            n *= d
        return n + (self.out_ch if with_bias else 0)

    def macs(self, h: int, w: int) -> int:
        """Multiply-accumulates to produce an (h, w) output map.

        1-D ops take (t, 1): h * w is the number of output positions either
        way, and the temporal window contributes `kernel` taps, not K^2."""
        if self.kind == DW:
            return h * w * self.kernel * self.kernel * self.in_ch
        if self.kind == DW1D:
            return h * w * self.kernel * self.in_ch
        if self.kind == CONV1D:
            return h * w * self.kernel * self.in_ch * self.out_ch
        if self.kind == DENSE:
            return self.in_ch * self.out_ch
        return h * w * self.kernel * self.kernel * self.in_ch * self.out_ch


@dataclasses.dataclass(frozen=True)
class SESpec:
    """Squeeze-and-Excitation (EfficientNet IRB, Fig. 3b): global-avg ->
    PW-SQ (reduce) -> PW-EX (expand) -> hard-sigmoid gate."""

    channels: int
    reduced: int
    bits: int = 4
    prefix: str = "se"

    @property
    def squeeze(self) -> OpSpec:
        return OpSpec(
            f"{self.prefix}/pw_sq", PW, self.channels, self.reduced,
            act=RELU6, bits=self.bits, act_bits=self.bits,
        )

    @property
    def excite(self) -> OpSpec:
        return OpSpec(
            f"{self.prefix}/pw_ex", PW, self.reduced, self.channels,
            act=HSIGMOID, bits=self.bits, act_bits=self.bits,
        )


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """A fusable group of operators — the unit the compiler maps to one CU
    invocation. `residual` adds the skip-line (Fig. 3) when shapes permit."""

    name: str
    ops: Tuple[OpSpec, ...]
    residual: bool = False
    se: Optional[SESpec] = None  # SE applied after the depthwise op
    se_after: Optional[str] = None  # op name the SE gate follows
    avgpool: bool = False  # global average pool after the ops (Tail CU)

    @property
    def stride(self) -> int:
        s = 1
        for op in self.ops:
            s *= op.stride
        return s

    @property
    def in_ch(self) -> int:
        return self.ops[0].in_ch

    @property
    def out_ch(self) -> int:
        return self.ops[-1].out_ch


@dataclasses.dataclass(frozen=True)
class NetSpec:
    """Whole-network description (the front-end's 'network description model')."""

    name: str
    blocks: Tuple[BlockSpec, ...]
    input_hw: int
    input_ch: int = 3
    num_classes: int = 1000

    def all_ops(self):
        for b in self.blocks:
            for op in b.ops:
                yield b, op
            if b.se is not None:
                yield b, b.se.squeeze
                yield b, b.se.excite

    def n_params(self, with_bias: bool = True) -> int:
        return sum(op.n_params(with_bias) for _, op in self.all_ops())

    def model_bits(self, with_bias: bool = True, bias_bits: int = 32) -> int:
        """Model size in bits with per-op BW — reproduces Table 2 Params(Mb)."""
        total = 0
        for _, op in self.all_ops():
            n = op.n_params(with_bias=False)
            total += n * op.bits
            if with_bias:
                total += op.out_ch * bias_bits
        return total

    @property
    def spatial_rank(self) -> int:
        """1 for temporal ([B, T, C]) nets, 2 for image ([B, H, W, C]) nets.

        Derived from the op kinds rather than stored, so `.qnet`
        serialization and every existing 2-D build record are untouched."""
        return 1 if any(op.kind in RANK1_KINDS
                        for _, op in self.all_ops()) else 2

    def input_shape(self) -> Tuple[int, ...]:
        """Per-example input tensor shape (no batch dim)."""
        if self.spatial_rank == 1:
            return (self.input_hw, self.input_ch)
        return (self.input_hw, self.input_hw, self.input_ch)

    def count_macs(self) -> int:
        """Total MACs for one input image (Table 2 '#Ops')."""
        h = self.input_hw
        w_of = (lambda h_out: 1) if self.spatial_rank == 1 else (lambda h_out: h_out)
        total = 0
        for b in self.blocks:
            for op in b.ops:
                if op.kind == DENSE:
                    total += op.macs(1, 1)
                    continue
                h_out = -(-h // op.stride)  # ceil div, SAME padding
                total += op.macs(h_out, w_of(h_out))
                h = h_out
            if b.se is not None:
                # SE convs act on 1x1 pooled features
                total += b.se.squeeze.macs(1, 1) + b.se.excite.macs(1, 1)
        return total

    def count_bn_ops(self) -> int:
        """Elementwise ops the (unfused) BN layers would add — the ~4% claim."""
        h = self.input_hw
        total = 0
        for b in self.blocks:
            for op in b.ops:
                if op.kind == DENSE:
                    continue
                h_out = -(-h // op.stride)
                elems = h_out if self.spatial_rank == 1 else h_out * h_out
                total += 2 * elems * op.out_ch  # scale + shift per element
                h = h_out
        return total


# name suffix appended by the act-bit rewrites below; stripped before
# re-appending so re-quantization is idempotent on the name
_ACT_SUFFIX_RE = re.compile(r"(_act(?:\d+|mix[0-9a-f]+))+$")


def _base_name(name: str) -> str:
    """Net name with any `_act{n}` / `_actmix{hash}` suffix removed."""
    return _ACT_SUFFIX_RE.sub("", name)


def with_act_bits(net: NetSpec, act_bits: int) -> NetSpec:
    """The same network at a different activation bit-width.

    Rewrites `act_bits` on every plain convolutional operator — the knob the
    QAT anneal schedule turns (train at 8-bit activations first, then step
    down to the deployment BW, per the paper's UInt4 recipe). Weight
    bit-widths and SE gates are left untouched: the gate output range is
    exactly [0, 1] regardless of BW, and `SESpec` derives both widths from
    one field. Op names (and therefore param trees) are unchanged, so one
    set of float params serves every anneal stage.

    The name gains one `_act{n}` suffix; any existing act suffix is
    stripped first, so re-quantizing an already-suffixed net yields
    `mnv2_act4`, never `mnv2_act8_act4` (artifact / tuned-cache / golden
    naming stays in sync across repeated anneal steps).
    """
    blocks = tuple(
        dataclasses.replace(
            b, ops=tuple(dataclasses.replace(op, act_bits=act_bits)
                         for op in b.ops))
        for b in net.blocks
    )
    return dataclasses.replace(
        net, name=f"{_base_name(net.name)}_act{act_bits}", blocks=blocks)


def with_op_act_bits(net: NetSpec, alloc: Dict[str, int]) -> NetSpec:
    """Per-op generalization of `with_act_bits`: heterogeneous precision.

    `alloc` maps op names to activation bit-widths; ops absent from the
    map keep their current `act_bits`. Unknown names raise — a typo'd
    allocation silently keeping the old width is exactly the bug class
    the mixed-precision tooling must not have. SE gate ops are derived
    from `SESpec` and are not individually addressable (the gate range is
    [0, 1] at any BW), so their names are rejected too.

    The returned net's name carries a deterministic `_actmix{hash}`
    suffix (stripping any existing act suffix first), so two different
    allocations never alias in tuned-cache `nets` lists or artifact
    filenames, while the same allocation always produces the same name.
    """
    if not alloc:
        return net
    known = {op.name for b in net.blocks for op in b.ops}
    unknown = sorted(set(alloc) - known)
    if unknown:
        raise KeyError(
            f"with_op_act_bits: unknown op name(s) {unknown!r} — "
            f"allocation keys must name plain ops of {net.name!r}")
    blocks = tuple(
        dataclasses.replace(
            b, ops=tuple(
                dataclasses.replace(op, act_bits=int(alloc[op.name]))
                if op.name in alloc else op
                for op in b.ops))
        for b in net.blocks
    )
    new = dataclasses.replace(net, blocks=blocks)
    widths = sorted({op.act_bits for b in new.blocks for op in b.ops})
    if len(widths) == 1:
        # degenerate map: every op ends at one width — same spelling as
        # the uniform rewrite so names stay canonical
        name = f"{_base_name(net.name)}_act{widths[0]}"
    else:
        sig = "-".join(f"{op.name}={op.act_bits}"
                       for b in new.blocks for op in b.ops)
        import hashlib

        digest = hashlib.sha1(sig.encode()).hexdigest()[:8]
        name = f"{_base_name(net.name)}_actmix{digest}"
    return dataclasses.replace(new, name=name)


def op_act_bits(net: NetSpec) -> Dict[str, int]:
    """The net's current per-op activation widths, `{op_name: bits}` —
    the inverse view `with_op_act_bits` consumes (plain ops only; SE gate
    widths are derived from `SESpec.bits`)."""
    return {op.name: op.act_bits for b in net.blocks for op in b.ops}


__all__ = [
    "OpSpec",
    "SESpec",
    "BlockSpec",
    "NetSpec",
    "with_act_bits",
    "with_op_act_bits",
    "op_act_bits",
    "CONV",
    "DW",
    "PW",
    "DENSE",
    "CONV1D",
    "DW1D",
    "RANK1_KINDS",
    "RELU6",
    "NONE",
    "HSIGMOID",
]
