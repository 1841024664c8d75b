"""1-D depthwise-separable CNN builders — the streaming sensor workloads.

Counterpart of `repro/models/dscnn1d.py`, over the port's `core/graph`.

Two families over [B, T, C] temporal tensors (DeepDive's DSCNN structure
transplanted onto the edge-sensor shapes the streaming engine serves):

  * ``dscnn_kws`` — keyword spotting over MFCC frames (Zhang et al.
    'Hello Edge' DS-CNN family): stem Conv1d stride 2, then a stack of
    identical DW1D->PW blocks at one width, tail PW + global pool,
    classifier.
  * ``dscnn_har`` — human activity recognition over raw accelerometer
    channels (the Kadoshima HAR topology): stem Conv1d, then widening
    DW1D->PW blocks that downsample by stride-2 depthwise convs, tail
    PW + global pool, classifier.

Both lower onto the port's integer ops: DW1D runs the shifted-multiply
depthwise formulation over one axis; PW/DENSE are rank-agnostic channel
matmuls (a [B, T, C] pointwise is exactly the flattened (B*T, C) @ (C, D)
the paper's pointwise CU computes).

The CU mapping falls out of the standard recurrence rule (compile_net):
Head = stem + first DS block, Body = remaining DS blocks, Tail = pw +
global pool, Classifier = dense.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.graph import (
    CONV1D,
    DENSE,
    DW1D,
    NONE,
    PW,
    RELU6,
    BlockSpec,
    NetSpec,
    OpSpec,
)


def ds_block(name: str, in_ch: int, out_ch: int, kernel: int, stride: int,
             bits: int, residual: bool = False) -> BlockSpec:
    """One depthwise-separable 1-D block: DW1D (temporal) -> PW (channel)."""
    ops = (
        OpSpec(f"{name}/dw", DW1D, in_ch, in_ch, kernel, stride, RELU6,
               bits, bits),
        OpSpec(f"{name}/pw", PW, in_ch, out_ch, 1, 1, RELU6, bits, bits),
    )
    return BlockSpec(name, ops,
                     residual=residual and stride == 1 and in_ch == out_ch)


def build_kws(
    input_t: int = 49,
    input_ch: int = 10,
    channels: int = 64,
    n_blocks: int = 4,
    kernel: int = 3,
    stem_kernel: int = 5,
    stem_stride: int = 2,
    bits: int = 8,
    first_conv_bits: int = 8,
    num_classes: int = 12,
    last_ch: int = 0,
    residual: bool = False,
) -> NetSpec:
    """Keyword-spotting DS-CNN: one width, repeated DS blocks."""
    blocks = [
        BlockSpec("stem", (OpSpec("stem/conv", CONV1D, input_ch, channels,
                                  stem_kernel, stem_stride, RELU6,
                                  first_conv_bits, bits),)),
    ]
    for i in range(n_blocks):
        blocks.append(ds_block(f"ds{i}", channels, channels, kernel, 1,
                               bits, residual=residual))
    tail_ch = last_ch or 2 * channels
    blocks.append(BlockSpec(
        "tail", (OpSpec("tail/pw", PW, channels, tail_ch, 1, 1, RELU6,
                        bits, bits),),
        avgpool=True))
    blocks.append(BlockSpec(
        "classifier",
        (OpSpec("classifier/fc", DENSE, tail_ch, num_classes, 1, 1, NONE,
                bits, bits),)))
    return NetSpec(
        name=f"dscnn_kws_t{input_t}_c{channels}_bw{bits}",
        blocks=tuple(blocks),
        input_hw=input_t,
        input_ch=input_ch,
        num_classes=num_classes,
    )


def build_har(
    input_t: int = 128,
    input_ch: int = 3,
    stem_channels: int = 48,
    channels: Sequence[int] = (96, 128, 160),
    kernel: int = 5,
    bits: int = 8,
    first_conv_bits: int = 8,
    num_classes: int = 12,
    last_ch: int = 0,
) -> NetSpec:
    """HAR DS-CNN: widening DS blocks, stride-2 temporal downsampling."""
    blocks = [
        BlockSpec("stem", (OpSpec("stem/conv", CONV1D, input_ch,
                                  stem_channels, kernel, 1, RELU6,
                                  first_conv_bits, bits),)),
    ]
    in_ch = stem_channels
    for i, out_ch in enumerate(channels):
        blocks.append(ds_block(f"ds{i}", in_ch, int(out_ch), kernel, 2, bits))
        in_ch = int(out_ch)
    tail_ch = last_ch or 2 * in_ch
    blocks.append(BlockSpec(
        "tail", (OpSpec("tail/pw", PW, in_ch, tail_ch, 1, 1, RELU6,
                        bits, bits),),
        avgpool=True))
    blocks.append(BlockSpec(
        "classifier",
        (OpSpec("classifier/fc", DENSE, tail_ch, num_classes, 1, 1, NONE,
                bits, bits),)))
    return NetSpec(
        name=f"dscnn_har_t{input_t}_bw{bits}",
        blocks=tuple(blocks),
        input_hw=input_t,
        input_ch=input_ch,
        num_classes=num_classes,
    )


__all__ = ["build_kws", "build_har", "ds_block"]
