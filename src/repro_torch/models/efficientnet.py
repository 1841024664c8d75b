"""Compact EfficientNet NetSpec construction (paper Sec. 5.2, Fig. 3b / Fig. 19).

EfficientNet IRB = pw-expand -> dw -> [SE: global-pool -> PW-SQ -> PW-EX ->
hard-sigmoid gate] -> pw-project, with the skip-line when stride=1 and
channels match. The paper compresses the baseline with smaller width (alpha),
depth, and H ('compound model scaling') to reach an edge-deployable model:
H=128, 7.81 Mb at BW=4, 4.914 M ops/inference, Body CU invoked 9 times.

`build_compact` reproduces that 9-body-invocation structure; `build` exposes
full compound scaling (width/depth/resolution) for design exploration.
"""
from __future__ import annotations

import math
from typing import Tuple

from repro_torch.core.graph import (
    CONV,
    DENSE,
    DW,
    NONE,
    PW,
    RELU6,
    BlockSpec,
    NetSpec,
    OpSpec,
    SESpec,
)
from repro_torch.models.mobilenet_v2 import _make_divisible

# EfficientNet-B0 baseline stage settings:
# (expansion t, out channels c, repeats n, stride s, kernel k)
B0_SETTINGS: Tuple[Tuple[int, int, int, int, int], ...] = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)


def mbconv_block(
    name: str,
    in_ch: int,
    out_ch: int,
    t: int,
    stride: int,
    kernel: int,
    bits: int,
    se_ratio: float = 0.25,
) -> BlockSpec:
    hidden = in_ch * t
    ops = []
    if t != 1:
        ops.append(OpSpec(f"{name}/expand", PW, in_ch, hidden, 1, 1, RELU6, bits, bits))
    dw_name = f"{name}/dw"
    ops.append(OpSpec(dw_name, DW, hidden, hidden, kernel, stride, RELU6, bits, bits))
    ops.append(OpSpec(f"{name}/project", PW, hidden, out_ch, 1, 1, NONE, bits, bits))
    se = None
    if se_ratio > 0:
        reduced = max(1, int(in_ch * se_ratio))
        se = SESpec(channels=hidden, reduced=reduced, bits=bits, prefix=f"{name}/se")
    residual = stride == 1 and in_ch == out_ch
    return BlockSpec(name, tuple(ops), residual=residual, se=se, se_after=dw_name)


def build(
    width: float = 1.0,
    depth: float = 1.0,
    input_hw: int = 224,
    bits: int = 4,
    first_conv_bits: int = 8,
    num_classes: int = 1000,
    se_ratio: float = 0.25,
) -> NetSpec:
    stem_ch = _make_divisible(32 * width)
    blocks = [
        BlockSpec(
            "stem",
            (OpSpec("stem/conv", CONV, 3, stem_ch, 3, 2, RELU6, first_conv_bits, bits),),
        )
    ]
    in_ch = stem_ch
    idx = 0
    for t, c, n, s, k in B0_SETTINGS:
        out_ch = _make_divisible(c * width)
        repeats = int(math.ceil(n * depth))
        for i in range(repeats):
            stride = s if i == 0 else 1
            blocks.append(
                mbconv_block(f"mb{idx}", in_ch, out_ch, t, stride, k, bits, se_ratio)
            )
            in_ch = out_ch
            idx += 1
    head_ch = _make_divisible(1280 * width)
    blocks.append(
        BlockSpec(
            "tail",
            (OpSpec("tail/pw", PW, in_ch, head_ch, 1, 1, RELU6, bits, bits),),
            avgpool=True,
        )
    )
    blocks.append(
        BlockSpec(
            "classifier",
            (OpSpec("classifier/fc", DENSE, head_ch, num_classes, 1, 1, NONE, bits, bits),),
        )
    )
    return NetSpec(
        name=f"efficientnet_w{width}_d{depth}_h{input_hw}_bw{bits}",
        blocks=tuple(blocks),
        input_hw=input_hw,
        num_classes=num_classes,
    )


def build_compact(
    input_hw: int = 128, bits: int = 4, num_classes: int = 1000
) -> NetSpec:
    """The paper's compressed EfficientNet: Body CU invoked 9 times (Fig. 19),
    i.e. 10 MBConv blocks with the first mapped into the Head CU.

    The paper does not publish its compound-scaling factors; width=0.65,
    depth=0.5 reproduces the structural constraints it does publish (9 Body
    invocations, H=128) and lands within 6% of its 7.81 Mb model size."""
    net = build(width=0.65, depth=0.5, input_hw=input_hw, bits=bits, num_classes=num_classes)
    return NetSpec(
        name=f"efficientnet_compact_h{input_hw}_bw{bits}",
        blocks=net.blocks,
        input_hw=input_hw,
        num_classes=num_classes,
    )


__all__ = ["build", "build_compact", "mbconv_block", "B0_SETTINGS"]
