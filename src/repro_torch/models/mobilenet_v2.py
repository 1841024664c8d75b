"""MobileNet-V2 NetSpec construction with the paper's tunable knobs (Sec. 2, 5.1).

Knobs:  alpha (width multiplier, scales channel counts), H (input resolution),
        BW (bit-width; first normal conv at 8 bits, the rest at BW — Sec. 5.1).

Topology follows the original [Sandler et al. 2018] inverted-residual stack:
    stem conv 3x3 s2 -> 17 IRBs -> pw 1280 -> avgpool -> classifier.
The paper's CU mapping (Fig. 15): Head = stem conv + IRB_0 (the special t=1
block, 'called once'); Body = the remaining 16 IRBs; Tail = pw-1280 + avgpool;
Classifier = dense 1280 -> k.
"""
from __future__ import annotations

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
)

# (expansion t, out channels c, repeats n, first stride s)
IRB_SETTINGS: Tuple[Tuple[int, int, int, int], ...] = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


def _make_divisible(v: float, divisor: int = 8) -> int:
    """Standard MobileNet channel rounding (keeps channels MXU/SIMD friendly)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def irb_block(
    name: str, in_ch: int, out_ch: int, t: int, stride: int, bits: int
) -> BlockSpec:
    """Inverted Residual Block (Fig. 3a): pw-expand -> dw -> pw-project."""
    hidden = in_ch * t
    ops = []
    if t != 1:
        ops.append(OpSpec(f"{name}/expand", PW, in_ch, hidden, 1, 1, RELU6, bits, bits))
    ops.append(OpSpec(f"{name}/dw", DW, hidden, hidden, 3, stride, RELU6, bits, bits))
    # projection conv is linear (no activation) — embeds into lower dimension
    ops.append(OpSpec(f"{name}/project", PW, hidden, out_ch, 1, 1, NONE, bits, bits))
    residual = stride == 1 and in_ch == out_ch
    return BlockSpec(name, tuple(ops), residual=residual)


def build(
    alpha: float = 1.0,
    input_hw: int = 224,
    bits: int = 4,
    first_conv_bits: int = 8,
    num_classes: int = 1000,
    round_nearest: int = 8,
) -> NetSpec:
    stem_ch = _make_divisible(32 * alpha, round_nearest)
    blocks = []
    # --- Head: stem normal conv (the single 'normal convolution' of a DSCNN) ---
    blocks.append(
        BlockSpec(
            "stem",
            (
                OpSpec(
                    "stem/conv", CONV, 3, stem_ch, 3, 2, RELU6, first_conv_bits, bits
                ),
            ),
        )
    )
    in_ch = stem_ch
    idx = 0
    for t, c, n, s in IRB_SETTINGS:
        out_ch = _make_divisible(c * alpha, round_nearest)
        for i in range(n):
            stride = s if i == 0 else 1
            blocks.append(irb_block(f"irb{idx}", in_ch, out_ch, t, stride, bits))
            in_ch = out_ch
            idx += 1
    # --- Tail: pw 1280 + global average pool ---
    last_ch = _make_divisible(1280 * max(1.0, alpha), round_nearest)
    blocks.append(
        BlockSpec(
            "tail",
            (OpSpec("tail/pw", PW, in_ch, last_ch, 1, 1, RELU6, bits, bits),),
            avgpool=True,
        )
    )
    # --- Classifier ---
    blocks.append(
        BlockSpec(
            "classifier",
            (OpSpec("classifier/fc", DENSE, last_ch, num_classes, 1, 1, NONE, bits, bits),),
        )
    )
    return NetSpec(
        name=f"mobilenet_v2_a{alpha}_h{input_hw}_bw{bits}",
        blocks=tuple(blocks),
        input_hw=input_hw,
        num_classes=num_classes,
    )


__all__ = ["build", "irb_block", "IRB_SETTINGS"]
