"""Stage compiler: `CUPlan` schedule -> one executor per CU stage.

Counterpart of `repro/serve/vision/stages.py`. Each contiguous run of
same-role CU invocations (Head, Body, Tail, Classifier) becomes one
`CompiledStage`: a pure tensor -> tensor map whose quantizer handoff is
static (`cu.propagate_qparams`), so the chain is bit-exact with the
monolithic `cu.run_qnet`.

The integer datapath of a stage runs on one of three op implementations:

  * the reference torch ops of `core/cu.py` (`run_block`);
  * the per-op kernels (`op_kernels`): DW through the depthwise kernel,
    PW/DENSE through the pointwise kernel, in every stage;
  * the fused-IRB kernel (`body_fast_path`): each fusable Body block as one
    kernel that keeps the expanded tensor on chip.

Both flags are "auto" (on when the device is CUDA), "on" or "off". On the
CPU the kernel wrappers run their plain PyTorch versions, so "on" there
exercises the same routing with the same bits.

Retrace accounting: the JAX package traces a stage once per novel input
shape (its `jax.jit` cache) and counts a trace at a batch size outside
`allowed_batches` (the engine's buckets) as a leak past the batch former.
Torch does not trace; each stage counts what that cache would: its first
call at each (shape, dtype) is a `trace`, and one outside
`allowed_batches` is a `retrace`, warned about (`RuntimeWarning`) and
reported to `on_retrace`.

`fixed_point=True` serves the integer mantissa/shift requant. The kernels'
epilogue is float-multiplier only (in the reference's Pallas kernels too),
so fixed point runs the reference torch ops: "auto" flags resolve to off,
and "on" with fixed point raises.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, List, Optional, Tuple, Union

import torch

from repro_torch.core import compiler as CC
from repro_torch.core import cu
from repro_torch.core import graph as G
from repro_torch.core.qnet import QNet
from repro_torch.kernels import ops as K


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """Everything one CU stage executor needs besides the net's constants."""

    cu: str
    blocks: Tuple[G.BlockSpec, ...]
    in_scale: float
    in_zp: float
    out_scale: float
    out_zp: float
    quantizes_input: bool  # Head: float image -> int activations
    dequantizes_output: bool  # Classifier: int logits -> float logits
    signature: CC.StageSignature


class CompiledStage:
    """One CU stage as a callable on tensors of the prepared net's device.
    `invocations` counts the micro-batches it ran, `traces` the distinct
    input shapes it has seen and `retraces` those outside
    `allowed_batches`."""

    def __init__(self, spec: StageSpec, pq: cu.PreparedQNet, *,
                 input_bits: int, fast_path: bool, op_kernels: bool,
                 fixed_point: bool = False):
        self.spec = spec
        self.pq = pq
        self._input_bits = input_bits
        self._fixed_point = fixed_point
        self._fast_path = fast_path and spec.cu == CC.BODY
        self._op_kernels = op_kernels
        self.invocations = 0  # CU invocations dispatched (micro-batches)
        self.traces = 0  # novel input shapes (the reference's jit misses)
        self._shapes: set = set()
        # the batch sizes the engine may legally present (its buckets); a
        # first call at any other leading dim is a retrace leak
        self.allowed_batches: Optional[frozenset] = None
        self.retraces = 0
        self.on_retrace: Optional[Callable[["CompiledStage", Tuple[int, ...]],
                                           None]] = None

    def _note_shape(self, x: torch.Tensor) -> None:
        """Count a first call at this input shape as the reference's jit
        would count a trace, and a leak where the batch is not a bucket."""
        key = (x.shape, x.dtype)
        if key in self._shapes:
            return
        self._shapes.add(key)
        self.traces += 1
        if (self.allowed_batches is not None
                and x.shape[0] not in self.allowed_batches):
            self.retraces += 1
            warnings.warn(
                f"stage {self.spec.cu}: retrace at non-bucketed batch "
                f"shape {tuple(x.shape)} (buckets "
                f"{sorted(self.allowed_batches)}) — a caller bypassed the "
                f"batch former",
                RuntimeWarning, stacklevel=3)
            if self.on_retrace is not None:
                self.on_retrace(self, tuple(x.shape))

    def run(self, x: torch.Tensor) -> torch.Tensor:
        """The stage's function, without counting an invocation."""
        self._note_shape(x)
        spec, pq = self.spec, self.pq
        y = x
        if spec.quantizes_input:
            y = cu.quantize_input(y, pq.input_scale, spec.in_zp,
                                  self._input_bits)
        s, z = spec.in_scale, spec.in_zp
        for block in spec.blocks:
            if self._fast_path and K.fusable_irb(block):
                y, s, z = K.run_irb_block(y, block, pq, s, z)
            elif self._op_kernels:
                y, s, z = K.run_block_kernels(y, block, pq, s, z)
            else:
                y, s, z = cu.run_block(y, block, pq, s, z,
                                       self._fixed_point)
        if spec.dequantizes_output:
            y = cu.dequantize(y, s, z)
        return y

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.invocations += 1
        return self.run(x)


def _resolve(flag: str, name: str, device: torch.device) -> bool:
    if flag not in ("auto", "on", "off"):
        raise ValueError(f"{name}={flag!r}")
    return device.type == "cuda" if flag == "auto" else flag == "on"


def compile_stages(
    qnet: Union[QNet, cu.PreparedQNet],
    plan: Optional[CC.CUPlan] = None,
    *,
    input_bits: int = 8,
    body_fast_path: str = "auto",
    op_kernels: str = "auto",
    fixed_point: bool = False,
    device=None,
) -> List[CompiledStage]:
    """Lower a CUPlan into the ordered list of stage executors.

    The net is prepared on `device` (CUDA unless the caller passes another;
    a `PreparedQNet` must already live there)."""
    pq = cu.prepare_qnet(qnet, input_bits=input_bits, device=device)
    if plan is None:
        plan = CC.compile_net(pq.spec)
    fast = _resolve(body_fast_path, "body_fast_path", pq.device)
    kerns = _resolve(op_kernels, "op_kernels", pq.device)
    if fixed_point and (fast or kerns):
        # the kernels' requant epilogue is float-multiplier only; serving
        # through them would not be run_qnet(fixed_point=True)
        if body_fast_path == "on" or op_kernels == "on":
            raise ValueError(
                "body_fast_path/op_kernels='on' is incompatible with "
                "fixed_point=True (the kernels have no fixed-point requant "
                "mode)")
        fast = kerns = False
    sigs = plan.stage_signatures()
    stages: List[CompiledStage] = []
    s, z = cu.input_qparams(pq)
    for i, sig in enumerate(sigs):
        out_s, out_z = cu.propagate_qparams(sig.blocks, pq, s, z)
        spec = StageSpec(
            cu=sig.cu, blocks=sig.blocks, in_scale=s, in_zp=z,
            out_scale=out_s, out_zp=out_z, quantizes_input=(i == 0),
            dequantizes_output=(i == len(sigs) - 1), signature=sig)
        stages.append(CompiledStage(spec, pq, input_bits=input_bits,
                                    fast_path=fast, op_kernels=kerns,
                                    fixed_point=fixed_point))
        s, z = out_s, out_z
    return stages


__all__ = ["StageSpec", "CompiledStage", "compile_stages"]
