"""Stage compiler: `CUPlan` schedule -> one executor per CU stage.

Counterpart of `repro/serve/vision/stages.py`. Each contiguous run of
same-role CU invocations (Head, Body, Tail, Classifier) becomes one
`CompiledStage`: a pure tensor -> tensor map whose quantizer handoff is
static (`cu.propagate_qparams`), so the chain is bit-exact with the
monolithic `cu.run_qnet`.

The integer datapath of a stage runs each block on one of two paths: the
fused-IRB kernel K4 (a block in `fused_blocks`, the expanded tensor kept on
chip), or `cu.run_block`, whose ops take the routes attached to the
prepared net (the kernels K2 / K3 or a torch-op formulation; an unrouted
op runs the reference torch op). Both sets come from one resolution,
`TunedPlan.resolve_with_defaults`: `tuned=` (a `repro_torch.tune.TunedPlan`,
or `plan.tuned`) gives the measured selection, and its misses, or every op
without a cache, take the defaults of two flags:

  * `op_kernels`: DW through K3, PW/DENSE and the SE squeeze through K2;
  * `body_fast_path`: each fusable Body block through K4.

Both flags are "auto" (on when the device is CUDA), "on" or "off". On the
CPU the kernel wrappers run their plain PyTorch versions, so "on" there
exercises the same routing with the same bits. A partial or foreign cache
therefore serves the untuned route wherever it has no entry.

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

Replication (`mesh=`, a `repro_torch.dist.sharding.data_mesh`): every
device of the mesh holds its own prepared net (`cu.prepare_qnet(mesh=)`),
with the routes resolved once; a stage takes a batch-sharded micro-batch
(`sharding.Sharded`, its row blocks in replica order) and runs each
replica's block through that replica's net, so the blocks stay split along
the whole chain with no gather between CUs, as the reference's
`in_shardings`/`out_shardings` keep them. Trace accounting counts the
whole micro-batch, as the reference's jit sees it. A mesh of one device
is that device: the stages take and give plain tensors.
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
from repro_torch.dist.sharding import Sharded
from repro_torch.kernels import ops as K
from repro_torch.tune.cache import TunedPlan


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
    """One CU stage as a callable on tensors of the prepared net's device
    (on a `ReplicatedQNet`, on batch-sharded values of its mesh).
    `invocations` counts the micro-batches it ran, `traces` the distinct
    input shapes it has seen and `retraces` those outside
    `allowed_batches`."""

    def __init__(self, spec: StageSpec,
                 pq: Union[cu.PreparedQNet, cu.ReplicatedQNet], *,
                 input_bits: int, fixed_point: bool = False,
                 fused_blocks: frozenset = frozenset()):
        self.spec = spec
        self.pq = pq  # its routes are the ops' resolved routes
        self._input_bits = input_bits
        self._fixed_point = fixed_point
        self.fused_blocks = fused_blocks  # the blocks that run K4
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

    def run(self, x: Union[torch.Tensor, Sharded]
            ) -> Union[torch.Tensor, Sharded]:
        """The stage's function, without counting an invocation."""
        self._note_shape(x)
        if isinstance(self.pq, cu.ReplicatedQNet):
            if not isinstance(x, Sharded) or x.mesh != self.pq.mesh:
                raise ValueError(f"stage {self.spec.cu}: replicated on "
                                 f"{self.pq.mesh}, given {x!r}")
            reps = self.pq.replicas
            return x.map(lambda part, i: self._run(part, reps[i]))
        return self._run(x, self.pq)

    def _run(self, x: torch.Tensor, pq: cu.PreparedQNet) -> torch.Tensor:
        spec = self.spec
        y = x
        if spec.quantizes_input:
            y = cu.quantize_input(y, pq.input_scale, spec.in_zp,
                                  self._input_bits)
        s, z = spec.in_scale, spec.in_zp
        for block in spec.blocks:
            if block.name in self.fused_blocks:
                y, s, z = K.run_irb_block(y, block, pq, s, z)
            else:
                y, s, z = cu.run_block(y, block, pq, s, z,
                                       self._fixed_point)
        if spec.dequantizes_output:
            y = cu.dequantize(y, s, z)
        return y

    def __call__(self, x: Union[torch.Tensor, Sharded]
                 ) -> Union[torch.Tensor, Sharded]:
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
    tuned=None,
    mesh=None,
) -> List[CompiledStage]:
    """Lower a CUPlan into the ordered list of stage executors.

    The net is prepared on `device` (CUDA unless the caller passes another;
    a `PreparedQNet` must already live there) with the routes resolved from
    `tuned` (or `plan.tuned`, or no cache) and the flags for this device's
    backend (see the module docstring); they replace any routes the net
    carries. Tuned routes are float-requant formulations, so `tuned`
    refuses `fixed_point=True`; the kernels' epilogue is float-multiplier
    only, so fixed point turns "auto" flags off and refuses "on".

    `mesh`: a mesh with a 'data' axis (`dist.sharding.data_mesh`)
    replicates the whole executor chain: the net is prepared on the mesh's
    first device (`device`, if given, must be it), its routes resolved
    there, and every device gets its own copy (`cu.prepare_qnet(mesh=)`);
    micro-batch rows are split along 'data' in and out of every stage.
    Batch sizes must divide by the replica count. `None` (default) is the
    single-device configuration."""
    if mesh is not None:
        if "data" not in mesh.axis_names:
            raise ValueError(
                f"mesh needs a 'data' axis, got {mesh.axis_names}")
        qnet = cu.mesh_base(qnet, mesh, device)
        device = mesh.device_list[0]
    pq = cu.prepare_qnet(qnet, input_bits=input_bits, device=device)
    if plan is None:
        plan = CC.compile_net(pq.spec)
    if tuned is None:
        tuned = plan.tuned
    fast = _resolve(body_fast_path, "body_fast_path", pq.device)
    kerns = _resolve(op_kernels, "op_kernels", pq.device)
    if fixed_point:
        if tuned is not None:
            raise ValueError(
                "tuned= carries float-requant routes only and cannot serve "
                "fixed_point=True")
        if body_fast_path == "on" or op_kernels == "on":
            raise ValueError(
                "body_fast_path/op_kernels='on' is incompatible with "
                "fixed_point=True (the kernels have no fixed-point requant "
                "mode)")
        fast = kerns = False
    if tuned is None:
        tuned = TunedPlan(backend=pq.device.type, nets=(), tuned_batch=0,
                          entries={})
    op_routes, fused = tuned.resolve_with_defaults(
        pq.spec, plan, backend=pq.device.type, op_kernels=kerns,
        body_fast_path=fast)
    pq = cu.prepare_qnet(pq, device=pq.device, routes=op_routes, mesh=mesh)
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
                                    fixed_point=fixed_point,
                                    fused_blocks=frozenset(fused)))
        s, z = out_s, out_z
    return stages


__all__ = ["StageSpec", "CompiledStage", "compile_stages"]
