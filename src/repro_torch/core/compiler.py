"""Network SoC Compiler analogue (Sec. 4.2).

Observes the network graph and partitions it into the four heterogeneous CU
classes based on operator recurrence — exactly the paper's rule:

  * Head       : the stem normal conv + the first (non-repeating) block
  * Body       : the repeated block pattern, invoked j times
  * Tail       : pointwise + global average pool feeding the classifier
  * Classifier : the dense mapping to k classes

It also derives the paper's architecture knobs: per-CU ParallelOps
(Eqs. 8-10: K_max^2 * N_max for dw/normal conv, N_max for pointwise), buffer
sizing from the maximum feature-map job, and the invocation schedule the host
would run. In the PyTorch port the 'hardware generation' step becomes one
stage executor per CU signature (`serve/vision/stages.py`), whose Body blocks
run through the hand-written fused-IRB kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core import graph as G

HEAD, BODY, TAIL, CLASSIFIER = "head", "body", "tail", "classifier"


@dataclasses.dataclass(frozen=True)
class CUAssignment:
    cu: str  # head | body | tail | classifier
    block: G.BlockSpec
    invocation: int  # order in the host schedule


@dataclasses.dataclass(frozen=True)
class StageSignature:
    """Shape contract of one CU stage (the 'AXI job descriptor' analogue).

    `in_hw`/`out_hw` are None once the tensor is spatially collapsed (after
    the Tail CU's global pool / in the Classifier CU)."""

    cu: str
    blocks: Tuple[G.BlockSpec, ...]
    in_hw: Optional[int]
    in_ch: int
    out_hw: Optional[int]
    out_ch: int

    @property
    def invocations(self) -> int:
        return len(self.blocks)


@dataclasses.dataclass
class CUPlan:
    net: G.NetSpec
    schedule: Tuple[CUAssignment, ...]
    # optional measured per-op route selection (repro_torch.tune.TunedPlan);
    # the stage compiler picks it up when the caller does not pass one
    tuned: Optional[object] = None

    @property
    def body_invocations(self) -> int:
        return sum(1 for a in self.schedule if a.cu == BODY)

    def blocks_for(self, cu: str) -> List[G.BlockSpec]:
        return [a.block for a in self.schedule if a.cu == cu]

    def stage_groups(self) -> Tuple[Tuple[str, Tuple[G.BlockSpec, ...]], ...]:
        """Contiguous same-CU runs of the schedule, in invocation order.

        This is the pipeline a serving engine executes: each group becomes
        one stage executor, invoked once per micro-batch. Raises if a CU
        role recurs non-contiguously (no such network exists under the
        recurrence partitioning rule, but a hand-built schedule could)."""
        groups: List[Tuple[str, List[G.BlockSpec]]] = []
        for a in self.schedule:
            if groups and groups[-1][0] == a.cu:
                groups[-1][1].append(a.block)
            else:
                groups.append((a.cu, [a.block]))
        seen = [cu for cu, _ in groups]
        if len(set(seen)) != len(seen):
            raise ValueError(f"non-contiguous CU schedule: {seen}")
        return tuple((cu, tuple(blocks)) for cu, blocks in groups)

    def op_descriptors(self) -> Tuple[Tuple[str, G.BlockSpec, G.OpSpec,
                                            Optional[int]], ...]:
        """Per-op job descriptors: (cu, block, op, in_hw) in schedule order.

        `in_hw` is the spatial size of the op's input tensor (None once the
        tensor is collapsed — DENSE after the Tail's global pool). This is
        the shape walk the route autotuner keys its per-op cache on: the
        same (kind, shape, act_bits) op in two nets resolves to the same
        tuning-cache entry. SE squeeze/excite ops are not enumerated: the
        cache keys neither (the stage compiler routes the squeeze by
        default, `TunedPlan.resolve_with_defaults`)."""
        descs: List[Tuple[str, G.BlockSpec, G.OpSpec, Optional[int]]] = []
        hw: Optional[int] = self.net.input_hw
        for a in self.schedule:
            for op in a.block.ops:
                descs.append((a.cu, a.block, op, hw))
                if op.kind == G.DENSE:
                    hw = None
                elif hw is not None:
                    hw = -(-hw // op.stride)
            if a.block.avgpool:
                hw = None
        return tuple(descs)

    def stage_signatures(self) -> Tuple[StageSignature, ...]:
        """Lower the schedule into per-stage shape signatures (what each
        stage executor consumes/produces for batch size 1)."""
        sigs: List[StageSignature] = []
        hw: Optional[int] = self.net.input_hw
        ch = self.net.input_ch
        for cu, blocks in self.stage_groups():
            in_hw, in_ch = hw, ch
            for b in blocks:
                for op in b.ops:
                    if op.kind == G.DENSE:
                        hw = None
                    elif hw is not None:
                        hw = -(-hw // op.stride)
                    ch = op.out_ch
                if b.avgpool:
                    hw = None
            sigs.append(StageSignature(cu, blocks, in_hw, in_ch, hw, ch))
        return tuple(sigs)

    # ---- architecture knobs (paper Sec. 4.1) ----

    def parallel_ops(self) -> Dict[str, int]:
        """Eq. 8/9/10: ParallelOps per operator class across the network."""
        k_dw = n_dw = k_nc = n_nc = n_pw_exp = n_pw_proj = 0
        for _, op in self.net.all_ops():
            if op.kind == G.DW:
                k_dw = max(k_dw, op.kernel)
                n_dw = max(n_dw, op.in_ch)
            elif op.kind == G.CONV:
                k_nc = max(k_nc, op.kernel)
                n_nc = max(n_nc, op.in_ch)
            elif op.kind == G.PW:
                if op.out_ch >= op.in_ch:
                    n_pw_exp = max(n_pw_exp, op.in_ch)
                else:
                    n_pw_proj = max(n_pw_proj, op.in_ch)
        return {
            "dw": k_dw * k_dw * n_dw,  # Eq. 8
            "conv": k_nc * k_nc * n_nc,  # Eq. 9
            "pw_expansion": n_pw_exp,  # Eq. 10 (per pointwise type)
            "pw_projection": n_pw_proj,
        }

    def buffer_bytes(self) -> Dict[str, int]:
        """Max per-CU activation 'job' footprint (the paper sizes Body CU
        buffers for the most memory-bound IRB). Bytes at each op's act BW."""
        out: Dict[str, int] = {}
        h = self.net.input_hw
        rank = self.net.spatial_rank
        for a in self.schedule:
            peak = 0
            for op in a.block.ops:
                if op.kind == G.DENSE:
                    elems = op.in_ch + op.out_ch
                else:
                    h_out = -(-h // op.stride)
                    in_sp = h if rank == 1 else h * h
                    out_sp = h_out if rank == 1 else h_out * h_out
                    elems = in_sp * op.in_ch + out_sp * op.out_ch
                    h = h_out
                peak = max(peak, (elems * op.act_bits + 7) // 8)
            out[a.cu] = max(out.get(a.cu, 0), peak)
        return out


def compile_net(net: G.NetSpec, tuned: Optional[object] = None) -> CUPlan:
    """Partition blocks into CUs by recurrence (paper Sec. 4.2.1).

    Rule: the stem (normal conv) and the first instance of the repeating
    block pattern form the Head; the remaining repeats form the Body; the
    final pointwise+avgpool is the Tail; the dense layer the Classifier.

    `tuned` (a `repro_torch.tune.TunedPlan`) rides on the plan: the stage
    compiler consults it for the measured per-op route selection.
    """
    blocks = list(net.blocks)
    schedule: List[CUAssignment] = []
    inv = 0

    # classify structurally
    roles: List[str] = []
    seen_repeat = False
    for i, b in enumerate(blocks):
        is_dense_only = all(op.kind == G.DENSE for op in b.ops)
        if is_dense_only:
            roles.append(CLASSIFIER)
        elif b.avgpool:
            roles.append(TAIL)
        elif i == 0 or not seen_repeat:
            roles.append(HEAD)
            # the first IRB-like block (multi-op) after the stem completes the Head
            if len(b.ops) >= 2 or i > 0:
                seen_repeat = True
        else:
            roles.append(BODY)

    for b, role in zip(blocks, roles):
        schedule.append(CUAssignment(role, b, inv))
        inv += 1
    return CUPlan(net, tuple(schedule), tuned=tuned)


__all__ = ["CUPlan", "CUAssignment", "compile_net", "HEAD", "BODY", "TAIL", "CLASSIFIER"]
