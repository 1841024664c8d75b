"""Calibrated per-op energy model: route timings × bytes × power curve.

Counterpart of `repro/energy/model.py`: the same accounting, op for op.

The paper's headline metric is FPS/Watt (47.4 for MobileNetV2, 233.3 for
compact EfficientNet on ZCU102). This module reproduces that accounting
in software from data the system already measures:

    op energy = compute term            + memory term
              = busy_w × route_time     + bytes_moved × PJ_PER_BYTE

  * `route_time` comes from the autotuner's committed caches
    (`experiments/tuned/*.json` — the best measured wall time of the
    bit-exact winning route, divided by the batch it was timed at).
    Ops with no cache entry fall back to an analytic MAC count priced
    at per-bit pJ/MAC constants (Horowitz, ISSCC'14 ballpark) — so the
    model degrades gracefully on untuned nets, and `tuned_fraction`
    reports how much of the estimate is measurement-backed.
  * `bytes_moved` is the analytic DDR traffic of the op — input and
    output activations at 1 byte/element (the integer datapath stores
    ≤8-bit activations) plus a single weight stream. This is the term
    the old `_energy_j_per_image` MAC proxy dropped: a DW and a PW op
    with identical MACs differ ~10x in bytes, and now score
    differently.
  * the power curve is a `repro_torch.energy.power.PowerModel` — RAPL-
    calibrated on Linux CPUs where available, per-backend constants
    otherwise (the H100's measured on the card).

Consumers: `VisionEngine`/`StreamEngine` stats (J/image, watts,
FPS/Watt gauges) and the `PowerGovernor` behind
`VisionEngine(power_budget_w=...)`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from repro_torch.core import compiler as CC
from repro_torch.core import graph as G
from repro_torch.energy.power import (
    PowerModel,
    default_backend,
    default_power_model,
)
from repro_torch.tune import cache as TC

# Energy per multiply-accumulate at the op's datapath bit width, in pJ.
# Horowitz ISSCC'14 45nm ballpark, interpolated for the intermediate
# anneal widths. (Moved here from serve/vision/engine.py, where it was
# the whole model; it is now only the fallback compute term for ops
# without a measured route timing.)
PJ_PER_MAC: Dict[int, float] = {8: 0.23, 6: 0.18, 5: 0.15, 4: 0.12, 3: 0.10}
PJ_PER_MAC_DEFAULT = 0.2

# DRAM access energy per byte (LPDDR4-class, ~20 pJ/B). The dominant
# term for memory-bound ops — exactly why DW and PW ops with equal MACs
# must not score equally.
PJ_PER_BYTE = 20.0


def op_pj_per_mac(op: G.OpSpec) -> float:
    """pJ per MAC at the op's *effective* datapath width.

    A MAC multiplies an `op.bits` weight by an activation; pricing by
    weight width alone let a w4/a8 op bill 4-bit MACs while moving and
    multiplying 8-bit activations. The effective width is the wider of
    the two — for uniform w4/a4 nets this reduces to the old `op.bits`
    pricing bit-for-bit."""
    eff = max(op.bits, op.act_bits)
    return PJ_PER_MAC.get(eff, PJ_PER_MAC_DEFAULT)

_TUNED = "tuned"
_ANALYTIC = "analytic"


def op_bytes_moved(op: G.OpSpec, in_hw: Optional[int], rank: int = 2,
                   *, in_bits: Optional[int] = None) -> int:
    """Analytic DDR bytes for one op at batch 1.

    Input activations read + output activations written, packed at their
    activation bit-widths (`in_bits` for the incoming tensor — the
    upstream op's `act_bits`, defaulting to this op's own width when the
    caller doesn't thread the chain — and `op.act_bits` for the output:
    a 4-bit tensor moves half the DDR bytes of an 8-bit one, which is
    exactly the axis the mixed-precision search trades on) plus the
    weight tensor streamed once (1 byte per weight, int32 bias).
    Intermediate SRAM/cache reuse is deliberately not modeled: this is
    the off-chip traffic bound the paper's co-design minimizes."""
    if op.kind == G.DENSE or in_hw is None:
        n_in, n_out = op.in_ch, op.out_ch
    else:
        out_hw = -(-in_hw // op.stride)
        if rank == 1:
            n_in = in_hw * op.in_ch
            n_out = out_hw * op.out_ch
        else:
            n_in = in_hw * in_hw * op.in_ch
            n_out = out_hw * out_hw * op.out_ch
    in_bits = op.act_bits if in_bits is None else int(in_bits)
    act_bytes = (n_in * in_bits + n_out * op.act_bits) / 8.0
    w_bytes = op.n_params(with_bias=False) + 4 * op.out_ch
    return int(math.ceil(act_bytes)) + w_bytes


def op_macs(op: G.OpSpec, in_hw: Optional[int], rank: int = 2) -> int:
    """MACs for one op at batch 1 (the `NetSpec.count_macs` shape walk)."""
    if op.kind == G.DENSE or in_hw is None:
        return op.macs(1, 1)
    out_hw = -(-in_hw // op.stride)
    return op.macs(out_hw, 1 if rank == 1 else out_hw)


@dataclasses.dataclass(frozen=True)
class OpEnergy:
    """One op's modeled cost: where its time came from and both J terms."""

    name: str
    cu: str
    kind: str
    key: str
    us: float  # modeled per-image execution time, microseconds
    source: str  # "tuned" (measured route timing) | "analytic" (pJ/MAC)
    macs: int
    bytes_moved: int
    compute_j: float
    memory_j: float

    @property
    def j(self) -> float:
        return self.compute_j + self.memory_j


@dataclasses.dataclass(frozen=True)
class EnergyReport:
    """Modeled energy of one net on one device power curve."""

    net: str
    backend: str
    power: PowerModel
    ops: Tuple[OpEnergy, ...]

    @property
    def j_per_image(self) -> float:
        return sum(o.j for o in self.ops)

    @property
    def us_per_image(self) -> float:
        return sum(o.us for o in self.ops)

    @property
    def tuned_fraction(self) -> float:
        """Fraction of ops priced from measured route timings."""
        if not self.ops:
            return 0.0
        return sum(1 for o in self.ops if o.source == _TUNED) / len(self.ops)

    def watts(self, fps: float) -> float:
        """Average device watts while serving `fps` images/s."""
        return self.power.idle_w + self.j_per_image * max(fps, 0.0)

    def fps_per_watt(self, fps: float) -> float:
        w = self.watts(fps)
        return fps / w if w > 0 else 0.0

    def per_cu(self) -> Dict[str, float]:
        """Joules per image broken down by CU."""
        out: Dict[str, float] = {}
        for o in self.ops:
            out[o.cu] = out.get(o.cu, 0.0) + o.j
        return out

    def as_dict(self) -> Dict[str, object]:
        return {
            "net": self.net,
            "backend": self.backend,
            "power": self.power.as_dict(),
            "j_per_image": self.j_per_image,
            "us_per_image": self.us_per_image,
            "tuned_fraction": self.tuned_fraction,
            "per_cu_j": self.per_cu(),
            "n_ops": len(self.ops),
        }


def _se_ops(block: G.BlockSpec) -> Tuple[G.OpSpec, ...]:
    if block.se is None:
        return ()
    return (block.se.squeeze, block.se.excite)


def estimate_energy(
    qnet,
    plan: Optional[CC.CUPlan] = None,
    *,
    tuned: Optional[TC.TunedPlan] = None,
    power: Optional[PowerModel] = None,
    backend: Optional[str] = None,
) -> EnergyReport:
    """Model per-image energy for `qnet` (anything with a `.spec` NetSpec).

    Walks the compiled plan's op descriptors in schedule order. Each op's
    execution time comes from the tuned cache when a shape-keyed entry
    exists (`us / tuned_batch` — the route actually served), otherwise
    from the analytic pJ/MAC table; either way the analytic bytes-moved
    term is added on top. SE squeeze/excite ops (not enumerated by the
    autotuner — they ride inside the Body CU invocation) are priced
    analytically at their pooled 1x1 spatial size.

    `backend` is the serving device's type (the engines pass theirs); with
    none given it is the cache's, else CUDA, which must be there."""
    spec: G.NetSpec = getattr(qnet, "spec", qnet)
    plan = plan if plan is not None else CC.compile_net(spec)
    if backend is None:
        if tuned is not None:
            backend = tuned.backend
        else:
            backend = default_backend()
    power = power if power is not None else default_power_model(backend)
    rank = spec.spatial_rank
    per_image = max(tuned.tuned_batch, 1) if tuned is not None else 1

    ops = []
    seen_se = set()
    # incoming activation width, threaded op to op in schedule order (the
    # same `cur_bits = op.act_bits` chain `cu.prepare_qnet` walks); the
    # input image is quantized at 8 bits
    cur_bits = 8
    for cu, block, op, in_hw in plan.op_descriptors():
        key = TC.op_key(op, in_hw, backend, rank)
        macs = op_macs(op, in_hw, rank)
        nbytes = op_bytes_moved(op, in_hw, rank, in_bits=cur_bits)
        cur_bits = op.act_bits
        entry = tuned.entries.get(key) if tuned is not None else None
        if entry is not None and entry.us > 0:
            us = entry.us / per_image
            compute_j = power.busy_w * us * 1e-6
            source = _TUNED
        else:
            compute_j = macs * op_pj_per_mac(op) * 1e-12
            us = compute_j / power.busy_w * 1e6
            source = _ANALYTIC
        memory_j = nbytes * PJ_PER_BYTE * 1e-12
        ops.append(OpEnergy(
            name=op.name, cu=cu, kind=op.kind, key=key, us=us, source=source,
            macs=macs, bytes_moved=nbytes, compute_j=compute_j,
            memory_j=memory_j,
        ))
        if block.se is not None and block.name not in seen_se:
            seen_se.add(block.name)
            for se_op in _se_ops(block):
                se_macs = op_macs(se_op, 1, rank)
                se_bytes = op_bytes_moved(se_op, 1, rank)
                se_cj = se_macs * op_pj_per_mac(se_op) * 1e-12
                ops.append(OpEnergy(
                    name=f"{block.name}/{se_op.name}", cu=cu, kind=se_op.kind,
                    key="", us=se_cj / power.busy_w * 1e6, source=_ANALYTIC,
                    macs=se_macs, bytes_moved=se_bytes, compute_j=se_cj,
                    memory_j=se_bytes * PJ_PER_BYTE * 1e-12,
                ))
    return EnergyReport(net=spec.name, backend=backend, power=power,
                        ops=tuple(ops))


def analytic_energy_j(spec: G.NetSpec) -> float:
    """Pure-analytic J/image (MAC + bytes terms, no timings, no power).

    The corrected successor of the deleted `_energy_j_per_image` MAC
    proxy: same pJ/MAC table, but DDR traffic is now priced too, so ops
    with equal MACs and different bytes-moved no longer tie."""
    total = 0.0
    rank = spec.spatial_rank
    plan = CC.compile_net(spec)
    cur_bits = 8
    for _, block, op, in_hw in plan.op_descriptors():
        total += op_macs(op, in_hw, rank) * op_pj_per_mac(op) * 1e-12
        total += (op_bytes_moved(op, in_hw, rank, in_bits=cur_bits)
                  * PJ_PER_BYTE * 1e-12)
        cur_bits = op.act_bits
    return total


def edp_score(time_s: float, bytes_moved: int, power: PowerModel) -> float:
    """Energy-delay product for route selection: (P·t + bytes·pJ/B) · t.

    The JAX package's autotuner scores `objective="edp"` candidates with
    it, so the tuner and the serving-side model price them identically. With equal
    bytes (per-op candidates of one op) the score is monotone in t and
    EDP selection degenerates to latency selection; the term that can
    flip a winner is block-level traffic (fused IRB keeps intermediates
    on-chip, per-op spills them)."""
    if time_s <= 0 or not math.isfinite(time_s):
        return math.inf
    energy_j = power.busy_w * time_s + bytes_moved * PJ_PER_BYTE * 1e-12
    return energy_j * time_s


__all__ = [
    "PJ_PER_BYTE",
    "PJ_PER_MAC",
    "PJ_PER_MAC_DEFAULT",
    "EnergyReport",
    "OpEnergy",
    "analytic_energy_j",
    "edp_score",
    "estimate_energy",
    "op_bytes_moved",
    "op_macs",
    "op_pj_per_mac",
]
