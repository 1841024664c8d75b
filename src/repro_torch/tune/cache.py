"""Tuning cache: measured per-op route selections as a committed artifact.

Counterpart of `repro/tune/cache.py`. A `TunedPlan` is the output of the
route autotuner (`repro_torch.tune.autotune`): for every operator of a
`CUPlan` — keyed by op kind, input shape, act bits and backend, NOT by op
name — it records which bit-exact route won the measurement and the
timings that justified it; at the block level, whether a fusable IRB runs
the fused kernel.

The route names are the JAX package's strings, so a cache written by
either package loads in the other. In the port `int_ref` is the float64
torch-op formulation (exact for every int8 x uint8 accumulation; the JAX
package's int32 XLA ops), `int_f32` the float32 one, `dw_shifts` the
shifted multiply-adds, and `pallas_pw` / `pallas_dw` / `fused_irb` mean the
hand-written kernels K2 / K3 / K4 (`kernels/ops.py`).

Shape keys make the cache portable: two nets sharing an op shape resolve
to the same entry, and an op with no entry keeps its default route, so a
cache can be partial, stale or empty without ever being wrong. The backend
is part of the key and is the serving device's type (`"cuda"`, `"cpu"`;
never JAX's `"gpu"`): a CPU cache consulted on the card resolves nothing.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Set, Tuple

from repro_torch.core import compiler as CC
from repro_torch.core import graph as G

# v2: `irb_key` carries all three act bit-widths of the fused block
# (expand/dw/project) instead of collapsing them into the project op's —
# a heterogeneous-bit block no longer aliases a uniform-bit block. Any
# v1 cache must be regenerated (the autotuner).
CACHE_VERSION = 2

# route identifiers (the JAX package's strings; see the module docstring)
INT_REF = "int_ref"  # float64 torch ops (exact; XLA's int32 ops in JAX)
INT_F32 = "int_f32"  # float32 torch ops, under the 2^24 exactness bound
DW_SHIFTS = "dw_shifts"  # K x K shifted int32 multiply-adds (depthwise)
PALLAS_PW = "pallas_pw"  # K2, the pointwise kernel (tile params)
PALLAS_DW = "pallas_dw"  # K3, the depthwise kernel
FUSED_IRB = "fused_irb"  # K4, the whole fused IRB block (block entry)
PER_OP = "per_op"  # block entry: keep the per-op selections

RouteMap = Dict[str, Tuple[str, Dict[str, int]]]


def op_key(op: G.OpSpec, in_hw: Optional[int], backend: str,
           rank: int = 2) -> str:
    """Cache key for one operator: kind + full shape + act bits + backend.

    `in_hw` is the op's input spatial size (0 once collapsed), which
    together with (in_ch, out_ch, kernel, stride) pins the exact workload
    the timing was measured on. `rank` selects the spatial-slot spelling:
    2-D entries say `hw{n}` (side length), 1-D entries say `t{n}` (frame
    count) — so a temporal op never resolves a timing measured on a 2-D
    op that happens to share the numbers (PW/DENSE kinds appear in both
    ranks, and a [B,T,C] pointwise is a very different workload from the
    [B,H,W,C] one at H=W=T)."""
    sp = 0 if in_hw is None else int(in_hw)
    slot = f"t{sp}" if rank == 1 else f"hw{sp}"
    return (f"{op.kind}:{slot}:cin{op.in_ch}:cout{op.out_ch}"
            f":k{op.kernel}:s{op.stride}:a{op.act_bits}:{backend}")


def irb_key(block: G.BlockSpec, in_hw: Optional[int], backend: str) -> str:
    """Cache key for a whole fusable IRB (expand -> dw -> project) block.

    All three stage act bit-widths are in the key: the fused kernel's
    timing (and its eligibility — `fusable_irb` requires one width) is a
    function of every stage's BW, so a mixed-bit block must never resolve
    a route measured on a uniform-bit block that happens to share the
    project op's width."""
    e, d, p = block.ops
    hw = 0 if in_hw is None else int(in_hw)
    return (f"irb:hw{hw}:c{e.in_ch}x{e.out_ch}x{p.out_ch}"
            f":k{d.kernel}:s{d.stride}"
            f":a{e.act_bits}x{d.act_bits}x{p.act_bits}"
            f":r{int(block.residual)}:{backend}")


@dataclasses.dataclass(frozen=True)
class RouteChoice:
    """One measured selection: the winning route and the evidence."""

    route: str
    params: Tuple[Tuple[str, int], ...] = ()  # sorted (name, value) pairs
    us: float = 0.0  # best measured wall time of the winner
    us_ref: Optional[float] = None  # the reference route's time, if timed
    n_candidates: int = 0
    disqualified: Tuple[str, ...] = ()  # candidates that drifted or raised

    @property
    def params_dict(self) -> Dict[str, int]:
        return dict(self.params)

    @staticmethod
    def make(route: str, params: Optional[Dict[str, int]] = None,
             **kw) -> "RouteChoice":
        items = tuple(sorted((params or {}).items()))
        return RouteChoice(route=route, params=items, **kw)

    def to_json(self) -> Dict:
        d = dataclasses.asdict(self)
        d["params"] = dict(self.params)
        d["disqualified"] = list(self.disqualified)
        return d

    @staticmethod
    def from_json(d: Dict) -> "RouteChoice":
        return RouteChoice(
            route=d["route"],
            params=tuple(sorted(
                (str(k), int(v)) for k, v in (d.get("params") or {}).items())),
            us=float(d.get("us", 0.0)),
            us_ref=(None if d.get("us_ref") is None else float(d["us_ref"])),
            n_candidates=int(d.get("n_candidates", 0)),
            disqualified=tuple(d.get("disqualified", ())),
        )


@dataclasses.dataclass(frozen=True)
class TunedPlan:
    """Measured per-op (and per-fusable-block) route selections.

    `entries` maps `op_key`/`irb_key` strings to the winning `RouteChoice`.
    `resolve` projects the shape-keyed cache onto a concrete net.
    """

    backend: str
    nets: Tuple[str, ...]
    tuned_batch: int
    entries: Dict[str, RouteChoice]
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.entries)

    # ------------------------------------------------------------------
    # projection onto a concrete net
    # ------------------------------------------------------------------

    def resolve(self, qnet, plan: Optional[CC.CUPlan] = None,
                backend: Optional[str] = None) -> Tuple[RouteMap, Set[str]]:
        """Project the cache onto `qnet` (anything with a `.spec` NetSpec,
        or a NetSpec).

        Returns (op_routes, fused_blocks): op name -> (route, params) for
        every op with an entry on `backend`, and the fusable IRB blocks
        whose block entry chose the fused kernel. Ops and blocks without
        an entry are absent: callers keep the default route. `backend`
        defaults to the device type of a prepared net, else CUDA's (which
        must be there)."""
        from repro_torch.kernels.ops import fusable_irb

        spec = _spec_of(qnet)
        plan = plan if plan is not None else CC.compile_net(spec)
        backend = _backend_of(qnet, backend)
        rank = spec.spatial_rank
        op_routes: RouteMap = {}
        block_in_hw: Dict[str, Optional[int]] = {}
        for _, block, op, in_hw in plan.op_descriptors():
            block_in_hw.setdefault(block.name, in_hw)
            entry = self.entries.get(op_key(op, in_hw, backend, rank=rank))
            if entry is not None:
                op_routes[op.name] = (entry.route, entry.params_dict)
        fused: Set[str] = set()
        for block in spec.blocks:
            if not fusable_irb(block):
                continue
            entry = self.entries.get(
                irb_key(block, block_in_hw.get(block.name), backend))
            if entry is not None and entry.route == FUSED_IRB:
                fused.add(block.name)
        return op_routes, fused

    def resolve_with_defaults(
        self, qnet, plan: Optional[CC.CUPlan] = None,
        backend: Optional[str] = None, *,
        op_kernels: bool = False, body_fast_path: bool = False,
    ) -> Tuple[RouteMap, Set[str]]:
        """`resolve`, then fill the cache's misses with the stage
        compiler's default routes: with `op_kernels` an uncovered DW op
        takes K3 and an uncovered PW/DENSE op K2 (2-D nets), and every SE
        squeeze K2 (the cache keys no squeeze); with `body_fast_path` a
        fusable Body block with no block entry takes K4 (one whose entry
        says `per_op` was measured and stays per op). Ops left unrouted
        run `cu.run_block`'s default formulation. An empty plan resolved
        so is the untuned serving route (`compile_stages`)."""
        from repro_torch.kernels.ops import fusable_irb

        spec = _spec_of(qnet)
        plan = plan if plan is not None else CC.compile_net(spec)
        backend = _backend_of(qnet, backend)
        op_routes, fused = self.resolve(spec, plan, backend=backend)
        block_in_hw: Dict[str, Optional[int]] = {}
        fill = op_kernels and spec.spatial_rank == 2
        for _, block, op, in_hw in plan.op_descriptors():
            block_in_hw.setdefault(block.name, in_hw)
            if not fill:
                continue
            if block.se is not None and block.se_after == op.name:
                op_routes[block.se.squeeze.name] = (PALLAS_PW, {})
            if op.name in op_routes or op.act == G.HSIGMOID:
                continue
            if op.kind == G.DW:
                op_routes[op.name] = (PALLAS_DW, {})
            elif op.kind in (G.PW, G.DENSE):
                op_routes[op.name] = (PALLAS_PW, {})
        if body_fast_path:
            for block in plan.blocks_for(CC.BODY):
                if not fusable_irb(block) or block.name in fused:
                    continue
                if irb_key(block, block_in_hw.get(block.name),
                           backend) not in self.entries:
                    fused.add(block.name)
        return op_routes, fused

    def coverage(self, qnet, plan: Optional[CC.CUPlan] = None,
                 backend: Optional[str] = None) -> float:
        """Fraction of this net's tunable ops with a cache entry."""
        spec = _spec_of(qnet)
        plan = plan if plan is not None else CC.compile_net(spec)
        op_routes, _ = self.resolve(spec, plan,
                                    backend=_backend_of(qnet, backend))
        tunable = [op for _, _, op, _ in plan.op_descriptors()
                   if op.act != G.HSIGMOID]
        return len(op_routes) / len(tunable) if tunable else 0.0

    # ------------------------------------------------------------------
    # merge / persist
    # ------------------------------------------------------------------

    def merge(self, other: "TunedPlan") -> "TunedPlan":
        """Union of two caches; on a key collision the faster entry wins."""
        if self.backend != other.backend:
            raise ValueError(
                f"cannot merge caches for different backends: "
                f"{self.backend!r} vs {other.backend!r}")
        entries = dict(self.entries)
        for key, choice in other.entries.items():
            if key not in entries or choice.us < entries[key].us:
                entries[key] = choice
        return TunedPlan(
            backend=self.backend,
            nets=tuple(sorted(set(self.nets) | set(other.nets))),
            tuned_batch=self.tuned_batch,
            entries=entries,
            meta={**self.meta, **other.meta},
        )

    def to_json(self) -> Dict:
        return {
            "version": CACHE_VERSION,
            "backend": self.backend,
            "nets": list(self.nets),
            "tuned_batch": self.tuned_batch,
            "meta": dict(self.meta),
            "entries": {k: self.entries[k].to_json()
                        for k in sorted(self.entries)},
        }

    @staticmethod
    def from_json(d: Dict) -> "TunedPlan":
        version = d.get("version")
        if version != CACHE_VERSION:
            raise ValueError(
                f"tuning cache version {version!r} != {CACHE_VERSION} — "
                f"regenerate it with the autotuner")
        return TunedPlan(
            backend=d["backend"],
            nets=tuple(d.get("nets", ())),
            tuned_batch=int(d.get("tuned_batch", 0)),
            entries={k: RouteChoice.from_json(v)
                     for k, v in d.get("entries", {}).items()},
            meta=dict(d.get("meta", {})),
        )


def _spec_of(qnet) -> G.NetSpec:
    return qnet.spec if hasattr(qnet, "spec") else qnet


def _backend_of(qnet, backend: Optional[str]) -> str:
    """The backend a cache is read for: the caller's, else a prepared
    net's device type, else CUDA's (`energy.default_backend`: raises
    without a card)."""
    if backend is not None:
        return backend
    device = getattr(qnet, "device", None)
    if device is not None:
        return device.type
    from repro_torch.energy.power import default_backend
    return default_backend()


def save_tuned(plan: TunedPlan, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(plan.to_json(), f, indent=1, sort_keys=True)
        f.write("\n")


def load_tuned(path: str) -> TunedPlan:
    with open(path) as f:
        return TunedPlan.from_json(json.load(f))


__all__ = [
    "CACHE_VERSION",
    "INT_REF", "INT_F32", "DW_SHIFTS", "PALLAS_PW", "PALLAS_DW",
    "FUSED_IRB", "PER_OP",
    "op_key", "irb_key",
    "RouteChoice", "TunedPlan",
    "save_tuned", "load_tuned",
]
