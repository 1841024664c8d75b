"""Tuning cache: measured per-op route selections as a committed artifact.

Counterpart of `repro/tune/cache.py`, the part the energy model reads: the
shape keys (`op_key`, `irb_key`), `RouteChoice`, `TunedPlan` and its JSON
form (`load_tuned`/`save_tuned`). A cache file written by the JAX
package's autotuner (`experiments/tuned/*.json`) loads here unchanged and
prices the same ops. Projecting a cache onto a net's routes (`resolve`,
`coverage`), merging caches and the autotuner itself come with `tuned=`
serving.

Keys name an op by kind, input shape, act bits and backend, NOT by op
name, so two nets sharing an op shape resolve to the same entry, and a
cache recorded on another backend resolves nothing.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

from repro_torch.core import graph as G

# v2: `irb_key` carries all three act bit-widths of the fused block
# (expand/dw/project) instead of collapsing them into the project op's —
# a heterogeneous-bit block no longer aliases a uniform-bit block. Any
# v1 cache must be regenerated (the autotuner).
CACHE_VERSION = 2


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
    disqualified: Tuple[str, ...] = ()  # candidates that drifted vs reference

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
    """

    backend: str
    nets: Tuple[str, ...]
    tuned_batch: int
    entries: Dict[str, RouteChoice]
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.entries)

    # ------------------------------------------------------------------
    # merge / persist
    # ------------------------------------------------------------------

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
    "op_key", "irb_key",
    "RouteChoice", "TunedPlan",
    "save_tuned", "load_tuned",
]
