"""Per-layer mixed-precision search: heterogeneous act-bit allocation.

Counterpart of `repro/tune/precision.py`. The paper's quantization recipe
is uniform (one 8 -> 4 activation anneal for the whole net), but its own
CU-heterogeneity argument applies to precision too: operators differ in
accuracy sensitivity and in the latency and energy each bit costs. This
module searches per-block activation bit-widths (e.g. {4, 6, 8}) over a
NetSpec and emits a Pareto artifact, scoring every candidate with

  * **latency** from a table assembled out of tuned-cache entries
    (`op_key` carries `a{bits}`, so the autotuner's measured route times
    are reused as they are; missing keys are timed by running the
    autotuner over the uniform-width variants, on the card with its
    kernel candidates (K2's tiles, K3, the K4 race), on the CPU with the
    torch-op candidates only, as the JAX package's CPU search does;
    injectable fake measure in tests),
  * **energy** through `repro_torch.energy.estimate_energy` / `edp_score`,
  * **accuracy** from a short QAT fine-tune through `train/vision.py`'s
    step (injectable fake in tests).

Search shape: the uniform widths anchor the front; mixed candidates come
from a deterministic *savings ladder*: blocks ranked by the measured
latency they give back when dropped from the widest to the narrowest
choice, then the top-k blocks are dropped for a schedule of k values
(plus a mid-width ladder when three choices are given).

Artifacts use the schema `precision-pareto-v1` of the JAX package (each
package's `check_pareto_artifact` accepts the other's). `pareto_path`
defaults to `smoke_out/precision/`, never over the JAX package's
`experiments/precision/`. A selected allocation exports as an ordinary
`.qnet` through `train.vision.export`, which writes only after every
serving route proves bit-exact, mixed widths included.

Every entry point runs on CUDA unless the caller passes `device="cpu"`,
and raises where there is no card. CLI: `python -m repro_torch.tune
--precision`.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import compiler as CC
from repro_torch.core import cu
from repro_torch.core import graph as G
from repro_torch.energy import model as EM
from repro_torch.energy.power import PowerModel, default_power_model
from repro_torch.tune import cache as TC

PARETO_SCHEMA = "precision-pareto-v1"
PRECISION_DIR = os.path.join("smoke_out", "precision")


# ---------------------------------------------------------------------------
# latency table: tuned-cache entries -> per-net microseconds
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NetCost:
    """One net's latency as the tuner tables price it."""

    us_per_image: float
    n_tuned: int
    n_ops: int
    missing: Tuple[str, ...]  # op_key strings with no cache entry

    @property
    def fps(self) -> float:
        return 1e6 / self.us_per_image if self.us_per_image > 0 else 0.0

    @property
    def tuned_fraction(self) -> float:
        return self.n_tuned / self.n_ops if self.n_ops else 0.0


class LatencyTable:
    """Latency lookup assembled from a `TunedPlan`'s measured entries.

    Every entry's `us` is the best measured wall time of the winning
    bit-exact route at `tuned_batch`; `op_us` normalizes to per-image.
    Blocks whose block-level entry selected the fused IRB kernel are
    priced by that block timing (that is the route serving runs);
    everything else sums per-op entries. Ops without an entry fall back
    to the analytic pJ/MAC estimate and are reported in `missing`."""

    def __init__(self, tuned: TC.TunedPlan, power: PowerModel,
                 backend: Optional[str] = None):
        self.tuned = tuned
        self.power = power
        self.backend = backend or tuned.backend
        self.per_image = max(tuned.tuned_batch, 1)

    def op_us(self, op: G.OpSpec, in_hw: Optional[int],
              rank: int = 2) -> Optional[float]:
        entry = self.tuned.entries.get(
            TC.op_key(op, in_hw, self.backend, rank=rank))
        if entry is None or entry.us <= 0:
            return None
        return entry.us / self.per_image

    def _analytic_us(self, op: G.OpSpec, in_hw: Optional[int],
                     rank: int) -> float:
        compute_j = (EM.op_macs(op, in_hw, rank)
                     * EM.op_pj_per_mac(op) * 1e-12)
        return compute_j / self.power.busy_w * 1e6

    def net_cost(self, spec: G.NetSpec,
                 plan: Optional[CC.CUPlan] = None) -> NetCost:
        from repro_torch.kernels.ops import fusable_irb

        plan = plan if plan is not None else CC.compile_net(spec)
        rank = spec.spatial_rank
        block_in_hw: Dict[str, Optional[int]] = {}
        for _, block, _, in_hw in plan.op_descriptors():
            block_in_hw.setdefault(block.name, in_hw)
        fused_us: Dict[str, float] = {}
        for block in spec.blocks:
            if not fusable_irb(block):
                continue
            entry = self.tuned.entries.get(TC.irb_key(
                block, block_in_hw.get(block.name), self.backend))
            if (entry is not None and entry.route == TC.FUSED_IRB
                    and entry.us > 0):
                fused_us[block.name] = entry.us / self.per_image
        total = 0.0
        n_tuned = n_ops = 0
        missing: List[str] = []
        priced_blocks = set()
        for _, block, op, in_hw in plan.op_descriptors():
            if block.name in fused_us:
                if block.name not in priced_blocks:
                    priced_blocks.add(block.name)
                    total += fused_us[block.name]
                n_ops += 1
                n_tuned += 1
                continue
            n_ops += 1
            us = self.op_us(op, in_hw, rank)
            if us is None:
                if op.act != G.HSIGMOID:  # gate ops are never tuned
                    missing.append(TC.op_key(op, in_hw, self.backend,
                                             rank=rank))
                total += self._analytic_us(op, in_hw, rank)
            else:
                n_tuned += 1
                total += us
        return NetCost(us_per_image=total, n_tuned=n_tuned, n_ops=n_ops,
                       missing=tuple(dict.fromkeys(missing)))


def _torch_op_candidates(pop):
    """An op's candidates without the kernels: what the JAX package's CPU
    search times (`include_pallas=False` off the TPU)."""
    from repro_torch.tune.autotune import op_candidates

    return [c for c in op_candidates(pop)
            if c.route not in (TC.PALLAS_PW, TC.PALLAS_DW)]


def ensure_coverage(
    table: LatencyTable,
    nets: Sequence[G.NetSpec],
    *,
    measure=None,
    batch: int = 8,
    repeats: int = 1,
    seed: int = 0,
    log: Optional[Callable[[str], None]] = None,
) -> LatencyTable:
    """Time the nets whose op keys the table is missing; return the
    merged table.

    The search's candidate space only needs the keys of the uniform width
    variants (each op of a per-block allocation carries one of the
    searched widths at an unchanged shape), so timing those nets makes
    every mixed candidate fully measured. They are tuned on the device the
    table's backend names: on `"cuda"` with every kernel candidate (K2's
    tiles, K3, the K4 race), on `"cpu"` with the torch-op candidates only.
    `measure` is the autotuner's injectable timer."""
    from repro_torch.models.layers import make_calibrated_qnet
    from repro_torch.tune.autotune import tune_qnet

    say = log or (lambda s: None)
    tuned = table.tuned
    device = cu.resolve_device(table.backend)
    candidates_fn = None if device.type == "cuda" else _torch_op_candidates
    # fresh timings must normalize like the seed cache's entries, so the
    # tuner runs at the cache's own batch when it has one
    batch = tuned.tuned_batch or batch
    for net in nets:
        probe = LatencyTable(tuned, table.power, table.backend)
        cost = probe.net_cost(net)
        if not cost.missing:
            continue
        say(f"[precision] timing {len(cost.missing)} missing keys "
            f"for {net.name}")
        qnet = make_calibrated_qnet(net, bits=8, device=device)
        fresh = tune_qnet(qnet, batch=batch, repeats=repeats, seed=seed,
                          measure=measure, candidates_fn=candidates_fn,
                          device=device)
        tuned = tuned.merge(fresh) if len(tuned.entries) else fresh
    return LatencyTable(tuned, table.power, table.backend)


# ---------------------------------------------------------------------------
# allocations + Pareto machinery
# ---------------------------------------------------------------------------


def block_allocation(net: G.NetSpec,
                     block_bits: Dict[str, int]) -> Dict[str, int]:
    """Expand per-block widths into the per-op map `with_op_act_bits`
    takes (every plain op of a named block gets the block's width, which
    keeps fused-IRB eligibility: it requires one width per block)."""
    by_name = {b.name: b for b in net.blocks}
    unknown = sorted(set(block_bits) - set(by_name))
    if unknown:
        raise KeyError(f"unknown block name(s) {unknown!r}")
    return {op.name: int(bits)
            for name, bits in block_bits.items()
            for op in by_name[name].ops}


@dataclasses.dataclass(frozen=True)
class PrecisionPoint:
    """One evaluated allocation: the candidate and all four objectives."""

    name: str
    block_bits: Dict[str, int]  # per-block widths (the search variable)
    alloc: Dict[str, int]  # per-op expansion (what artifacts carry)
    uniform: Optional[int]  # the width when uniform, else None
    accuracy: float
    us_per_image: float
    model_bytes: int
    j_per_image: float
    edp: float
    tuned_fraction: float

    @property
    def fps(self) -> float:
        return 1e6 / self.us_per_image if self.us_per_image > 0 else 0.0

    def as_dict(self) -> Dict[str, object]:
        return {
            "name": self.name,
            "block_bits": dict(self.block_bits),
            "alloc": dict(self.alloc),
            "uniform": self.uniform,
            "accuracy": self.accuracy,
            "us_per_image": self.us_per_image,
            "fps": self.fps,
            "model_bytes": self.model_bytes,
            "j_per_image": self.j_per_image,
            "edp": self.edp,
            "tuned_fraction": self.tuned_fraction,
        }


def dominates(a: PrecisionPoint, b: PrecisionPoint) -> bool:
    """a dominates b: no worse on every objective, strictly better on one
    (accuracy and fps maximize; model bytes and J/image minimize)."""
    ge = (a.accuracy >= b.accuracy and a.fps >= b.fps
          and a.model_bytes <= b.model_bytes
          and a.j_per_image <= b.j_per_image)
    gt = (a.accuracy > b.accuracy or a.fps > b.fps
          or a.model_bytes < b.model_bytes
          or a.j_per_image < b.j_per_image)
    return ge and gt


def pareto_front(points: Sequence[PrecisionPoint]) -> List[PrecisionPoint]:
    return [p for p in points
            if not any(dominates(q, p) for q in points if q is not p)]


# ---------------------------------------------------------------------------
# accuracy term: short QAT fine-tune through train/vision
# ---------------------------------------------------------------------------


class QATFinetuneAccuracy:
    """Held-out accuracy after a short QAT fine-tune at the allocation.

    One shared base run (the config's float + QAT schedule at uniform
    `base_act_bits` activations) trains once on `device` (CUDA unless
    named); each candidate then fine-tunes `steps` QAT steps at its own
    (possibly heterogeneous) widths through the same
    `make_vision_train_step` the phase schedule uses, eagerly on the
    params' device, and is scored by `train.vision.eval_accuracy` on the
    held-out eval stream. Results are memoized by allocation. `finetune`
    also returns the fine-tuned params: the export path picks them up, so
    the artifact is the net the score was measured on."""

    def __init__(self, cfg, *, steps: int = 10, base_act_bits: int = 8,
                 eval_seed: int = 2, eval_batches: int = 4,
                 log: Optional[Callable[[str], None]] = None, device=None):
        self.cfg = dataclasses.replace(cfg, op_act_bits=None)
        self.steps = steps
        self.base_act_bits = base_act_bits
        self.eval_seed = eval_seed
        self.eval_batches = eval_batches
        self.say = log or (lambda s: None)
        self.device = cu.resolve_device(device)
        self._base = None
        self._memo: Dict[Tuple[Tuple[str, int], ...], float] = {}

    def base_params(self):
        if self._base is None:
            from repro_torch.train import vision as V
            base_cfg = dataclasses.replace(
                self.cfg, act_bits=self.base_act_bits, anneal_from=None,
                calibrate_every=0, ckpt_every=0)
            self.say(f"[precision] base QAT run "
                     f"({base_cfg.total_steps} steps, "
                     f"act{self.base_act_bits})")
            self._base = V.train(base_cfg, device=self.device)
        return self._base.params

    def finetune(self, cfg_variant, net: G.NetSpec):
        """(params, accuracy) after `steps` QAT steps at `net`'s widths."""
        from repro_torch.train import optimizer as O
        from repro_torch.train import vision as V
        params = self.base_params()
        if self.steps > 0:
            opt_cfg = O.AdamWConfig(
                lr=cfg_variant.qat_lr, warmup_steps=1,
                total_steps=self.steps,
                weight_decay=cfg_variant.weight_decay)
            step_fn = V.make_vision_train_step(
                net, opt_cfg, qat=True, grad_accum=cfg_variant.grad_accum)
            opt_state = O.init_state(params)
            # the data stream continues past the base run's steps, so the
            # fine-tune never re-sees a base batch
            offset = self.cfg.total_steps
            for i in range(self.steps):
                batch = V.train_batch(self.cfg, offset + i, self.device)
                params, opt_state, _ = step_fn(params, opt_state, batch)
        acc = V.eval_accuracy(params, net, self.cfg, qat=True,
                              eval_seed=self.eval_seed,
                              eval_batches=self.eval_batches)
        return params, acc

    def __call__(self, cfg_variant, net: G.NetSpec) -> float:
        key = tuple(sorted(G.op_act_bits(net).items()))
        if key not in self._memo:
            _, acc = self.finetune(cfg_variant, net)
            self._memo[key] = acc
            self.say(f"[precision] accuracy({net.name}) = {acc:.3f}")
        return self._memo[key]


def fake_accuracy(cfg_variant, net: G.NetSpec) -> float:
    """Deterministic accuracy stand-in for tests: monotone in the mean
    activation width with a small early-layer sensitivity bonus, so the
    fake front has the right qualitative shape without training."""
    widths = [op.act_bits for b in net.blocks for op in b.ops]
    mean_w = float(np.mean(widths)) if widths else 0.0
    early = float(np.mean(widths[: max(1, len(widths) // 4)]))
    return round(min(1.0, 0.55 + 0.04 * mean_w + 0.01 * early), 4)


def fake_measure(fn, x, candidate=None) -> float:
    """Deterministic timer stand-in for tests: pseudo-seconds derived from
    the workload size and a fixed per-route factor (never runs the
    candidate: the tuner's exactness gate already did)."""
    factors = {TC.INT_REF: 3.0, TC.INT_F32: 2.0, TC.DW_SHIFTS: 2.5,
               TC.PALLAS_PW: 1.5, TC.PALLAS_DW: 1.6, TC.FUSED_IRB: 1.2,
               TC.PER_OP: 2.8}
    route = getattr(candidate, "route", None)
    size = float(np.prod(np.shape(x)))
    return size * factors.get(route, 2.0) * 1e-9


# ---------------------------------------------------------------------------
# the search driver
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PrecisionResult:
    """Everything one search run produced, artifact-shaped."""

    model: str
    backend: str
    choices: Tuple[int, ...]
    build: Dict[str, object]  # the base config's build record (no alloc)
    points: Tuple[PrecisionPoint, ...]
    front: Tuple[str, ...]  # names of non-dominated points
    tuned_batch: int
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def point(self, name: str) -> PrecisionPoint:
        for p in self.points:
            if p.name == name:
                return p
        raise KeyError(name)

    def front_points(self) -> List[PrecisionPoint]:
        return [self.point(n) for n in self.front]

    def as_dict(self) -> Dict[str, object]:
        return {
            "schema": PARETO_SCHEMA,
            "model": self.model,
            "backend": self.backend,
            "choices": list(self.choices),
            "build": dict(self.build),
            "tuned_batch": self.tuned_batch,
            "meta": dict(self.meta),
            "points": [p.as_dict() for p in self.points],
            "pareto": list(self.front),
        }


def _evaluate(name: str, cfg, block_bits: Dict[str, int],
              uniform: Optional[int], table: LatencyTable,
              accuracy_fn, power: PowerModel) -> PrecisionPoint:
    from repro_torch.train import vision as V
    base_net = V.build_net(dataclasses.replace(cfg, op_act_bits=None))
    alloc = block_allocation(base_net, block_bits)
    if uniform is not None:
        cfg_v = dataclasses.replace(cfg, act_bits=uniform, op_act_bits=None)
    else:
        cfg_v = dataclasses.replace(cfg,
                                    op_act_bits=tuple(sorted(alloc.items())))
    net = V.build_net(cfg_v)
    cost = table.net_cost(net)
    report = EM.estimate_energy(net, tuned=table.tuned, power=power,
                                backend=table.backend)
    j = report.j_per_image
    acc = float(accuracy_fn(cfg_v, net))
    return PrecisionPoint(
        name=name,
        block_bits=dict(block_bits),
        alloc=alloc,
        uniform=uniform,
        accuracy=acc,
        us_per_image=cost.us_per_image,
        model_bytes=(net.model_bits(with_bias=True) + 7) // 8,
        j_per_image=j,
        edp=EM.edp_score(cost.us_per_image * 1e-6,
                         sum(o.bytes_moved for o in report.ops), power),
        tuned_fraction=cost.tuned_fraction,
    )


def _block_savings(net: G.NetSpec, table: LatencyTable, lo: int,
                   hi: int) -> List[Tuple[str, float]]:
    """Per-block latency give-back when dropped hi -> lo, descending."""
    hi_net = G.with_act_bits(net, hi)
    lo_net = G.with_act_bits(net, lo)
    plan = CC.compile_net(hi_net)
    rank = hi_net.spatial_rank
    per_block: Dict[str, float] = {}
    by_name_lo = {b.name: b for b in lo_net.blocks}
    for _, block, op, in_hw in plan.op_descriptors():
        op_lo = next(o for o in by_name_lo[block.name].ops
                     if o.name == op.name)
        us_hi = table.op_us(op, in_hw, rank)
        us_lo = table.op_us(op_lo, in_hw, rank)
        if us_hi is None or us_lo is None:
            us_hi = table._analytic_us(op, in_hw, rank)
            us_lo = table._analytic_us(op_lo, in_hw, rank)
        per_block[block.name] = (per_block.get(block.name, 0.0)
                                 + (us_hi - us_lo))
    return sorted(per_block.items(), key=lambda kv: (-kv[1], kv[0]))


def _ladder_schedule(n: int, budget: int) -> List[int]:
    """k values for the savings ladder: geometric coverage of 1..n."""
    ks: List[int] = []
    k = 1
    while k < n and len(ks) < max(budget - 1, 1):
        ks.append(k)
        k *= 2
    if n > 0 and (not ks or ks[-1] != n):
        ks.append(n)
    return ks[:budget]


def search_precision(
    cfg,
    *,
    choices: Sequence[int] = (4, 6, 8),
    tuned: Optional[TC.TunedPlan] = None,
    power: Optional[PowerModel] = None,
    backend: Optional[str] = None,
    accuracy_fn=None,
    measure=None,
    ladder_budget: int = 5,
    tune_batch: int = 8,
    tune_repeats: int = 1,
    finetune_steps: int = 10,
    log: Optional[Callable[[str], None]] = None,
    device=None,
) -> PrecisionResult:
    """Search per-block act-bit allocations for `cfg`'s model on `device`
    (CUDA unless named; it raises without a card).

    `tuned` seeds the latency table (committed caches); missing keys are
    timed through the autotuner with `measure` (wall clock by default,
    deterministic fake in tests). `backend` defaults to the seed cache's,
    else the device's type. `accuracy_fn(cfg_variant, net) -> float`
    defaults to the QAT fine-tune scorer. Returns every evaluated point
    plus the non-dominated front."""
    from repro_torch.train import vision as V

    say = log or (lambda s: None)
    dev = cu.resolve_device(device)
    choices = tuple(sorted(int(c) for c in choices))
    if len(choices) < 2:
        raise ValueError("need at least two width choices to search over")
    backend = backend or (tuned.backend if tuned is not None else dev.type)
    power = power if power is not None else default_power_model(backend)
    if tuned is None:
        tuned = TC.TunedPlan(backend=backend, nets=(), tuned_batch=tune_batch,
                             entries={})
    if accuracy_fn is None:
        accuracy_fn = QATFinetuneAccuracy(cfg, steps=finetune_steps,
                                          log=say, device=dev)

    base_cfg = dataclasses.replace(cfg, op_act_bits=None)
    base_net = V.build_net(base_cfg)
    uniform_nets = [G.with_act_bits(base_net, w) for w in choices]
    table = LatencyTable(tuned, power, backend)
    table = ensure_coverage(table, uniform_nets, measure=measure,
                            batch=tune_batch, repeats=tune_repeats, log=say)

    block_names = [b.name for b in base_net.blocks]
    lo, hi = choices[0], choices[-1]
    points: List[PrecisionPoint] = []

    for w in choices:
        bits = {name: w for name in block_names}
        points.append(_evaluate(f"uniform{w}", cfg, bits, w, table,
                                accuracy_fn, power))
        say(f"[precision] uniform{w}: {points[-1].us_per_image:.1f} us, "
            f"acc {points[-1].accuracy:.3f}")

    savings = _block_savings(base_net, table, lo, hi)
    order = [name for name, _ in savings]
    seen = {tuple(sorted(p.block_bits.items())) for p in points}

    def ladder(width_low: int, tag: str):
        for k in _ladder_schedule(len(order), ladder_budget):
            bits = {name: hi for name in block_names}
            for name in order[:k]:
                bits[name] = width_low
            sig = tuple(sorted(bits.items()))
            if sig in seen:
                continue
            seen.add(sig)
            points.append(_evaluate(f"{tag}_top{k}", cfg, bits, None,
                                    table, accuracy_fn, power))
            say(f"[precision] {tag}_top{k}: "
                f"{points[-1].us_per_image:.1f} us, "
                f"acc {points[-1].accuracy:.3f}")

    ladder(lo, f"mix{lo}of{hi}")
    for w in choices[1:-1]:
        ladder(w, f"mix{w}of{hi}")

    front = [p.name for p in pareto_front(points)]
    return PrecisionResult(
        model=cfg.model,
        backend=backend,
        choices=choices,
        build=V.build_record(base_cfg),
        points=tuple(points),
        front=tuple(front),
        tuned_batch=table.tuned.tuned_batch,
        meta={
            "n_blocks": len(block_names),
            "savings_order": order,
            "ladder_budget": ladder_budget,
            "tuned_entries": len(table.tuned.entries),
            "objectives": ["accuracy", "fps", "model_bytes", "j_per_image"],
        },
    )


# ---------------------------------------------------------------------------
# artifact I/O + schema gate
# ---------------------------------------------------------------------------


def pareto_path(model: str, backend: str,
                out_dir: str = PRECISION_DIR) -> str:
    return os.path.join(out_dir, f"{model}_{backend}_pareto.json")


def write_pareto(result: PrecisionResult, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(result.as_dict(), f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def check_pareto_artifact(path: str, *, min_points: int = 3,
                          require_domination: bool = False) -> Dict:
    """Schema-check a Pareto artifact; raises ValueError.

    Verifies the schema tag, the per-point field set, that every width
    drawn is one of the declared choices, that the recorded front is
    exactly the non-dominated set of the recorded points, and (with
    `require_domination`) that some mixed allocation strictly beats a
    uniform point on the latency axis at no worse model bytes and
    equal-or-better accuracy."""
    with open(path) as f:
        d = json.load(f)
    if d.get("schema") != PARETO_SCHEMA:
        raise ValueError(f"{path}: schema {d.get('schema')!r} != "
                         f"{PARETO_SCHEMA!r}")
    choices = set(d.get("choices", ()))
    if not choices:
        raise ValueError(f"{path}: empty choices")
    raw = d.get("points", [])
    need = {"name", "block_bits", "alloc", "uniform", "accuracy",
            "us_per_image", "fps", "model_bytes", "j_per_image", "edp",
            "tuned_fraction"}
    points: List[PrecisionPoint] = []
    for rp in raw:
        missing = need - set(rp)
        if missing:
            raise ValueError(
                f"{path}: point {rp.get('name')!r} missing {sorted(missing)}")
        bad = {b for b in rp["alloc"].values() if b not in choices}
        if bad:
            raise ValueError(f"{path}: point {rp['name']!r} uses widths "
                             f"{sorted(bad)} outside choices")
        points.append(PrecisionPoint(
            name=rp["name"], block_bits=rp["block_bits"], alloc=rp["alloc"],
            uniform=rp["uniform"], accuracy=float(rp["accuracy"]),
            us_per_image=float(rp["us_per_image"]),
            model_bytes=int(rp["model_bytes"]),
            j_per_image=float(rp["j_per_image"]), edp=float(rp["edp"]),
            tuned_fraction=float(rp["tuned_fraction"])))
    front = [p.name for p in pareto_front(points)]
    if sorted(front) != sorted(d.get("pareto", [])):
        raise ValueError(f"{path}: recorded front {sorted(d.get('pareto'))} "
                         f"!= recomputed {sorted(front)}")
    if len(front) < min_points:
        raise ValueError(f"{path}: front has {len(front)} points "
                         f"(need >= {min_points})")
    if require_domination and not find_domination(points):
        raise ValueError(f"{path}: no mixed point dominates a uniform one "
                         f"on (latency, model_bytes) at >= accuracy")
    return d


def find_domination(
    points: Sequence[PrecisionPoint],
) -> Optional[Tuple[str, str]]:
    """(mixed, uniform) names where the mixed allocation strictly beats
    the uniform one on latency at no worse model bytes and equal-or-
    better accuracy."""
    for m in points:
        if m.uniform is not None:
            continue
        for u in points:
            if u.uniform is None:
                continue
            if (m.us_per_image < u.us_per_image
                    and m.model_bytes <= u.model_bytes
                    and m.accuracy >= u.accuracy):
                return m.name, u.name
    return None


# ---------------------------------------------------------------------------
# export: one searched allocation -> a conformant .qnet
# ---------------------------------------------------------------------------


def export_point(
    cfg,
    point: PrecisionPoint,
    path: str,
    *,
    tuned: Optional[TC.TunedPlan] = None,
    accuracy_impl: Optional[QATFinetuneAccuracy] = None,
    finetune_steps: int = 10,
    device=None,
) -> Dict:
    """Export one searched allocation as a `.qnet` through the training
    export path: `train.vision.export` proves the reference, prepared,
    stage-executor and engine routes bit-exact (on the card: K2-K4)
    before writing, and the build record carries the `op_act_bits`
    allocation so the file self-describes. Runs on `accuracy_impl`'s
    device, else on `device` (CUDA unless named)."""
    from repro_torch.train import vision as V

    if point.uniform is not None:
        cfg_v = dataclasses.replace(cfg, act_bits=point.uniform,
                                    op_act_bits=None)
    else:
        cfg_v = dataclasses.replace(
            cfg, op_act_bits=tuple(sorted(point.alloc.items())))
    net = V.build_net(cfg_v)
    impl = accuracy_impl or QATFinetuneAccuracy(cfg, steps=finetune_steps,
                                                device=device)
    params, acc = impl.finetune(cfg_v, net)
    _, report = V.export(
        params, net, cfg_v, path=path, verify=True, tuned=tuned,
        provenance={"precision_point": point.name,
                    "precision_accuracy": acc},
        device=impl.device)
    report["accuracy"] = acc
    return report


__all__ = [
    "PARETO_SCHEMA",
    "PRECISION_DIR",
    "LatencyTable",
    "NetCost",
    "PrecisionPoint",
    "PrecisionResult",
    "QATFinetuneAccuracy",
    "block_allocation",
    "check_pareto_artifact",
    "dominates",
    "ensure_coverage",
    "export_point",
    "fake_accuracy",
    "fake_measure",
    "find_domination",
    "pareto_front",
    "pareto_path",
    "search_precision",
    "write_pareto",
]
