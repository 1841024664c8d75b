"""Route autotuner: measured per-op route selection (DeepDive co-design).

Counterpart of `repro/tune/autotune.py`. The paper specializes each CU per
operator class and layer shape; here every op of a `CUPlan` has several
bit-exact routes whose speed depends on the shape and the device — the
torch-op formulations (`int_ref` in float64, `int_f32` under the 2^24
bound, `dw_shifts`), the hand-written kernels K2 (`pallas_pw`, at three
tiles) and K3 (`pallas_dw`), and at the block level K4 (`fused_irb`) for
fusable IRBs — and the tuner measures the choice instead of fixing it:

  for each op (keyed by kind/shape/act_bits/backend):
      run every candidate once on the layer's true input activations
      -> a candidate whose output differs from the reference op in one
         element, or that raises, is DISQUALIFIED (its label recorded,
         never timed, never selectable)
      -> time the survivors (best of N, injectable for tests)
      -> the fastest exact candidate becomes the cache entry

Each fusable IRB then races K4 against the composite of its per-op
winners. The result is a `TunedPlan` (`repro_torch.tune.cache`) that
`prepare_qnet` / `compile_stages` / `VisionEngine` consume; the whole tuned
net is re-run through both and held bit for bit against the untuned
`run_qnet` before the plan is returned.

Selection runs eagerly: the JAX package verifies and times each candidate
under `jax.jit`, which the port's eager stages have no counterpart of. On
the card a candidate's first, untimed call pays the kernel's build at
first use, `cudaFuncSetAttribute` and the workspace's growth; the timed
calls are each synchronized, so a time is a call as the host sees it.

`objective="edp"` ranks by the energy-delay product of
`repro_torch.energy.edp_score`. Per-op candidates move the same bytes, so
there EDP ranks as latency does; what it can flip is a block race, since
the per-op composite spills every intermediate and K4 keeps them on chip.
The exactness gate and the MARGIN hysteresis are the same under both.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import compiler as CC
from repro_torch.core import cu
from repro_torch.core import graph as G
from repro_torch.kernels import ops as K
from repro_torch.kernels import pointwise_conv as PWK
from repro_torch.obs import trace as OT
from repro_torch.tune.cache import (
    DW_SHIFTS, FUSED_IRB, INT_F32, INT_REF, PALLAS_DW, PALLAS_PW, PER_OP,
    RouteChoice, TunedPlan, irb_key, op_key,
)


MARGIN = 0.1  # a challenger must beat the untuned route by this fraction


def pw_tile_sweep(rows: int, k: int, n: int) -> Tuple[Tuple[int, int, int],
                                                      ...]:
    """K2's candidate tiles for an [rows, k] x [k, n] product: `plan`'s
    default tile with block_m swept over every size the kernel is built
    for (`BLOCKS_M`), so three tiles with the default among them."""
    _, bn, bk = PWK.plan(max(rows, 1), k, n).tile
    return tuple((bm, bn, bk) for bm in PWK.BLOCKS_M)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One runnable route candidate: `fn(x_q) -> y_q` for the full op."""

    route: str
    params: Dict[str, int]
    fn: Callable[[torch.Tensor], torch.Tensor]

    @property
    def label(self) -> str:
        if not self.params:
            return self.route
        inner = ",".join(f"{k}={v}" for k, v in sorted(self.params.items()))
        return f"{self.route}[{inner}]"


def _sync(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def wall_measure(repeats: int = 3):
    """Best-of-N wall-clock timer (the default `measure`): one untimed call
    first, then `repeats` calls, each followed by a device synchronize.
    Tests inject a deterministic fake instead."""

    def measure(fn, x, candidate: Optional[Candidate] = None) -> float:
        fn(x)
        _sync(x)
        best = float("inf")
        for _ in range(max(1, repeats)):
            t0 = time.perf_counter()
            fn(x)
            _sync(x)
            best = min(best, time.perf_counter() - t0)
        return best

    return measure


def op_candidates(pop: cu.PreparedQOp, *, rows: int = 1) -> List[Candidate]:
    """The candidate routes of one prepared op: the torch-op formulations,
    and the kernels as in the reference (its `include_pallas`): K2 on
    every PW/DENSE op (it flattens the leading axes), K3 on 2-D DW ops.
    `rows` is the number of input rows the op sees (batch x spatial
    positions), which K2's tile sweep depends on.

    Eligibility is structural (`int_f32` only under the 2^24 bound); the
    tuner still verifies every candidate's output before it may win."""
    op = pop.spec
    if op.act == G.HSIGMOID:
        return []  # the gate runs its default formulation only

    def routed(name: str) -> Candidate:
        ready = cu._route_ready(pop, name)
        return Candidate(name, {}, lambda x: cu.run_qop(
            x, ready, route=(name, {})))

    cands = [routed(INT_REF)]
    if op.kind == G.DW:
        cands.append(routed(DW_SHIFTS))
        cands.append(Candidate(PALLAS_DW, {}, lambda x: K.run_dw_qop(x, pop)))
    elif op.kind in (G.PW, G.DENSE):
        if pop.f32_exact:
            cands.append(routed(INT_F32))
        for bm, bn, bk in pw_tile_sweep(rows, op.in_ch, op.out_ch):
            params = {"block_m": bm, "block_n": bn, "block_k": bk}
            cands.append(Candidate(
                PALLAS_PW, params,
                lambda x, p=dict(params): K.run_pw_qop(x, pop, **p)))
    elif op.kind == G.DW1D:
        cands.append(routed(DW_SHIFTS))
    elif op.kind in (G.CONV, G.CONV1D):
        if pop.f32_exact:
            cands.append(routed(INT_F32))
    return cands


def default_route(pop: cu.PreparedQOp, backend: str, rank: int = 2) -> str:
    """The route the untuned stages run for this op on `backend`: on
    `"cuda"` (the JAX package's `"tpu"` branch) K3 for DW and K2 for
    PW/DENSE of 2-D nets; elsewhere the JAX package's CPU defaults. `rank`
    is the net's spatial rank: 1-D nets never default onto the kernels."""
    op = pop.spec
    if op.kind == G.DW:
        return PALLAS_DW if backend == "cuda" else DW_SHIFTS
    if op.kind == G.DW1D:
        return DW_SHIFTS
    if op.kind in (G.PW, G.DENSE):
        if backend == "cuda" and rank != 1:
            return PALLAS_PW
        return INT_F32 if pop.f32_exact else INT_REF
    return INT_F32 if pop.f32_exact else INT_REF  # CONV / CONV1D


def _select(cands: Sequence[Candidate], x: torch.Tensor, ref: torch.Tensor,
            measure, default: Optional[str] = None,
            tracer: OT.Tracer = OT.NULL,
            span_key: str = "",
            scorer: Optional[Callable[[float, Candidate], float]] = None,
            verbose: bool = False) -> Optional[RouteChoice]:
    """Verify-then-time every candidate; return the best exact one.

    Exactness is the hard gate: a candidate whose output differs from the
    reference in any element, or that raises, is disqualified before it is
    ever timed, and its label is recorded in `RouteChoice.disqualified`
    (with `verbose`, the reason is printed to stderr). Ties break on the
    label, so selection is deterministic under a deterministic timer.
    `scorer(seconds, candidate)` replaces raw time as the ranking metric
    (the EDP objective). `default` names the untuned route; a challenger
    replaces it only by beating its score by more than MARGIN (isolated
    per-op times flatter a route, and clocks are noisy: within the margin
    the proven default is the better bet)."""
    timed: List[Tuple[float, Candidate]] = []
    disqualified: List[str] = []
    for c in cands:
        t0 = tracer.now() if tracer else 0.0
        measured, why = None, None
        try:
            out = c.fn(x)
            if out.shape != ref.shape or not torch.equal(out, ref):
                why = "output differs from the reference"
        except Exception as e:  # noqa: BLE001 — a route that cannot run loses
            why = f"raised {type(e).__name__}: {e}"
        if why is not None:
            disqualified.append(c.label)
            if verbose:
                print(f"[tune] {span_key}: {c.label} disqualified: {why}",
                      file=sys.stderr)
        else:
            measured = float(measure(c.fn, x, c))
            timed.append((measured, c))
        if tracer:
            tracer.complete(
                f"tune:{span_key or 'select'}", t0, tracer.now(),
                cat="tune", tid=OT.TID_TUNE,
                args={"candidate": c.label,
                      "us": None if measured is None else measured * 1e6,
                      "disqualified": measured is None})
    if not timed:
        return None
    score_of = scorer if scorer is not None else (lambda t, c: t)
    scored = [(score_of(t, c), t, c) for t, c in timed]
    scored.sort(key=lambda stc: (stc[0], stc[2].label))
    us_ref = next((t * 1e6 for _, t, c in scored if c.route == INT_REF), None)
    best_s, best_t, best = scored[0]
    if default is not None and best.route != default:
        default_scored = [stc for stc in scored if stc[2].route == default]
        if default_scored and best_s > default_scored[0][0] * (1.0 - MARGIN):
            best_s, best_t, best = default_scored[0]
    return RouteChoice.make(
        best.route, best.params, us=best_t * 1e6, us_ref=us_ref,
        n_candidates=len(cands), disqualified=tuple(disqualified))


def _winner(tracer, key: str, choice: RouteChoice, verbose: bool) -> None:
    if tracer:
        tracer.instant("tune_winner", tracer.now(), cat="tune",
                       tid=OT.TID_TUNE,
                       args={"key": key, "route": choice.route,
                             "params": dict(choice.params), "us": choice.us})
    if verbose:
        print(f"[tune] {key} -> {choice.route}{dict(choice.params) or ''} "
              f"{choice.us:.1f}us", file=sys.stderr)


def tune_qnet(
    qnet,
    plan: Optional[CC.CUPlan] = None,
    *,
    batch: int = 8,
    input_bits: int = 8,
    seed: int = 0,
    repeats: int = 3,
    measure=None,
    candidates_fn=None,
    device=None,
    verbose: bool = False,
    tracer: Optional[OT.Tracer] = None,
    objective: str = "latency",
    power=None,
) -> TunedPlan:
    """Tune every op (and fusable IRB block) of `qnet` on `device` (CUDA
    unless the caller names another; it raises without a card); return a
    `TunedPlan` for that device's backend.

    Walks the net with the default (reference) formulations, so each
    candidate is verified and timed on the true input activations of its
    layer (`batch` images drawn from `seed`). `measure(fn, x, candidate)
    -> seconds` and `candidates_fn(prepared_op) -> [Candidate]` are
    injectable (deterministic fakes in tests). `objective` ranks by
    `"latency"` or `"edp"` (with `power`, default the backend's
    `default_power_model`). The plan is returned only after the whole net
    has been re-run through `run_qnet(prepare_qnet(tuned=))` and through
    the tuned stage executors without one logit drifting from the
    untuned `run_qnet`: else it raises. `tracer`
    records one span per candidate and one winner instant per entry on the
    `autotune` track (`TID_TUNE`)."""
    if objective not in ("latency", "edp"):
        raise ValueError(f"unknown objective {objective!r} "
                         f"(want 'latency' or 'edp')")
    pq = cu.prepare_qnet(qnet, input_bits=input_bits, device=device)
    pq = cu.prepare_qnet(pq, device=pq.device, routes={})  # the reference
    dev = pq.device
    backend = dev.type
    if objective == "edp" and power is None:
        from repro_torch.energy.power import default_power_model
        power = default_power_model(backend)
    tracer = tracer if tracer is not None else OT.NULL
    if tracer:
        tracer.name_track(OT.TID_TUNE, "autotune")
    spec = pq.spec
    plan = plan if plan is not None else CC.compile_net(spec)
    measure = measure or wall_measure(repeats)
    rank = spec.spatial_rank
    in_hw_by_op = {op.name: in_hw
                   for _, _, op, in_hw in plan.op_descriptors()}
    block_in_hw: Dict[str, Optional[int]] = {}
    for _, block, _, in_hw in plan.op_descriptors():
        block_in_hw.setdefault(block.name, in_hw)
    op_scorer, block_scorer = _scorers(objective, power, rank)

    gen = torch.Generator().manual_seed(seed)
    x = (torch.rand((batch, *spec.input_shape()), generator=gen) * 2 - 1
         ).to(dev)
    in_s, in_z = cu.input_qparams(pq)
    y = cu.quantize_input(x, pq.input_scale, in_z, input_bits)

    entries: Dict[str, RouteChoice] = {}
    s, z = in_s, in_z
    for block in spec.blocks:
        x_block, s_block, z_block = y, s, z
        block_routes: Dict[str, Tuple[str, Dict[str, int]]] = {}
        for op in block.ops:
            pop = pq.ops[op.name]
            ref = cu.run_qop(y, pop)
            if candidates_fn is None:
                cands = op_candidates(pop, rows=y.numel() // op.in_ch)
            else:
                cands = candidates_fn(pop)
            if cands:
                key = op_key(op, in_hw_by_op[op.name], backend, rank=rank)
                choice = entries.get(key)
                if choice is None:
                    # an identical-shape op is measured once (repeated
                    # Body blocks): re-measuring would let the clock's
                    # noise flip the recorded winner
                    choice = _select(
                        cands, y, ref, measure,
                        default=default_route(pop, backend, rank=rank),
                        tracer=tracer, span_key=key,
                        scorer=op_scorer(op, in_hw_by_op[op.name]),
                        verbose=verbose)
                    if choice is not None:
                        _winner(tracer, key, choice, verbose)
                if choice is not None:
                    entries[key] = choice
                    block_routes[op.name] = (choice.route,
                                             choice.params_dict)
            y = ref
            s, z = pop.out_scale, pop.out_zp
            if block.se is not None and block.se_after == op.name:
                y = cu.se_gate(y, block, pq)  # not tuned: the default ops
        if block.residual:
            y_s, y_z = pq.res_q[block.name]
            qmax = 2 ** block.ops[-1].act_bits - 1
            y = cu.residual_add(x_block, s_block, z_block, y, s, z, y_s, y_z,
                                qmax)
            s, z = y_s, y_z
        if K.fusable_irb(block):
            # race K4 against the composite of the per-op winners (both
            # verified against the reference block output)
            bkey = irb_key(block, block_in_hw[block.name], backend)
            if bkey not in entries:
                pq_routed = cu.prepare_qnet(pq, device=dev,
                                            routes=block_routes)

                def per_op_fn(xb, _b=block, _s=s_block, _z=z_block,
                              _q=pq_routed):
                    return cu.run_block(xb, _b, _q, _s, _z)[0]

                def fused_fn(xb, _b=block, _s=s_block, _z=z_block):
                    return K.run_irb_block(xb, _b, pq, _s, _z)[0]

                choice = _select(
                    [Candidate(PER_OP, {}, per_op_fn),
                     Candidate(FUSED_IRB, {}, fused_fn)],
                    x_block, y, measure,
                    default=FUSED_IRB if backend == "cuda" else PER_OP,
                    tracer=tracer, span_key=bkey,
                    scorer=block_scorer(block, block_in_hw[block.name]),
                    verbose=verbose)
                if choice is not None:
                    entries[bkey] = choice
                    _winner(tracer, bkey, choice, verbose)
        if block.avgpool:
            y = cu.mean_round(y)

    tuned = TunedPlan(
        backend=backend,
        nets=(spec.name,),
        tuned_batch=batch,
        entries=entries,
        meta={"torch": torch.__version__, "input_hw": spec.input_hw,
              "input_bits": input_bits, "seed": seed,
              "fixed_point": False, "objective": objective,
              **({"power": power.as_dict()} if objective == "edp" else {})},
    )
    _verify_end_to_end(pq, plan, tuned, x, input_bits)
    return tuned


def _scorers(objective: str, power, rank: int):
    """(op_scorer, block_scorer): factories of the EDP scorers of one op's
    candidates and of a block race; each returns None under latency."""
    if objective != "edp":
        return (lambda op, in_hw: None), (lambda block, in_hw: None)
    from repro_torch.energy import model as EM

    def op_scorer(op: G.OpSpec, in_hw: Optional[int]):
        # every candidate of one op moves the same bytes
        nbytes = EM.op_bytes_moved(op, in_hw, rank)
        return lambda t, c: EM.edp_score(t, nbytes, power)

    def block_scorer(block: G.BlockSpec, in_hw: Optional[int]):
        # the per-op composite pays the DRAM traffic of every intermediate,
        # the fused kernel the block's input, output and weights only
        per_op_b, hw = 0, in_hw
        for op in block.ops:
            per_op_b += EM.op_bytes_moved(op, hw, rank)
            if hw is not None and op.kind != G.DENSE:
                hw = -(-hw // op.stride)
        w_bytes = sum(op.n_params(with_bias=False) + 4 * op.out_ch
                      for op in block.ops)
        first, last = block.ops[0], block.ops[-1]
        if in_hw is None or hw is None:
            n_in, n_out = first.in_ch, last.out_ch
        else:
            n_in = (in_hw * in_hw if rank == 2 else in_hw) * first.in_ch
            n_out = (hw * hw if rank == 2 else hw) * last.out_ch
        by_route = {PER_OP: per_op_b, FUSED_IRB: n_in + n_out + w_bytes}
        return lambda t, c: EM.edp_score(
            t, by_route.get(c.route, per_op_b), power)

    return op_scorer, block_scorer


def _verify_end_to_end(pq: cu.PreparedQNet, plan: CC.CUPlan,
                       tuned: TunedPlan, x: torch.Tensor,
                       input_bits: int) -> None:
    """Raise unless the tuned net's logits equal the untuned `run_qnet`'s
    through `prepare_qnet(tuned=)` and through the tuned stage executors
    (which also run the fused-IRB choices)."""
    from repro_torch.serve.vision.stages import compile_stages

    want = cu.run_qnet(pq, x, input_bits=input_bits)
    got = cu.run_qnet(cu.prepare_qnet(pq, device=pq.device, tuned=tuned), x,
                      input_bits=input_bits)
    if not torch.equal(got, want):
        raise RuntimeError("tuned plan drifted from run_qnet on the "
                           "monolithic route — refusing to emit it")
    y = x
    for stage in compile_stages(pq, plan, input_bits=input_bits,
                                device=pq.device, tuned=tuned):
        y = stage(y)
    if not torch.equal(y, want):
        raise RuntimeError("tuned plan drifted from run_qnet on the "
                           "stage-executor route — refusing to emit it")


__all__ = [
    "Candidate",
    "default_route",
    "op_candidates",
    "pw_tile_sweep",
    "tune_qnet",
    "wall_measure",
]
