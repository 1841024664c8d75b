"""Continuous-batching front end for integer DSCNN serving.

Counterpart of `repro/serve/vision/engine.py` (`VisionEngine`). Requests
(single images) enter a bounded queue; the batch former drains it
earliest-deadline-first into micro-batches, pads an odd tail up to the
nearest bucket so every stage sees one of a fixed set of batch sizes, drops
requests whose deadline has passed (they burn no CU work), and feeds the
software-pipelined CU executor. Results are un-padded back to per-request
logits with latency accounting. Every time — arrival, deadline, latency,
wall — is read from one injectable clock.

Admission mirrors what a fixed-function accelerator accepts: images must
match the compiled input signature (H x W x C, float) exactly.

`MultiModelEngine` routes requests tagged by model to per-model engines
sharing the card; the order models dispatch in each round is
earliest-deadline-first over their next micro-batches.

`EngineStats` reports the paper's Table 6 serving quantities: FPS, latency
percentiles, per-stage invocation counts, and modeled energy from the
calibrated `repro_torch.energy` model (analytic pJ/MAC and pJ/byte, or
tuned route timings, x the device's power curve) — J/image, average
watts, and the paper's headline FPS/Watt. With `power_budget_w=` the batch
former consults a `PowerGovernor` before every dispatch and defers (or
sheds lowest-SLO) work so the modeled rolling-window watt estimate never
crosses the budget. With `tracer=`/`metrics=` (`repro_torch.obs`) every
request's lifecycle becomes trace spans and every stage's work metrics,
with the same clock reads, spans and instruments as the reference's.

`tuned=` serves a measured route selection (`repro_torch.tune`; see
`compile_stages`), and the same cache prices the energy model's ops.

`mesh=` (a 1-D 'data' mesh from `repro_torch.dist.sharding.data_mesh`)
replicates the whole integer datapath: every device of the mesh holds its
own constants, and each micro-batch's rows are split across the replicas,
each block copied to its own device, and gathered back in replica order —
the multi-device analogue of DeepDive's parallel channel/filter CU
replication. Results stay bit-exact because every image's arithmetic is
replica-local.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import compiler as CC
from repro_torch.core import cu
from repro_torch.core.qnet import QNet, load_qnet
from repro_torch.dist.sharding import batch_sharding, place
from repro_torch.energy import (
    EnergyReport,
    PowerGovernor,
    PowerModel,
    estimate_energy,
)
from repro_torch.obs import metrics as OM
from repro_torch.obs import trace as OT
from repro_torch.serve.vision.pipeline import PipelinedExecutor
from repro_torch.serve.vision.stages import CompiledStage, compile_stages


def _percentile(sorted_lat: Sequence[float], p: float) -> float:
    """Nearest-rank percentile over pre-sorted latencies; NaN when there
    are none (every request expired)."""
    if not sorted_lat:
        return float("nan")
    return sorted_lat[max(0, math.ceil(p * len(sorted_lat)) - 1)]


class AdmissionError(ValueError):
    """Request rejected at admission (shape mismatch / queue full)."""


@dataclasses.dataclass
class VisionRequest:
    rid: int
    image: np.ndarray  # [H, W, C] float, in the calibrated input range
    deadline_s: Optional[float] = None  # absolute time on the engine clock
    arrival_s: float = 0.0
    # SLO class: higher is more important. Under a power budget the
    # governor may shed requests at or below the engine's shed class;
    # work above it is only ever deferred, never dropped.
    slo: int = 0


@dataclasses.dataclass
class RequestResult:
    rid: int
    status: str  # "ok" | "expired" | "shed"
    logits: Optional[np.ndarray]  # [num_classes] float32, None unless ok
    latency_s: float


@dataclasses.dataclass
class EngineStats:
    n_ok: int
    n_expired: int
    wall_s: float
    fps: float
    latency_p50_s: float
    latency_p95_s: float
    micro_batches: int
    pad_fraction: float  # padded rows / dispatched rows
    stage_invocations: Dict[str, int]
    harvest_wait_s: float
    macs_per_image: int
    # calibrated energy model (repro_torch.energy): J/image from route
    # timings x bytes-moved x the device power curve; watts = idle +
    # dispatched J / wall; fps_per_watt is the paper's headline metric
    energy_j_per_image: float
    watts: float
    fps_per_watt: float
    power_source: str
    energy_tuned_fraction: float  # fraction of ops priced from measured routes
    device: str
    replicas: int = 1  # mesh 'data' extent the engine shards over
    latency_p99_s: float = float("nan")
    # first calls at non-bucketed shapes per stage (should stay all-zero;
    # see CompiledStage.allowed_batches — a nonzero count is a leak)
    stage_retraces: Dict[str, int] = dataclasses.field(default_factory=dict)
    # power-capped scheduling outcomes (zero unless power_budget_w is set)
    n_shed: int = 0
    n_deferred: int = 0
    power_budget_w: Optional[float] = None

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


class VisionEngine:
    """Serve a calibrated QNet through the pipelined CU stage executors on
    one device (CUDA unless `device=` names another). `fixed_point=True`
    serves the integer mantissa/shift requant through the reference torch
    ops (see `compile_stages`).

    `mesh`: a 1-D 'data' mesh (see `dist.sharding.data_mesh`) shards every
    micro-batch data-parallel across its replicas; each requested bucket is
    rounded up to the next replica multiple (rows are bucket-padded anyway,
    so each replica gets equal rows). The engine's `device` is the mesh's
    first device; a `device=` that names another raises. `pq` is the net
    prepared there, the stages hold one copy a replica.

    `clock`: injectable time source (returns seconds, perf_counter-like) —
    deadlines, latencies, wall time, trace timestamps and the governor's
    window all read it; tests pass a fake.
    `tracer` / `metrics` / `name`: observability (`repro_torch.obs`); the
    name labels this engine's instruments and request spans.
    `tuned`: a `repro_torch.tune.TunedPlan` — the measured per-op route
    selection; ops with no cache entry keep the kernel flags' defaults
    (see `compile_stages`). The same cache feeds the energy model's per-op
    timings.
    `power_model` / `energy`: override the device power curve or the whole
    `EnergyReport` (defaults: the device's per-backend constants, or RAPL
    on a CPU, and `estimate_energy` over this plan and cache).
    `power_budget_w`: power-capped mode — before each dispatch the batch
    former asks a `PowerGovernor` whether the modeled rolling-window
    (`power_window_s`) watt estimate would cross the budget; if so,
    requests with `slo <= shed_slo` are shed (terminal "shed" status) and
    the rest are deferred back to the queue for a later `run()`.
    """

    @classmethod
    def from_artifact(cls, path: str, **kwargs) -> "VisionEngine":
        """Serve a frozen `.qnet` deployment artifact straight from disk (its
        build record rebuilds the NetSpec). Engine knobs (`buckets`,
        `mesh`, `tuned`, ...) pass through."""
        return cls(load_qnet(path), **kwargs)

    def __init__(
        self,
        qnet: QNet,
        plan: Optional[CC.CUPlan] = None,
        *,
        buckets: Sequence[int] = (1, 2, 4, 8),
        input_bits: int = 8,
        body_fast_path: str = "auto",
        op_kernels: str = "auto",
        fixed_point: bool = False,
        device=None,
        mesh=None,
        tuned=None,
        clock: Optional[Callable[[], float]] = None,
        max_queue: int = 4096,
        tracer: Optional[OT.Tracer] = None,
        metrics: Optional[OM.MetricsRegistry] = None,
        name: str = "default",
        power_model: Optional[PowerModel] = None,
        energy: Optional[EnergyReport] = None,
        power_budget_w: Optional[float] = None,
        power_window_s: float = 1.0,
        shed_slo: int = 0,
    ):
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError(f"bad buckets {buckets}")
        if mesh is not None:
            qnet = cu.mesh_base(qnet, mesh, device)
            device = mesh.device_list[0]
        self.pq = cu.prepare_qnet(qnet, input_bits=input_bits, device=device)
        self.device = self.pq.device
        self.qnet = self.pq.qnet
        self.plan = plan if plan is not None else CC.compile_net(self.pq.spec)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.mesh = mesh
        self.replicas = 1
        self._batch_sharding = None
        if mesh is not None:
            self.replicas = int(dict(mesh.shape).get("data", 1))
            # every bucket rounds up to the next replica multiple: batches
            # are bucket-padded regardless, so each shard gets equal rows
            self.buckets = tuple(sorted(
                {-(-b // self.replicas) * self.replicas
                 for b in self.buckets}))
            self._batch_sharding = batch_sharding(mesh)
        self._clock = time.perf_counter if clock is None else clock
        self.max_queue = max_queue
        self.stages: List[CompiledStage] = compile_stages(
            self.pq, self.plan, input_bits=input_bits,
            body_fast_path=body_fast_path, op_kernels=op_kernels,
            fixed_point=fixed_point, device=self.device, tuned=tuned,
            mesh=mesh)
        self.name = name
        self.tracer = tracer if tracer is not None else OT.NULL
        self.metrics = metrics
        self._reg = metrics if metrics is not None else OM.NULL_REGISTRY
        self.pipe = PipelinedExecutor(self.stages, clock=self._clock,
                                      tracer=tracer, metrics=metrics)
        self.input_shape = self.pq.spec.input_shape()  # (H, W, C)
        # calibrated energy model over this plan: tuned route timings (when
        # a cache is in hand) priced on this device's power curve
        self.energy = energy if energy is not None else estimate_energy(
            self.pq.spec, self.plan, tuned=tuned, power=power_model,
            backend=self.device.type)
        self.power_budget_w = power_budget_w
        self.shed_slo = shed_slo
        self._governor: Optional[PowerGovernor] = None
        if power_budget_w is not None:
            self._governor = PowerGovernor(
                power_budget_w, window_s=power_window_s,
                idle_w=self.energy.power.idle_w)
        self._queue: List[VisionRequest] = []
        self._rid = itertools.count()
        self._results: Dict[int, RequestResult] = {}
        # cumulative counters (across run() calls)
        self._n_ok = 0
        self._n_expired = 0
        self._n_shed = 0
        self._n_deferred = 0
        self._dispatched_j = 0.0  # modeled energy of every dispatched row
        self._latencies: List[float] = []
        self._micro_batches = 0
        self._rows = 0
        self._pad_rows = 0
        self._wall_s = 0.0
        self._init_obs()

    def _init_obs(self) -> None:
        """Register instruments, arm retrace-leak detection, name the trace
        tracks, and tie stage dispatch spans back to request ids."""
        reg, lbl = self._reg, {"model": self.name}
        self._m_submitted = reg.counter(
            "serve_requests_submitted_total", "requests admitted", labels=lbl)
        self._m_expired = reg.counter(
            "serve_requests_expired_total",
            "requests dropped at batch forming (EDF deadline expiry)",
            labels=lbl)
        self._m_completed = reg.counter(
            "serve_requests_completed_total", "requests answered with logits",
            labels=lbl)
        self._m_qdepth = reg.gauge(
            "serve_queue_depth", "requests waiting for batch formation",
            labels=lbl)
        self._m_qwait = reg.histogram(
            "serve_queue_wait_seconds",
            "arrival to batch-formation wait", labels=lbl)
        self._m_latency = reg.histogram(
            "serve_request_latency_seconds",
            "arrival to harvested-logits latency", labels=lbl)
        self._m_batches = reg.counter(
            "serve_micro_batches_total", "bucket-padded micro-batches formed",
            labels=lbl)
        self._m_rows = reg.counter(
            "serve_dispatched_rows_total",
            "rows dispatched incl. bucket padding", labels=lbl)
        self._m_pad = reg.counter(
            "serve_pad_rows_total", "bucket-padding waste rows", labels=lbl)
        self._m_fps = reg.gauge(
            "serve_fps", "completed images per second of drain wall time",
            labels=lbl)
        self._m_fpw = reg.gauge(
            "serve_fps_per_watt",
            "modeled FPS per watt (calibrated energy model, incl. idle draw)",
            labels=lbl)
        self._m_watts = reg.gauge(
            "serve_watts",
            "modeled average device watts over serving wall time", labels=lbl)
        self._m_shed = reg.counter(
            "serve_requests_shed_total",
            "low-SLO requests shed by the power governor", labels=lbl)
        self._m_deferred = reg.counter(
            "serve_requests_deferred_total",
            "requests deferred to a later run() by the power governor",
            labels=lbl)
        # retrace-leak detection: every stage knows the legal batch shapes
        # (the padded buckets); a first call outside them is a leak past
        # the batch former — counted, warned, and surfaced in stats()
        allowed = frozenset(self.buckets)
        for st in self.stages:
            st.allowed_batches = allowed
            st.on_retrace = self._note_retrace(reg.counter(
                "serve_stage_retraces_total",
                "stage traces at non-bucketed batch shapes (retrace leak)",
                labels={"model": self.name, "cu": st.spec.cu}))
        if self.tracer:
            self.tracer.name_track(OT.TID_ENGINE, "engine")
            self.tracer.name_track(OT.TID_REQUESTS, "requests")
            self.tracer.name_track(OT.TID_SCHED, "scheduler")
            self.pipe.tag_info = lambda reqs: {"rids": [r.rid for r in reqs]}

    def _note_retrace(self, metric) -> Callable:
        def _hook(stage: CompiledStage, shape: Tuple[int, ...]) -> None:
            metric.inc()
            if self.tracer:
                self.tracer.instant(
                    f"retrace:{stage.spec.cu}", self._clock(),
                    cat="retrace", tid=OT.TID_ENGINE,
                    args={"shape": list(shape),
                          "buckets": sorted(stage.allowed_batches)})
        return _hook

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def submit(self, image: np.ndarray, *, deadline_s: Optional[float] = None,
               now: Optional[float] = None, slo: int = 0) -> int:
        """Admit one image; returns its request id.

        `slo` is the request's service class (higher = more important);
        under a power budget only classes at or below `shed_slo` may be
        shed. Raises AdmissionError when the image does not match the
        compiled input signature or the queue is full."""
        image = np.asarray(image)
        if image.shape != self.input_shape:
            raise AdmissionError(
                f"image shape {image.shape} != compiled input signature "
                f"{self.input_shape} (HxWxC)")
        if not np.issubdtype(image.dtype, np.floating):
            raise AdmissionError(
                f"expected float image in the calibrated input range, got "
                f"dtype {image.dtype}")
        if len(self._queue) >= self.max_queue:
            raise AdmissionError(f"queue full ({self.max_queue})")
        rid = next(self._rid)
        arrival = self._clock() if now is None else now
        self._queue.append(VisionRequest(
            rid=rid, image=image, deadline_s=deadline_s, arrival_s=arrival,
            slo=slo))
        self._m_submitted.inc()
        self._m_qdepth.set(len(self._queue))
        if self.tracer:
            # per-request lifecycle span opens at admission (async "b",
            # closed at expiry, shedding or completion); arrival is already
            # read — no extra clock reads on the admission path
            self.tracer.async_begin(
                "request", rid, arrival, cat=f"request:{self.name}",
                args={"model": self.name, "deadline_s": deadline_s})
            self.tracer.counter(
                f"queue_depth:{self.name}", {"pending": len(self._queue)},
                arrival)
        return rid

    def pending(self) -> int:
        return len(self._queue)

    # ------------------------------------------------------------------
    # batch forming
    # ------------------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        """Smallest bucket that covers n, else the largest bucket."""
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _place(self, x: np.ndarray):
        """Host micro-batch -> device: the one copy a micro-batch makes,
        from pinned memory on CUDA so that it runs asynchronously. With a
        mesh, each replica's rows go to its own device."""
        t = torch.from_numpy(x)
        if self._batch_sharding is not None:
            return place(t, self._batch_sharding, non_blocking=True)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _form_batches(self) -> Iterator[Tuple[List[VisionRequest],
                                              torch.Tensor]]:
        """Drain the queue into bucket-padded micro-batches, EDF-ordered,
        one per next() — so forming batch k+1 overlaps the card running
        batch k."""
        self._queue.sort(
            key=lambda r: r.deadline_s if r.deadline_s is not None
            else float("inf"))
        pending, self._queue = self._queue, []
        self._m_qdepth.set(0)
        head = 0
        while head < len(pending):
            now = self._clock()
            live: List[VisionRequest] = []
            while head < len(pending) and len(live) < self.buckets[-1]:
                req = pending[head]
                head += 1
                if req.deadline_s is not None and now > req.deadline_s:
                    self._results[req.rid] = RequestResult(
                        req.rid, "expired", None, now - req.arrival_s)
                    self._n_expired += 1
                    self._m_expired.inc()
                    if self.tracer:
                        self.tracer.async_end(
                            "request", req.rid, now,
                            cat=f"request:{self.name}",
                            args={"status": "expired"})
                    continue
                live.append(req)
            if not live:
                continue
            bucket = self._bucket_for(len(live))
            if self._governor is not None:
                # power-capped dispatch: every padded row costs modeled
                # J/image on the device; if this batch would push the
                # rolling-window watt estimate over the budget, shed the
                # sheddable SLO classes and defer everything else — the
                # budget is never crossed at any dispatch point.
                batch_j = bucket * self.energy.j_per_image
                if self._governor.would_exceed(batch_j, now):
                    self._shed_or_defer(live, pending[head:], now)
                    return
                self._governor.record(batch_j, now)
            self._dispatched_j += bucket * self.energy.j_per_image
            x = np.zeros((bucket, *self.input_shape), np.float32)
            for i, req in enumerate(live):
                x[i] = req.image
            self._micro_batches += 1
            self._rows += bucket
            self._pad_rows += bucket - len(live)
            self._m_batches.inc()
            self._m_rows.inc(bucket)
            self._m_pad.inc(bucket - len(live))
            for req in live:
                self._m_qwait.observe(now - req.arrival_s)
            if self.tracer:
                # batch-formation span covers the host-side gather+pad; the
                # per-request queue waits nest as b/e pairs on timestamps
                # already read (arrival, now)
                tf1 = self._clock()
                self.tracer.complete(
                    "form_batch", now, tf1, cat="pipeline", tid=OT.TID_SCHED,
                    args={"model": self.name, "bucket": bucket,
                          "live": len(live), "pad": bucket - len(live),
                          "rids": [r.rid for r in live]})
                for req in live:
                    self.tracer.async_begin(
                        "queue_wait", req.rid, req.arrival_s,
                        cat=f"request:{self.name}")
                    self.tracer.async_end(
                        "queue_wait", req.rid, now,
                        cat=f"request:{self.name}")
            yield live, self._place(x)

    def _shed_or_defer(self, live: List[VisionRequest],
                       rest: List[VisionRequest], now: float) -> None:
        """Over-budget batch: shed classes <= shed_slo (terminal), defer
        the remainder back to the queue for a later run()."""
        deferred: List[VisionRequest] = []
        for req in live:
            if req.slo <= self.shed_slo:
                self._results[req.rid] = RequestResult(
                    req.rid, "shed", None, now - req.arrival_s)
                self._n_shed += 1
                self._m_shed.inc()
                if self.tracer:
                    self.tracer.async_end(
                        "request", req.rid, now, cat=f"request:{self.name}",
                        args={"status": "shed"})
            else:
                deferred.append(req)
        deferred.extend(rest)
        if deferred:
            # deferral is not terminal: requests keep their arrival and
            # deadline, and re-enter EDF ordering on the next drain
            self._queue.extend(deferred)
            self._n_deferred += len(deferred)
            self._m_deferred.inc(len(deferred))
            self._m_qdepth.set(len(self._queue))
        if self.tracer:
            self.tracer.instant(
                "power_cap", now, cat="governor", tid=OT.TID_SCHED,
                args={"model": self.name,
                      "watts": self._governor.watts(now),
                      "budget_w": self.power_budget_w,
                      "shed": self._n_shed, "deferred": len(deferred)})

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------

    def _record_batch(self, reqs: List[VisionRequest], y,
                      done: float) -> None:
        """Un-pad a finished micro-batch into per-request results (a
        replicated one gathered in replica order)."""
        logits = y.cpu().numpy()
        for i, req in enumerate(reqs):
            self._results[req.rid] = RequestResult(
                req.rid, "ok", logits[i], done - req.arrival_s)
            self._latencies.append(done - req.arrival_s)
            self._n_ok += 1
            self._m_completed.inc()
            self._m_latency.observe(done - req.arrival_s)
            if self.tracer:
                self.tracer.async_end(
                    "request", req.rid, done, cat=f"request:{self.name}",
                    args={"status": "ok"})

    def _collect_results(self) -> Dict[int, RequestResult]:
        results, self._results = self._results, {}
        return results

    def run(self) -> Dict[int, RequestResult]:
        """Drain the queue through the pipelined CU stages; return results
        (keyed by request id) for everything finished by this call."""
        t0 = self._clock()
        for reqs, y in self.pipe.stream(self._form_batches()):
            self._record_batch(reqs, y, self._clock())
        t1 = self._clock()
        self._wall_s += t1 - t0
        if self.tracer:
            self.tracer.complete(
                "drain", t0, t1, cat="engine", tid=OT.TID_ENGINE,
                args={"model": self.name})
        return self._collect_results()

    def warmup(self) -> None:
        """Run every stage once at every bucket size (builds the kernels and
        warms the allocator off the serving path)."""
        for b in self.buckets:
            self.pipe.warmup(
                self._place(np.zeros((b, *self.input_shape), np.float32)))

    # ------------------------------------------------------------------
    # stats
    # ------------------------------------------------------------------

    def stats(self) -> EngineStats:
        lat = sorted(self._latencies)
        fps = self._n_ok / self._wall_s if self._wall_s > 0 else 0.0
        # modeled draw over the serving window: static idle floor plus the
        # dispatched (bucket-padded) rows' modeled joules amortized over
        # wall time — rate-dependent, like measured board power
        watts = self.energy.power.idle_w + (
            self._dispatched_j / self._wall_s if self._wall_s > 0 else 0.0)
        fps_per_watt = fps / watts if watts > 0 else 0.0
        self._m_fps.set(fps)
        self._m_fpw.set(fps_per_watt)
        self._m_watts.set(watts)
        return EngineStats(
            n_ok=self._n_ok,
            n_expired=self._n_expired,
            wall_s=self._wall_s,
            fps=fps,
            latency_p50_s=_percentile(lat, 0.50),
            latency_p95_s=_percentile(lat, 0.95),
            micro_batches=self._micro_batches,
            pad_fraction=(self._pad_rows / self._rows) if self._rows else 0.0,
            stage_invocations={s.spec.cu: s.invocations for s in self.stages},
            harvest_wait_s=self.pipe.harvest_wait_s,
            macs_per_image=self.pq.spec.count_macs(),
            energy_j_per_image=self.energy.j_per_image,
            watts=watts,
            fps_per_watt=fps_per_watt,
            power_source=self.energy.power.source,
            energy_tuned_fraction=self.energy.tuned_fraction,
            device=str(self.device),
            replicas=self.replicas,
            latency_p99_s=_percentile(lat, 0.99),
            stage_retraces={s.spec.cu: s.retraces for s in self.stages},
            n_shed=self._n_shed,
            n_deferred=self._n_deferred,
            power_budget_w=self.power_budget_w,
        )


class MultiModelEngine:
    """EDF router over per-model `VisionEngine`s sharing the card (mesh).

    Requests are tagged by model name at submit time and drain through that
    model's own stage pipeline. One `run()` drains every model's queue:
    each scheduler round ticks every pipeline once (so no model starves),
    and the order models dispatch within a round is earliest-deadline-first
    over each model's next pending micro-batch — the model holding the
    tightest deadline enqueues its CU invocations into the shared CUDA
    stream first, extending the single-model EDF policy across models.

    `dispatch_log` records (model, live_rows) per dispatched micro-batch in
    dispatch order for the LAST drain (reset at each run()) — the
    scheduling trace the fairness tests assert on.

    One time source rules the fleet: an explicit `clock` is propagated down
    to every engine (wall time, latencies, and deadline expiry must never
    mix clocks); with `clock=None` the router adopts the engines' shared
    clock and refuses construction if they disagree.

    `power_budget_w` installs ONE shared `PowerGovernor` across every
    engine: the rolling-window watt estimate sums all models' dispatches,
    so the fleet as a whole stays under the budget (an engine that already
    has its own governor is refused — two books over one device would
    both be wrong).
    """

    def __init__(self, engines: Dict[str, VisionEngine],
                 clock: Optional[Callable[[], float]] = None,
                 *, power_budget_w: Optional[float] = None,
                 power_window_s: float = 1.0):
        if not engines:
            raise ValueError("need at least one model engine")
        self.engines = dict(engines)
        if clock is None:
            clocks = {id(e._clock) for e in self.engines.values()}
            if len(clocks) != 1:
                raise ValueError(
                    "engines hold different clocks — pass an explicit "
                    "clock= to unify the router's time source")
            self._clock = next(iter(self.engines.values()))._clock
        else:
            for eng in self.engines.values():
                # rebinding the clock over prior activity would mix time
                # domains: arrivals/deadlines in flight, or wall/expiry
                # counters already accrued under the old clock
                if (eng.pending() or eng._latencies or eng._results
                        or eng._wall_s or eng._n_ok or eng._n_expired
                        or eng.pipe.busy):
                    raise ValueError(
                        "cannot rebind the clock of an engine with pending "
                        "requests or recorded activity — construct the "
                        "router before serving")
            self._clock = clock
            for eng in self.engines.values():
                eng._clock = clock
                eng.pipe._clock = clock
        self.governor: Optional[PowerGovernor] = None
        if power_budget_w is not None:
            owned = sorted(m for m, e in self.engines.items()
                           if e._governor is not None)
            if owned:
                raise ValueError(
                    f"engines {owned} already run their own power governor "
                    f"— a fleet budget needs one shared book; construct "
                    f"them without power_budget_w")
            idle = max(e.energy.power.idle_w for e in self.engines.values())
            self.governor = PowerGovernor(
                power_budget_w, window_s=power_window_s, idle_w=idle)
            for eng in self.engines.values():
                eng._governor = self.governor
                eng.power_budget_w = power_budget_w
        self.dispatch_log: List[Tuple[str, int]] = []
        # router dispatch decisions, counted into each engine's registry
        # (engines sharing a registry/tracer yield one fleet-wide view)
        self._m_dispatch = {
            m: e._reg.counter(
                "router_dispatch_total",
                "micro-batches the EDF router dispatched for this model",
                labels={"model": m})
            for m, e in self.engines.items()}

    # -- admission ---------------------------------------------------------

    def submit(self, model: str, image: np.ndarray, *,
               deadline_s: Optional[float] = None,
               now: Optional[float] = None,
               slo: int = 0) -> Tuple[str, int]:
        """Admit one image for `model`; returns the (model, rid) handle."""
        eng = self.engines.get(model)
        if eng is None:
            raise AdmissionError(
                f"unknown model {model!r}; serving {sorted(self.engines)}")
        return model, eng.submit(image, deadline_s=deadline_s, now=now,
                                 slo=slo)

    def pending(self) -> Dict[str, int]:
        return {m: e.pending() for m, e in self.engines.items()}

    def warmup(self) -> None:
        for eng in self.engines.values():
            eng.warmup()

    # -- scheduling --------------------------------------------------------

    @staticmethod
    def _edf_key(batch) -> float:
        """Earliest live deadline in a formed micro-batch (inf if none)."""
        if batch is None:
            return float("inf")
        deadlines = [r.deadline_s for r in batch[0] if r.deadline_s is not None]
        return min(deadlines) if deadlines else float("inf")

    def run(self) -> Dict[Tuple[str, int], RequestResult]:
        """Drain every model's queue; results keyed by (model, rid)."""
        t0 = self._clock()
        self.dispatch_log = []  # trace of THIS drain only (bounded)
        formers: Dict[str, Iterator] = {}
        peeked: Dict[str, Optional[Tuple]] = {}
        for m, eng in self.engines.items():
            if eng.pending():
                formers[m] = eng._form_batches()
                peeked[m] = next(formers[m], None)
        active = set(formers)

        def live_models() -> List[str]:
            return [m for m, e in self.engines.items()
                    if peeked.get(m) is not None or e.pipe.busy]

        try:
            while True:
                models = live_models()
                if not models:
                    break
                # EDF across models: tightest next-batch deadline
                # dispatches first this round; name-ordered tie-break keeps
                # it deterministic (and round-robin-fair for deadline-less
                # load).
                for m in sorted(models,
                                key=lambda m: (self._edf_key(peeked.get(m)), m)):
                    eng = self.engines[m]
                    finished = eng.pipe.advance()
                    batch = peeked.get(m)
                    if batch is not None:
                        eng.pipe.inject(batch)
                        self.dispatch_log.append((m, len(batch[0])))
                        self._m_dispatch[m].inc()
                        if eng.tracer:
                            edf = self._edf_key(batch)
                            eng.tracer.instant(
                                "router_dispatch", self._clock(),
                                cat="router", tid=OT.TID_SCHED,
                                args={"model": m, "rows": len(batch[0]),
                                      "edf_deadline_s":
                                          edf if math.isfinite(edf)
                                          else None})
                        peeked[m] = next(formers[m], None)
                    if finished is not None:
                        eng.pipe.harvest(finished)
                        eng._record_batch(
                            finished[0], finished[1], eng._clock())
        finally:
            # mirror stream()'s abandoned-drain contract for the tick-level
            # drive: an escaping exception must not leave stale in-flight
            # batches to replay into a later run()'s results
            for m in self.engines:
                self.engines[m].pipe.reset()
        t1 = self._clock()
        wall = t1 - t0
        results: Dict[Tuple[str, int], RequestResult] = {}
        for m, eng in self.engines.items():
            if m in active:
                # the drain shared the device, so the full drain wall is
                # each participating model's serving window
                eng._wall_s += wall
                if eng.tracer:
                    eng.tracer.complete(
                        "drain", t0, t1, cat="engine", tid=OT.TID_ENGINE,
                        args={"model": m})
            for rid, res in eng._collect_results().items():
                results[(m, rid)] = res
        return results

    def stats(self) -> Dict[str, EngineStats]:
        return {m: e.stats() for m, e in self.engines.items()}


__all__ = [
    "AdmissionError",
    "VisionRequest",
    "RequestResult",
    "EngineStats",
    "VisionEngine",
    "MultiModelEngine",
]
