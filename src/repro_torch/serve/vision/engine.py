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

Not ported yet: the data-parallel mesh, tuned route plans, the energy model
and power governor, observability, and `MultiModelEngine`.
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


@dataclasses.dataclass
class RequestResult:
    rid: int
    status: str  # "ok" | "expired"
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
    latency_p99_s: float
    micro_batches: int
    pad_fraction: float  # padded rows / dispatched rows
    stage_invocations: Dict[str, int]
    harvest_wait_s: float
    macs_per_image: int
    device: str

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


class VisionEngine:
    """Serve a calibrated QNet through the pipelined CU stage executors on
    one device (CUDA unless `device=` names another). `fixed_point=True`
    serves the integer mantissa/shift requant through the reference torch
    ops (see `compile_stages`)."""

    @classmethod
    def from_artifact(cls, path: str, **kwargs) -> "VisionEngine":
        """Serve a frozen `.qnet` deployment artifact straight from disk (its
        build record rebuilds the NetSpec). Engine knobs pass through."""
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
        clock: Optional[Callable[[], float]] = None,
        max_queue: int = 4096,
    ):
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError(f"bad buckets {buckets}")
        self.pq = cu.prepare_qnet(qnet, input_bits=input_bits, device=device)
        self.device = self.pq.device
        self.plan = plan if plan is not None else CC.compile_net(self.pq.spec)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self._clock = time.perf_counter if clock is None else clock
        self.max_queue = max_queue
        self.stages: List[CompiledStage] = compile_stages(
            self.pq, self.plan, input_bits=input_bits,
            body_fast_path=body_fast_path, op_kernels=op_kernels,
            fixed_point=fixed_point, device=self.device)
        self.pipe = PipelinedExecutor(self.stages, clock=self._clock)
        self.input_shape = self.pq.spec.input_shape()  # (H, W, C)
        self._queue: List[VisionRequest] = []
        self._rid = itertools.count()
        self._results: Dict[int, RequestResult] = {}
        # cumulative counters (across run() calls)
        self._n_ok = 0
        self._n_expired = 0
        self._latencies: List[float] = []
        self._micro_batches = 0
        self._rows = 0
        self._pad_rows = 0
        self._wall_s = 0.0

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def submit(self, image: np.ndarray, *, deadline_s: Optional[float] = None,
               now: Optional[float] = None) -> int:
        """Admit one image; returns its request id. Raises AdmissionError
        when the image does not match the compiled input signature or the
        queue is full."""
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
            rid=rid, image=image, deadline_s=deadline_s, arrival_s=arrival))
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

    def _place(self, x: np.ndarray) -> torch.Tensor:
        """Host micro-batch -> device: the one copy a micro-batch makes,
        from pinned memory on CUDA so that it runs asynchronously."""
        t = torch.from_numpy(x)
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
                    continue
                live.append(req)
            if not live:
                continue
            bucket = self._bucket_for(len(live))
            x = np.zeros((bucket, *self.input_shape), np.float32)
            for i, req in enumerate(live):
                x[i] = req.image
            self._micro_batches += 1
            self._rows += bucket
            self._pad_rows += bucket - len(live)
            yield live, self._place(x)

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------

    def _record_batch(self, reqs: List[VisionRequest], y: torch.Tensor,
                      done: float) -> None:
        """Un-pad a finished micro-batch into per-request results."""
        logits = y.cpu().numpy()
        for i, req in enumerate(reqs):
            self._results[req.rid] = RequestResult(
                req.rid, "ok", logits[i], done - req.arrival_s)
            self._latencies.append(done - req.arrival_s)
            self._n_ok += 1

    def run(self) -> Dict[int, RequestResult]:
        """Drain the queue through the pipelined CU stages; return results
        (keyed by request id) for everything finished by this call."""
        t0 = self._clock()
        for reqs, y in self.pipe.stream(self._form_batches()):
            self._record_batch(reqs, y, self._clock())
        self._wall_s += self._clock() - t0
        results, self._results = self._results, {}
        return results

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
        return EngineStats(
            n_ok=self._n_ok,
            n_expired=self._n_expired,
            wall_s=self._wall_s,
            fps=self._n_ok / self._wall_s if self._wall_s > 0 else 0.0,
            latency_p50_s=_percentile(lat, 0.50),
            latency_p95_s=_percentile(lat, 0.95),
            latency_p99_s=_percentile(lat, 0.99),
            micro_batches=self._micro_batches,
            pad_fraction=(self._pad_rows / self._rows) if self._rows else 0.0,
            stage_invocations={s.spec.cu: s.invocations for s in self.stages},
            harvest_wait_s=self.pipe.harvest_wait_s,
            macs_per_image=self.pq.spec.count_macs(),
            device=str(self.device),
        )


__all__ = [
    "AdmissionError",
    "VisionRequest",
    "RequestResult",
    "EngineStats",
    "VisionEngine",
]
