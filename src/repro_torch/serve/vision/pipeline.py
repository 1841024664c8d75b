"""Software-pipelined scheduler over the CU stage executors.

Counterpart of `repro/serve/vision/pipeline.py`. One scheduler tick advances
every occupied slot by one stage (back to front, so a micro-batch moves one
stage a tick) and then injects the next micro-batch into the Head slot.
PyTorch enqueues CUDA work asynchronously, so every dispatch of a tick
returns at once; when a micro-batch leaves the last stage the tick records
a CUDA event behind it, and `harvest` waits on that event alone — the work
already queued for later micro-batches keeps the card busy meanwhile.
A replicated micro-batch (`sharding.Sharded`, its row blocks on the
devices of a mesh) records one event on each of its devices' current
streams, and `harvest` waits for them all. On the CPU everything is
synchronous and `harvest` waits for nothing.

Observability (`tracer=` / `metrics=`, see `repro_torch.obs`), as in the
reference: each stage dispatch becomes a `dispatch:<cu>` span on that CU's
track (`TID_STAGE0 + i`; the enqueue time, since CUDA work is asynchronous,
so stage compute shows up as harvest wait at the sync point, which is also
traced), plus per-stage dispatch-seconds and bytes-moved instruments, a
tick counter and a harvest-wait histogram. Every extra clock read is
guarded by `if tracer`: with observability off the executor reads the
clock exactly where it always did.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Deque, Iterable, Iterator, List, Optional, Tuple

import torch

from repro_torch.dist.sharding import parts_of
from repro_torch.obs import metrics as OM
from repro_torch.obs import trace as OT
from repro_torch.serve.vision.stages import CompiledStage


def _stage_bytes_per_row(stage: CompiledStage) -> int:
    """Analytic uint8 activation traffic of one batch row through a stage:
    input read + output write at the stage boundary (the DDR view of the
    paper's CU invocation; intra-stage intermediates stay on chip)."""
    sig = stage.spec.signature
    n_in = (sig.in_hw or 1) * (sig.in_hw or 1) * sig.in_ch
    n_out = (sig.out_hw or 1) * (sig.out_hw or 1) * sig.out_ch
    return n_in + n_out


def _cuda_devices(x) -> List[torch.device]:
    """The CUDA devices a (placed) value lies on, each once, in order."""
    return list(dict.fromkeys(p.device for p in parts_of(x) if p.is_cuda))


def _done_events(y) -> List[torch.cuda.Event]:
    """One event behind the work that makes `y`, on each of its devices'
    current streams."""
    events = []
    for dev in _cuda_devices(y):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append(ev)
    return events


class PipelinedExecutor:
    def __init__(self, stages: List[CompiledStage], clock=None,
                 tracer: Optional[OT.Tracer] = None, metrics=None):
        if not stages:
            raise ValueError("need at least one stage")
        self.stages = stages
        self._slots: List[Optional[Tuple[Any, torch.Tensor]]] = \
            [None] * len(stages)
        self._done: Deque[List[torch.cuda.Event]] = collections.deque()
        self._clock = time.perf_counter if clock is None else clock
        self._streaming = False
        # wall time spent blocked on finished outputs (pipeline stall proxy)
        self.harvest_wait_s = 0.0
        self.tracer = tracer if tracer is not None else OT.NULL
        # optional tag -> trace-args hook: the engine installs one mapping
        # its (reqs, x) batch tags to request ids, tying every stage
        # dispatch span back to the requests riding the micro-batch
        self.tag_info = None
        reg = metrics if metrics is not None else OM.NULL_REGISTRY
        self._m_harvest = reg.histogram(
            "serve_harvest_wait_seconds",
            "wall time blocked on a finished stage output (the pipeline's "
            "only sync point)")
        self._m_ticks = reg.counter(
            "serve_pipeline_ticks_total", "scheduler ticks advanced")
        self._stage_row_bytes = [_stage_bytes_per_row(s) for s in stages]
        self._m_stage_dispatch = []
        self._m_stage_bytes = []
        for i, stage in enumerate(stages):
            cu = stage.spec.cu
            lbl = {"cu": cu}
            self._m_stage_dispatch.append(reg.histogram(
                "serve_stage_dispatch_seconds",
                "per-stage dispatch (enqueue) wall time", labels=lbl))
            self._m_stage_bytes.append(reg.counter(
                "serve_stage_bytes_moved_total",
                "analytic uint8 activation bytes in+out of the stage",
                labels=lbl))
            if self.tracer:
                self.tracer.name_track(OT.TID_STAGE0 + i, f"stage:{cu}")

    @property
    def depth(self) -> int:
        return len(self.stages)

    @property
    def busy(self) -> bool:
        """True while any micro-batch is still in flight."""
        return any(s is not None for s in self._slots)

    # -- tick-level API ------------------------------------------------------

    def advance(self) -> Optional[Tuple[Any, torch.Tensor]]:
        """One scheduler tick: every occupied slot advances exactly one
        stage (back to front, all dispatches asynchronous on CUDA). Frees
        the Head slot. Returns the (tag, y) that left the last stage this
        tick, if any, not yet waited on: pass it to `harvest`."""
        finished = None
        self._m_ticks.inc()
        for i in reversed(range(self.depth)):
            if self._slots[i] is None:
                continue
            tag, x = self._slots[i]
            self._slots[i] = None
            rows = int(x.shape[0])  # the whole micro-batch, every replica
            if self.tracer:
                t0 = self._clock()
                y = self.stages[i](x)  # enqueued, returns at once on CUDA
                t1 = self._clock()
                args = {"rows": rows}
                if self.tag_info is not None:
                    args.update(self.tag_info(tag))
                self.tracer.complete(
                    f"dispatch:{self.stages[i].spec.cu}", t0, t1,
                    cat="stage", tid=OT.TID_STAGE0 + i, args=args)
                self._m_stage_dispatch[i].observe(t1 - t0)
            else:
                y = self.stages[i](x)  # enqueued, returns at once on CUDA
            self._m_stage_bytes[i].inc(rows * self._stage_row_bytes[i])
            if i + 1 < self.depth:
                self._slots[i + 1] = (tag, y)
            else:
                finished = (tag, y)
                self._done.append(_done_events(y))
        return finished

    def inject(self, batch: Tuple[Any, torch.Tensor]) -> None:
        """Occupy the Head slot with the next micro-batch."""
        if self._slots[0] is not None:
            raise RuntimeError("Head slot occupied — advance() first")
        self._slots[0] = batch

    def reset(self) -> None:
        """Drop every in-flight micro-batch (abandoned drain)."""
        self._slots = [None] * self.depth
        self._done.clear()

    def harvest(self, finished: Tuple[Any, torch.Tensor]
                ) -> Tuple[Any, torch.Tensor]:
        """Wait until a finished output is ready (the only sync point).
        Outputs are harvested in the order `advance` returned them."""
        t0 = self._clock()
        for ev in self._done.popleft():
            ev.synchronize()
        t1 = self._clock()
        self.harvest_wait_s += t1 - t0
        self._m_harvest.observe(t1 - t0)
        if self.tracer:
            self.tracer.complete("harvest", t0, t1, cat="pipeline",
                                 tid=OT.TID_SCHED)
        return finished

    # -- streaming loop ------------------------------------------------------

    def stream(self, batches: Iterable[Tuple[Any, torch.Tensor]]
               ) -> Iterator[Tuple[Any, torch.Tensor]]:
        """Stream (tag, x) micro-batches through the stages; yield (tag, y)
        in submission order (the pipeline is in-order), each ready."""
        if self._streaming or self.busy:
            raise RuntimeError(
                "PipelinedExecutor is already draining — one stream() (or "
                "tick-level drive) at a time")
        self._streaming = True
        it = iter(batches)
        exhausted = False
        try:
            while True:
                finished = self.advance()
                if not exhausted:
                    try:
                        self.inject(next(it))
                    except StopIteration:
                        exhausted = True
                if finished is not None:
                    yield self.harvest(finished)
                if exhausted and not self.busy:
                    return
        finally:
            # abandoned mid-drain (caller broke out / exception): a later
            # drain must not replay stale tags
            self._streaming = False
            self.reset()

    def run(self, batches: Iterable[torch.Tensor]) -> List[torch.Tensor]:
        """Convenience: pipeline a list of micro-batches, return outputs."""
        tagged = ((i, x) for i, x in enumerate(batches))
        return [y for _, y in self.stream(tagged)]

    def warmup(self, example: torch.Tensor) -> None:
        """Run every stage once at `example`'s batch size, outside the
        invocation counts: builds the kernels and warms the allocator.
        With tracing on, each stage is waited on before the next — the one
        place a stage's compute time is observable without breaking the
        pipelining — and lands on its track as `warmup:<cu>`."""
        x = example
        for i, stage in enumerate(self.stages):
            if self.tracer:
                t0 = self._clock()
                x = stage.run(x)
                for dev in _cuda_devices(x):
                    torch.cuda.synchronize(dev)
                self.tracer.complete(
                    f"warmup:{stage.spec.cu}", t0, self._clock(),
                    cat="stage", tid=OT.TID_STAGE0 + i,
                    args={"rows": int(example.shape[0])})
            else:
                x = stage.run(x)
        for dev in _cuda_devices(x):
            torch.cuda.synchronize(dev)


__all__ = ["PipelinedExecutor"]
