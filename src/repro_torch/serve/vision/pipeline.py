"""Software-pipelined scheduler over the CU stage executors.

Counterpart of `repro/serve/vision/pipeline.py`. One scheduler tick advances
every occupied slot by one stage (back to front, so a micro-batch moves one
stage a tick) and then injects the next micro-batch into the Head slot.
PyTorch enqueues CUDA work asynchronously, so every dispatch of a tick
returns at once; when a micro-batch leaves the last stage the tick records
a CUDA event behind it, and `harvest` waits on that event alone — the work
already queued for later micro-batches keeps the card busy meanwhile.
On the CPU everything is synchronous and `harvest` waits for nothing.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Deque, Iterable, Iterator, List, Optional, Tuple

import torch

from repro_torch.serve.vision.stages import CompiledStage


class PipelinedExecutor:
    def __init__(self, stages: List[CompiledStage], clock=None):
        if not stages:
            raise ValueError("need at least one stage")
        self.stages = stages
        self._slots: List[Optional[Tuple[Any, torch.Tensor]]] = \
            [None] * len(stages)
        self._done: Deque[Optional[torch.cuda.Event]] = collections.deque()
        self._clock = time.perf_counter if clock is None else clock
        self._streaming = False
        # wall time spent blocked on finished outputs (pipeline stall proxy)
        self.harvest_wait_s = 0.0

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
        for i in reversed(range(self.depth)):
            if self._slots[i] is None:
                continue
            tag, x = self._slots[i]
            self._slots[i] = None
            y = self.stages[i](x)
            if i + 1 < self.depth:
                self._slots[i + 1] = (tag, y)
            else:
                finished = (tag, y)
                ev = None
                if y.is_cuda:
                    ev = torch.cuda.Event()
                    ev.record(torch.cuda.current_stream(y.device))
                self._done.append(ev)
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
        ev = self._done.popleft()
        if ev is not None:
            ev.synchronize()
        self.harvest_wait_s += self._clock() - t0
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
        invocation counts: builds the kernels and warms the allocator."""
        x = example
        for stage in self.stages:
            x = stage.run(x)
        if x.is_cuda:
            torch.cuda.synchronize(x.device)


__all__ = ["PipelinedExecutor"]
