"""Straggler detection for the training loop.

Counterpart of `repro/train/straggler.py` (pure Python, a copy).
Synchronous training waits for its slowest worker at every step. The
mitigation has two halves:

  1. detect: `StepWatchdog` tracks an EMA of step wall times and flags
     steps beyond `threshold` x EMA (transient stragglers: a slow host,
     a preemption warning, thermal throttling);
  2. act: a persistent straggler (`patience` flagged steps in a row) calls
     `on_straggler`, which `launch/train.py` wires to checkpoint-now, so a
     scheduler can replace the slow worker and training resume with the
     same data stream (the data pipeline skips to the saved step).

`stop()` reads the host clock: call it after a read that waits for the
device (the step's loss as a Python float), or it times the launch of the
step and not the step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional


@dataclasses.dataclass
class StepWatchdog:
    threshold: float = 2.0  # flag steps slower than threshold x EMA
    ema_beta: float = 0.9
    patience: int = 3  # consecutive flags => persistent straggler
    warmup: int = 5  # steps before flagging starts
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    _ema: Optional[float] = None
    _steps: int = 0
    _consecutive: int = 0
    _t0: Optional[float] = None
    flagged: List[int] = dataclasses.field(default_factory=list)

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> bool:
        """Record one step; returns True if a persistent straggler fired."""
        dt = time.perf_counter() - self._t0
        return self.observe(dt)

    def observe(self, dt: float) -> bool:
        self._steps += 1
        if self._ema is None:
            self._ema = dt
            return False
        slow = (self._steps > self.warmup
                and dt > self.threshold * self._ema)
        if slow:
            self.flagged.append(self._steps)
            self._consecutive += 1
        else:
            self._consecutive = 0
            # only healthy steps enter the EMA, so a slow stretch cannot
            # normalize itself away
            self._ema = self.ema_beta * self._ema + (1 - self.ema_beta) * dt
        if self._consecutive >= self.patience:
            if self.on_straggler is not None:
                self.on_straggler(self._steps, dt, self._ema)
            self._consecutive = 0
            return True
        return False

    @property
    def ema(self) -> Optional[float]:
        return self._ema


__all__ = ["StepWatchdog"]
