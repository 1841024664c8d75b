"""Rolling-window modeled power accounting for power-capped dispatch.

Counterpart of `repro/energy/governor.py` (a copy).

`PowerGovernor` is the bookkeeping behind `VisionEngine(power_budget_w=)`:
every dispatched batch records its modeled joules at the engine clock's
"now"; the modeled draw is then

    watts(now) = idle_w + (joules recorded in [now - window, now]) / window

The EDF dispatcher asks `would_exceed(batch_j, now)` *before* yielding a
batch and defers or sheds instead of dispatching when the answer is yes —
so the estimate never crosses the budget at any dispatch point.

Determinism: the governor never reads a wall clock. All times are passed
in from the engine's injected clock, so fake-clock tests replay dispatch
decisions bit-identically. One instance may be shared by every engine
under a `MultiModelEngine` to enforce a fleet-wide budget.
"""
from __future__ import annotations

from typing import List, Tuple


class PowerGovernor:
    """Tracks modeled dispatch energy over a sliding window vs a watt cap."""

    def __init__(self, budget_w: float, *, window_s: float = 1.0,
                 idle_w: float = 0.0):
        if budget_w <= idle_w:
            raise ValueError(
                f"power budget {budget_w} W must exceed idle draw "
                f"{idle_w} W — nothing could ever dispatch")
        if window_s <= 0:
            raise ValueError(f"window_s must be positive, got {window_s}")
        self.budget_w = float(budget_w)
        self.window_s = float(window_s)
        self.idle_w = float(idle_w)
        self._events: List[Tuple[float, float]] = []  # (t, joules)
        self.total_j = 0.0  # lifetime dispatched joules (not pruned)

    def _prune(self, now: float) -> None:
        cut = now - self.window_s
        i = 0
        for i, (t, _) in enumerate(self._events):
            if t > cut:
                break
        else:
            i = len(self._events)
        if i:
            del self._events[:i]

    def record(self, joules: float, now: float) -> None:
        """Account `joules` of modeled work dispatched at time `now`."""
        if joules < 0:
            raise ValueError(f"negative energy {joules}")
        self._events.append((now, joules))
        self.total_j += joules
        self._prune(now)

    def window_j(self, now: float) -> float:
        self._prune(now)
        return sum(j for _, j in self._events)

    def watts(self, now: float) -> float:
        """Modeled average draw over the trailing window ending at `now`."""
        return self.idle_w + self.window_j(now) / self.window_s

    def headroom_j(self, now: float) -> float:
        """Joules that can still be dispatched at `now` without crossing
        the budget."""
        return ((self.budget_w - self.idle_w) * self.window_s
                - self.window_j(now))

    def would_exceed(self, joules: float, now: float) -> bool:
        """True if dispatching `joules` at `now` would push the windowed
        estimate over the budget."""
        return joules > self.headroom_j(now) * (1 + 1e-12)


__all__ = ["PowerGovernor"]
