"""Span-based request-lifecycle tracer, exported as Chrome trace-event JSON.

Counterpart of `repro/obs/trace.py` (a copy: the port imports nothing of
the JAX package).

The paper measures *where* time goes on real hardware (per-CU invocation
latency over AXI, DDR stalls); the serving analogue is a trace of the
request lifecycle through the pipelined executor: submit -> queue wait ->
batch formation -> per-stage CU dispatch -> harvest -> complete. This
module records those spans in the Chrome trace-event format ("Trace Event
Format", the `traceEvents` JSON array), which Perfetto / chrome://tracing
load directly — drop the file into https://ui.perfetto.dev and every
track/span below renders on a timeline.

Design constraints, in order:

  * **Injectable clock.** Every timestamp comes either from an explicit
    caller-supplied time (the engine records spans with ITS clock, so one
    time source rules engine stats, deadlines, and trace alike) or from the
    tracer's own clock, which tests replace with a fake — the exported
    trace of a fake-clock run is byte-deterministic.
  * **Cheap when off.** `NULL` is a no-op tracer that is falsy; hot-path
    call sites guard their extra clock reads with `if tracer:` so a
    tracing-disabled engine performs exactly the clock reads it always did.
  * **Zero dependencies.** Events are plain dicts; export is `json.dump`.

Event vocabulary (all standard trace-event phases):

  * `complete(name, t0, t1)`    -> "X" duration span on a named track
  * `instant(name, t)`          -> "i" instant marker
  * `counter(name, {k: v}, t)`  -> "C" counter track (e.g. queue depth)
  * `async_begin/async_end`     -> "b"/"e" async spans keyed by id: one
                                   per-request lifecycle span that overlaps
                                   freely with other requests
  * `name_track(tid, name)`     -> "M" metadata naming a track
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional

# Well-known track ids for the serving pipeline (metadata-named on first
# use; stage executors get TID_STAGE0 + stage index).
TID_ENGINE = 0
TID_REQUESTS = 1
TID_SCHED = 2
TID_TUNE = 3
TID_TRAIN = 4
TID_STAGE0 = 10


class NullTracer:
    """No-op tracer: every record method does nothing, truthiness is False
    so call sites can skip the extra clock reads tracing needs."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def now(self) -> float:
        return 0.0

    def complete(self, *a, **k) -> None:
        pass

    def instant(self, *a, **k) -> None:
        pass

    def counter(self, *a, **k) -> None:
        pass

    def async_begin(self, *a, **k) -> None:
        pass

    def async_end(self, *a, **k) -> None:
        pass

    def name_track(self, *a, **k) -> None:
        pass

    @contextmanager
    def span(self, *a, **k):
        yield

    def to_chrome(self) -> Dict[str, Any]:
        return {"traceEvents": []}

    def save(self, path: str) -> None:
        raise ValueError("cannot save the null tracer (tracing is off)")


NULL = NullTracer()


class Tracer:
    """Collects trace events; `to_chrome()`/`save()` export Perfetto JSON.

    `clock` returns seconds (perf_counter-like). Timestamps passed to the
    record methods are in the SAME time base as `clock`; the tracer
    subtracts its construction-time origin and scales to microseconds (the
    trace-event unit). `pid` tags every event (one tracer per process is
    the normal shape; a shared tracer across engines puts them on one
    timeline, which is exactly what the multi-model router wants)."""

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 *, process_name: str = "repro-serve", pid: int = 0,
                 origin_s: Optional[float] = None):
        self._clock = time.perf_counter if clock is None else clock
        self._origin = self._clock() if origin_s is None else origin_s
        self.pid = pid
        self.events: List[Dict[str, Any]] = []
        self._tracks: Dict[int, str] = {}
        self._meta: List[Dict[str, Any]] = [{
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": process_name},
        }]

    def __bool__(self) -> bool:
        return True

    def __len__(self) -> int:
        return len(self.events)

    def now(self) -> float:
        return self._clock()

    def _ts(self, t_s: Optional[float]) -> float:
        t = self._clock() if t_s is None else t_s
        return (t - self._origin) * 1e6

    # -- record methods ----------------------------------------------------

    def name_track(self, tid: int, name: str) -> None:
        if self._tracks.get(tid) == name:
            return
        self._tracks[tid] = name
        self._meta.append({
            "ph": "M", "name": "thread_name", "pid": self.pid, "tid": tid,
            "args": {"name": name},
        })

    def complete(self, name: str, start_s: float, end_s: float, *,
                 cat: str = "", tid: int = TID_ENGINE,
                 args: Optional[Dict[str, Any]] = None) -> None:
        """One finished span with explicit start/end times ("X" event)."""
        ev: Dict[str, Any] = {
            "ph": "X", "name": name, "cat": cat, "pid": self.pid,
            "tid": tid, "ts": self._ts(start_s),
            "dur": max(0.0, (end_s - start_s) * 1e6),
        }
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, t_s: Optional[float] = None, *,
                cat: str = "", tid: int = TID_ENGINE,
                args: Optional[Dict[str, Any]] = None) -> None:
        ev: Dict[str, Any] = {
            "ph": "i", "name": name, "cat": cat, "pid": self.pid,
            "tid": tid, "ts": self._ts(t_s), "s": "t",
        }
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, values: Dict[str, float],
                t_s: Optional[float] = None, *, tid: int = TID_ENGINE) -> None:
        self.events.append({
            "ph": "C", "name": name, "pid": self.pid, "tid": tid,
            "ts": self._ts(t_s), "args": dict(values),
        })

    def async_begin(self, name: str, span_id: int,
                    t_s: Optional[float] = None, *, cat: str = "request",
                    args: Optional[Dict[str, Any]] = None) -> None:
        """Open an async span (nestable "b"); pairs with `async_end` by
        (cat, id) — the per-request lifecycle span, one id per rid."""
        ev: Dict[str, Any] = {
            "ph": "b", "name": name, "cat": cat, "id": span_id,
            "pid": self.pid, "tid": TID_REQUESTS, "ts": self._ts(t_s),
        }
        if args:
            ev["args"] = args
        self.events.append(ev)

    def async_end(self, name: str, span_id: int,
                  t_s: Optional[float] = None, *, cat: str = "request",
                  args: Optional[Dict[str, Any]] = None) -> None:
        ev: Dict[str, Any] = {
            "ph": "e", "name": name, "cat": cat, "id": span_id,
            "pid": self.pid, "tid": TID_REQUESTS, "ts": self._ts(t_s),
        }
        if args:
            ev["args"] = args
        self.events.append(ev)

    @contextmanager
    def span(self, name: str, *, cat: str = "", tid: int = TID_ENGINE,
             args: Optional[Dict[str, Any]] = None):
        """Context-managed span timed on the tracer's own clock (for call
        sites without their own time source, e.g. the tuner / trainer)."""
        t0 = self._clock()
        try:
            yield
        finally:
            self.complete(name, t0, self._clock(), cat=cat, tid=tid,
                          args=args)

    # -- export ------------------------------------------------------------

    def to_chrome(self) -> Dict[str, Any]:
        """The Perfetto-loadable document: metadata first (track names),
        then events in record order (the format does not require sorting)."""
        return {
            "traceEvents": self._meta + self.events,
            "displayTimeUnit": "ms",
        }

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, allow_nan=False)
        return path


def validate_chrome_trace(doc: Any) -> List[str]:
    """Schema check over an exported trace document; returns the list of
    violations (empty == loadable). `python -m repro_torch.obs validate`
    runs it over a saved trace."""
    errors: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["document is not an object with a 'traceEvents' array"]
    events = doc["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' is not an array"]
    open_async: Dict[tuple, int] = {}
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "C", "b", "e", "M"):
            errors.append(f"{where}: unknown phase {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errors.append(f"{where}: missing name")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                errors.append(f"{where}: missing integer {key!r}")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            errors.append(f"{where}: missing numeric ts")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where}: X event needs dur >= 0")
        if ph == "C" and not isinstance(ev.get("args"), dict):
            errors.append(f"{where}: C event needs an args value dict")
        if ph in ("b", "e"):
            if "id" not in ev or not ev.get("cat"):
                errors.append(f"{where}: async event needs id and cat")
            else:
                key = (ev["cat"], ev["id"], ev["name"])
                if ph == "b":
                    open_async[key] = open_async.get(key, 0) + 1
                else:
                    n = open_async.get(key, 0)
                    if n <= 0:
                        errors.append(f"{where}: async end without begin "
                                      f"for {key}")
                    else:
                        open_async[key] = n - 1
    for key, n in sorted(open_async.items()):
        if n > 0:
            errors.append(f"async span {key} opened {n} time(s) without end")
    return errors


__all__ = [
    "NULL",
    "NullTracer",
    "TID_ENGINE",
    "TID_REQUESTS",
    "TID_SCHED",
    "TID_STAGE0",
    "TID_TRAIN",
    "TID_TUNE",
    "Tracer",
    "validate_chrome_trace",
]
