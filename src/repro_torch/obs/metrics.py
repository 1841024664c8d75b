"""Metrics registry: counters, gauges, fixed-bucket histograms.

Counterpart of `repro/obs/metrics.py` (a copy).

Prometheus-style instruments with zero dependencies, designed to be safe to
touch on the serving hot path: `inc`/`set`/`observe` are a handful of float
ops and a bisect — no allocation, no locks (the serving loop is
single-threaded by construction), no label parsing at observe time (labels
are frozen at registration, so an instrument handle is grabbed once at
engine construction and hammered thereafter).

Two export surfaces:

  * `to_prometheus()` — the text exposition format (`# TYPE` lines,
    cumulative `_bucket{le=...}` histogram rows) for scraping or a
    `--metrics-out metrics.prom` dump.
  * `snapshot()` — a JSON-safe dict (non-finite values become None, so
    `json.dumps(snapshot, allow_nan=False)` always succeeds — a registry
    snapshot is well-defined at zero completions by construction).

Instruments are get-or-create: registering the same (name, labels) twice
returns the same handle; re-registering under a different type (or a
histogram under different buckets) raises — silent double-registration is
how two subsystems end up splitting one logical counter.
"""
from __future__ import annotations

import math
from bisect import bisect_left
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

# Default latency buckets (seconds): 100us .. 10s, roughly log-spaced — the
# serving path spans sub-ms CPU micro-batches to multi-second cold drains.
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _label_key(labels: Optional[Mapping[str, str]]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((labels or {}).items()))


def _label_str(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"


def _json_num(v: float) -> Optional[float]:
    return float(v) if math.isfinite(v) else None


class Counter:
    """Monotone counter. `inc` with a negative amount raises — a counter
    that can go down is a gauge wearing the wrong type."""

    __slots__ = ("name", "help", "labels", "value")

    def __init__(self, name: str, help: str = "",
                 labels: Tuple[Tuple[str, str], ...] = ()):
        self.name, self.help, self.labels = name, help, labels
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({n})")
        self.value += n


class Gauge:
    __slots__ = ("name", "help", "labels", "value")

    def __init__(self, name: str, help: str = "",
                 labels: Tuple[Tuple[str, str], ...] = ()):
        self.name, self.help, self.labels = name, help, labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


class Histogram:
    """Fixed-bucket histogram with Prometheus `le` (inclusive upper bound)
    semantics. `counts[i]` is the NON-cumulative count of the i-th bucket;
    the implicit +Inf bucket is `counts[-1]`. Export cumulates."""

    __slots__ = ("name", "help", "labels", "buckets", "counts", "sum",
                 "count")

    def __init__(self, name: str, buckets: Sequence[float], help: str = "",
                 labels: Tuple[Tuple[str, str], ...] = ()):
        bounds = tuple(float(b) for b in buckets)
        if not bounds:
            raise ValueError(f"histogram {name}: need at least one bucket")
        if any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError(
                f"histogram {name}: bucket bounds must be strictly "
                f"increasing, got {bounds}")
        if any(not math.isfinite(b) for b in bounds):
            raise ValueError(f"histogram {name}: bounds must be finite "
                             f"(+Inf is implicit), got {bounds}")
        self.name, self.help, self.labels = name, help, labels
        self.buckets = bounds
        self.counts = [0] * (len(bounds) + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1

    def merge(self, other: "Histogram") -> "Histogram":
        """Pointwise sum under identical bounds (associative, commutative;
        the merge of shard-local histograms IS the fleet histogram)."""
        if self.buckets != other.buckets:
            raise ValueError(
                f"cannot merge histograms with different buckets: "
                f"{self.buckets} vs {other.buckets}")
        out = Histogram(self.name, self.buckets, self.help, self.labels)
        out.counts = [a + b for a, b in zip(self.counts, other.counts)]
        out.sum = self.sum + other.sum
        out.count = self.count + other.count
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-resolution quantile estimate: the upper bound of the
        first bucket whose cumulative count reaches q*count (linear
        interpolation inside the bucket; the +Inf bucket reports the top
        finite bound). None with zero observations — never NaN."""
        if self.count == 0:
            return None
        q = min(max(q, 0.0), 1.0)
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            prev_cum = cum
            cum += c
            if cum >= target and c > 0:
                if i >= len(self.buckets):
                    return self.buckets[-1]
                lo = 0.0 if i == 0 else self.buckets[i - 1]
                hi = self.buckets[i]
                frac = (target - prev_cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return self.buckets[-1]


class _NullInstrument:
    """Shared no-op stand-in for every instrument type (what a
    `NullRegistry` hands out): the hot path calls observe/inc/set
    unconditionally and pays one empty method call when metrics are off."""

    __slots__ = ()

    def inc(self, n: float = 1.0) -> None:
        pass

    def dec(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


NULL_INSTRUMENT = _NullInstrument()


class MetricsRegistry:
    def __init__(self):
        # (name, labelkey) -> instrument; name -> type for conflict checks
        self._instruments: Dict[Tuple[str, Tuple], object] = {}
        self._types: Dict[str, type] = {}
        self._help: Dict[str, str] = {}

    def __bool__(self) -> bool:
        return True

    def __len__(self) -> int:
        return len(self._instruments)

    def _get(self, cls, name: str, help: str,
             labels: Optional[Mapping[str, str]], **kwargs):
        lk = _label_key(labels)
        inst = self._instruments.get((name, lk))
        if inst is not None:
            if not isinstance(inst, cls):
                raise ValueError(
                    f"{name} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}")
            if (isinstance(inst, Histogram) and "buckets" in kwargs
                    and tuple(kwargs["buckets"]) != inst.buckets):
                raise ValueError(
                    f"histogram {name} already registered with buckets "
                    f"{inst.buckets}")
            return inst
        if self._types.setdefault(name, cls) is not cls:
            raise ValueError(
                f"{name} already registered as "
                f"{self._types[name].__name__}, not {cls.__name__}")
        if help:
            self._help.setdefault(name, help)
        inst = cls(name, help=help or self._help.get(name, ""),
                   labels=lk, **kwargs)
        self._instruments[(name, lk)] = inst
        return inst

    def counter(self, name: str, help: str = "",
                labels: Optional[Mapping[str, str]] = None) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Mapping[str, str]] = None) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Mapping[str, str]] = None,
                  buckets: Sequence[float] = LATENCY_BUCKETS_S) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def instruments(self) -> Iterable[object]:
        return self._instruments.values()

    # -- export ------------------------------------------------------------

    def snapshot(self) -> Dict[str, Dict]:
        """JSON-safe state dump: {'counters': {...}, 'gauges': {...},
        'histograms': {...}} keyed by label-qualified metric name. Every
        value is finite-or-None (`json.dumps(..., allow_nan=False)` safe),
        and histograms carry bucket-estimate p50/p95/p99 (None when
        empty — a snapshot at zero completions has no NaN anywhere)."""
        out: Dict[str, Dict] = {"counters": {}, "gauges": {},
                                "histograms": {}}
        for inst in self._instruments.values():
            key = inst.name + _label_str(inst.labels)
            if isinstance(inst, Counter):
                out["counters"][key] = _json_num(inst.value)
            elif isinstance(inst, Gauge):
                out["gauges"][key] = _json_num(inst.value)
            elif isinstance(inst, Histogram):
                out["histograms"][key] = {
                    "buckets": list(inst.buckets),
                    "counts": list(inst.counts),
                    "sum": _json_num(inst.sum),
                    "count": inst.count,
                    "p50": inst.quantile(0.5),
                    "p95": inst.quantile(0.95),
                    "p99": inst.quantile(0.99),
                }
        return out

    def to_prometheus(self) -> str:
        """Text exposition format (one # HELP/# TYPE block per name)."""
        by_name: Dict[str, List] = {}
        for inst in self._instruments.values():
            by_name.setdefault(inst.name, []).append(inst)
        lines: List[str] = []
        for name in sorted(by_name):
            group = by_name[name]
            kind = {Counter: "counter", Gauge: "gauge",
                    Histogram: "histogram"}[type(group[0])]
            help_text = next((g.help for g in group if g.help), "")
            if help_text:
                lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {kind}")
            for inst in sorted(group, key=lambda g: g.labels):
                ls = _label_str(inst.labels)
                if isinstance(inst, Histogram):
                    cum = 0
                    for bound, c in zip(inst.buckets, inst.counts):
                        cum += c
                        lb = dict(inst.labels, le=repr(bound))
                        lines.append(
                            f"{name}_bucket"
                            + _label_str(tuple(sorted(lb.items())))
                            + f" {cum}")
                    lb = dict(inst.labels, le="+Inf")
                    lines.append(
                        f"{name}_bucket"
                        + _label_str(tuple(sorted(lb.items())))
                        + f" {inst.count}")
                    lines.append(f"{name}_sum{ls} {inst.sum}")
                    lines.append(f"{name}_count{ls} {inst.count}")
                else:
                    lines.append(f"{name}{ls} {inst.value}")
        return "\n".join(lines) + ("\n" if lines else "")

    def save(self, path: str) -> str:
        """Write the registry to `path`: Prometheus text for .prom/.txt,
        JSON snapshot otherwise."""
        import json as _json
        if path.endswith((".prom", ".txt")):
            body = self.to_prometheus()
        else:
            body = _json.dumps(self.snapshot(), indent=1, allow_nan=False)
        with open(path, "w") as f:
            f.write(body)
        return path


class NullRegistry:
    """Falsy registry returning the shared no-op instrument — lets call
    sites register instruments unconditionally and keep the hot path
    branch-free when metrics are disabled."""

    def __bool__(self) -> bool:
        return False

    def counter(self, *a, **k) -> _NullInstrument:
        return NULL_INSTRUMENT

    def gauge(self, *a, **k) -> _NullInstrument:
        return NULL_INSTRUMENT

    def histogram(self, *a, **k) -> _NullInstrument:
        return NULL_INSTRUMENT


NULL_REGISTRY = NullRegistry()


__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS_S",
    "MetricsRegistry",
    "NULL_INSTRUMENT",
    "NULL_REGISTRY",
    "NullRegistry",
]
