"""Observability layer: request-lifecycle tracing + a metrics registry.

Counterpart of `repro/obs/`, a copy of its pure-Python modules so that the
port stays self-contained. The serving and streaming engines report into
it:

  * `trace`   — span-based `Tracer` with an injectable clock, exported as
                Chrome trace-event JSON (Perfetto-loadable); `NULL` no-op
                tracer keeps the hot path untouched when tracing is off.
  * `metrics` — counters / gauges / fixed-bucket histograms with
                Prometheus text exposition and a JSON-safe snapshot
                (`NULL_REGISTRY` when disabled).
  * `summary` — `python -m repro_torch.obs summarize` pipeline-profile
                reports (top-N slowest spans, queue-wait percentiles);
                `validate` schema-checks exported traces.

Invariants the tests pin:

  * **Off means off** — with `NULL` / `NULL_REGISTRY`, instrumented code
    performs zero clock reads and zero allocations on the hot path.
  * **Byte-determinism under fake clocks** — every timestamp comes from
    the injected clock, so two runs with the same fake clock export
    byte-identical traces and snapshots, equal to the JAX package's for
    the same calls (no wall-clock reads anywhere).
  * Exported traces must pass `python -m repro_torch.obs validate`.
"""
from repro_torch.obs.metrics import (
    LATENCY_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NULL_REGISTRY,
    NullRegistry,
)
from repro_torch.obs.summary import render_report, span_groups, summarize_trace
from repro_torch.obs.trace import (
    NULL,
    NullTracer,
    Tracer,
    validate_chrome_trace,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS_S",
    "MetricsRegistry",
    "NULL",
    "NULL_REGISTRY",
    "NullRegistry",
    "NullTracer",
    "Tracer",
    "render_report",
    "span_groups",
    "summarize_trace",
    "validate_chrome_trace",
]
