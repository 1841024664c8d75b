"""Pipeline-profile reports over exported traces + metrics snapshots.

Counterpart of `repro/obs/summary.py` (a copy).

`python -m repro_torch.obs summarize --trace t.json --metrics m.json` renders the
human view of one serving run: top-N slowest span groups (where did the
wall time go, stage by stage), per-request queue-wait and end-to-end
latency percentiles reconstructed from the request-lifecycle spans, and the
headline FPS / FPS-per-Watt-proxy gauges from the metrics snapshot. The
same functions are importable (tests assert on the dicts, not the text).
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, List, Optional, Sequence


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def _percentile(sorted_vals: Sequence[float], p: float) -> Optional[float]:
    if not sorted_vals:
        return None
    return sorted_vals[max(0, math.ceil(p * len(sorted_vals)) - 1)]


def span_groups(events: List[Dict], top: Optional[int] = None) -> List[Dict]:
    """Group "X" spans by name: count / total / mean / max duration (us),
    sorted by total descending — the 'top-N slowest stages' table."""
    groups: Dict[str, Dict] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        g = groups.setdefault(ev["name"], {
            "name": ev["name"], "count": 0, "total_us": 0.0, "max_us": 0.0})
        dur = float(ev.get("dur", 0.0))
        g["count"] += 1
        g["total_us"] += dur
        g["max_us"] = max(g["max_us"], dur)
    out = sorted(groups.values(), key=lambda g: (-g["total_us"], g["name"]))
    for g in out:
        g["mean_us"] = g["total_us"] / g["count"] if g["count"] else 0.0
    return out[:top] if top else out


def async_durations(events: List[Dict], name: str,
                    cat: str = "request") -> Dict[Any, float]:
    """Durations (seconds) of completed async b/e span pairs, keyed by
    (cat, id). `cat` matches exactly or as a `cat:qualifier` prefix — the
    engine qualifies the request category per model ("request:mnv2"), and
    ids (rids) are only unique within one model's category. Unmatched
    begins are dropped (an unfinished request has no duration yet)."""
    begins: Dict[Any, float] = {}
    durs: Dict[Any, float] = {}
    for ev in events:
        ec = ev.get("cat")
        if (ev.get("name") != name or not isinstance(ec, str)
                or (ec != cat and not ec.startswith(cat + ":"))):
            continue
        key = (ec, ev.get("id"))
        if ev.get("ph") == "b":
            begins[key] = float(ev["ts"])
        elif ev.get("ph") == "e" and key in begins:
            durs[key] = (float(ev["ts"]) - begins.pop(key)) * 1e-6
    return durs


def summarize_trace(doc: Dict, top: int = 10) -> Dict[str, Any]:
    """The structured profile of one trace document."""
    events = doc.get("traceEvents", [])
    queue_waits = sorted(async_durations(events, "queue_wait").values())
    req_durs = sorted(async_durations(events, "request").values())
    statuses: Dict[str, int] = {}
    for ev in events:
        if (ev.get("ph") == "e" and ev.get("name") == "request"
                and isinstance(ev.get("args"), dict)):
            status = ev["args"].get("status", "unknown")
            statuses[status] = statuses.get(status, 0) + 1
    return {
        "n_events": len(events),
        "spans": span_groups(events, top=top),
        "requests": {
            "completed": len(req_durs),
            "by_status": statuses,
            "latency_p50_s": _percentile(req_durs, 0.50),
            "latency_p95_s": _percentile(req_durs, 0.95),
            "latency_p99_s": _percentile(req_durs, 0.99),
        },
        "queue_wait": {
            "n": len(queue_waits),
            "p50_s": _percentile(queue_waits, 0.50),
            "p95_s": _percentile(queue_waits, 0.95),
            "p99_s": _percentile(queue_waits, 0.99),
        },
    }


def _fmt_s(v: Optional[float]) -> str:
    if v is None:
        return "n/a"
    return f"{v * 1e3:.3f}ms"


def render_report(trace_summary: Optional[Dict] = None,
                  metrics_snapshot: Optional[Dict] = None,
                  top: int = 10) -> str:
    """Text report over `summarize_trace` output + a registry snapshot."""
    lines: List[str] = []
    if trace_summary:
        ts = trace_summary
        lines.append(f"== trace: {ts['n_events']} events ==")
        req = ts["requests"]
        lines.append(
            f"requests: {req['completed']} completed {req['by_status']} "
            f"latency p50={_fmt_s(req['latency_p50_s'])} "
            f"p95={_fmt_s(req['latency_p95_s'])} "
            f"p99={_fmt_s(req['latency_p99_s'])}")
        qw = ts["queue_wait"]
        lines.append(
            f"queue wait: n={qw['n']} p50={_fmt_s(qw['p50_s'])} "
            f"p95={_fmt_s(qw['p95_s'])} p99={_fmt_s(qw['p99_s'])}")
        lines.append(f"top {top} span groups by total time:")
        name_w = max([len(g["name"]) for g in ts["spans"][:top]] + [4])
        lines.append(f"  {'name':<{name_w}}  {'count':>6}  {'total':>10}  "
                     f"{'mean':>9}  {'max':>9}")
        for g in ts["spans"][:top]:
            lines.append(
                f"  {g['name']:<{name_w}}  {g['count']:>6}  "
                f"{g['total_us'] / 1e3:>8.2f}ms  {g['mean_us']:>7.1f}us  "
                f"{g['max_us']:>7.1f}us")
    if metrics_snapshot:
        lines.append("== metrics ==")
        gauges = metrics_snapshot.get("gauges", {})
        counters = metrics_snapshot.get("counters", {})
        for key in sorted(gauges):
            lines.append(f"  gauge {key} = {gauges[key]}")
        for key in sorted(counters):
            lines.append(f"  counter {key} = {counters[key]}")
        for key, h in sorted(metrics_snapshot.get("histograms", {}).items()):
            lines.append(
                f"  histogram {key}: count={h['count']} sum={h['sum']} "
                f"p50={h['p50']} p95={h['p95']} p99={h['p99']}")
    return "\n".join(lines)


__all__ = [
    "async_durations",
    "load_json",
    "render_report",
    "span_groups",
    "summarize_trace",
]
