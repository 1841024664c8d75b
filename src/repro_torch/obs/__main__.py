"""Observability CLI.

    PYTHONPATH=src python -m repro_torch.obs summarize \
        --trace trace.json --metrics metrics.json [--top 10]

renders the pipeline profile of one serving run (top-N slowest span groups,
queue-wait / latency percentiles, the FPS and FPS/Watt-proxy gauges).

    PYTHONPATH=src python -m repro_torch.obs validate --trace trace.json

schema-checks an exported Chrome trace (exit 1 on any violation).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.obs.summary import load_json, render_report, summarize_trace
from repro_torch.obs.trace import validate_chrome_trace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("summarize", help="render a pipeline-profile report")
    s.add_argument("--trace", default=None, help="Chrome trace JSON")
    s.add_argument("--metrics", default=None, help="metrics snapshot JSON")
    s.add_argument("--top", type=int, default=10,
                   help="span groups to show, by total time")

    v = sub.add_parser("validate", help="schema-check a Chrome trace")
    v.add_argument("--trace", required=True, help="Chrome trace JSON")

    args = ap.parse_args(argv)
    if args.cmd == "validate":
        errors = validate_chrome_trace(load_json(args.trace))
        for e in errors:
            print(f"[obs-validate] {e}", file=sys.stderr)
        print(f"[obs-validate] {args.trace}: "
              + ("OK" if not errors else f"{len(errors)} violation(s)"))
        return 1 if errors else 0

    if not args.trace and not args.metrics:
        ap.error("summarize needs --trace and/or --metrics")
    trace_summary = None
    if args.trace:
        trace_summary = summarize_trace(load_json(args.trace), top=args.top)
    metrics = load_json(args.metrics) if args.metrics else None
    try:
        print(render_report(trace_summary, metrics, top=args.top))
    except BrokenPipeError:  # `... | head` closed the pipe: not an error
        sys.stderr.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
