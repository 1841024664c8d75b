"""§Perf hillclimb: re-trace one dry-run cell with plan overrides and a
tag, and print its roofline terms against the cell's baseline.

    python -m repro_torch.launch.hillclimb --arch qwen3-32b --shape decode_32k \
        --tag kv8 --set kv_bits=8
    python -m repro_torch.launch.hillclimb --arch llama3.2-1b \
        --shape train_4k --tag ga4 --set grad_accum=4

Counterpart of `repro/launch/hillclimb.py`, with its flags. Results land in
`smoke_out/perf/<cell>__<tag>.json`; the baseline is the cell's dry-run
report in `smoke_out/dryrun/` (`launch/dryrun.py`), traced first where
there is none, so the deltas always print. Neither default is
the JAX package's `experiments/` directory.

The hillclimb also fronts the mixed-precision search (the act-bit analogue of
a plan-override hillclimb): `--precision` forwards every remaining flag to
`python -m repro_torch.tune --precision`:

    python -m repro_torch.launch.hillclimb --precision --fake --device cpu \
        --out /tmp/p.json
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.launch.dryrun import run_cell, shape_by_name


def parse_override(kv: str):
    k, v = kv.split("=", 1)
    if v.lower() in ("true", "false"):
        return k, v.lower() == "true"
    if v.lower() in ("none", "null"):
        return k, None
    try:
        return k, int(v)
    except ValueError:
        try:
            return k, float(v)
        except ValueError:
            return k, v


TERMS = ("t_compute_s", "t_memory_s", "t_collective_s")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--precision" in argv:
        from repro_torch.tune.__main__ import main as tune_main
        return tune_main(argv)
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.hillclimb")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="plan override key=value (repeatable)")
    ap.add_argument("--out", default="smoke_out/perf")
    ap.add_argument("--baseline-dir", default="smoke_out/dryrun")
    args = ap.parse_args(argv)

    overrides = dict(parse_override(kv) for kv in args.set)
    shape = shape_by_name(args.shape)
    mesh = "2x16x16" if args.multi_pod else "16x16"
    base_path = os.path.join(args.baseline_dir,
                             f"{args.arch}__{args.shape}__{mesh}.json")
    if os.path.exists(base_path):
        with open(base_path) as f:
            base = json.load(f)
    else:
        base = run_cell(args.arch, shape, multi_pod=args.multi_pod,
                        out_dir=args.baseline_dir)
    report = run_cell(args.arch, shape, multi_pod=args.multi_pod,
                      out_dir=args.out, plan_overrides=overrides,
                      tag=args.tag)
    # delta vs baseline
    if report.get("status") == "ok" and base.get("status") == "ok":
        b, n = base["roofline"], report["roofline"]
        for term in TERMS:
            delta = (n[term] - b[term]) / b[term] * 100 if b[term] else 0
            print(f"  {term}: {b[term]:.3e} -> {n[term]:.3e} "
                  f"({delta:+.1f}%)")
        bt = max(b[t] for t in TERMS)
        nt = max(n[t] for t in TERMS)
        print(f"  bound: {bt:.3e} ({b['bottleneck']}) -> "
              f"{nt:.3e} ({n['bottleneck']})  [{(nt-bt)/bt*100:+.1f}%]")
    return report


if __name__ == "__main__":
    main()
