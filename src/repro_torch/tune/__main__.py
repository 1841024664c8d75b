"""Tune route-selection caches with the port's autotuner.

Counterpart of `python -m repro.tune`:

    # the golden-fixture nets of tests/golden/ (batch 2, as they serve);
    # --models filters them
    PYTHONPATH=src python -m repro_torch.tune --golden [--models dscnn_kws]

    # the benchmark nets (MobileNetV2 alpha 0.35, act4, at hw 48 and 32),
    # merged into one cache
    PYTHONPATH=src python -m repro_torch.tune --bench

    # ad hoc: chosen models at one shape
    PYTHONPATH=src python -m repro_torch.tune --models mobilenet_v2 \
        --hw 48 --bits 4 --batch 8 --out /tmp/custom.json

    # the energy-delay-product objective: files gain an `_edp` suffix
    PYTHONPATH=src python -m repro_torch.tune --golden --objective edp

Caches are keyed by backend, the device's type: a run on the card writes
`cuda` caches, `--device cpu` writes `cpu` ones (the filenames carry it).
Without `--device` the tuner runs on CUDA and fails where there is no card.
Files go to `--out-dir` (default `smoke_out/tuned/`, which git ignores),
never over the JAX package's caches in `experiments/tuned/`. Not ported yet, refused
with a non-zero exit: `--precision` and `--check-pareto` (the
mixed-precision search, ROADMAP queue 1 item 11).
"""
from __future__ import annotations

import argparse
import functools
import os
import sys

OUT_DIR = os.path.join("smoke_out", "tuned")
GOLDEN_DIR = os.path.join("tests", "golden")

# the golden fixtures of tests/golden/ (written by the JAX package): input
# 32x32 (the KWS net: 32 frames of 6 channels), 10 classes, batch 2
GOLDEN_HW, GOLDEN_CLASSES, GOLDEN_BATCH = 32, 10, 2
KWS_KW = dict(input_t=32, input_ch=6, channels=16, n_blocks=2, kernel=3)
CASES = tuple((model, bits)
              for model in ("mobilenet_v2", "efficientnet_compact")
              for bits in (4, 8)) + (("dscnn_kws", 8),)


def build_net(model: str, bits: int):
    """The NetSpec of a golden case."""
    from repro_torch.models import dscnn1d
    from repro_torch.models import efficientnet as effn
    from repro_torch.models import mobilenet_v2 as mnv2

    if model == "mobilenet_v2":
        return mnv2.build(alpha=0.35, input_hw=GOLDEN_HW, bits=bits,
                          num_classes=GOLDEN_CLASSES)
    if model == "efficientnet_compact":
        return effn.build_compact(input_hw=GOLDEN_HW, bits=bits,
                                  num_classes=GOLDEN_CLASSES)
    if model == "dscnn_kws":
        return dscnn1d.build_kws(bits=bits, num_classes=GOLDEN_CLASSES,
                                 **KWS_KW)
    raise ValueError(model)


def fixture_path(model: str, bits: int) -> str:
    """The golden case's frozen `.qnet`."""
    return os.path.join(GOLDEN_DIR, f"{model}_act{bits}.qnet")


def _suffix(args) -> str:
    return "" if args.objective == "latency" else f"_{args.objective}"


def _tune(qnet, args, batch: int):
    from repro_torch.tune import tune_qnet

    return tune_qnet(qnet, batch=batch, repeats=args.repeats, seed=args.seed,
                     verbose=args.verbose, objective=args.objective,
                     device=args.device)


def _bench_qnet(model: str, hw: int, bits: int, num_classes: int, device):
    from repro_torch.models import efficientnet as effn
    from repro_torch.models import layers
    from repro_torch.models import mobilenet_v2 as mnv2

    if model == "mobilenet_v2":
        net = mnv2.build(alpha=0.35, input_hw=hw, bits=bits,
                         num_classes=num_classes)
    elif model == "efficientnet_compact":
        net = effn.build_compact(input_hw=hw, bits=bits,
                                 num_classes=num_classes)
    else:
        raise SystemExit(f"unknown model {model!r}")
    return layers.make_calibrated_qnet(net, bits=bits, device=device)


def tune_golden(args) -> list:
    """One cache per golden fixture net. Returns the files written."""
    from repro_torch.core import qnet as Q
    from repro_torch.tune import save_tuned

    wanted = set(args.models.split(",")) if args.models else None
    written = []
    for model, bits in CASES:
        if wanted and model not in wanted:
            continue
        qnet = Q.load_qnet(fixture_path(model, bits), build_net(model, bits))
        plan = _tune(qnet, args, GOLDEN_BATCH)
        out = os.path.join(
            args.out_dir, f"{model}_act{bits}_{plan.backend}{_suffix(args)}"
            ".json")
        save_tuned(plan, out)
        written.append(out)
        print(f"[tune] {model} act{bits}: {len(plan)} entries -> {out}")
    return written


def _merged(plans):
    return functools.reduce(lambda a, b: a.merge(b), plans)


def tune_bench(args) -> str:
    """One merged cache over the benchmark serving shapes."""
    from repro_torch.tune import save_tuned

    plans = []
    for hw in (48, 32):  # the benchmark and its smoke geometry
        qnet = _bench_qnet("mobilenet_v2", hw, 4, 1000, args.device)
        plans.append(_tune(qnet, args, args.batch))
        print(f"[tune] mobilenet_v2 hw{hw}: {len(plans[-1])} entries",
              file=sys.stderr)
    merged = _merged(plans)
    out = os.path.join(args.out_dir,
                       f"bench_{merged.backend}{_suffix(args)}.json")
    save_tuned(merged, out)
    print(f"[tune] bench cache: {len(merged)} entries -> {out}")
    return out


def tune_custom(args) -> str:
    from repro_torch.tune import save_tuned

    merged = _merged([
        _tune(_bench_qnet(m.strip(), args.hw, args.bits, args.num_classes,
                          args.device), args, args.batch)
        for m in args.models.split(",")])
    out = args.out or os.path.join(
        args.out_dir, f"custom_{merged.backend}{_suffix(args)}.json")
    save_tuned(merged, out)
    print(f"[tune] {args.models}: {len(merged)} entries -> {out}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tune")
    ap.add_argument("--golden", action="store_true",
                    help="tune the 5 golden-fixture nets")
    ap.add_argument("--bench", action="store_true",
                    help="tune the benchmark nets into one merged cache")
    ap.add_argument("--precision", action="store_true",
                    help="mixed-precision search (not ported yet)")
    ap.add_argument("--check-pareto", default=None, metavar="PATH",
                    help="schema-check a Pareto artifact (not ported yet)")
    ap.add_argument("--models", default=None,
                    help="comma-separated models for an ad-hoc tune (with "
                         "--golden: a filter)")
    ap.add_argument("--hw", type=int, default=48)
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--objective", choices=("latency", "edp"),
                    default="latency",
                    help="route ranking metric: measured latency (default) "
                         "or energy-delay product")
    ap.add_argument("--out", default=None,
                    help="the ad-hoc tune's file")
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    if args.precision or args.check_pareto:
        raise SystemExit(
            "python -m repro_torch.tune: the mixed-precision search "
            "(--precision, --check-pareto) is not ported yet (ROADMAP "
            "queue 1 item 11)")
    if not (args.golden or args.bench or args.models):
        ap.error("pick at least one of --golden / --bench / --models")
    from repro_torch.core.cu import resolve_device
    resolve_device(args.device)  # no card and no --device: raise first
    if args.golden:
        tune_golden(args)
    if args.bench:
        tune_bench(args)
    if args.models and not args.golden:  # with --golden, --models filters
        tune_custom(args)


if __name__ == "__main__":
    main()
