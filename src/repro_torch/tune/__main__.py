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

    # mixed-precision search (`precision.search_precision`): per-block
    # act-bit allocation over the tuned timings, a Pareto artifact
    # (default `smoke_out/precision/{model}_{backend}_pareto.json`);
    # --precision-export also writes the headline mixed allocation as a
    # .qnet proven on every serving route
    PYTHONPATH=src python -m repro_torch.tune --precision --hw 32 \
        --num-classes 10 --choices 4,6,8
    PYTHONPATH=src python -m repro_torch.tune --precision --fake \
        --device cpu --out /tmp/p.json --precision-export /tmp/p.qnet
    PYTHONPATH=src python -m repro_torch.tune --check-pareto \
        experiments/precision/mobilenet_v2_cpu_pareto.json

Caches are keyed by backend, the device's type: a run on the card writes
`cuda` caches, `--device cpu` writes `cpu` ones (the filenames carry it).
Without `--device` the tuner and the search run on CUDA and fail where
there is no card. Files go to `--out-dir` (default `smoke_out/tuned/`,
which git ignores), never over the JAX package's caches in
`experiments/tuned/`; the search seeds its latency table from those caches
of its backend (`experiments/tuned/{model}_act*_{backend}.json`; there is
no `cuda` one, so on the card every key is timed there).
"""
from __future__ import annotations

import argparse
import functools
import os
import sys

OUT_DIR = os.path.join("smoke_out", "tuned")
TUNED_DIR = os.path.join("experiments", "tuned")  # the JAX package's caches
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


def tune_precision(args) -> str:
    """The mixed-precision search (`repro_torch.tune.precision`). Returns
    the artifact's path."""
    import glob

    from repro_torch.core.cu import resolve_device
    from repro_torch.train.vision import VisionTrainConfig
    from repro_torch.tune import load_tuned
    from repro_torch.tune import precision as P

    device = resolve_device(args.device)
    backend = device.type
    choices = tuple(int(c) for c in args.choices.split(","))
    model = (args.models or "mobilenet_v2").split(",")[0].strip()
    if args.fake:
        # tiny but non-zero training budget: the search scores with
        # fake_accuracy, but --precision-export still fine-tunes and
        # proves every route through the real QAT and export path
        cfg = VisionTrainConfig(model=model, input_hw=8, num_classes=4,
                                bits=args.bits, act_bits=min(choices),
                                float_steps=6, qat_steps=4,
                                calibrate_every=0, ckpt_every=0, batch=8)
        measure, accuracy_fn, tuned = P.fake_measure, P.fake_accuracy, None
    else:
        cfg = VisionTrainConfig(
            model=model, input_hw=args.hw, num_classes=args.num_classes,
            bits=args.bits, act_bits=min(choices),
            float_steps=args.float_steps, qat_steps=args.qat_steps,
            batch=args.batch)
        measure, accuracy_fn = None, None
        tuned = None
        # seed the latency table from every committed cache of this model
        # on this backend (the per-width `{model}_act{n}` files)
        for p in sorted(glob.glob(os.path.join(
                TUNED_DIR, f"{model}_act*_{backend}.json"))):
            t = load_tuned(p)
            tuned = t if tuned is None else tuned.merge(t)
            print(f"[precision] seeded {len(t)} entries from {p}",
                  file=sys.stderr)
    result = P.search_precision(
        cfg, choices=choices, tuned=tuned, backend=backend,
        accuracy_fn=accuracy_fn, measure=measure,
        ladder_budget=args.ladder_budget,
        tune_batch=args.batch, tune_repeats=args.repeats,
        finetune_steps=args.finetune_steps,
        log=lambda s: print(s, file=sys.stderr), device=device)
    out = args.out or P.pareto_path(model, backend)
    P.write_pareto(result, out)
    dom = P.find_domination(list(result.points))
    print(f"[precision] {len(result.points)} points, front: "
          f"{', '.join(result.front)} -> {out}")
    if dom:
        m, u = dom
        print(f"[precision] {m} dominates {u} on (latency, model_bytes) "
              f"at >= accuracy")
    if args.precision_export:
        # headline = the dominating mixed point if one exists, else the
        # first mixed allocation on the front (the export must exercise a
        # heterogeneous net), else the front's head
        name = dom[0] if dom else next(
            (n for n in result.front if n.startswith("mix")),
            result.front[0])
        best = result.point(name)
        impl = None
        if args.fake:
            # the export still goes through the real proof: only the
            # search's scoring was faked
            impl = P.QATFinetuneAccuracy(cfg, steps=0, device=device)
        report = P.export_point(cfg, best, args.precision_export,
                                accuracy_impl=impl, device=device)
        print(f"[precision] exported {best.name} -> "
              f"{args.precision_export} (routes: "
              f"{', '.join(report.get('routes', []))})")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tune")
    ap.add_argument("--golden", action="store_true",
                    help="tune the 5 golden-fixture nets")
    ap.add_argument("--bench", action="store_true",
                    help="tune the benchmark nets into one merged cache")
    ap.add_argument("--precision", action="store_true",
                    help="per-block mixed-precision search over the tuned "
                         "timings (writes a Pareto artifact)")
    ap.add_argument("--choices", default="4,6,8",
                    help="act-bit widths the precision search draws from")
    ap.add_argument("--float-steps", type=int, default=40)
    ap.add_argument("--qat-steps", type=int, default=20)
    ap.add_argument("--ladder-budget", type=int, default=5,
                    help="mixed candidates per savings ladder")
    ap.add_argument("--finetune-steps", type=int, default=10,
                    help="QAT fine-tune steps per candidate allocation")
    ap.add_argument("--fake", action="store_true",
                    help="deterministic fake measure + accuracy (tests)")
    ap.add_argument("--precision-export", default=None, metavar="PATH",
                    help="also export the headline allocation as a .qnet "
                         "(every serving route proven first)")
    ap.add_argument("--check-pareto", default=None, metavar="PATH",
                    help="schema-check a Pareto artifact and exit")
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
                    help="the ad-hoc tune's file, or the Pareto artifact")
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    if args.check_pareto:
        from repro_torch.tune import precision as P
        P.check_pareto_artifact(args.check_pareto)
        print(f"[precision] OK {args.check_pareto}")
        return
    if not (args.precision or args.golden or args.bench or args.models):
        ap.error("pick at least one of --golden / --bench / --models "
                 "/ --precision / --check-pareto")
    from repro_torch.core.cu import resolve_device
    resolve_device(args.device)  # no card and no --device: raise first
    if args.precision:
        tune_precision(args)
        return
    if args.golden:
        tune_golden(args)
    if args.bench:
        tune_bench(args)
    if args.models and not args.golden:  # with --golden, --models filters
        tune_custom(args)


if __name__ == "__main__":
    main()
