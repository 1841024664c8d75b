"""Serving driver: LMs through the slot-batched `Engine`, integer vision
QNets through the port's vision engines.

Counterpart of `repro/launch/serve.py`. LM serving:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        [--reduced] [--requests 8] [--slots 4] [--max-new 16] \
        [--prompt-len 12] [--max-len 128] [--quant-bits 8] [--device cpu]

The weights come from the port's `init_params` seeded with `--seed` (its
own draws, not the JAX CLI's); the prompts from numpy's generator seeded
with `--seed`, as there. Even requests are greedy, odd ones sample at
temperature 0.8. `--quant-bits` 8 or 4 serves weight-only quantized
linears (dequantized next to each product, as the JAX model does).

Vision serving (multi-model, with data-parallel replicas):

    PYTHONPATH=src python -m repro_torch.launch.serve --vision \
        --models mobilenet_v2,efficientnet_compact --hw 128 --requests 32 \
        [--replicas 4] [--tune] [--tuned-cache PATH] [--power-budget-w W] \
        [--trace-out trace.json] [--metrics-out metrics.json] [--device cpu]

Each model is a calibrated integer QNet (`models.layers.make_calibrated_qnet`
from `--seed`: the port's own random draws, so not the JAX CLI's nets)
served through the pipelined CU stage executors of its `VisionEngine`;
every model shares one `MultiModelEngine` (EDF across models) and, with
`--power-budget-w`, one power governor. `--replicas N` (> 1) builds a 1-D
'data' mesh over the first N visible devices of `--device`'s type
(`dist.sharding.data_mesh`) and replicates every engine across it; more
replicas than visible devices is refused. `--tuned-cache` serves through a
saved route selection (`repro_torch.tune`); `--tune` measures one on the
device first (and writes it to `--tuned-cache` when given). `--trace-out`
exports the request-lifecycle Chrome trace, `--metrics-out` the metrics
registry (Prometheus text for .prom/.txt, JSON otherwise); `python -m
repro_torch.obs summarize` renders either.

Without `--device` the driver runs on CUDA and fails where there is no
card. The LM engine serves on one device: the LM path refuses
`--replicas` > 1 with a non-zero exit.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import sys
import time

import numpy as np

from repro_torch.configs import ARCHS

VISION_ARCHS = ("mobilenet_v2", "efficientnet_compact")


def vision_qnet(arch: str, hw: int, seed: int = 0, device=None):
    """The served net of `arch` at input `hw`: the reference CLI's
    configuration (MobileNetV2 alpha 0.35, the compact EfficientNet; 1000
    classes), calibrated on `device` (CUDA unless named)."""
    from repro_torch.models import efficientnet as effn
    from repro_torch.models import layers
    from repro_torch.models import mobilenet_v2 as mnv2

    if arch == "mobilenet_v2":
        net = mnv2.build(alpha=0.35, input_hw=hw, num_classes=1000)
    elif arch == "efficientnet_compact":
        net = effn.build_compact(input_hw=hw, num_classes=1000)
    else:
        raise ValueError(
            f"unknown vision arch {arch!r} (pick from {VISION_ARCHS})")
    return layers.make_calibrated_qnet(net, seed=seed, device=device)


def _vision_tuned(args, qnets, device):
    """The serving route selection: measured live (--tune), or loaded from
    a saved cache (--tuned-cache). Returns a TunedPlan or None."""
    from repro_torch.tune import load_tuned, save_tuned, tune_qnet

    if args.tune:
        plans = [tune_qnet(q, batch=args.batch, device=device)
                 for q in qnets.values()]
        tuned = functools.reduce(lambda a, b: a.merge(b), plans)
        if args.tuned_cache:
            save_tuned(tuned, args.tuned_cache)
            print(f"[serve-vision] tuned {len(tuned)} entries "
                  f"-> {args.tuned_cache}")
        return tuned
    if args.tuned_cache:
        tuned = load_tuned(args.tuned_cache)
        print(f"[serve-vision] loaded tuning cache {args.tuned_cache} "
              f"({len(tuned)} entries, backend {tuned.backend})")
        return tuned
    return None


def vision_main(args):
    """Serve `args.requests` seeded images round-robin over the models.
    Returns {"results": {(model, rid): RequestResult}, "requests":
    [((model, rid), image)], "qnets": {model: QNet}, "coverage": {model:
    fraction} (tuned runs only), "stats": {model: EngineStats}}."""
    from repro_torch.core import cu
    from repro_torch.dist.sharding import data_mesh
    from repro_torch.serve.vision import MultiModelEngine, VisionEngine

    dev = cu.resolve_device(args.device)
    mesh = data_mesh(args.replicas, device=dev) if args.replicas > 1 \
        else None
    tracer = metrics = None
    if args.trace_out:
        from repro_torch.obs import Tracer
        tracer = Tracer()  # one tracer across models = one timeline
    if args.metrics_out:
        from repro_torch.obs import MetricsRegistry
        metrics = MetricsRegistry()
    # --batch bounds the largest micro-batch; the engine rounds buckets up
    # to replica multiples itself
    buckets = tuple(sorted(
        {b for b in (1, 2, 4) if b < args.batch} | {args.batch}))
    models = [m.strip() for m in args.models.split(",") if m.strip()]
    qnets = {m: vision_qnet(m, args.hw, args.seed, device=dev)
             for m in models}
    tuned = _vision_tuned(args, qnets, dev)
    coverage = {}
    if tuned is not None:
        for m, q in qnets.items():
            coverage[m] = tuned.coverage(q, backend=dev.type)
            print(f"[serve-vision] {m}: tuned route coverage "
                  f"{coverage[m]:.0%} ({dev.type})")
    engines = {
        m: VisionEngine(qnets[m], buckets=buckets, tuned=tuned,
                        tracer=tracer, metrics=metrics, name=m,
                        device=None if mesh else dev, mesh=mesh)
        for m in models
    }
    router = MultiModelEngine(engines, power_budget_w=args.power_budget_w)
    if args.power_budget_w:
        print(f"[serve-vision] power cap {args.power_budget_w:.1f} W "
              f"shared across {len(models)} model(s)")
    router.warmup()
    rng = np.random.default_rng(args.seed)
    now = time.perf_counter()
    requests = []
    for i in range(args.requests):
        img = rng.uniform(-1, 1, (args.hw, args.hw, 3)).astype(np.float32)
        deadline = now + 5.0 if i % 3 == 0 else None
        requests.append((router.submit(models[i % len(models)], img,
                                       deadline_s=deadline), img))
    results = router.run()
    n_ok = sum(1 for r in results.values() if r.status == "ok")
    print(f"[serve-vision] {n_ok}/{len(results)} ok over "
          f"{len(models)} model(s) on {dev}"
          + (f", {args.replicas} replicas: {mesh}" if mesh else ""))
    stats = router.stats()
    for m, st in sorted(stats.items()):
        print(f"[serve-vision] {m}: fps={st.fps:.1f} "
              f"p95={st.latency_p95_s*1e3:.1f}ms "
              f"micro_batches={st.micro_batches} replicas={st.replicas}")
        print(f"[serve-vision] {m}: "
              f"{st.energy_j_per_image*1e6:.1f} uJ/image "
              f"({st.power_source}) -> {st.watts:.1f} W, "
              f"{st.fps_per_watt:.1f} fps/W"
              + (f", shed={st.n_shed} deferred={st.n_deferred}"
                 if args.power_budget_w else ""))
    if tracer is not None:
        print(f"[serve-vision] trace -> {tracer.save(args.trace_out)} "
              f"({len(tracer)} events; load in https://ui.perfetto.dev)")
    if metrics is not None:
        print(f"[serve-vision] metrics -> {metrics.save(args.metrics_out)}")
    if tracer is not None or metrics is not None:
        from repro_torch.obs import render_report, summarize_trace
        print(render_report(
            summarize_trace(tracer.to_chrome()) if tracer else None,
            metrics.snapshot() if metrics else None))
    return {"results": results, "requests": requests, "qnets": qnets,
            "coverage": coverage, "stats": stats}


def _refuse_replicas(args):
    if args.replicas > 1:
        raise SystemExit(
            "--replicas > 1: the LM engine serves on one device; "
            "data-parallel replicas are for --vision")


def lm_main(args):
    """Serve `args.requests` seeded prompts through the LM `Engine`.
    Returns {"done": {rid: tokens}, "cfg": LMConfig, "params": the served
    weights, "seconds": wall time of the serving run (the device done),
    "tok_per_s": tokens over it}."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.cu import resolve_device
    from repro_torch.models.lm import model as M
    from repro_torch.serve.engine import Engine, Request

    _refuse_replicas(args)
    dev = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.quant_bits:
        cfg = dataclasses.replace(cfg, quant_bits=args.quant_bits)
    params, _ = M.init_params(cfg, args.seed, device=dev)
    eng = Engine(cfg, params, batch_slots=args.slots, max_len=args.max_len,
                 seed=args.seed, device=dev)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for i in range(args.requests):
        eng.submit(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab, args.prompt_len).astype(
                np.int32),
            max_new=args.max_new,
            temperature=0.0 if i % 2 == 0 else 0.8))
    done = eng.run()  # tokens come back to the host: the device is done
    dt = time.perf_counter() - t0
    total_tokens = sum(len(v) for v in done.values())
    for rid in sorted(done):
        print(f"[serve] req {rid}: {done[rid][:8]}... "
              f"({len(done[rid])} tokens)")
    print(f"[serve] {len(done)} requests, {total_tokens} tokens in "
          f"{dt:.2f}s ({total_tokens / dt:.1f} tok/s) on {dev}", flush=True)
    return {"done": done, "cfg": cfg, "params": params, "seconds": dt,
            "tok_per_s": total_tokens / dt}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--vision", action="store_true",
                    help="serve integer vision QNets instead of an LM")
    ap.add_argument("--models", default="mobilenet_v2",
                    help="comma-separated vision model list "
                         f"(from {', '.join(VISION_ARCHS)})")
    ap.add_argument("--replicas", type=int, default=1,
                    help="data-parallel replicas (vision; needs devices)")
    ap.add_argument("--hw", type=int, default=48, help="vision input H=W")
    ap.add_argument("--batch", type=int, default=8,
                    help="largest vision micro-batch bucket")
    ap.add_argument("--tune", action="store_true",
                    help="autotune per-op routes for each vision model "
                         "before serving (saved to --tuned-cache if given)")
    ap.add_argument("--tuned-cache", default=None,
                    help="tuning-cache JSON to load (or write, with "
                         "--tune) for vision serving")
    ap.add_argument("--power-budget-w", type=float, default=None,
                    help="shared modeled-power cap in watts: one rolling-"
                         "window governor across all models defers or "
                         "sheds work to stay under the cap")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace of the serving run")
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics registry (.prom/.txt = "
                         "Prometheus text, else JSON snapshot)")
    ap.add_argument("--arch", choices=sorted(ARCHS), default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced config (tiny widths)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--quant-bits", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    args = ap.parse_args(argv)

    if args.vision:
        return vision_main(args)
    return lm_main(args)


if __name__ == "__main__":
    main()
    sys.exit(0)
