"""Vision QAT training driver: train -> online-quantize -> export -> serve.

    PYTHONPATH=src python -m repro_torch.launch.train_vision \
        --model mobilenet_v2 --hw 16 --classes 4 \
        --float-steps 40 --qat-steps 20 [--anneal-from 8] \
        --ckpt-dir /tmp/ckpt [--resume] \
        --export /tmp/mnv2.qnet [--tune] [--device cpu]

The paper's Fig. 1 front end on one card (or on the CPU with `--device
cpu`): float pre-training with BatchNorm, BN fusion, QAT with online
quantization (held-out calibration rounds through `core/calibrate`),
periodic async checkpoints with bitwise restart, and an export that
proves the `.qnet` bit-exact through every serving route (reference
interpreter, prepared net, stage executors, `VisionEngine`; with `--tune`
also the `VisionEngine` serving the route selection the autotuner measured
on the exported net) before writing it.

    PYTHONPATH=src python -m repro_torch.launch.train_vision \
        --check-artifact /tmp/mnv2.qnet [--device cpu]

re-opens an artifact through the serve-side loader, prints its schema
(build record, provenance, op table) and re-proves route parity on a fresh
batch. The exit status is non-zero on any parity failure. Without
`--device`, both modes run on CUDA and fail where there is no card.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from repro_torch.train import vision as V


def check_artifact(path: str, batch: int = 4, seed: int = 123,
                   device=None) -> int:
    """Load `path` from disk alone and re-prove serving parity on `device`
    (CUDA unless named). Returns an exit code (0 = schema complete and
    every route bit-exact)."""
    from repro_torch.core import cu
    from repro_torch.core.qnet import load_qnet, read_qnet_meta

    dev = cu.resolve_device(device)
    meta = read_qnet_meta(path)
    missing = [k for k in ("net", "ops", "build") if k not in meta]
    if missing:
        print(f"[check-artifact] {path}: missing meta keys {missing}")
        return 1
    qnet = load_qnet(path)  # the build record alone: the serve-side route
    print(f"[check-artifact] {path}: net={meta['net']} "
          f"ops={len(meta['ops'])} build={meta['build']}")
    if "provenance" in meta:
        print(f"[check-artifact] provenance: "
              f"{json.dumps(meta['provenance'], sort_keys=True)}")
    hw = qnet.spec.input_hw
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (batch, hw, hw, qnet.spec.input_ch)
                    ).astype(np.float32)
    try:
        report = V.verify_export(qnet, x, device=dev)
    except V.ExportParityError as e:
        print(f"[check-artifact] PARITY FAILURE: {e}")
        return 1
    s, z = cu.input_qparams(qnet)
    print(f"[check-artifact] routes bit-exact on {dev}: {report['routes']} "
          f"({report['stages']} stages, input S={s:.5f} z={z:.0f})")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("mobilenet_v2", "efficientnet_compact"),
                    default="mobilenet_v2")
    ap.add_argument("--alpha", type=float, default=0.35)
    ap.add_argument("--hw", type=int, default=16, help="input H=W")
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--bits", type=int, default=4, help="weight BW")
    ap.add_argument("--act-bits", type=int, default=4,
                    help="deployment activation BW")
    ap.add_argument("--anneal-from", type=int, default=None,
                    help="start QAT at this activation BW (e.g. 8) and "
                         "anneal down to --act-bits halfway")
    ap.add_argument("--no-bn", action="store_true",
                    help="skip BatchNorm in the float phase")
    ap.add_argument("--float-steps", type=int, default=40)
    ap.add_argument("--qat-steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--qat-lr", type=float, default=5e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calibrate-every", type=int, default=10,
                    help="QAT steps between online-quantization rounds")
    ap.add_argument("--calib-batches", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--stop-after", type=int, default=None,
                    help="checkpoint and exit after N global steps "
                         "(simulated preemption)")
    ap.add_argument("--export", default=None, metavar="PATH",
                    help="freeze the trained net to a .qnet artifact "
                         "(after proving every serving route bit-exact)")
    ap.add_argument("--no-verify", action="store_true",
                    help="skip the export parity proof (NOT recommended)")
    ap.add_argument("--tune", action="store_true",
                    help="autotune the exported net and prove the tuned "
                         "VisionEngine route too")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny CI-sized run (overrides steps/batch)")
    ap.add_argument("--check-artifact", default=None, metavar="PATH",
                    help="no-train mode: load a frozen .qnet and re-prove "
                         "schema + route parity")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    args = ap.parse_args(argv)

    if args.check_artifact:
        return check_artifact(args.check_artifact, device=args.device)

    if args.stop_after is not None and not args.ckpt_dir:
        ap.error("--stop-after requires --ckpt-dir (nothing would be saved "
                 "to resume from)")

    if args.smoke:
        args.float_steps = min(args.float_steps, 6)
        args.qat_steps = min(args.qat_steps, 6)
        args.batch = min(args.batch, 16)
        args.calibrate_every = min(args.calibrate_every, 3)

    cfg = V.VisionTrainConfig(
        model=args.model, alpha=args.alpha, input_hw=args.hw,
        num_classes=args.classes, bits=args.bits, act_bits=args.act_bits,
        anneal_from=args.anneal_from, bn=not args.no_bn,
        float_steps=args.float_steps, qat_steps=args.qat_steps,
        batch=args.batch, grad_accum=args.grad_accum,
        lr=args.lr, qat_lr=args.qat_lr, seed=args.seed,
        calibrate_every=args.calibrate_every,
        calib_batches=args.calib_batches,
        ckpt_every=args.ckpt_every if args.ckpt_dir else 0,
    )

    if args.export:
        result, qnet, report = V.train_and_export(
            cfg, ckpt_dir=args.ckpt_dir, resume=args.resume,
            stop_after=args.stop_after, path=args.export,
            verify=not args.no_verify, tune=args.tune, log=print,
            device=args.device)
    else:
        result = V.train(cfg, ckpt_dir=args.ckpt_dir, resume=args.resume,
                         stop_after=args.stop_after, log=print,
                         device=args.device)
        qnet, report = None, {}
    losses = result.history["loss"]
    if losses:
        print(f"[train-vision] {result.step}/{cfg.total_steps} steps; "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    if not result.done:
        print("[train-vision] run preempted — resume with --resume")
        return 0
    if args.export:
        if report.get("observers_used"):
            print(f"[train-vision] exported with "
                  f"{report['online_quant_rounds']} online-quant round(s) "
                  f"of observer state")
        print(f"[train-vision] exported {args.export} "
              f"({report.get('artifact_bytes', 0)} bytes, "
              f"{qnet.model_bytes()} packed model bytes)")
        if report.get("verified"):
            print(f"[train-vision] serving routes proven bit-exact: "
                  f"{report['routes']}")
    return 0


if __name__ == "__main__":
    sys.exit(main() or 0)
