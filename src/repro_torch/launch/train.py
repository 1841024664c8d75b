"""LM training driver with fault tolerance.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --reduced --steps 100 --ckpt-dir /tmp/ckpt [--grad-compress] \
        [--grad-accum 2] [--resume] [--device cpu]

Counterpart of `repro/launch/train.py`, with its flags and defaults, on
one card (or on the CPU with `--device cpu`; without it the run needs a
card and fails where there is none):

  * the deterministic data stream (`data/pipeline.lm_stream`), resumed at
    the saved step, so a restarted run sees no batch twice;
  * periodic async checkpoints with rotation, each joined before the next
    one starts, and a SIGTERM drain (checkpoint, then exit: preemption);
  * a straggler watchdog whose persistent-straggler callback checkpoints
    at the end of the step;
  * optional int8 gradient compression with error feedback
    (`--grad-compress`) and gradient accumulation (`--grad-accum`);
  * a restart that continues the straight run bit for bit: the checkpoint
    holds (params, opt_state), and with `--grad-compress` the error-feedback
    residual too (the reference's checkpoint leaves it out, so its restart
    starts the residual from zeros: ROADMAP F11).

Parameters are placed as the reference places them: under
`use_mesh(make_host_mesh(...))`, through `tree_shardings` of the model's
logical axes. For every family, with or without `--grad-compress`, and a
`--device` that names no index (`cuda`, the default, or `cpu`), the host
mesh spans every visible device of that type ((n, 1) on ('data',
'model'): every card, or the one CPU), and the step is data-parallel over
it, as the reference's pjit over its host mesh: each device holds the
parameters whole and its rows of each batch (`--batch` must divide by
n), the gradients are psummed over 'data' (the partitioned step,
`models/lm/model.py`; the moe family's capacity and aux loss over the
whole batch), and `--grad-compress` compresses the psummed gradients, its
residual placed like the parameters and checkpointed so. A device named
by index (such as `cuda:1`) keeps the (1, 1) mesh of that one device. On
one device every placement is that device and no number moves. The
driver feeds tokens alone, as the reference's does, so the audio family
(whose encoder needs its frames) cannot train through it.
"""
from __future__ import annotations

import argparse
import signal
import time

import torch

from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.core.cu import resolve_device
from repro_torch.data.pipeline import DataConfig, lm_stream
from repro_torch.dist.sharding import (
    P,
    NamedSharding,
    place,
    tree_shardings,
    use_mesh,
)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.lm import model as M
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import grad_compress as GC
from repro_torch.train import optimizer as O
from repro_torch.train import tree as T
from repro_torch.train.straggler import StepWatchdog
from repro_torch.train.train_loop import make_train_step


def _ckpt_tree(params, opt_state, err_state):
    """What a checkpoint holds: the residual only where there is one."""
    if err_state is None:
        return params, opt_state
    return params, opt_state, err_state


def main(argv=None):
    """Train as the flags say; returns the loss of every step run."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=sorted(ARCHS), default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    spans = args.device is None or torch.device(args.device).index is None
    mesh = (make_host_mesh(device=dev) if spans
            else make_host_mesh(devices=[dev]))
    dev = mesh.device_list[0]
    rows = NamedSharding(mesh, P("data", None))
    data_cfg = DataConfig(seed=args.seed, vocab=cfg.vocab,
                          seq_len=args.seq, global_batch=args.batch)
    opt_cfg = O.AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                            total_steps=args.steps)

    with use_mesh(mesh):
        params, logical = M.init_params(cfg, args.seed, device=dev)
        param_sh = tree_shardings(logical, mesh)
        params = T.tree_map(place, params, param_sh)
    opt_state = O.init_state(params)
    err_state = GC.init_error(params) if args.grad_compress else None
    start_step = 0
    if args.resume and args.ckpt_dir:
        try:
            (params, opt_state, *err), start_step = CKPT.restore(
                args.ckpt_dir, _ckpt_tree(params, opt_state, err_state))
            err_state = err[0] if err else None
            print(f"[train] resumed from step {start_step}", flush=True)
        except FileNotFoundError:
            print("[train] no checkpoint found; cold start", flush=True)

    step_fn = make_train_step(cfg, opt_cfg, grad_accum=args.grad_accum,
                              compress=args.grad_compress)

    stop = {"now": False}
    ckpt_req = {"now": False}

    def _sigterm(signum, frame):  # preemption drain
        print("[train] SIGTERM: checkpoint + exit", flush=True)
        stop["now"] = True

    def _on_straggler(step_no, dt, ema):
        print(f"[train] persistent straggler at step {step_no} "
              f"({dt:.2f}s vs EMA {ema:.2f}s): checkpoint + advise "
              f"evict/reshard", flush=True)
        ckpt_req["now"] = True

    watchdog = StepWatchdog(on_straggler=_on_straggler)
    prev_handler = signal.signal(signal.SIGTERM, _sigterm)
    pending = None
    losses = []
    step = start_step
    try:
        t0 = time.time()
        stream = lm_stream(data_cfg, start_step)
        for step in range(start_step, args.steps):
            batch = {k: place(torch.from_numpy(v).long(), rows)
                     for k, v in next(stream).items()}
            watchdog.start()
            if args.grad_compress:
                params, opt_state, err_state, metrics = step_fn(
                    params, opt_state, batch, err_state)
            else:
                params, opt_state, metrics = step_fn(params, opt_state, batch)
            losses.append(float(metrics["loss"]))  # waits for the device
            watchdog.stop()
            if (step + 1) % args.log_every == 0:
                rate = (step + 1 - start_step) / (time.time() - t0)
                print(f"[train] step {step + 1} loss={losses[-1]:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"({rate:.2f} steps/s)", flush=True)
            want_ckpt = args.ckpt_dir and (
                (step + 1) % args.ckpt_every == 0 or stop["now"]
                or ckpt_req["now"] or step + 1 == args.steps)
            ckpt_req["now"] = False
            if want_ckpt:
                if pending is not None:
                    pending.join()
                pending = CKPT.save(
                    args.ckpt_dir, step + 1,
                    _ckpt_tree(params, opt_state, err_state), async_=True,
                    extra={"loss": losses[-1]})
            if stop["now"]:
                break
    finally:
        if pending is not None:
            pending.join()
        signal.signal(signal.SIGTERM, prev_handler)
    if losses:
        print(f"[train] done at step {step + 1}; "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    return losses


if __name__ == "__main__":
    main()
