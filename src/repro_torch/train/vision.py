"""FPGA-aware QAT vision training: train -> online-quantize -> export (Fig. 1).

Counterpart of `repro/train/vision.py`, the paper's front end end to end:

  1. **Float pre-training** with BatchNorm on batch statistics
     (`models/layers.forward(bn_stats=...)`), the running stats kept by the
     train step; microbatched gradient accumulation and AdamW through
     `train/train_loop.make_train_step` and `train/optimizer`.
  2. **BN fusion** at the float -> QAT boundary (`layers.fuse_bn_params`,
     Eqs. 4-6): QAT fake quant sees the deployed weights.
  3. **QAT with online quantization**: fake-quantized forward at the target
     bit-widths, with an optional activation-bit anneal (8 -> 4); every
     `calibrate_every` QAT steps the held-out calibration stream goes
     through `core/calibrate.ActObserver` (EMA) and the ReLU6-fused qparams
     are re-derived. The observers are checkpointed training state: once
     every one has seen a round (`observers_ready`), their ranges become
     the exported artifact's activation quantizers.
  4. **Checkpoint/restart**: periodic async checkpoints
     (`train/checkpoint.py`, the reference's format); a run restarted from
     any checkpoint continues bit for bit (counter-based data, a fresh
     optimizer per phase, deterministic float32 in the step), across the
     BN-fusion boundary too. Checkpoints record whether they hold the
     fused tree.
  5. **Export**: calibrate -> `quantize_net` -> prove the artifact bit-exact
     through the reference interpreter, `prepare_qnet`, the stage executors
     (on the card: the K2-K4 kernels) and a `VisionEngine` — and, with
     `tune=True` or `tuned=`, a `VisionEngine` serving the measured route
     selection (`repro_torch.tune`) — and only then write the `.qnet` with
     its build record and training provenance.

Every entry point runs on CUDA unless the caller passes `device="cpu"`,
and raises when there is no card.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import compiler as CC
from repro_torch.core import cu
from repro_torch.core import graph as G
from repro_torch.core import qnet as Q
from repro_torch.core.calibrate import ActObserver, calibrate, relu6_fused_qparams
from repro_torch.core.quant import QuantConfig
from repro_torch.data.pipeline import image_batch
from repro_torch.models import layers
from repro_torch.obs import metrics as OM
from repro_torch.obs import trace as OT
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import optimizer as O
from repro_torch.train import tree as T
from repro_torch.train.train_loop import make_train_step

# ---------------------------------------------------------------------------
# configuration + phase schedule
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VisionTrainConfig:
    """One deterministic training run: the phase boundaries, the data
    stream and the calibration stream are pure functions of it."""

    model: str = "mobilenet_v2"  # mobilenet_v2 | efficientnet_compact
    alpha: float = 0.35  # mobilenet width multiplier
    input_hw: int = 16
    num_classes: int = 4
    bits: int = 4  # weight BW
    act_bits: int = 4  # deployment activation BW
    # heterogeneous deployment: sorted ((op_name, act_bits), ...) pairs on
    # top of the uniform `act_bits` (`alloc` gives the dict view)
    op_act_bits: Optional[Tuple[Tuple[str, int], ...]] = None
    anneal_from: Optional[int] = None  # e.g. 8: first half of QAT at 8b acts
    bn: bool = True  # float phase trains with BatchNorm, fused before QAT
    float_steps: int = 40
    qat_steps: int = 20
    batch: int = 32
    grad_accum: int = 1
    lr: float = 2e-3
    qat_lr: float = 5e-4
    weight_decay: float = 0.0
    warmup_steps: int = 5
    bn_momentum: float = 0.9
    seed: int = 0  # param init
    data_seed: int = 0  # training stream
    calib_seed: int = 1  # held-out calibration stream (disjoint from data)
    calib_batches: int = 4
    calib_momentum: Optional[float] = 0.9  # EMA observers for online quant
    calibrate_every: int = 0  # QAT steps between online-quant rounds; 0=off
    ckpt_every: int = 0  # global steps between checkpoints; 0 = off
    ckpt_keep: int = 3

    @property
    def total_steps(self) -> int:
        return self.float_steps + self.qat_steps

    @property
    def alloc(self) -> Optional[Dict[str, int]]:
        """The per-op activation allocation as a dict, or None (uniform)."""
        if not self.op_act_bits:
            return None
        return {str(k): int(v) for k, v in self.op_act_bits}


@dataclasses.dataclass(frozen=True)
class Phase:
    name: str
    start: int  # first global step of this phase
    stop: int  # one past the last
    qat: bool
    act_bits: int
    lr: float


def build_net(cfg: VisionTrainConfig, act_bits: Optional[int] = None
              ) -> G.NetSpec:
    """The deployment NetSpec, through the artifact's own build record (so
    the spec trained is the spec `load_qnet(path)` rebuilds); `act_bits`
    overrides the activation BW for an anneal phase, which trains without
    the per-op allocation."""
    rec = build_record(cfg)
    if act_bits is not None:
        rec["act_bits"] = act_bits
        if act_bits != cfg.act_bits:
            rec.pop("op_act_bits", None)
    return Q.build_netspec(rec)


def build_record(cfg: VisionTrainConfig) -> Dict[str, Any]:
    """The artifact's self-description (inverse of `build_netspec`)."""
    rec: Dict[str, Any] = {"model": cfg.model, "input_hw": cfg.input_hw,
                           "bits": cfg.bits, "num_classes": cfg.num_classes,
                           "act_bits": cfg.act_bits}
    if cfg.model == "mobilenet_v2":
        rec["alpha"] = cfg.alpha
    if cfg.alloc:
        rec["op_act_bits"] = cfg.alloc
    return rec


def phase_schedule(cfg: VisionTrainConfig) -> Tuple[Phase, ...]:
    phases: List[Phase] = []
    if cfg.float_steps:
        phases.append(Phase("float", 0, cfg.float_steps, False,
                            cfg.act_bits, cfg.lr))
    q0 = cfg.float_steps
    if cfg.qat_steps:
        if cfg.anneal_from is not None and cfg.anneal_from != cfg.act_bits:
            n1 = cfg.qat_steps // 2
            if n1:
                phases.append(Phase(f"qat_act{cfg.anneal_from}", q0, q0 + n1,
                                    True, cfg.anneal_from, cfg.qat_lr))
            phases.append(Phase(f"qat_act{cfg.act_bits}", q0 + n1,
                                q0 + cfg.qat_steps, True, cfg.act_bits,
                                cfg.qat_lr))
        else:
            phases.append(Phase("qat", q0, q0 + cfg.qat_steps, True,
                                cfg.act_bits, cfg.qat_lr))
    if not phases:
        raise ValueError("config trains for zero steps")
    return tuple(phases)


def phase_at(cfg: VisionTrainConfig, step: int) -> int:
    """Index of the phase a run with `step` completed steps resumes into."""
    phases = phase_schedule(cfg)
    for i, ph in enumerate(phases):
        if step < ph.stop:
            return i
    return len(phases) - 1


# ---------------------------------------------------------------------------
# data + train step
# ---------------------------------------------------------------------------


def _device_of(params) -> torch.device:
    return T.leaves(params)[0].device


def train_batch(cfg: VisionTrainConfig, step: int, device=None
                ) -> Dict[str, torch.Tensor]:
    """Global step `step`'s batch on `device` (CUDA unless named)."""
    dev = cu.resolve_device(device)
    b = image_batch(cfg.data_seed, step, cfg.batch, cfg.input_hw,
                    cfg.num_classes)
    return {"images": torch.from_numpy(b["images"]).to(dev),
            "labels": torch.from_numpy(b["labels"]).to(dev)}


def eval_accuracy(
    params,
    net: G.NetSpec,
    cfg: VisionTrainConfig,
    *,
    qat: bool = True,
    eval_seed: int = 2,
    eval_batches: int = 4,
) -> float:
    """Held-out top-1 accuracy of the (fake-quantized) forward, on the
    params' device; the stream (`eval_seed`, batch index) is disjoint from
    training and calibration."""
    dev = _device_of(params)
    correct = total = 0
    with torch.no_grad(), layers.exact_f32():
        for i in range(eval_batches):
            b = image_batch(eval_seed, i, cfg.batch, cfg.input_hw,
                            cfg.num_classes)
            logits, _ = layers.forward(
                params, torch.from_numpy(b["images"]).to(dev), net, qat=qat)
            pred = torch.argmax(logits, dim=-1).cpu().numpy()
            correct += int((pred == b["labels"]).sum())
            total += int(b["labels"].size)
    return correct / total if total else 0.0


def calibration_batches(cfg: VisionTrainConfig, device=None
                        ) -> List[torch.Tensor]:
    """Held-out calibration stream, fixed for the whole run."""
    dev = cu.resolve_device(device)
    return [torch.from_numpy(image_batch(
        cfg.calib_seed, i, cfg.batch, cfg.input_hw,
        cfg.num_classes)["images"]).to(dev)
        for i in range(cfg.calib_batches)]


def vision_loss(net: G.NetSpec, *, qat: bool, bn_batch: bool = False
                ) -> Callable:
    """The train step's loss: the mean negative log-softmax of the label,
    read through a one-hot product (exact, and deterministic on the card,
    where a gather's backward is not); with `bn_batch`, `(loss, BN batch
    moments)`."""

    def loss_fn(params, batch):
        bn_stats: Optional[Dict] = {} if bn_batch else None
        logits, _ = layers.forward(params, batch["images"], net, qat=qat,
                                   bn_stats=bn_stats)
        lp = torch.log_softmax(logits, dim=-1)
        classes = torch.arange(logits.shape[-1], device=logits.device)
        onehot = (batch["labels"].long()[:, None] == classes).to(lp.dtype)
        loss = -(lp * onehot).sum(dim=-1).mean()
        return (loss, bn_stats) if bn_batch else loss

    return loss_fn


def make_vision_train_step(
    net: G.NetSpec,
    opt_cfg: O.AdamWConfig,
    *,
    qat: bool,
    grad_accum: int = 1,
    bn_batch: bool = False,
    bn_momentum: float = 0.9,
) -> Callable:
    """Microbatched QAT/float train step over `make_train_step` with
    `vision_loss`. `bn_batch=True` (float pre-training) runs BN on batch
    statistics and folds the microbatch-averaged moments into the running
    stats by EMA after the optimizer update."""
    loss_fn = vision_loss(net, qat=qat, bn_batch=bn_batch)
    base = make_train_step(None, opt_cfg, loss_fn=loss_fn,
                           grad_accum=grad_accum, has_aux=bn_batch)
    if not bn_batch:
        return base

    def step(params, opt_state, batch):
        prev = params  # pre-update running stats (the optimizer never owns them)
        params, opt_state, metrics = base(params, opt_state, batch)
        moments = metrics.pop("aux")
        m = bn_momentum
        params = dict(params)
        for name, mom in moments.items():
            old = prev[name]["bn"]
            p = dict(params[name])
            p["bn"] = {
                "gamma": params[name]["bn"]["gamma"],
                "beta": params[name]["bn"]["beta"],
                "mean": m * old["mean"] + (1 - m) * mom["mean"],
                "var": m * old["var"] + (1 - m) * mom["var"],
            }
            params[name] = p
        return params, opt_state, metrics

    return step


# ---------------------------------------------------------------------------
# online quantization (calibration rounds during QAT)
# ---------------------------------------------------------------------------


def observer_keys(net: G.NetSpec) -> Tuple[str, ...]:
    """Every activation name the capture forward emits, from the spec
    alone (the traversal of `layers._apply_block`)."""
    keys: List[str] = []
    for block in net.blocks:
        for op in block.ops:
            keys.append(op.name)
            if block.se is not None and block.se_after == op.name:
                keys.append("se_gate")
        if block.residual:
            keys.append(block.name + "/residual")
        if block.avgpool:
            keys.append(block.name + "/avgpool")
    return tuple(dict.fromkeys(keys))


def init_observers(cfg: VisionTrainConfig, device=None
                   ) -> Dict[str, ActObserver]:
    """Untouched (±inf range) EMA observers for every capture key, on
    `device` (CUDA unless named)."""
    dev = cu.resolve_device(device)
    return {k: ActObserver.init((), momentum=cfg.calib_momentum, device=dev)
            for k in observer_keys(build_net(cfg))}


def _obs_tree(observers: Dict[str, ActObserver]):
    """Checkpointable tree view (momentum is config, not state)."""
    return {k: {"mn": o.min_val, "mx": o.max_val}
            for k, o in observers.items()}


def _obs_from_tree(tree, momentum: Optional[float]) -> Dict[str, ActObserver]:
    return {k: ActObserver(v["mn"], v["mx"], momentum)
            for k, v in tree.items()}


def observers_ready(observers: Dict[str, ActObserver]) -> bool:
    """True once a full calibration round ran: every observer holds a
    finite range."""
    return bool(observers) and all(
        bool(torch.isfinite(o.min_val).all())
        and bool(torch.isfinite(o.max_val).all())
        for o in observers.values())


_CFG_MOMENTUM = object()  # sentinel: "use cfg.calib_momentum"


def run_calibration(
    params,
    net: G.NetSpec,
    cfg: VisionTrainConfig,
    observers: Optional[Dict[str, ActObserver]] = None,
    act_bits: Optional[int] = None,
    momentum=_CFG_MOMENTUM,
) -> Tuple[Dict[str, ActObserver], Dict[str, Any]]:
    """One calibration round on the params' device: the held-out stream
    through the BN-fused float forward, the observers updated, the
    ReLU6-fused qparams re-derived. Returns (observers, round summary).
    `momentum=None` forces true-min/max observers (the from-scratch export
    recalibration)."""
    bw = act_bits if act_bits is not None else cfg.act_bits
    acfg = QuantConfig(bw, symmetric=False, channel_axis=None)

    def apply_fn(p, b):
        return layers.forward(p, b, net, capture=True)[1]

    m = cfg.calib_momentum if momentum is _CFG_MOMENTUM else momentum
    with layers.exact_f32():
        observers = calibrate(
            apply_fn, params, calibration_batches(cfg, _device_of(params)),
            acfg, observers=observers, momentum=m)
    s6, z6 = relu6_fused_qparams(acfg)
    summary = {
        "act_bits": bw,
        "relu6_scale": float(s6),
        "relu6_zp": float(z6),
        "n_observers": len(observers),
        "ranges": {
            name: (float(obs.min_val), float(obs.max_val))
            for name, obs in sorted(observers.items())[:4]
        },
    }
    return observers, summary


# ---------------------------------------------------------------------------
# training orchestrator (checkpoint / restart / preemption)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainResult:
    params: Any
    net: G.NetSpec  # deployment spec (final act bits)
    cfg: VisionTrainConfig
    step: int  # global steps completed
    history: Dict[str, Any]
    observers: Dict[str, ActObserver]
    opt_state: Any = None  # the last phase's optimizer state

    @property
    def done(self) -> bool:
        return self.step >= self.cfg.total_steps


def _has_bn(params) -> bool:
    return any("bn" in p for p in params.values())


def phase_opt_cfg(cfg: VisionTrainConfig, ph: Phase) -> O.AdamWConfig:
    """Phase `ph`'s optimizer: its own lr schedule over its steps."""
    n = ph.stop - ph.start
    return O.AdamWConfig(
        lr=ph.lr, warmup_steps=min(cfg.warmup_steps, max(n // 5, 1)),
        total_steps=n, weight_decay=cfg.weight_decay)


def phase_step(cfg: VisionTrainConfig, ph: Phase, params
               ) -> Tuple[G.NetSpec, Callable, Callable]:
    """(net, loss_fn, step) of phase `ph` for the tree `params` holds at
    the phase's entry: the net at the phase's activation BW, the loss the
    step differentiates, and the step over `phase_opt_cfg`."""
    net = build_net(cfg, act_bits=ph.act_bits)
    bn_batch = (not ph.qat) and cfg.bn and _has_bn(params)
    step = make_vision_train_step(
        net, phase_opt_cfg(cfg, ph), qat=ph.qat, grad_accum=cfg.grad_accum,
        bn_batch=bn_batch, bn_momentum=cfg.bn_momentum)
    return net, vision_loss(net, qat=ph.qat, bn_batch=bn_batch), step


def calibration_due(cfg: VisionTrainConfig, ph: Phase, completed: int
                    ) -> bool:
    """Whether an online-quantization round follows the step that brought
    the run to `completed` global steps."""
    return bool(ph.qat and cfg.calibrate_every
                and (completed - ph.start) % cfg.calibrate_every == 0)


def _ckpt_extra(ckpt_dir: str, step: int) -> Dict[str, Any]:
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "manifest.json")
    with open(path) as f:
        return json.load(f).get("extra", {})


def _template(cfg: VisionTrainConfig, fused: bool, device):
    """The parameter tree at a checkpoint: init replayed (+ BN fusion when
    the checkpoint is past the float -> QAT boundary)."""
    params = layers.init_params(cfg.seed, build_net(cfg), bn=cfg.bn,
                                device=device)
    if fused and cfg.bn:
        params = layers.fuse_bn_params(params)
    return params


def train(
    cfg: VisionTrainConfig,
    *,
    ckpt_dir: Optional[str] = None,
    resume: bool = False,
    stop_after: Optional[int] = None,
    log: Optional[Callable[[str], None]] = None,
    tracer: Optional[OT.Tracer] = None,
    metrics: Optional[OM.MetricsRegistry] = None,
    device=None,
) -> TrainResult:
    """Run (or resume) the full schedule on `device` (CUDA unless named).
    `stop_after=k` checkpoints and returns after k global steps (the
    simulated preemption).

    `tracer`/`metrics` (`repro_torch.obs`) record phase, calibration and
    checkpoint spans on the `train` track, and the per-step loss, the
    act-bit anneal position, calibration rounds, observer readiness and
    checkpoint time, under the reference's names."""
    dev = cu.resolve_device(device)
    say = log or (lambda s: None)
    tracer = tracer if tracer is not None else OT.NULL
    reg = metrics if metrics is not None else OM.NULL_REGISTRY
    if tracer:
        tracer.name_track(OT.TID_TRAIN, "train")
    m_loss = reg.gauge("train_loss", "last train-step loss")
    m_steps = reg.counter("train_steps_total",
                          "global train steps run by this process")
    m_act_bits = reg.gauge(
        "train_act_bits",
        "activation bit-width of the current phase (the QAT anneal path)")
    m_calib = reg.counter("train_calibration_rounds_total",
                          "online-quantization calibration rounds")
    m_obs_ready = reg.gauge(
        "train_observers_ready",
        "1 once every activation observer holds a finite range")
    m_ckpt = reg.histogram(
        "train_checkpoint_seconds",
        "save_ckpt wall time (incl. waiting out the prior async write)")
    if stop_after is not None and not ckpt_dir:
        raise ValueError("stop_after requires ckpt_dir (nothing would be "
                         "saved to resume from)")
    phases = phase_schedule(cfg)
    history: Dict[str, Any] = {"loss": [], "phases": [], "calibration": []}
    observers = init_observers(cfg, dev)

    start = 0
    if resume and ckpt_dir and CKPT.latest_step(ckpt_dir) is not None:
        start = CKPT.latest_step(ckpt_dir)
        extra = _ckpt_extra(ckpt_dir, start)
        template = _template(cfg, extra.get("fused", not cfg.bn), dev)
        (params, opt_state, obs_tree), _ = CKPT.restore(
            ckpt_dir, (template, O.init_state(template),
                       _obs_tree(observers)), step=start)
        # observers ride the checkpoint: a resumed run's online-quant
        # rounds, and so its export quantizers, are the straight run's
        observers = _obs_from_tree(obs_tree, cfg.calib_momentum)
        # the run log rides the manifest, so a resumed run's history spans
        # the whole run (JSON turns tuples into lists)
        history = extra.get("history", history)
        say(f"[train-vision] resumed at step {start} "
            f"(phase {phases[phase_at(cfg, start)].name})")
    else:
        params = layers.init_params(cfg.seed, build_net(cfg), bn=cfg.bn,
                                    device=dev)
        opt_state = None  # initialized at phase entry

    pending = None  # in-flight async checkpoint writer
    completed = start  # global steps finished so far
    stopped = False

    def save_ckpt(step_done: int, loss: float):
        nonlocal pending
        if not ckpt_dir:
            return
        tc0 = time.perf_counter()
        with tracer.span("checkpoint", cat="train", tid=OT.TID_TRAIN,
                         args={"step": step_done}):
            if pending is not None:
                pending.join()
            pending = CKPT.save(
                ckpt_dir, step_done,
                (params, opt_state, _obs_tree(observers)),
                keep=cfg.ckpt_keep, async_=True,
                extra={"fused": not _has_bn(params), "loss": loss,
                       # a JSON round trip is a deep snapshot the async
                       # writer cannot see mutate
                       "history": json.loads(json.dumps(history)),
                       "phase": phases[min(phase_at(cfg, step_done),
                                           len(phases) - 1)].name})
        m_ckpt.observe(time.perf_counter() - tc0)

    for ph in phases:
        if stopped or completed >= ph.stop:
            continue
        if ph.qat and _has_bn(params):
            # float -> QAT boundary: fold BN so fake quant trains the
            # deployed weights; the tree changes shape here
            params = layers.fuse_bn_params(params)
            say(f"[train-vision] fused BN into weights at step {completed}")
        net_ph, _, step_fn = phase_step(cfg, ph, params)
        if opt_state is None or completed == ph.start:
            # a fresh optimizer per phase (its own schedule)
            opt_state = O.init_state(params)
        if not any(e["name"] == ph.name for e in history["phases"]):
            history["phases"].append(
                {"name": ph.name, "start": ph.start, "stop": ph.stop,
                 "act_bits": ph.act_bits, "qat": ph.qat})
        m_act_bits.set(ph.act_bits)
        ph_t0 = tracer.now() if tracer else 0.0
        ph_from = completed

        for gs in range(completed, ph.stop):
            batch = train_batch(cfg, gs, dev)
            params, opt_state, step_metrics = step_fn(params, opt_state,
                                                      batch)
            loss = float(step_metrics["loss"])
            history["loss"].append(loss)
            completed = gs + 1
            m_loss.set(loss)
            m_steps.inc()
            if calibration_due(cfg, ph, completed):
                with tracer.span("calibration_round", cat="train",
                                 tid=OT.TID_TRAIN,
                                 args={"step": completed,
                                       "act_bits": ph.act_bits}):
                    observers, summary = run_calibration(
                        params, net_ph, cfg, observers, act_bits=ph.act_bits)
                history["calibration"].append(dict(summary, step=completed))
                m_calib.inc()
                if reg:
                    m_obs_ready.set(1.0 if observers_ready(observers)
                                    else 0.0)
                say(f"[train-vision] online-quant round at step {completed}: "
                    f"act{summary['act_bits']} relu6 S="
                    f"{summary['relu6_scale']:.5f}")
            if stop_after is not None and completed >= stop_after:
                save_ckpt(completed, loss)
                stopped = True
                say(f"[train-vision] preempted at step {completed} "
                    f"(checkpointed)")
                break
            if cfg.ckpt_every and (completed % cfg.ckpt_every == 0
                                   or completed == cfg.total_steps):
                save_ckpt(completed, loss)

        if tracer:
            tracer.complete(
                f"phase:{ph.name}", ph_t0, tracer.now(), cat="train",
                tid=OT.TID_TRAIN,
                args={"act_bits": ph.act_bits, "qat": ph.qat,
                      "steps": completed - ph_from})

    if pending is not None:
        pending.join()
    return TrainResult(params=params, net=build_net(cfg), cfg=cfg,
                       step=completed, history=history, observers=observers,
                       opt_state=opt_state)


# ---------------------------------------------------------------------------
# export: calibrate -> quantize -> prove bit-exact -> freeze
# ---------------------------------------------------------------------------


class ExportParityError(AssertionError):
    """A serving route disagreed with the reference interpreter bitwise."""


def stage_vectors(qnet, x: np.ndarray, device=None):
    """(stage CU names, per-stage integer activations, float logits) from
    the reference `cu.run_blocks` walk on `device` (CUDA unless named): the
    ground truth every other route is proven against."""
    pq = cu.prepare_qnet(qnet, device=device)
    sigs = CC.compile_net(pq.spec).stage_signatures()
    s, z = cu.input_qparams(pq)
    y = cu.quantize_input(cu.as_input(x, pq.device), pq.input_scale, z, 8)
    acts, cus = [], []
    for sig in sigs:
        y, s, z = cu.run_blocks(y, sig.blocks, pq, s, z)
        acts.append(y.cpu().numpy())
        cus.append(sig.cu)
    logits = (acts[-1].astype(np.float32) + np.float32(z)) * np.float32(s)
    return cus, acts, logits


def _check_equal(name: str, got, want: np.ndarray, report: List[str]):
    if isinstance(got, torch.Tensor):
        got = got.cpu().numpy()
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise ExportParityError(
            f"{name}: shape {got.shape} != reference {want.shape}")
    if not np.array_equal(got, want):
        n = int(np.sum(got != want))
        d = float(np.max(np.abs(got.astype(np.float64)
                                - want.astype(np.float64))))
        raise ExportParityError(
            f"{name}: {n} elements differ from the reference "
            f"(max |delta| {d:.3g}); routes proven so far: {report}")
    report.append(name)


def verify_export(qnet, x: np.ndarray, device=None,
                  tuned=None) -> Dict[str, Any]:
    """Prove one input batch bit-exact across every serving route on
    `device` (CUDA unless named): reference interpreter, `prepare_qnet`,
    the stage executors (the K2-K4 kernels on the card), a `VisionEngine`
    and, given a `TunedPlan`, a `VisionEngine(tuned=)` (`engine[tuned]`).
    Raises `ExportParityError` on the first route that drifts one LSB."""
    from repro_torch.serve.vision import VisionEngine, compile_stages

    x = np.asarray(x, np.float32)
    pq = cu.prepare_qnet(qnet, device=device)
    cus, acts, logits = stage_vectors(pq, x, device=pq.device)
    proven: List[str] = ["reference"]

    _check_equal("prepared", cu.run_qnet(pq, x), logits, proven)

    stages = compile_stages(pq, device=pq.device)
    y = torch.from_numpy(x).to(pq.device)
    for i, st in enumerate(stages):
        y = st(y)
        if i < len(stages) - 1:
            _check_equal(f"stage[{i}:{st.spec.cu}]", y,
                         acts[i].astype(np.int32), proven)
    _check_equal("stage-executors", y, logits, proven)

    eng = VisionEngine(pq, buckets=(x.shape[0],), device=pq.device)
    rids = [eng.submit(img) for img in x]
    res = eng.run()
    _check_equal("engine", np.stack([res[r].logits for r in rids]), logits,
                 proven)

    if tuned is not None:
        eng = VisionEngine(pq, buckets=(x.shape[0],), device=pq.device,
                           tuned=tuned)
        rids = [eng.submit(img) for img in x]
        res = eng.run()
        _check_equal("engine[tuned]",
                     np.stack([res[r].logits for r in rids]), logits, proven)

    return {"routes": proven, "stages": len(cus), "cus": cus,
            "logits": logits, "device": str(pq.device),
            "tuned_entries": len(tuned) if tuned is not None else 0}


def export(
    params,
    net: G.NetSpec,
    cfg: VisionTrainConfig,
    *,
    path: Optional[str] = None,
    observers: Optional[Dict[str, ActObserver]] = None,
    verify: bool = True,
    verify_batch: Optional[np.ndarray] = None,
    tuned=None,
    tune: bool = False,
    provenance: Optional[Dict[str, Any]] = None,
    tracer: Optional[OT.Tracer] = None,
    device=None,
) -> Tuple[Q.QNet, Dict[str, Any]]:
    """BN-fuse (if still unfused) -> calibrate on the held-out stream ->
    `quantize_net` -> prove every serving route bit-exact -> write `path`.

    `observers`: the run's online-quantization observers (once
    `observers_ready`), or None to recalibrate from scratch with
    true-min/max observers. Calibration and the proof run on `device`
    (CUDA unless named; the params are moved there). `tune=True` autotunes
    the exported net on that device (`repro_torch.tune.tune_qnet`, with
    `tracer` passed on) and proves the tuned engine too;
    `tuned=` passes a ready plan instead. The artifact is written only
    after every proof passes."""
    dev = cu.resolve_device(device)
    params = T.tree_map(lambda t: t.to(dev), params)
    if _has_bn(params):
        params = layers.fuse_bn_params(params)
    if observers is None:
        observers, _ = run_calibration(params, net, cfg, momentum=None)
    qnet = Q.quantize_net(params, net, observers)

    if tune and tuned is None:
        from repro_torch.tune import tune_qnet
        tuned = tune_qnet(qnet, batch=min(cfg.batch, 8), repeats=1,
                          device=dev, tracer=tracer)

    report: Dict[str, Any] = {"verified": False}
    if verify:
        if verify_batch is None:
            verify_batch = calibration_batches(cfg, "cpu")[0].numpy()
        report = verify_export(qnet, verify_batch, device=dev, tuned=tuned)
        report["verified"] = True

    if path is not None:
        prov = {"model": cfg.model, "total_steps": cfg.total_steps,
                "float_steps": cfg.float_steps, "qat_steps": cfg.qat_steps,
                "act_bits": cfg.act_bits, "bits": cfg.bits,
                "anneal_from": cfg.anneal_from, "bn": cfg.bn,
                "seed": cfg.seed, "data_seed": cfg.data_seed,
                "calib_seed": cfg.calib_seed,
                "calib_batches": cfg.calib_batches,
                "op_act_bits": cfg.alloc,
                "verified_routes": report.get("routes", [])}
        if provenance:
            prov.update(provenance)
        Q.save_qnet(qnet, path, build=build_record(cfg), provenance=prov)
        report["path"] = path
        report["artifact_bytes"] = os.path.getsize(path)
    return qnet, report


def train_and_export(
    cfg: VisionTrainConfig,
    *,
    ckpt_dir: Optional[str] = None,
    resume: bool = False,
    stop_after: Optional[int] = None,
    path: Optional[str] = None,
    verify: bool = True,
    verify_batch: Optional[np.ndarray] = None,
    tune: bool = False,
    log: Optional[Callable[[str], None]] = None,
    tracer: Optional[OT.Tracer] = None,
    metrics: Optional[OM.MetricsRegistry] = None,
    device=None,
) -> Tuple[TrainResult, Optional[Q.QNet], Dict[str, Any]]:
    """The whole Fig. 1 front end in one call (the launch driver's body)."""
    result = train(cfg, ckpt_dir=ckpt_dir, resume=resume,
                   stop_after=stop_after, log=log, tracer=tracer,
                   metrics=metrics, device=device)
    if not result.done:
        return result, None, {"verified": False, "reason": "preempted"}
    # once every observer saw a full round, the EMA-tracked ranges become
    # the artifact's activation quantizers (else recalibrate from scratch)
    obs = result.observers if observers_ready(result.observers) else None
    rounds = len(result.history["calibration"])
    qnet, report = export(result.params, result.net, cfg, path=path,
                          observers=obs, verify=verify,
                          verify_batch=verify_batch, tune=tune,
                          tracer=tracer,
                          provenance={"final_loss": result.history["loss"][-1]
                                      if result.history["loss"] else None,
                                      "online_quant_rounds": rounds},
                          device=device)
    report["online_quant_rounds"] = rounds
    report["observers_used"] = obs is not None
    return result, qnet, report


__all__ = [
    "VisionTrainConfig",
    "Phase",
    "TrainResult",
    "ExportParityError",
    "build_net",
    "build_record",
    "phase_schedule",
    "phase_at",
    "train_batch",
    "calibration_batches",
    "eval_accuracy",
    "vision_loss",
    "make_vision_train_step",
    "observer_keys",
    "init_observers",
    "observers_ready",
    "run_calibration",
    "phase_opt_cfg",
    "phase_step",
    "calibration_due",
    "train",
    "stage_vectors",
    "verify_export",
    "export",
    "train_and_export",
]
