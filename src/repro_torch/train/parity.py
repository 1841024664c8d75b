"""A training run on one device held step by step against the CPU.

Two whole trajectories of a small config cannot be compared: its float
phase is chaotic (batch-statistics BN over 8 values at 1x1, and Adam's
first step moving every parameter by about lr whatever its gradient's
size, turn a 1e-7 change of the init into over 0.1 % of the second step's
loss). So each step is held on its own. `verify_train_steps` walks
`vision.train`'s schedule on the CPU; at every step the device takes the
CPU's params, optimizer state and batch, and its loss, gradients, updated
params and BN running stats are held against the CPU's, and so is its
AdamW update of the CPU's own gradients; at every QAT step its
fake-quantized activations too, and at every online-quantization round
its observers. The CPU then goes on from its own result. At the end the
walk is held bitwise against `vision.train(cfg, device="cpu")`, so it is
the trainer's own schedule.

The tolerances are those the CPU tests hold the port to against the JAX
package (`tests/test_torch_train_vision.py`), where they apply to a step
from any state; the notes say where and why they differ:

  * loss: rtol 1e-4 (float step) or 1e-6 (QAT step);
  * gradients: within 0.05 of the largest gradient element-wise, and 0.05
    (float) or 0.02 (QAT) apart in relative L2 norm;
  * updated parameters: at most 2 lr apart (Adam moves each by about lr);
    at a phase's first step, within 1e-5 where the gradient exceeds 1e-3
    of the largest on both devices, with the same sign. A fresh Adam moves
    a parameter by lr g / (|g| + eps), lr sign(g) once |g| is well above
    eps; the CPU tests ask the threshold of the reference's gradient only,
    but on the card a clipped-STE mask edge can leave an element's
    gradient 4e-4 on one device and 1e-7 on the other (eps-sized after
    clipping). At later steps Adam's move scales with g over its history,
    so a gradient 0.4 % apart moves a small-gradient parameter by a good
    share of lr: only the 2 lr bound holds there;
  * BN running stats: rtol 1e-3, atol 1e-3 times the leaf's largest
    magnitude, and for a running mean at least 1e-3 of the channel's
    running standard deviation (the batch mean of a convolution that reads
    a batch-normalized projection with beta 0 is zero up to rounding, 1e-7
    against a spread of 2 to 5, and its rounding scales with the spread);
  * fake-quantized activations (every op with an activation): at most one
    activation step apart, and a step apart on at most 0.1 % of a
    tensor's elements; the rest rtol 1e-5;
  * the device's AdamW on the CPU's gradients and optimizer state (its
    arithmetic alone, which the CPU tests do not separate): updated
    parameters within 1e-5 lr plus 2 ulp of the parameter, moments rtol
    1e-5, atol 1e-5 times the leaf's largest magnitude;
  * observers after a round (the BN-fused float forward's ranges): rtol
    1e-5, atol 1e-5 times the larger of the range's magnitudes.

`lm_step_errors` measures how far one LM train step went apart on two
sides (the JAX package's and the port's on the CPU in the tests, the CPU
and the card in `chip_smoke.py`), and `lm_step_failures` holds those
numbers to the `LM_*` bounds, the same on both uses.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.core import cu
from repro_torch.models import layers
from repro_torch.train import optimizer as O
from repro_torch.train import tree as T
from repro_torch.train import vision as V
from repro_torch.train.train_loop import value_and_grad

LOSS_RTOL = {False: 1e-4, True: 1e-6}  # by qat
GRAD_ELEM = 0.05  # of the largest gradient element
GRAD_L2 = {False: 0.05, True: 0.02}  # relative L2 norm, by qat
PARAM_LR = 2.0  # |updated param difference| <= PARAM_LR * lr
PARAM_SURE = 1e-5  # ... and this where the gradient's sign is sure
SURE_FRAC = 1e-3  # "sure": |g| above this share of the largest
BN_TOL = 1e-3  # running stats: rtol, and atol times the leaf's magnitude
OPT_LR = 1e-5  # the device's AdamW alone: params within this many lr ...
OPT_ULP = 2  # ... plus this many ulp of the parameter
OPT_MOM = 1e-5  # ... and moments within this rtol (atol times magnitude)
FQ_FLIP_SHARE = 1e-3  # fake-quant outputs a step apart, share of a tensor
FQ_RTOL = 1e-5  # the rest of them
OBS_TOL = 1e-5  # observer ranges: rtol, and atol times their magnitude


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _to(tree, dev: torch.device):
    return T.tree_map(lambda t: t.to(dev), tree)


def _leaf_names(params) -> List[str]:
    """'op/leaf' (or 'op/bn/leaf') names in the tree's flatten order."""
    names: List[str] = []

    def walk(prefix, t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(f"{prefix}/{k}" if prefix else k, t[k])
        else:
            names.append(prefix)

    walk("", params)
    return names


def _grads(want, got, qat: bool, fail: List[str], at: str):
    a = [_np(g) for g in T.leaves(want)]
    b = [_np(g) for g in T.leaves(got)]
    gmax = max(float(np.abs(x).max()) for x in a)
    elem = max(float(np.abs(x - y).max()) for x, y in zip(a, b)) / gmax
    err = np.sqrt(sum(float(((x - y) ** 2).sum()) for x, y in zip(a, b)))
    rel = float(err / np.sqrt(sum(float((x ** 2).sum()) for x in a)))
    if elem > GRAD_ELEM:
        fail.append(f"{at}: a gradient element {elem:.3g} of the largest "
                    f"apart (> {GRAD_ELEM})")
    if rel > GRAD_L2[qat]:
        fail.append(f"{at}: gradients {rel:.3g} apart in relative L2 "
                    f"(> {GRAD_L2[qat]})")
    return gmax, elem, rel


def _params(params, want, got, g_want, g_got, gmax: float, lr: float,
            first: bool, fail: List[str], at: str):
    """The step end to end: (worst param distance, worst where the
    gradient is sure, worst BN stat in units of its tolerance)."""
    names = _leaf_names(params)
    want_by = dict(zip(names, (_np(t) for t in T.leaves(want))))
    worst = worst_sure = worst_bn = 0.0
    for name, p, b, ga, gb in zip(names, T.leaves(params), T.leaves(got),
                                  T.leaves(g_want), T.leaves(g_got)):
        a, b = want_by[name], _np(b)
        d = np.abs(b - a)
        if name.endswith("/bn/mean") or name.endswith("/bn/var"):
            atol = BN_TOL * np.abs(a).max()
            if name.endswith("/bn/mean"):
                std = np.sqrt(want_by[name[:-len("mean")] + "var"])
                atol = np.maximum(atol, BN_TOL * std)
            lim = BN_TOL * np.abs(a) + atol
            worst_bn = max(worst_bn,
                           float((d / np.maximum(lim, 1e-30)).max()))
            if np.any(d > lim):
                fail.append(f"{at}: BN running stat {name} beyond rtol/atol "
                            f"{BN_TOL}")
            continue
        if not O._trainable(p):
            continue
        worst = max(worst, float(d.max()))
        if d.max() > PARAM_LR * lr * (1 + 1e-3):
            fail.append(f"{at}: {name} moved {d.max():.3g} apart (> "
                        f"{PARAM_LR} lr, lr {lr:.3g})")
        if not first:
            continue
        ga, gb = _np(ga), _np(gb)
        sure = (np.abs(ga) > SURE_FRAC * gmax) \
            & (np.abs(gb) > SURE_FRAC * gmax) & (np.sign(ga) == np.sign(gb))
        s = float(d[sure].max(initial=0.0))
        worst_sure = max(worst_sure, s)
        if s > PARAM_SURE:
            fail.append(f"{at}: {name} {s:.3g} apart where the gradient is "
                        f"sure (> {PARAM_SURE})")
    return worst, worst_sure, worst_bn


def _optimizer(params, grads, state, opt_cfg, dev, fail: List[str],
               at: str):
    """The device's AdamW on the CPU's gradients and state against the
    CPU's: (worst param distance in units of its tolerance, worst moment
    distance relative to the leaf's largest magnitude)."""
    with torch.no_grad():
        want_p, want_s, m = O.apply_updates(params, grads, state, opt_cfg)
        got_p, got_s, _ = O.apply_updates(_to(params, dev), _to(grads, dev),
                                          _to(state, dev), opt_cfg)
    lr = float(m["lr"])
    worst_p = worst_m = 0.0
    for name, a, b in zip(_leaf_names(params), T.leaves(want_p),
                          T.leaves(got_p)):
        a, b = _np(a), _np(b)
        lim = OPT_LR * lr + OPT_ULP * np.spacing(np.abs(a))
        worst_p = max(worst_p, float((np.abs(b - a) / lim).max()))
        if np.any(np.abs(b - a) > lim):
            fail.append(f"{at}: the device's AdamW moved {name} "
                        f"{float(np.abs(b - a).max()):.3g} from the CPU's on "
                        f"the same gradients")
    for a, b in zip(T.leaves((want_s.m, want_s.v)),
                    T.leaves((got_s.m, got_s.v))):
        a, b = _np(a), _np(b)
        mag = max(float(np.abs(a).max()), 1e-30)
        worst_m = max(worst_m, float(np.abs(b - a).max()) / mag)
        if np.any(np.abs(b - a) > OPT_MOM * np.abs(a) + OPT_MOM * mag):
            fail.append(f"{at}: the device's AdamW moments beyond rtol "
                        f"{OPT_MOM} on the same gradients")
    return worst_p, worst_m


def _fake_quant(params, images, net, dev, fail: List[str], at: str):
    """Every activated op's fake-quantized output, on the CPU and on
    `dev`: (largest distance in activation steps, elements a step apart,
    elements compared)."""
    with torch.no_grad(), layers.exact_f32():
        _, want = layers.forward(params, images, net, qat=True, capture=True)
        _, got = layers.forward(_to(params, dev), images.to(dev), net,
                                qat=True, capture=True)
    worst, flips, n = 0.0, 0, 0
    for _, op in net.all_ops():
        if op.act == "none":
            continue
        w, g = _np(want[op.name]), _np(got[op.name])
        step = (w.max() - min(w.min(), 0.0)) / (2 ** op.act_bits - 1)
        d = np.abs(g - w)
        flipped = d > step / 2
        worst = max(worst, float(d.max() / step))
        flips, n = flips + int(flipped.sum()), n + d.size
        if d.max() > step * (1 + 1e-4) + 1e-6:
            fail.append(f"{at}: {op.name} fake-quant output "
                        f"{d.max() / step:.3g} steps apart")
        if flipped.mean() > FQ_FLIP_SHARE:
            fail.append(f"{at}: {op.name} fake-quant output a step apart "
                        f"on {int(flipped.sum())} of {d.size} elements")
        rest = np.abs(g[~flipped] - w[~flipped])
        if np.any(rest > FQ_RTOL * np.abs(w[~flipped])
                  + FQ_RTOL * max(step, 1e-30)):
            fail.append(f"{at}: {op.name} fake-quant output beyond rtol "
                        f"{FQ_RTOL} off its flipped elements")
    return worst, flips, n


def _observers(want, got, fail: List[str], at: str) -> float:
    worst = 0.0
    for k, o in want.items():
        for a, b in ((o.min_val, got[k].min_val),
                     (o.max_val, got[k].max_val)):
            a, b = _np(a), _np(b)
            mag = max(float(np.abs(_np(o.min_val)).max()),
                      float(np.abs(_np(o.max_val)).max()), 1e-30)
            d = float(np.abs(b - a).max())
            worst = max(worst, d / mag)
            if np.any(np.abs(b - a) > OBS_TOL * np.abs(a) + OBS_TOL * mag):
                fail.append(f"{at}: observer {k} beyond rtol/atol {OBS_TOL}")
    return worst


def verify_train_steps(cfg: V.VisionTrainConfig, device=None
                       ) -> Dict[str, Any]:
    """Walk `cfg`'s schedule on the CPU, holding each step, fake-quant
    forward and calibration round on `device` (CUDA unless named) against
    it. Returns {"steps": [...], "rounds": [...], "failures": [...]}; an
    empty `failures` means every check held. Each step's entry has the
    loss on both devices and the worst distances found, in units of the
    tolerance's own scale."""
    dev = cu.resolve_device(device)
    cpu = torch.device("cpu")
    fail: List[str] = []
    steps: List[Dict[str, Any]] = []
    rounds: List[Dict[str, Any]] = []
    losses: List[float] = []
    params = layers.init_params(cfg.seed, V.build_net(cfg), bn=cfg.bn,
                                device=cpu)
    observers = V.init_observers(cfg, cpu)
    for ph in V.phase_schedule(cfg):
        if ph.qat and V._has_bn(params):
            params = layers.fuse_bn_params(params)
        net, loss_fn, step = V.phase_step(cfg, ph, params)
        opt_cfg = V.phase_opt_cfg(cfg, ph)
        has_aux = (not ph.qat) and V._has_bn(params)
        state = O.init_state(params)
        for gs in range(ph.start, ph.stop):
            at = f"step {gs} ({ph.name})"
            batch = V.train_batch(cfg, gs, cpu)
            with layers.exact_f32():
                lw, _, gw = value_and_grad(loss_fn, params, batch, has_aux)
                lg, _, gg = value_and_grad(loss_fn, _to(params, dev),
                                           _to(batch, dev), has_aux)
            new, new_state, m = step(params, state, batch)
            got, _, _ = step(_to(params, dev), _to(state, dev),
                             _to(batch, dev))
            lw, lg, lr = float(lw), float(lg), float(m["lr"])
            loss_rel = abs(lg - lw) / abs(lw)
            if loss_rel > LOSS_RTOL[ph.qat]:
                fail.append(f"{at}: loss {lg} against {lw} (rtol "
                            f"{LOSS_RTOL[ph.qat]})")
            gmax, g_elem, g_l2 = _grads(gw, gg, ph.qat, fail, at)
            p_max, p_sure, bn = _params(params, new, got, gw, gg, gmax, lr,
                                        gs == ph.start, fail, at)
            opt_p, opt_m = _optimizer(params, gw, state, opt_cfg, dev, fail,
                                      at)
            entry = dict(step=gs, phase=ph.name, loss_cpu=lw, loss_dev=lg,
                         loss_rel=loss_rel, grad_elem=g_elem, grad_l2=g_l2,
                         lr=lr, param_max=p_max, param_sure=p_sure, bn=bn,
                         opt_param=opt_p, opt_moment=opt_m)
            if ph.qat:
                fq, flips, n = _fake_quant(params, batch["images"], net,
                                           dev, fail, at)
                entry.update(fq_steps=fq, fq_flipped=flips, fq_elements=n)
            steps.append(entry)
            params, state = new, new_state
            losses.append(float(m["loss"]))
            if V.calibration_due(cfg, ph, gs + 1):
                want, _ = V.run_calibration(params, net, cfg, observers,
                                            act_bits=ph.act_bits)
                got_obs, _ = V.run_calibration(
                    _to(params, dev), net, cfg,
                    {k: dataclasses.replace(o, min_val=o.min_val.to(dev),
                                            max_val=o.max_val.to(dev))
                     for k, o in observers.items()},
                    act_bits=ph.act_bits)
                rounds.append(dict(step=gs + 1, obs=_observers(
                    want, got_obs, fail, f"round after step {gs}")))
                observers = want
    ref = V.train(cfg, device=cpu)
    same = losses == ref.history["loss"] and all(
        torch.equal(a, b) for a, b in zip(
            T.leaves((params, V._obs_tree(observers))),
            T.leaves((ref.params, V._obs_tree(ref.observers)))))
    if not same:
        fail.append("the CPU walk is not vision.train's run")
    return {"steps": steps, "rounds": rounds, "failures": fail}


# ---------------------------------------------------------------------------
# the LM train step (`train_loop.make_train_step(cfg)`), one step from one
# state on two sides: the JAX package's and the port's on the CPU (the
# tests), the port's on the CPU and on the card (`chip_smoke.py`)
# ---------------------------------------------------------------------------

# float32 bounds, each measured first on the reduced configs (the JAX
# package against the port on the CPU) and at Llama-3.2-1B's widths (the
# card against the CPU):
LM_LOSS_RTOL = 1e-5  # loss, grad_norm (measured at most 1.6e-7)
LM_GRAD_L2 = 1e-4  # each gradient leaf's relative L2 distance (2.6e-6)
LM_MOMENT_L2 = 2e-4  # each m and v leaf's, v about g squared (4.4e-6)
LM_SURE_EPS = 1e3  # "sure": |clipped g| above this many Adam eps, both sides
# updated params there, in units of lr: JAX against the port on the CPU
# (3.05e-5, one float32 ulp of a parameter near 0.25) and the card against
# the CPU (1.22e-4 at full width, one ulp of a norm scale of 1) ...
LM_PARAM_SURE = 1.5e-4
LM_PARAM_SURE_CARD = 5e-4
LM_PARAM_LR = 2.0  # ... and everywhere (a fresh Adam moves each by ~lr)
# bfloat16: the loss and each gradient leaf of two computations of the
# same loss (the JAX package against the port on the CPU, the pipeline
# against the plain loss on the card)
LM_BF16_LOSS_RTOL = 1e-4
LM_BF16_GRAD_L2 = 2e-2


def _as_tensor(x, dev) -> torch.Tensor:
    """A torch tensor or an array (JAX, numpy) as a tensor on `dev`,
    floating values in float64 (bf16 exactly), integers as they are."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        x = torch.from_numpy(np.array(
            a.astype(np.float32) if a.dtype.name == "bfloat16" else a))
    x = x.detach().to(dev)
    return x.to(torch.float64) if x.is_floating_point() else x


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """|b - a| / |a| in L2 (float64 tensors) over the elements that are
    not NaN on both sides (inf where a NaN stands on one side only)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return float("inf")
    a, b = a[~na], b[~na]
    den = float(torch.linalg.vector_norm(a))
    num = float(torch.linalg.vector_norm(b - a))
    return num / den if den > 0 else float(num > 0) * float("inf")


def lm_step_errors(before, want: Dict[str, Any], got: Dict[str, Any],
                   opt_cfg: O.AdamWConfig, device="cpu") -> Dict[str, Any]:
    """How far one train step from the parameters `before` went apart on
    two sides. `want` and `got` hold `loss`, `grad_norm`, `lr` (numbers)
    and the trees `grads`, `params` (after the step), `m` and `v` (8-bit
    moments dequantized), in the reference's leaf order; leaves are torch
    tensors or arrays, compared in float64 on `device`. Returns the
    largest relative error of the loss and grad norm, `lr`'s absolute
    one, the worst leaf's relative L2 distance of the gradients and of the
    moments (`worst_grad`, `worst_moment` name the leaves), the updated
    params' distance in units of lr where the clipped gradient is sure on
    both sides (`params_sure`, Adam's first step moves them by lr g / (|g|
    + eps)) and everywhere (`params`), and the sure share of the trained
    elements. Integer leaves must be equal. A NaN must stand on both sides
    (`nan` counts the updated parameters that are NaN on both; one side's
    alone counts as inf): the 8-bit state of both packages turns a
    parameter whose first gradient is exactly 0 into NaN (ROADMAP F9)."""
    names = _leaf_names(before)
    lr = float(want["lr"])
    clip = {k: min(1.0, opt_cfg.grad_clip / max(float(d["grad_norm"]), 1e-9))
            if opt_cfg.grad_clip else 1.0 for k, d in (("w", want),
                                                       ("g", got))}
    out = {"loss": abs(float(got["loss"]) - float(want["loss"]))
           / abs(float(want["loss"])),
           "grad_norm": abs(float(got["grad_norm"]) - float(want["grad_norm"]))
           / abs(float(want["grad_norm"])),
           "lr": abs(float(got["lr"]) - lr), "grads": 0.0, "moments": 0.0,
           "params_sure": 0.0, "params": 0.0, "frozen_equal": True, "nan": 0,
           "worst_grad": "", "worst_moment": ""}
    n_sure = n_all = 0
    leaves = zip(names, T.leaves(before), *(
        T.leaves(d[k]) for d in (want, got) for k in ("grads", "params")),
        *(T.leaves(d[k]) for k in ("m", "v") for d in (want, got)))
    with torch.no_grad():
        for name, p0, gw, pw, gg, pg, mw, mg, vw, vg in leaves:
            p0, pw, pg = (_as_tensor(x, device) for x in (p0, pw, pg))
            if not p0.is_floating_point():
                out["frozen_equal"] &= bool(torch.equal(pw, pg)
                                            and torch.equal(pw, p0))
                continue
            gw, gg = _as_tensor(gw, device), _as_tensor(gg, device)
            e = _rel_l2(gw, gg)
            if e > out["grads"]:
                out["grads"], out["worst_grad"] = e, name
            for tag, a, b in ((f"{name} m", mw, mg), (f"{name} v", vw, vg)):
                e = _rel_l2(_as_tensor(a, device), _as_tensor(b, device))
                if e > out["moments"]:
                    out["moments"], out["worst_moment"] = e, tag
            both = torch.isnan(pw) & torch.isnan(pg)
            out["nan"] += int(both.sum())
            d = (pg - pw).abs() / lr
            d[both] = 0.0
            d[torch.isnan(d)] = float("inf")  # a NaN on one side only
            out["params"] = max(out["params"], float(d.max()))
            cw, cg = gw * clip["w"], gg * clip["g"]
            lim = LM_SURE_EPS * opt_cfg.eps
            sure = (cw.abs() > lim) & (cg.abs() > lim) \
                & (torch.sign(cw) == torch.sign(cg))
            if sure.any():
                out["params_sure"] = max(out["params_sure"],
                                         float(d[sure].max()))
            n_sure += int(sure.sum())
            n_all += sure.numel()
    out["sure_share"] = n_sure / max(n_all, 1)
    return out


def lm_step_failures(err: Dict[str, Any],
                     moment_l2: float = LM_MOMENT_L2,
                     params_sure: float = LM_PARAM_SURE) -> List[str]:
    """The bounds `lm_step_errors`' numbers broke (the moments' bound is
    the caller's for 8-bit state, the sure params' LM_PARAM_SURE_CARD for
    the card against the CPU)."""
    fail = []
    for key, lim in (("loss", LM_LOSS_RTOL), ("grad_norm", LM_LOSS_RTOL),
                     ("grads", LM_GRAD_L2), ("moments", moment_l2),
                     ("params_sure", params_sure),
                     ("params", LM_PARAM_LR)):
        if not err[key] <= lim:
            fail.append(f"{key} {err[key]:.3g} > {lim}")
    if err["lr"] != 0.0:
        fail.append(f"lr {err['lr']:.3g} apart")
    if not err["frozen_equal"]:
        fail.append("an integer leaf changed")
    return fail


__all__ = ["verify_train_steps", "lm_step_errors", "lm_step_failures"]
