"""The port's vision training front end (`repro_torch.train.vision`,
`models/layers.py`, `train/train_loop.py`, `data/pipeline.py`,
`launch/train_vision.py`) against the JAX package's, on parameters carried
across with `convert.params_from_reference`.

The reference programs are jitted with XLA's algebraic simplifier off
(`xla_disable_hlo_passes=algsimp`): it turns each division by a constant
into a multiplication by the reciprocal, which eager JAX (the source's own
semantics) and the port do not. JAX's `train()` is never run here (the JAX
package's own tests do); the reference's step is its
`make_vision_train_step`.

Tolerances, each measured first and stated where it is used:

  * float forward (BN folded from running stats), every activation and
    the logits: rtol 1e-5, atol 1e-5 times the tensor's largest magnitude
    (sums in another order, compounded over the blocks);
  * QAT forward, op by op on the same input: at most one activation step
    apart, and a step apart on at most 0.1 % of the elements (an element
    lying on a rounding tie after a convolution whose sums run in another
    order); MobileNetV2 whole-network QAT the same. A whole compact
    EfficientNet at 16x16 is not held this way: its SE gates and 1x1 maps
    cascade one flipped step into others;
  * a float step (BN on batch statistics) and a QAT step: loss rtol 1e-4
    (float; batch-statistics BN over 8 values at 1x1 amplifies rounding
    layer by layer) and 1e-6 (QAT); gradients within 0.05 of the largest
    gradient element-wise, and 0.05 (float) or 0.02 (QAT) in relative L2
    norm (a clipped-STE mask edge sits on an element's last bit); updated
    parameters at most 2 lr apart (Adam's first step moves each by about
    lr sign(g)), and within 1e-5 where the reference gradient exceeds 1e-3
    of the largest with the same sign in both; BN running stats rtol 1e-3,
    atol 1e-3 times the leaf's largest magnitude;
  * the schedule, the data stream and the exported artifact: exact. The
    JAX `quantize_net` on the port's trained state is held in
    `tests/test_torch_quant_train.py`.
"""
from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cu as RCU
from repro.core import qnet as RQN
from repro.data.pipeline import image_batch as r_image_batch
from repro.models import efficientnet as R_EFFN
from repro.models import layers as RL
from repro.train import optimizer as RO
from repro.train import train_loop as RTL
from repro.train import vision as RV
from repro_torch import convert
from repro_torch.core import cu as PCU
from repro_torch.core import qnet as PQN
from repro_torch.data.pipeline import image_batch as p_image_batch
from repro_torch.launch import train_vision as CLI
from repro_torch.models import layers as PL
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.train import optimizer as PO
from repro_torch.train import parity as PP
from repro_torch.train import train_loop as PTL
from repro_torch.train import tree as PT
from repro_torch.train import vision as PV

NO_ALGSIMP = {"xla_disable_hlo_passes": "algsimp"}
# the JAX trainer test's CFG (tests/test_train_vision.py)
CFG_KW = dict(model="mobilenet_v2", alpha=0.35, input_hw=16, num_classes=4,
              float_steps=4, qat_steps=4, batch=8, anneal_from=8,
              calibrate_every=2, ckpt_every=2)
RCFG = RV.VisionTrainConfig(**CFG_KW)
PCFG = PV.VisionTrainConfig(**CFG_KW)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side on one intra-op thread, as the other port test files
    under several workers: the default (every core, in each worker)
    oversubscribes the machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=NO_ALGSIMP)


def _np_params(net, seed: int, bn: bool):
    """He-normal weights, small nonzero biases and (with `bn`) BN leaves
    off identity, drawn with numpy, in the reference's layout."""
    rng = np.random.default_rng(seed)
    se = {n for b in net.blocks if b.se is not None
          for n in (b.se.squeeze.name, b.se.excite.name)}
    params = {}
    for _, op in net.all_ops():
        shape = op.weight_shape()
        fan_in = int(np.prod(shape[:-1])) or 1
        p = {"w": (rng.normal(size=shape) * (2.0 / fan_in) ** 0.5
                   ).astype(np.float32),
             "b": (0.05 * rng.normal(size=(op.out_ch,))).astype(np.float32)}
        if bn and op.kind != "dense" and op.name not in se:
            m = op.out_ch
            p["bn"] = {
                "gamma": rng.uniform(0.5, 1.5, m).astype(np.float32),
                "beta": (0.1 * rng.normal(size=m)).astype(np.float32),
                "mean": (0.1 * rng.normal(size=m)).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, m).astype(np.float32)}
        params[op.name] = p
    return params


NETS = {
    "mobilenet_v2": lambda: RV.build_net(RCFG),
    "efficientnet_compact": lambda: R_EFFN.build_compact(
        input_hw=16, num_classes=4, bits=4),
}


@pytest.fixture(scope="module", params=sorted(NETS))
def net_case(request):
    rnet = NETS[request.param]()
    params = _np_params(rnet, 1, bn=True)
    x = np.random.default_rng(2).uniform(-1, 1, (8, 16, 16, 3)).astype(
        np.float32)
    return (request.param, rnet, convert.netspec_from_reference(rnet),
            params, convert.params_from_reference(params, device="cpu"), x)


def test_forward_float_matches(net_case):
    _, rnet, pnet, params, pparams, x = net_case
    f = _jit(lambda p, v: RL.forward(p, v, rnet, capture=True), params, x)
    ry, racts = f(params, x)
    with torch.no_grad():
        py, pacts = PL.forward(pparams, torch.from_numpy(x), pnet,
                               capture=True)
    assert sorted(pacts) == sorted(racts)
    for k in racts:
        want = np.asarray(racts[k])
        np.testing.assert_allclose(pacts[k].numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)
    np.testing.assert_allclose(py.numpy(), np.asarray(ry), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(ry)).max())


def _assert_within_one_step(got: np.ndarray, want: np.ndarray, bits: int,
                            what: str):
    """Fake-quantized outputs: one step apart at most, and a step apart
    on at most 0.1 % of the elements; the rest equal to rtol 1e-5."""
    step = (want.max() - min(want.min(), 0.0)) / (2 ** bits - 1)
    d = np.abs(got - want)
    assert d.max() <= step * (1 + 1e-4) + 1e-6, (what, d.max() / step)
    flipped = d > step / 2
    assert flipped.mean() <= 1e-3, (what, int(flipped.sum()), d.size)
    np.testing.assert_allclose(got[~flipped], want[~flipped], rtol=1e-5,
                               atol=1e-5 * max(step, 1e-30), err_msg=what)
    return int(flipped.sum())


def test_forward_qat_op_by_op(net_case):
    """Every op (SE squeeze and excite included) on the input the port's
    forward gave it, through both packages' `_apply_op(qat=True)`."""
    _, rnet, pnet, params, pparams, x = net_case
    seen = {}
    orig = PL._apply_op

    def record(v, op, p, **kw):
        y = orig(v, op, p, **kw)
        seen[op.name] = (v.numpy(), y.numpy())
        return y

    PL._apply_op = record
    try:
        with torch.no_grad():
            PL.forward(pparams, torch.from_numpy(x), pnet, qat=True)
    finally:
        PL._apply_op = orig
    ops = {op.name: op for _, op in rnet.all_ops()}
    assert sorted(seen) == sorted(ops)
    ins = {k: v[0] for k, v in seen.items()}
    f = _jit(lambda p, xs: {k: RL._apply_op(xs[k], ops[k], p[k], qat=True)
                            for k in xs}, params, ins)
    want = f(params, ins)
    flips = 0
    for k, op in ops.items():
        got, ref = seen[k][1], np.asarray(want[k])
        if op.act == "none":
            np.testing.assert_allclose(got, ref, rtol=1e-5,
                                       atol=1e-5 * np.abs(ref).max(),
                                       err_msg=k)
        else:
            flips += _assert_within_one_step(got, ref, op.act_bits, k)
    assert flips <= 3


def test_forward_qat_whole_net_mobilenet():
    rnet = RV.build_net(RCFG)
    params = _np_params(rnet, 3, bn=True)
    pparams = convert.params_from_reference(params, device="cpu")
    x = np.random.default_rng(4).uniform(-1, 1, (8, 16, 16, 3)).astype(
        np.float32)
    f = _jit(lambda p, v: RL.forward(p, v, rnet, qat=True, capture=True),
             params, x)
    ry, racts = f(params, x)
    with torch.no_grad():
        py, pacts = PL.forward(pparams, torch.from_numpy(x),
                               convert.netspec_from_reference(rnet), qat=True,
                               capture=True)
    for _, op in rnet.all_ops():
        if op.act != "none":
            _assert_within_one_step(pacts[op.name].numpy(),
                                    np.asarray(racts[op.name]), op.act_bits,
                                    op.name)
    np.testing.assert_allclose(py.numpy(), np.asarray(ry), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(ry)).max())


# ---------------------------------------------------------------------------
# one train step against the reference's
# ---------------------------------------------------------------------------

OPT_KW = dict(lr=2e-3, warmup_steps=1, total_steps=4, weight_decay=0.0)


@pytest.fixture(scope="module", params=["float", "qat"])
def step_case(request):
    """One reference step from a fresh optimizer on the CFG net: the
    vision step's loss and gradients (its loss, restated here, since the
    step returns no gradients; the compiler merges the two) and the
    step's own output; the port's the same way."""
    qat = request.param == "qat"
    rnet = RV.build_net(RCFG)
    pnet = convert.netspec_from_reference(rnet)
    params = _np_params(rnet, 5, bn=True)
    pparams = convert.params_from_reference(params, device="cpu")
    if qat:  # QAT trains the BN-fused tree
        pparams = PL.fuse_bn_params(pparams)
        params = convert.params_to_reference(pparams)
    batch = RV.train_batch(RCFG, 0)
    opt = RO.AdamWConfig(**OPT_KW)

    def ref(p, b):
        def loss_fn(p, b):
            stats = None if qat else {}
            logits, _ = RL.forward(p, b["images"], rnet, qat=qat,
                                   bn_stats=stats)
            lp = jax.nn.log_softmax(logits)
            return -jnp.take_along_axis(lp, b["labels"][:, None],
                                        1).mean(), stats
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(p, b)
        step = RV.make_vision_train_step(rnet, opt, qat=qat,
                                         bn_batch=not qat)
        return loss, grads, step(p, RO.init_state(p), b)

    loss, grads, (new_p, _, metrics) = _jit(ref, params, batch)(
        params, batch)
    assert float(loss) == float(metrics["loss"])  # the restated loss is it
    pbatch = PV.train_batch(PCFG, 0, "cpu")
    ploss, _, pgrads = PTL.value_and_grad(
        PV.vision_loss(pnet, qat=qat, bn_batch=not qat), pparams, pbatch,
        has_aux=not qat)
    pnew, _, pmetrics = PV.make_vision_train_step(
        pnet, PO.AdamWConfig(**OPT_KW), qat=qat, bn_batch=not qat)(
        pparams, PO.init_state(pparams), pbatch)
    return dict(qat=qat, params=params, loss=float(loss), grads=grads,
                new=new_p, metrics=metrics, ploss=float(ploss),
                pgrads=pgrads, pnew=pnew, pmetrics=pmetrics)


def test_train_step_loss_and_gradients(step_case):
    c = step_case
    np.testing.assert_allclose(c["ploss"], c["loss"],
                               rtol=1e-6 if c["qat"] else 1e-4)
    np.testing.assert_allclose(float(c["pmetrics"]["loss"]), c["loss"],
                               rtol=1e-6 if c["qat"] else 1e-4)
    rg = [np.asarray(a) for a in jax.tree.leaves(c["grads"])]
    pg = [a.numpy() for a in PT.leaves(c["pgrads"])]
    assert len(rg) == len(pg)
    gmax = max(np.abs(a).max() for a in rg)
    for a, b in zip(rg, pg):
        assert np.abs(a - b).max() <= 0.05 * gmax
    err = np.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(rg, pg)))
    norm = np.sqrt(sum((a ** 2).sum() for a in rg))
    assert err <= (0.02 if c["qat"] else 0.05) * norm, err / norm
    np.testing.assert_allclose(float(c["pmetrics"]["lr"]),
                               float(c["metrics"]["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(c["pmetrics"]["grad_norm"]),
                               float(c["metrics"]["grad_norm"]), rtol=0.05)


def test_train_step_updated_params(step_case):
    c = step_case
    lr = OPT_KW["lr"]
    flat_r, tdef = jax.tree_util.tree_flatten_with_path(c["new"])
    flat_p = PT.leaves(c["pnew"])
    assert len(flat_r) == len(flat_p)
    grads = {jax.tree_util.keystr(k): np.asarray(g) for k, g in
             jax.tree_util.tree_flatten_with_path(c["grads"])[0]}
    pgrads = dict(zip(grads, (g.numpy() for g in PT.leaves(c["pgrads"]))))
    gmax = max(np.abs(g).max() for g in grads.values())
    moved = 0
    for (path, r), p in zip(flat_r, flat_p):
        key = jax.tree_util.keystr(path)
        r, p = np.asarray(r), p.numpy()
        if key.endswith("['mean']") or key.endswith("['var']"):
            # BN running stats: the EMA of this batch's moments
            np.testing.assert_allclose(p, r, rtol=1e-3,
                                       atol=1e-3 * np.abs(r).max(),
                                       err_msg=key)
            moved += int(np.any(r != np.asarray(
                _lookup(c["params"], path))))
            continue
        d = np.abs(p - r)
        assert d.max() <= 2 * lr * (1 + 1e-3), key
        g, pgk = grads[key], pgrads[key]
        sure = (np.abs(g) > 1e-3 * gmax) & (np.sign(g) == np.sign(pgk))
        assert d[sure].max(initial=0.0) <= 1e-5, key
    assert moved or c["qat"]  # the float step moves the running stats


def _lookup(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


# ---------------------------------------------------------------------------
# schedule, data, specs, microbatches
# ---------------------------------------------------------------------------

SCHEDULES = [
    dict(CFG_KW),
    dict(CFG_KW, anneal_from=None),
    dict(CFG_KW, qat_steps=5),
    dict(CFG_KW, qat_steps=1, anneal_from=8),
    dict(CFG_KW, float_steps=0),
    dict(CFG_KW, qat_steps=0),
    dict(CFG_KW, anneal_from=4),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=range(len(SCHEDULES)))
def test_phase_schedule_equal(kw):
    r, p = RV.VisionTrainConfig(**kw), PV.VisionTrainConfig(**kw)
    assert [dataclasses.astuple(ph) for ph in PV.phase_schedule(p)] == \
        [dataclasses.astuple(ph) for ph in RV.phase_schedule(r)]
    for step in range(p.total_steps + 2):
        assert PV.phase_at(p, step) == RV.phase_at(r, step)


def test_phase_schedule_refuses_zero_steps():
    kw = dict(CFG_KW, float_steps=0, qat_steps=0)
    with pytest.raises(ValueError, match="zero steps"):
        RV.phase_schedule(RV.VisionTrainConfig(**kw))
    with pytest.raises(ValueError, match="zero steps"):
        PV.phase_schedule(PV.VisionTrainConfig(**kw))


@pytest.mark.parametrize("seed,step,batch,hw,classes,channels", [
    (0, 0, 8, 16, 4, 3), (1, 7, 5, 9, 13, 3), (3, 2, 2, 32, 1000, 1)])
def test_image_batch_equal(seed, step, batch, hw, classes, channels):
    a = p_image_batch(seed, step, batch, hw, classes, channels)
    b = r_image_batch(seed, step, batch, hw, classes, channels)
    for k in ("images", "labels"):
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
    t = PV.train_batch(PCFG, 3, "cpu")
    ref = RV.train_batch(RCFG, 3)
    np.testing.assert_array_equal(t["images"].numpy(), ref["images"])
    np.testing.assert_array_equal(t["labels"].numpy(), ref["labels"])


@pytest.mark.parametrize("kw", [
    dict(CFG_KW), dict(CFG_KW, bits=4, act_bits=8),
    dict(CFG_KW, model="efficientnet_compact", input_hw=32),
    dict(CFG_KW, op_act_bits=(("irb3/dw", 8), ("tail/pw", 6)))])
def test_build_net_record_and_observer_keys(kw):
    r, p = RV.VisionTrainConfig(**kw), PV.VisionTrainConfig(**kw)
    assert PV.build_record(p) == RV.build_record(r)
    assert PV.build_net(p) == convert.netspec_from_reference(RV.build_net(r))
    assert PV.build_net(p, act_bits=6) == convert.netspec_from_reference(
        RV.build_net(r, act_bits=6))
    assert PQN.build_netspec(PV.build_record(p)) == PV.build_net(p)
    assert PV.observer_keys(PV.build_net(p)) == \
        RV.observer_keys(RV.build_net(r))


def test_microbatches_split_as_the_reference():
    """grad_accum=2 splits the batch into the reference's contiguous row
    blocks; its loss, gradients and BN moments are the microbatch means."""
    b = RV.train_batch(RCFG, 1)
    ref = RTL._split_microbatches({k: np.asarray(v) for k, v in b.items()},
                                  2)
    pb = PV.train_batch(PCFG, 1, "cpu")
    mine = PTL._split_microbatches(pb, 2)
    for i in range(2):
        for k in b:
            np.testing.assert_array_equal(mine[i][k].numpy(), ref[k][i])
    pnet = PV.build_net(PCFG)
    params = PL.init_params(0, pnet, bn=True)
    loss_fn = PV.vision_loss(pnet, qat=False, bn_batch=True)
    parts = [PTL.value_and_grad(loss_fn, params, mb, has_aux=True)
             for mb in mine]
    step = PTL.make_train_step(None, PO.AdamWConfig(), loss_fn=loss_fn,
                               grad_accum=2, has_aux=True)
    _, _, metrics = step(params, PO.init_state(params), pb)
    assert float(metrics["loss"]) == float((parts[0][0] + parts[1][0]) * 0.5)
    for k, mom in metrics["aux"].items():
        for s in ("mean", "var"):
            want = (parts[0][1][k][s] + parts[1][1][k][s]) * 0.5
            assert torch.equal(mom[s], want), (k, s)


# ---------------------------------------------------------------------------
# the port's trainer: restart, export, observability, CLI
# ---------------------------------------------------------------------------


def _state(result):
    return PT.leaves((result.params, result.opt_state,
                      PV._obs_tree(result.observers)))


@pytest.fixture(scope="module")
def straight():
    return PV.train(dataclasses.replace(PCFG, ckpt_every=0), device="cpu")


@pytest.mark.parametrize("kill_at", [3, 7])
def test_restart_continues_bitwise(straight, kill_at, tmp_path):
    """Killed at step 3 (before BN fusion: the tree changes shape across
    it) or 7 (mid annealed QAT) and resumed: params, optimizer state,
    observers and the loss history equal the straight run's bit for bit."""
    ckpt = str(tmp_path)
    part = PV.train(PCFG, ckpt_dir=ckpt, stop_after=kill_at, device="cpu")
    assert part.step == kill_at and not part.done
    extra = PV._ckpt_extra(ckpt, kill_at)
    assert extra["fused"] == (kill_at > PCFG.float_steps)
    resumed = PV.train(PCFG, ckpt_dir=ckpt, resume=True, device="cpu")
    assert resumed.done
    a, b = _state(straight), _state(resumed)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert resumed.history["loss"] == straight.history["loss"]
    assert [r["act_bits"] for r in resumed.history["calibration"]] == [8, 4]


def test_train_smoke_fuses_bn_and_calibrates(straight):
    assert straight.done and straight.step == PCFG.total_steps
    losses = straight.history["loss"]
    assert len(losses) == PCFG.total_steps and np.isfinite(losses).all()
    assert not any("bn" in p for p in straight.params.values())
    for r in straight.history["calibration"]:
        assert r["relu6_scale"] == pytest.approx(
            6.0 / (2 ** r["act_bits"] - 1))
        assert r["relu6_zp"] == 0.0
    assert PV.observers_ready(straight.observers)
    assert not PV.observers_ready(PV.init_observers(PCFG, "cpu"))
    assert 0.0 <= PV.eval_accuracy(straight.params, straight.net, PCFG,
                                   eval_batches=1) <= 1.0
    with pytest.raises(ValueError, match="ckpt_dir"):
        PV.train(PCFG, stop_after=3, device="cpu")


def test_train_traces_and_meters():
    tracer, reg = Tracer(), MetricsRegistry()
    cfg = dataclasses.replace(PCFG, float_steps=2, qat_steps=2,
                              anneal_from=None, calibrate_every=1)
    res = PV.train(cfg, tracer=tracer, metrics=reg, device="cpu")
    names = {e["name"] for e in tracer.to_chrome()["traceEvents"]}
    assert {"phase:float", "phase:qat", "calibration_round"} <= names
    snap = reg.snapshot()
    assert set(snap["gauges"]) == {"train_loss", "train_act_bits",
                                   "train_observers_ready"}
    assert snap["counters"] == {"train_steps_total": 4.0,
                                "train_calibration_rounds_total": 2.0}
    assert set(snap["histograms"]) == {"train_checkpoint_seconds"}
    assert res.done


def test_train_and_export_served_by_the_reference(tmp_path):
    """The whole slice: the port trains and exports at CFG; the JAX
    `load_qnet` plus a jitted `cu.run_qnet` serve the file with the port's
    logits bit for bit, and so does the port's own loader."""
    path = str(tmp_path / "mnv2.qnet")
    result, qnet, report = PV.train_and_export(PCFG, path=path, device="cpu")
    assert report["verified"] and report["observers_used"]
    assert report["routes"] == ["reference", "prepared", "stage[0:head]",
                                "stage[1:body]", "stage[2:tail]",
                                "stage-executors", "engine"]
    meta = RQN.read_qnet_meta(path)
    assert meta["build"] == RV.build_record(RCFG)
    assert meta["provenance"]["verified_routes"] == report["routes"]
    assert meta["provenance"]["online_quant_rounds"] == 2
    x = PV.calibration_batches(PCFG, "cpu")[0].numpy()
    rq = RQN.load_qnet(path)
    want = np.asarray(_jit(lambda v: RCU.run_qnet(rq, v), x)(x))
    np.testing.assert_array_equal(report["logits"], want)
    got = PCU.run_qnet(PQN.load_qnet(path), x, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_cli_smoke_export_and_check(tmp_path, capsys):
    path = str(tmp_path / "smoke.qnet")
    ckpt = str(tmp_path / "ckpt")
    assert CLI.main(["--smoke", "--device", "cpu", "--export", path,
                     "--ckpt-dir", ckpt]) == 0
    out = capsys.readouterr().out
    assert "serving routes proven bit-exact" in out
    assert os.path.exists(os.path.join(ckpt, "LATEST"))
    assert CLI.main(["--check-artifact", path, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "routes bit-exact on cpu" in out
    prov = json.loads(out.split("provenance: ")[1].splitlines()[0])
    assert prov["total_steps"] == 12 and prov["bn"] is True
    assert RQN.read_qnet_meta(path)["build"]["model"] == "mobilenet_v2"


def test_export_tune_proves_the_tuned_engine(straight):
    """`export(tune=True)` autotunes the exported net on the device and
    proves `engine[tuned]` beside every untuned route; `tuned=` passes a
    ready plan instead (here one whose every route is forced off the
    defaults), and the tuned engine stays bit-exact."""
    from repro_torch.tune import TunedPlan, tune_qnet

    qnet, report = PV.export(straight.params, straight.net, PCFG,
                             observers=straight.observers, tune=True,
                             device="cpu")
    assert report["routes"][-2:] == ["engine", "engine[tuned]"]
    assert report["tuned_entries"] > 0
    plan = tune_qnet(qnet, batch=2, device="cpu", measure=lambda fn, x, c: {
        "int_ref": 0.1, "fused_irb": 0.1}.get(c.route, 1.0))
    assert isinstance(plan, TunedPlan)
    assert {v.route for v in plan.entries.values()} == {"int_ref",
                                                         "fused_irb"}
    _, again = PV.export(straight.params, straight.net, PCFG,
                         observers=straight.observers, tuned=plan,
                         device="cpu")
    assert again["routes"] == report["routes"]
    np.testing.assert_array_equal(again["logits"], report["logits"])


def test_cli_tune_proves_the_tuned_engine(tmp_path, capsys):
    path = str(tmp_path / "tuned.qnet")
    assert CLI.main(["--smoke", "--device", "cpu", "--export", path,
                     "--tune"]) == 0
    assert "'engine', 'engine[tuned]']" in capsys.readouterr().out
    prov = RQN.read_qnet_meta(path)["provenance"]
    assert prov["verified_routes"][-1] == "engine[tuned]"


def test_tiny_float_phase_is_chaotic():
    """Why the card is held against the CPU step by step on shared params
    (`repro_torch.train.parity`) and not as two trajectories: at CFG's
    size a 1e-7 relative change of the init weights moves the second float
    step's loss by more than 0.1 % (BN over 8 values at 1x1, and Adam's
    first step moving every parameter by about lr whatever its gradient's
    size)."""
    cfg = dataclasses.replace(PCFG, qat_steps=0, ckpt_every=0)
    net = PV.build_net(cfg)
    opt = PO.AdamWConfig(lr=cfg.lr, warmup_steps=1,
                         total_steps=cfg.float_steps, weight_decay=0.0)
    step = PV.make_vision_train_step(net, opt, qat=False, bn_batch=True)

    def losses(scale: float):
        params = PL.init_params(cfg.seed, net, bn=True, device="cpu")
        gen = torch.Generator().manual_seed(1)
        for p in params.values():
            p["w"] = p["w"] * (1 + scale * torch.randn(p["w"].shape,
                                                       generator=gen))
        state, out = PO.init_state(params), []
        for i in range(2):
            params, state, m = step(params, state,
                                    PV.train_batch(cfg, i, "cpu"))
            out.append(float(m["loss"]))
        return out

    base, moved = losses(0.0), losses(1e-7)
    assert base == PV.train(cfg, device="cpu").history["loss"][:2]
    assert abs(moved[1] - base[1]) / base[1] > 1e-3


def test_step_parity_walk_is_the_trainers_run():
    """`parity.verify_train_steps` with the CPU as its device: every step,
    fake-quant forward and calibration round visited, each at distance 0,
    and its walk held bitwise against `train`'s run."""
    rep = PP.verify_train_steps(PCFG, device="cpu")
    assert rep["failures"] == []
    assert [e["step"] for e in rep["steps"]] == list(range(PCFG.total_steps))
    assert [e["phase"] for e in rep["steps"]] == \
        ["float"] * 4 + ["qat_act8"] * 2 + ["qat_act4"] * 2
    assert [r["step"] for r in rep["rounds"]] == [6, 8]
    for e in rep["steps"]:
        assert e["loss_dev"] == e["loss_cpu"]
        assert e["grad_elem"] == e["grad_l2"] == e["param_max"] == \
            e["bn"] == e["opt_param"] == e["opt_moment"] == 0.0
        assert e.get("fq_flipped", 0) == 0
    assert all(e["fq_elements"] > 0 for e in rep["steps"][4:])
    assert all(r["obs"] == 0.0 for r in rep["rounds"])


def test_step_parity_catches_an_inexact_device(monkeypatch):
    """A device that receives every float tensor 1e-3 relative off fails
    the loss, parameter, optimizer, fake-quant and observer checks."""
    def skewed(tree, dev):
        return PT.tree_map(lambda t: t * (1 + 1e-3) if t.is_floating_point()
                           else t, tree)

    monkeypatch.setattr(PP, "_to", skewed)
    cfg = dataclasses.replace(PCFG, float_steps=1, qat_steps=1,
                              anneal_from=None, calibrate_every=1,
                              ckpt_every=0)
    fails = "\n".join(PP.verify_train_steps(cfg, device="cpu")["failures"])
    for what in ("step 0 (float): loss", "step 1 (qat): loss",
                 "where the gradient is sure", "the device's AdamW",
                 "fake-quant output",
                 "round after step 1: observer"):
        assert what in fails, what
    assert "not vision.train's run" not in fails
