"""The port's mixed-precision search (`repro_torch.tune.precision`,
`python -m repro_torch.tune --precision / --precision-export /
--check-pareto`) on the CPU, held against the JAX package's
(`repro.tune.precision`):

  (a) the latency table on the committed JAX CPU caches
      (`experiments/tuned/mobilenet_v2_act{4,8}_cpu.json`) at the committed
      artifact's build: every uniform width prices the same microseconds,
      tuned counts, missing keys and J/image in both packages, and act4
      and act8 give the committed artifact's numbers;
  (b) the whole search under `fake_measure` and `fake_accuracy` on the
      JAX test's tiny config (`tests/test_precision.py`): the same points,
      allocations, savings order and front, every float equal. The JAX
      side's tuner jit-compiles every candidate (165 s for MobileNetV2
      on a CPU), so its answers, with the latency table its search built, are
      frozen in `tests/golden_torch/precision_fake_{model}.json`, as the
      full-width fixtures freeze `run_qnet` (`--regen` below). The JAX
      search is also run live over the port's table, where it tunes
      nothing;
  (c) artifacts: each package's `check_pareto_artifact` accepts the
      other's and the committed `experiments/precision/` one;
  (d) `QATFinetuneAccuracy`: one fine-tune step at a mixed allocation from
      shared base params against the JAX step (jitted with XLA's algebraic
      simplifier off, ROADMAP F7), within the tolerances of
      `tests/test_torch_train_vision.py::test_train_step_updated_params`;
      its accuracy equals the JAX `eval_accuracy` on the same params.
      Whole trajectories are not compared: they diverge
      (`test_tiny_float_phase_is_chaotic`);
  (e) export: the fake search's headline mixed point exports through the
      port's route proof to a `.qnet` the JAX package serves bit for bit
      as the port does, and the committed JAX export
      `experiments/precision/mobilenet_v2_cpu_mix4of8_top2.qnet` serves
      bit-identically through every port route;
  (f) the CLI on `--device cpu`.

Regenerate the frozen JAX fake searches (~3 min each):

    PYTHONPATH=src python -m tests.test_torch_precision --regen
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cu as RCU
from repro.core import graph as RG
from repro.core import qnet as RQ
from repro.data.pipeline import image_batch as r_image_batch
from repro.energy import PowerModel as RPowerModel
from repro.energy import model as REM
from repro.models import layers as RL
from repro.train import optimizer as RO
from repro.train import vision as RV
from repro.tune import load_tuned as r_load_tuned
from repro.tune import precision as RP
from repro.tune.cache import TunedPlan as RTunedPlan
from repro_torch import convert
from repro_torch.core import cu
from repro_torch.core import graph as G
from repro_torch.core import qnet as Q
from repro_torch.energy import PowerModel
from repro_torch.energy import model as EM
from repro_torch.models import layers as PL
from repro_torch.serve.vision import VisionEngine, compile_stages
from repro_torch.train import train_loop as PTL
from repro_torch.train import tree as PT
from repro_torch.train import vision as PV
from repro_torch.tune import load_tuned
from repro_torch.tune import precision as P
from repro_torch.tune import __main__ as TUNE_CLI
from tests.test_torch_train_vision import NO_ALGSIMP, _np_params

ROOT = os.path.join(os.path.dirname(__file__), "..")
TUNED_DIR = os.path.join(ROOT, "experiments", "tuned")
PRECISION = os.path.join(ROOT, "experiments", "precision")
COMMITTED = os.path.join(PRECISION, "mobilenet_v2_cpu_pareto.json")
COMMITTED_QNET = os.path.join(PRECISION, "mobilenet_v2_cpu_mix4of8_top2.qnet")
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden_torch")
MODELS = ("mobilenet_v2", "efficientnet_compact")
# the JAX precision test's tiny config and search (tests/test_precision.py)
TINY = dict(input_hw=8, num_classes=4, bits=4, act_bits=4, float_steps=6,
            qat_steps=4, calibrate_every=0, ckpt_every=0, batch=8)
FAKE = dict(choices=(4, 6, 8), backend="cpu", ladder_budget=3, tune_batch=2)
# the committed artifact's build (its `build` record)
COMMITTED_BUILD = dict(model="mobilenet_v2", alpha=0.35, input_hw=32,
                       num_classes=10, bits=4, act_bits=4)
# the committed artifact's uniform points, which the JAX table reproduces
# from the committed caches
COMMITTED_US = {4: 561.1070155282505, 8: 600.1819965604227}
FLOATS = ("accuracy", "us_per_image", "fps", "j_per_image", "edp",
          "tuned_fraction")
WATTS = dict(busy_w=18.0, idle_w=4.0, source="test")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side on one intra-op thread, as the other port test files
    under several workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def golden_path(model: str) -> str:
    return os.path.join(GOLDEN_DIR, f"precision_fake_{model}.json")


def _spy_coverage(module, into: dict):
    """Wrap `module.ensure_coverage` so the table the search builds is kept
    in `into["table"]`; returns the original."""
    orig = module.ensure_coverage

    def spy(*a, **kw):
        into["table"] = orig(*a, **kw)
        return into["table"]

    module.ensure_coverage = spy
    return orig


def regen(model: str) -> None:
    """Run the JAX package's fake search on the tiny config; store its
    artifact and the latency table it built."""
    into: dict = {}
    orig = _spy_coverage(RP, into)
    try:
        res = RP.search_precision(
            RV.VisionTrainConfig(model=model, **TINY),
            accuracy_fn=RP.fake_accuracy, measure=RP.fake_measure, **FAKE)
    finally:
        RP.ensure_coverage = orig
    with open(golden_path(model), "w") as f:
        json.dump({"artifact": res.as_dict(),
                   "tuned": into["table"].tuned.to_json()}, f, indent=1,
                  sort_keys=True)
        f.write("\n")
    print(f"[precision] {model}: {len(res.points)} points -> "
          f"{golden_path(model)}")


def _as_json(d):
    return json.loads(json.dumps(d))


def assert_same_artifact(got: dict, want: dict):
    """Names, allocations, front and meta identical; floats to rtol 1e-12."""
    got, want = _as_json(got), _as_json(want)
    assert [p["name"] for p in got["points"]] == \
        [p["name"] for p in want["points"]]
    assert got["pareto"] == want["pareto"]
    assert got["meta"] == want["meta"]
    for k in ("schema", "model", "backend", "choices", "build",
              "tuned_batch"):
        assert got[k] == want[k], k
    for a, b in zip(got["points"], want["points"]):
        for k in b:
            if k in FLOATS:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-12,
                                           err_msg=f"{b['name']}.{k}")
            else:
                assert a[k] == b[k], f"{b['name']}.{k}"


# ---------------------------------------------------------------------------
# (a) the latency table on the committed caches
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def committed_tables():
    paths = sorted(glob.glob(os.path.join(TUNED_DIR,
                                          "mobilenet_v2_act*_cpu.json")))
    assert [os.path.basename(p) for p in paths] == [
        "mobilenet_v2_act4_cpu.json", "mobilenet_v2_act8_cpu.json"]
    tuned = load_tuned(paths[0]).merge(load_tuned(paths[1]))
    r_tuned = r_load_tuned(paths[0]).merge(r_load_tuned(paths[1]))
    net = PV.build_net(PV.VisionTrainConfig(**COMMITTED_BUILD))
    rnet = RV.build_net(RV.VisionTrainConfig(**COMMITTED_BUILD))
    return (P.LatencyTable(tuned, PowerModel(**WATTS), "cpu"), net,
            RP.LatencyTable(r_tuned, RPowerModel(**WATTS), "cpu"), rnet)


@pytest.mark.parametrize("width", [4, 6, 8])
def test_latency_table_on_committed_caches(committed_tables, width):
    table, net, rtable, rnet = committed_tables
    net, rnet = G.with_act_bits(net, width), RG.with_act_bits(rnet, width)
    cost, rcost = table.net_cost(net), rtable.net_cost(rnet)
    assert dataclasses.astuple(cost) == dataclasses.astuple(rcost)
    if width in COMMITTED_US:
        assert cost.us_per_image == COMMITTED_US[width]
        assert cost.tuned_fraction == 1.0 and not cost.missing
    else:  # no committed act6 key: every op priced analytically
        assert cost.n_tuned == 0 and len(cost.missing) == 30
    j = EM.estimate_energy(net, tuned=table.tuned, power=table.power,
                           backend="cpu").j_per_image
    rj = REM.estimate_energy(rnet, tuned=rtable.tuned, power=rtable.power,
                             backend="cpu").j_per_image
    np.testing.assert_allclose(j, rj, rtol=1e-12)


def test_savings_order_on_committed_caches(committed_tables):
    table, net, rtable, rnet = committed_tables
    got = P._block_savings(net, table, 4, 8)
    assert got == RP._block_savings(rnet, rtable, 4, 8)
    with open(COMMITTED) as f:
        order = json.load(f)["meta"]["savings_order"]
    assert [name for name, _ in got] == order


@pytest.mark.parametrize("n", [0, 1, 2, 5, 17, 20, 33])
def test_allocation_and_ladder_match_the_reference(n):
    for budget in (1, 3, 5, 8):
        assert P._ladder_schedule(n, budget) == RP._ladder_schedule(n,
                                                                    budget)
    net = PV.build_net(PV.VisionTrainConfig(**COMMITTED_BUILD))
    rnet = RV.build_net(RV.VisionTrainConfig(**COMMITTED_BUILD))
    bits = {b.name: (4, 6, 8)[i % 3] for i, b in enumerate(net.blocks)
            if i < n}
    assert P.block_allocation(net, bits) == RP.block_allocation(rnet, bits)
    with pytest.raises(KeyError, match="irb99"):
        P.block_allocation(net, {"irb99": 4})


# ---------------------------------------------------------------------------
# (b) the whole search under fakes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=MODELS)
def fake_case(request):
    """The port's fake search (and the table it built) and the JAX
    package's frozen one."""
    model = request.param
    into: dict = {}
    orig = _spy_coverage(P, into)
    try:
        res = P.search_precision(
            PV.VisionTrainConfig(model=model, **TINY),
            accuracy_fn=P.fake_accuracy, measure=P.fake_measure,
            device="cpu", **FAKE)
    finally:
        P.ensure_coverage = orig
    with open(golden_path(model)) as f:
        golden = json.load(f)
    return dict(model=model, result=res, tuned=into["table"].tuned,
                golden=golden)


def test_fake_search_matches_the_reference(fake_case):
    res = fake_case["result"]
    assert_same_artifact(res.as_dict(), fake_case["golden"]["artifact"])
    mixed = [p for p in res.points if p.uniform is None]
    assert mixed and {"uniform4", "uniform6", "uniform8"} <= {
        p.name for p in res.points}
    # per-block granularity: every block internally uniform
    net = Q.build_netspec({**res.build, "op_act_bits": mixed[-1].alloc})
    assert all(len({op.act_bits for op in b.ops}) == 1 for b in net.blocks)


def test_fake_search_builds_the_reference_table(fake_case):
    """The port's tuner (torch-op candidates, as the JAX CPU search's
    `include_pallas=False`) times the same keys with the same winners."""
    got = fake_case["tuned"].to_json()
    want = fake_case["golden"]["tuned"]
    assert got["tuned_batch"] == want["tuned_batch"] == 2
    assert got["entries"].keys() == want["entries"].keys()
    for key, w in want["entries"].items():
        g = got["entries"][key]
        assert (g["route"], g["params"], g["us"], g["n_candidates"]) == (
            w["route"], w["params"], w["us"], w["n_candidates"]), key
        assert not g["disqualified"] and not w["disqualified"], key


def test_reference_search_on_the_port_table(fake_case):
    """The JAX search over the port's table (it tunes nothing there) gives
    the port's artifact."""
    r_tuned = RTunedPlan.from_json(fake_case["tuned"].to_json())
    ref = RP.search_precision(
        RV.VisionTrainConfig(model=fake_case["model"], **TINY),
        tuned=r_tuned, accuracy_fn=RP.fake_accuracy, measure=None, **FAKE)
    assert_same_artifact(fake_case["result"].as_dict(), ref.as_dict())


def test_search_refuses_one_width_and_needs_a_card():
    cfg = PV.VisionTrainConfig(**TINY)
    with pytest.raises(ValueError, match="two width"):
        P.search_precision(cfg, choices=(4,), device="cpu")
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.search_precision(cfg, accuracy_fn=P.fake_accuracy,
                           measure=P.fake_measure)


# ---------------------------------------------------------------------------
# (c) artifacts and the schema gate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer,checker", [("port", "jax"), ("jax", "port"),
                                            ("committed", "port"),
                                            ("committed", "jax")])
def test_each_checker_accepts_the_others_artifact(fake_case, tmp_path,
                                                  writer, checker):
    path = str(tmp_path / "pareto.json")
    if writer == "port":
        P.write_pareto(fake_case["result"], path)
    elif writer == "jax":
        with open(path, "w") as f:
            json.dump(fake_case["golden"]["artifact"], f)
    else:
        path = COMMITTED
    check = (P if checker == "port" else RP).check_pareto_artifact
    doc = check(path, require_domination=writer == "committed")
    assert doc["schema"] == P.PARETO_SCHEMA == RP.PARETO_SCHEMA


@pytest.mark.parametrize("tamper", ["front", "field", "width", "schema"])
def test_schema_gate_catches_what_the_reference_does(tmp_path, tamper):
    with open(COMMITTED) as f:
        doc = json.load(f)
    if tamper == "front":
        doc["pareto"] = doc["pareto"][:1]
    elif tamper == "field":
        del doc["points"][0]["edp"]
    elif tamper == "width":
        doc["points"][0]["alloc"]["stem/conv"] = 5
    else:
        doc["schema"] = "precision-pareto-v0"
    path = str(tmp_path / "bad.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    errors = []
    for check in (P.check_pareto_artifact, RP.check_pareto_artifact):
        with pytest.raises(ValueError) as e:
            check(path)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_dominance_matches_the_reference():
    rng = np.random.default_rng(3)
    pts, rpts = [], []
    for i in range(24):
        kw = dict(name=f"p{i}", block_bits={}, alloc={},
                  uniform=None if i % 3 else 8,
                  accuracy=float(rng.choice([0.8, 0.85, 0.9])),
                  us_per_image=float(rng.choice([90.0, 100.0, 110.0])),
                  model_bytes=int(rng.choice([500, 600])),
                  j_per_image=float(rng.choice([1.0, 2.0])), edp=1.0,
                  tuned_fraction=1.0)
        pts.append(P.PrecisionPoint(**kw))
        rpts.append(RP.PrecisionPoint(**kw))
    assert [p.name for p in P.pareto_front(pts)] == \
        [p.name for p in RP.pareto_front(rpts)]
    assert P.find_domination(pts) == RP.find_domination(rpts)
    assert [[P.dominates(a, b) for b in pts] for a in pts] == \
        [[RP.dominates(a, b) for b in rpts] for a in rpts]


# ---------------------------------------------------------------------------
# (d) QATFinetuneAccuracy, one step
# ---------------------------------------------------------------------------


def _mixed_cfgs():
    """(port cfg, JAX cfg) at a 4/6/8 allocation cycling over the blocks."""
    pcfg = PV.VisionTrainConfig(**TINY)
    net = PV.build_net(pcfg)
    alloc = P.block_allocation(net, {b.name: (8, 4, 6)[i % 3]
                                     for i, b in enumerate(net.blocks)})
    kw = dict(TINY, op_act_bits=tuple(sorted(alloc.items())))
    return PV.VisionTrainConfig(**kw), RV.VisionTrainConfig(**kw)


def test_finetune_step_matches_the_reference():
    pcfg, rcfg = _mixed_cfgs()
    pnet, rnet = PV.build_net(pcfg), RV.build_net(rcfg)
    assert G.op_act_bits(pnet) == RG.op_act_bits(rnet)
    assert len(set(G.op_act_bits(pnet).values())) == 3
    base = PL.fuse_bn_params(convert.params_from_reference(
        _np_params(rnet, 7, bn=True), device="cpu"))
    params = convert.params_to_reference(base)

    impl = P.QATFinetuneAccuracy(pcfg, steps=1, device="cpu")
    impl._base = types.SimpleNamespace(params=base)  # shared base params
    pnew, acc = impl.finetune(pcfg, pnet)

    # the reference's fine-tune step (`QATFinetuneAccuracy.finetune`), and
    # the gradient it takes, from the same batch
    batch = RV.train_batch(rcfg, rcfg.total_steps)
    opt = RO.AdamWConfig(lr=rcfg.qat_lr, warmup_steps=1, total_steps=1,
                         weight_decay=rcfg.weight_decay)

    def ref(p, b):
        def loss_fn(p):
            logits, _ = RL.forward(p, b["images"], rnet, qat=True)
            lp = jax.nn.log_softmax(logits)
            return -jnp.take_along_axis(lp, b["labels"][:, None], 1).mean()
        step = RV.make_vision_train_step(rnet, opt, qat=True,
                                         grad_accum=rcfg.grad_accum)
        return jax.grad(loss_fn)(p), step(p, RO.init_state(p), b)[0]

    grads, new = jax.jit(ref).lower(params, batch).compile(
        compiler_options=NO_ALGSIMP)(params, batch)
    _, _, pgrads = PTL.value_and_grad(
        PV.vision_loss(pnet, qat=True), base,
        PV.train_batch(pcfg, pcfg.total_steps, "cpu"))
    flat_r, _ = jax.tree_util.tree_flatten_with_path(new)
    flat_p = PT.leaves(pnew)
    rg = {jax.tree_util.keystr(k): np.asarray(g) for k, g in
          jax.tree_util.tree_flatten_with_path(grads)[0]}
    pg = dict(zip(rg, (g.numpy() for g in PT.leaves(pgrads))))
    gmax = max(np.abs(g).max() for g in rg.values())
    assert len(flat_r) == len(flat_p) == len(rg)
    for (path, r), p in zip(flat_r, flat_p):
        key = jax.tree_util.keystr(path)
        d = np.abs(p.numpy() - np.asarray(r))
        assert d.max() <= 2 * rcfg.qat_lr * (1 + 1e-3), key
        sure = (np.abs(rg[key]) > 1e-3 * gmax) & (
            np.sign(rg[key]) == np.sign(pg[key]))
        assert d[sure].max(initial=0.0) <= 1e-5, key

    # the score: the reference's `eval_accuracy` on the same params, its
    # loop restated over one jitted forward (eager JAX compiles each
    # primitive: 40 s on a CPU)
    rnew = convert.params_to_reference(pnew)
    fwd = None
    correct = total = 0
    for i in range(impl.eval_batches):
        b = r_image_batch(impl.eval_seed, i, rcfg.batch, rcfg.input_hw,
                          rcfg.num_classes)
        if fwd is None:
            fwd = jax.jit(lambda p, x: RL.forward(p, x, rnet, qat=True)[0]
                          ).lower(rnew, b["images"]).compile(
                              compiler_options=NO_ALGSIMP)
        pred = np.asarray(jnp.argmax(fwd(rnew, b["images"]), axis=-1))
        correct += int((pred == b["labels"]).sum())
        total += int(b["labels"].size)
    assert acc == correct / total
    assert impl(pcfg, pnet) == acc and len(impl._memo) == 1  # memoized


# ---------------------------------------------------------------------------
# (e) export
# ---------------------------------------------------------------------------


def _images(hw: int, n: int = 4, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, hw, hw, 3)).astype(np.float32)


def _reference_logits(path: str, x: np.ndarray) -> np.ndarray:
    rq = RQ.load_qnet(path)
    return np.asarray(jax.jit(lambda t: RCU.run_qnet(rq, t))(jnp.asarray(x)))


def _headline(result):
    dom = P.find_domination(list(result.points))
    return dom[0] if dom else next(n for n in result.front
                                   if n.startswith("mix"))


def test_export_point_serves_as_the_reference(fake_case, tmp_path):
    cfg = PV.VisionTrainConfig(model=fake_case["model"], **TINY)
    point = fake_case["result"].point(_headline(fake_case["result"]))
    assert point.uniform is None
    path = str(tmp_path / "mixed.qnet")
    report = P.export_point(cfg, point, path, device="cpu",
                            accuracy_impl=P.QATFinetuneAccuracy(
                                cfg, steps=0, device="cpu"))
    assert report["routes"][-1] == "engine" and "prepared" in report["routes"]
    assert Q.read_qnet_meta(path)["build"]["op_act_bits"] == point.alloc
    qnet = Q.load_qnet(path)
    assert G.op_act_bits(qnet.spec) == point.alloc
    x = _images(TINY["input_hw"])
    want = _reference_logits(path, x)
    assert RG.op_act_bits(RQ.load_qnet(path).spec) == point.alloc
    np.testing.assert_array_equal(
        cu.run_qnet(cu.prepare_qnet(qnet, device="cpu"), x).numpy(), want)


def test_committed_export_serves_on_every_route():
    """The JAX package's committed mixed export (mix4of8_top2): the port's
    `run_qnet`, prepared net, stage executors and engine equal the JAX
    `run_qnet` bit for bit."""
    build = Q.read_qnet_meta(COMMITTED_QNET)["build"]
    x = _images(build["input_hw"])
    want = _reference_logits(COMMITTED_QNET, x)
    qnet = Q.load_qnet(COMMITTED_QNET)
    assert len(set(G.op_act_bits(qnet.spec).values())) == 2
    np.testing.assert_array_equal(
        cu.run_qnet(qnet, x, device="cpu").numpy(), want)
    pq = cu.prepare_qnet(qnet, device="cpu")
    np.testing.assert_array_equal(cu.run_qnet(pq, x).numpy(), want)
    y = torch.from_numpy(x)
    for st in compile_stages(pq, device="cpu"):
        y = st(y)
    np.testing.assert_array_equal(y.numpy(), want)
    eng = VisionEngine(pq, device="cpu", buckets=(len(x),))
    rids = [eng.submit(img) for img in x]
    res = eng.run()
    np.testing.assert_array_equal(np.stack([res[r].logits for r in rids]),
                                  want)


# ---------------------------------------------------------------------------
# (f) python -m repro_torch.tune
# ---------------------------------------------------------------------------


def test_cli_check_pareto_accepts_the_committed_artifact(capsys):
    TUNE_CLI.main(["--check-pareto", COMMITTED])
    assert f"[precision] OK {COMMITTED}" in capsys.readouterr().out


def test_cli_fake_search_writes_what_both_checkers_accept(tmp_path, capsys):
    out = str(tmp_path / "p.json")
    TUNE_CLI.main(["--precision", "--fake", "--device", "cpu", "--out", out])
    assert out in capsys.readouterr().out
    doc = P.check_pareto_artifact(out)
    assert RP.check_pareto_artifact(out) == doc
    assert doc["backend"] == "cpu" and doc["meta"]["ladder_budget"] == 5


def test_cli_fake_export_writes_a_qnet_the_reference_loads(tmp_path,
                                                          capsys):
    qpath = str(tmp_path / "p.qnet")
    TUNE_CLI.main(["--precision", "--fake", "--device", "cpu", "--out",
                   str(tmp_path / "p.json"), "--precision-export", qpath])
    text = capsys.readouterr().out
    assert f"-> {qpath} (routes: reference, prepared" in text
    rq = RQ.load_qnet(qpath)
    assert len(set(RG.op_act_bits(rq.spec).values())) > 1
    x = _images(8)
    np.testing.assert_array_equal(
        cu.run_qnet(cu.prepare_qnet(Q.load_qnet(qpath), device="cpu"),
                    x).numpy(), _reference_logits(qpath, x))


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--regen", nargs="?", const="all",
                    choices=("all",) + MODELS,
                    help="rewrite the frozen JAX fake searches")
    which = ap.parse_args().regen
    if which:
        for m in MODELS if which == "all" else (which,):
            regen(m)
