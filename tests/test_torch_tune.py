"""The port's route autotuner and tuned serving (`repro_torch.tune`,
`prepare_qnet(tuned=, routes=)`, `compile_stages(tuned=)`,
`VisionEngine(tuned=)`) on the CPU, held against the JAX package:

  (a) every committed JAX CPU cache (`experiments/tuned/*_cpu*.json`,
      latency and EDP) resolves to the same routes on its golden net in
      both packages, and serves the golden logits and stage vectors bit
      for bit through the port's tuned `run_qnet`, stage executors and
      engine; the only difference is the Pallas tile params the port's
      kernels cannot take, dropped at attach time and listed here;
  (b) caches round-trip between the packages, and `merge` agrees;
  (c) the selection logic under a fake timer (`tests/test_autotune.py`'s
      cases);
  (d) both tuners pick the same route at every key under one fake timer
      (the golden KWS net and a small 2-D net with a fusable block: the
      JAX tuner jit-compiles every candidate, about 38 s on a golden
      MobileNetV2, so the 2-D case is the small net);
  (e) every eligible route forced on every op of random small NetSpecs
      equals the JAX `run_qnet` bit for bit.

On the CPU the kernel routes (K2, K3, K4) run their plain PyTorch
versions; the card tests (`tests/test_torch_cuda.py`) run the kernels.
"""
from __future__ import annotations

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cu as RCU
from repro.core import qnet as RQ
from repro.tune import load_tuned as r_load_tuned
from repro.tune import save_tuned as r_save_tuned
from repro.tune import tune_qnet as r_tune_qnet
from repro_torch import convert
from repro_torch.core import compiler as CC
from repro_torch.core import cu
from repro_torch.core import graph as G
from repro_torch.core import qnet as Q
from repro_torch.kernels import pointwise_conv as PW
from repro_torch.models import layers
from repro_torch.serve.vision import VisionEngine, compile_stages
from repro_torch.tune import (
    Candidate,
    RouteChoice,
    TunedPlan,
    load_tuned,
    op_candidates,
    op_key,
    save_tuned,
    tune_qnet,
)
from repro_torch.tune import __main__ as TUNE_CLI
from tests.regen_golden import build_net, fixture_paths
from tests.test_autotune import _tiny_net as r_tiny_net
from tests.test_prepared_fastpath import _mixed_act_bits, _rand_netspec

TUNED_DIR = os.path.join(os.path.dirname(__file__), "..", "experiments",
                         "tuned")
CACHES = sorted(os.path.basename(p) for p in glob.glob(
    os.path.join(TUNED_DIR, "*_cpu*.json"))
    if not os.path.basename(p).startswith("bench"))

# (route, param, value) of the JAX caches' Pallas params that the port's
# kernels do not take, with how many routed ops of each cache carry it:
# K2 is built for block_m 16/64/128, block_n 16/64, block_k 32/128, and K3
# has no row tile
DROPPED = {
    "dscnn_kws_act8_cpu.json": {("pallas_pw", "block_n", 128): 1},
    "dscnn_kws_act8_cpu_edp.json": {("pallas_pw", "block_k", 64): 1,
                                    ("pallas_pw", "block_m", 256): 1,
                                    ("pallas_pw", "block_n", 128): 1},
    "efficientnet_compact_act4_cpu.json": {},
    "efficientnet_compact_act4_cpu_edp.json": {
        ("pallas_pw", "block_n", 128): 1},
    "efficientnet_compact_act8_cpu.json": {},
    "efficientnet_compact_act8_cpu_edp.json": {},
    "mobilenet_v2_act4_cpu.json": {},
    "mobilenet_v2_act4_cpu_edp.json": {("pallas_pw", "block_k", 64): 2,
                                       ("pallas_pw", "block_m", 256): 2,
                                       ("pallas_pw", "block_n", 128): 3,
                                       ("pallas_dw", "block_h", 16): 1},
    "mobilenet_v2_act8_cpu.json": {("pallas_pw", "block_n", 128): 3,
                                   ("pallas_pw", "block_k", 64): 1,
                                   ("pallas_pw", "block_m", 256): 1,
                                   ("pallas_dw", "block_h", 16): 1},
    "mobilenet_v2_act8_cpu_edp.json": {("pallas_pw", "block_k", 64): 4,
                                       ("pallas_pw", "block_m", 256): 4,
                                       ("pallas_pw", "block_n", 128): 5},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side on one intra-op thread, as the other port test files
    under several workers: the default (every core, in each worker)
    oversubscribes the machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _case(name: str):
    model, rest = name.split("_act")
    return model, int(rest[0])


@pytest.fixture(scope="module", params=CACHES)
def cache_case(request):
    name = request.param
    model, bits = _case(name)
    qnet_path, npz_path = fixture_paths(model, bits)
    path = os.path.join(TUNED_DIR, name)
    return dict(name=name, qnet=Q.load_qnet(qnet_path),
                rq=RQ.load_qnet(qnet_path, build_net(model, bits)),
                fix=np.load(npz_path), tuned=load_tuned(path),
                r_tuned=r_load_tuned(path))


def test_every_committed_cache_has_its_drops_listed():
    assert len(CACHES) == 10 and set(CACHES) == set(DROPPED)


# ---------------------------------------------------------------------------
# (a) the committed JAX caches
# ---------------------------------------------------------------------------


def test_committed_cache_resolves_as_the_reference(cache_case):
    c = cache_case
    pq = cu.prepare_qnet(c["qnet"], device="cpu")
    routes, fused = c["tuned"].resolve(pq)
    r_routes, r_fused = c["r_tuned"].resolve(c["rq"])
    assert routes == r_routes and fused == r_fused
    assert c["tuned"].coverage(pq) == 1.0
    assert c["r_tuned"].coverage(c["rq"]) == 1.0
    got = cu.prepare_qnet(pq, device="cpu", tuned=c["tuned"]).routes
    want = RCU.prepare_qnet(c["rq"], tuned=c["r_tuned"]).routes
    assert got.keys() == want.keys()
    dropped = {}
    for name, (route, params) in want.items():
        assert got[name][0] == route, name
        for k, v in params.items():
            if got[name][1].get(k) != v:
                dropped[(route, k, v)] = dropped.get((route, k, v), 0) + 1
        assert set(got[name][1].items()) <= set(params.items()), name
    assert dropped == DROPPED[c["name"]]
    for route, k, v in dropped:
        assert route == "pallas_dw" or v not in {
            "block_m": PW.BLOCKS_M, "block_n": PW.BLOCKS_N,
            "block_k": PW.BLOCKS_K}[k]


def test_committed_cache_tuned_run_qnet_matches_golden(cache_case):
    c = cache_case
    pq = cu.prepare_qnet(c["qnet"], device="cpu", tuned=c["tuned"])
    assert pq.routes
    np.testing.assert_array_equal(cu.run_qnet(pq, c["fix"]["input"]).numpy(),
                                  c["fix"]["logits"])


def test_committed_cache_tuned_stages_match_golden(cache_case):
    c = cache_case
    fix = c["fix"]
    stages = compile_stages(c["qnet"], device="cpu", tuned=c["tuned"])
    assert all(st.pq.routes for st in stages)
    acts = [fix[k] for k in sorted(f for f in fix.files
                                   if f.startswith("stage"))]
    y = torch.from_numpy(fix["input"])
    for i, st in enumerate(stages):
        y = st(y)
        if i < len(stages) - 1:
            np.testing.assert_array_equal(y.numpy(), acts[i].astype(np.int32),
                                          err_msg=st.spec.cu)
    np.testing.assert_array_equal(y.numpy(), fix["logits"])


def test_committed_cache_tuned_engine_matches_golden(cache_case):
    c = cache_case
    x = c["fix"]["input"]
    eng = VisionEngine(c["qnet"], buckets=(x.shape[0],), device="cpu",
                       tuned=c["tuned"])
    rids = [eng.submit(img) for img in x]
    res = eng.run()
    np.testing.assert_array_equal(np.stack([res[r].logits for r in rids]),
                                  c["fix"]["logits"])
    assert eng.energy.tuned_fraction > 0.5  # SE ops are priced analytically


def test_cpu_cache_resolves_nothing_for_another_backend(cache_case):
    routes, fused = cache_case["tuned"].resolve(cache_case["qnet"],
                                                backend="cuda")
    assert routes == {} and fused == set()


# ---------------------------------------------------------------------------
# (b) round trip between the packages, merge
# ---------------------------------------------------------------------------


def _plan(backend="cpu", nets=("tiny",)):
    return TunedPlan(
        backend=backend, nets=nets, tuned_batch=4,
        entries={
            "dw:hw8:cin16:cout16:k3:s1:a4:cpu": RouteChoice.make(
                "dw_shifts", us=12.5, us_ref=600.0, n_candidates=5),
            "pw:hw8:cin8:cout16:k1:s1:a4:cpu": RouteChoice.make(
                "pallas_pw", {"block_m": 64, "block_n": 64, "block_k": 128},
                us=20.0, n_candidates=5, disqualified=("evil",)),
        },
        meta={"torch": torch.__version__})


def test_port_cache_loads_in_the_reference_and_back(tmp_path):
    plan = _plan()
    save_tuned(plan, str(tmp_path / "p.json"))
    r = r_load_tuned(str(tmp_path / "p.json"))
    assert r.to_json() == plan.to_json()
    r_save_tuned(r, str(tmp_path / "r.json"))
    back = load_tuned(str(tmp_path / "r.json"))
    assert back == plan
    assert (tmp_path / "p.json").read_text() == \
        (tmp_path / "r.json").read_text()


@pytest.mark.parametrize("name", ["mobilenet_v2_act8_cpu_edp.json",
                                  "bench_cpu.json"])
def test_reference_cache_round_trips_through_the_port(tmp_path, name):
    path = os.path.join(TUNED_DIR, name)
    save_tuned(load_tuned(path), str(tmp_path / "p.json"))
    assert r_load_tuned(str(tmp_path / "p.json")) == r_load_tuned(path)


def test_merge_agrees_with_the_reference():
    key = "dw:hw8:cin16:cout16:k3:s1:a4:cpu"
    a = TunedPlan("cpu", ("a",), 4,
                  {key: RouteChoice.make("int_ref", us=100.0)},
                  meta={"x": 1})
    b = _plan(nets=("b",))
    b = dataclasses.replace(b, entries={
        **b.entries, key: RouteChoice.make("dw_shifts", us=10.0)})
    bench = load_tuned(os.path.join(TUNED_DIR, "bench_cpu.json"))
    ra, rb, rbench = (r_load_tuned_json(p) for p in (a, b, bench))
    for x, y, rx, ry in ((a, b, ra, rb), (b, a, rb, ra),
                         (bench, a, rbench, ra)):
        assert x.merge(y).to_json() == rx.merge(ry).to_json()
    assert a.merge(b).entries[key].route == "dw_shifts"
    with pytest.raises(ValueError, match="backends"):
        a.merge(_plan(backend="cuda"))


def r_load_tuned_json(plan: TunedPlan):
    from repro.tune.cache import TunedPlan as RTunedPlan
    return RTunedPlan.from_json(plan.to_json())


# ---------------------------------------------------------------------------
# (c) selection under a fake timer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_qnet():
    return layers.make_calibrated_qnet(
        convert.netspec_from_reference(r_tiny_net()), device="cpu")


def _torch_ops(pop):
    """An op's candidates without the kernels (the JAX tuner's
    `include_pallas=False`)."""
    return [c for c in op_candidates(pop) if not c.route.startswith("pallas")]


def _fake_measure(times):
    """Deterministic timer: seconds per route name (default 1.0)."""

    def measure(fn, x, candidate=None):
        return times.get(candidate.route if candidate else None, 1.0)

    return measure


def _images(hw=16, n=2, seed=0):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, hw, hw, 3)).astype(np.float32)


def _stages_out(qnet, x, **kw):
    y = torch.from_numpy(x)
    for st in compile_stages(qnet, device="cpu", **kw):
        y = st(y)
    return y.numpy()


def test_selection_deterministic_under_fake_timer(tiny_qnet):
    times = {"int_ref": 5.0, "dw_shifts": 0.5, "int_f32": 0.25,
             "pallas_pw": 9.0, "pallas_dw": 9.0,
             "per_op": 1.0, "fused_irb": 2.0}
    plans = [tune_qnet(tiny_qnet, batch=2, measure=_fake_measure(times),
                       device="cpu") for _ in range(2)]
    assert plans[0] == plans[1]
    assert plans[0].backend == "cpu" and plans[0].meta["objective"] == \
        "latency"
    for key, choice in plans[0].entries.items():
        if key.startswith("dw:"):
            assert choice.route == "dw_shifts"
        elif key.startswith("irb:"):
            assert choice.route == "per_op"
        elif key.startswith(("pw:", "dense:", "conv:")):
            assert choice.route in ("int_f32", "int_ref")
        assert not choice.disqualified, key


def test_kernel_candidates_sweep_three_tiles_with_the_default(tiny_qnet):
    pq = cu.prepare_qnet(tiny_qnet, device="cpu")
    pop = pq.ops["b1/expand"]
    cands = op_candidates(pop, rows=2 * 8 * 8)
    tiles = [tuple(c.params[k] for k in ("block_m", "block_n", "block_k"))
             for c in cands if c.route == "pallas_pw"]
    assert len(tiles) == 3 and PW.plan(128, 8, 16).tile in tiles
    assert {t[0] for t in tiles} == set(PW.BLOCKS_M)
    assert [c.route for c in op_candidates(pq.ops["b1/dw"])] == [
        "int_ref", "dw_shifts", "pallas_dw"]
    assert [c.route for c in _torch_ops(pop)] == ["int_ref", "int_f32"]
    x = cu.quantize_input(torch.from_numpy(_images()), pq.input_scale,
                          cu.input_qparams(pq)[1])
    x = cu.run_qop(x, pq.ops["stem/conv"])
    want = cu.run_qop(x, pop)
    for c in cands:
        assert torch.equal(c.fn(x), want), c.label


def test_fused_irb_selected_when_fastest(tiny_qnet):
    plan = tune_qnet(tiny_qnet, batch=2, device="cpu",
                     measure=_fake_measure({"per_op": 5.0,
                                            "fused_irb": 0.5}))
    irb = {k: v for k, v in plan.entries.items() if k.startswith("irb:")}
    assert irb and all(v.route == "fused_irb" for v in irb.values())
    x = _images()
    stages = compile_stages(tiny_qnet, device="cpu", tuned=plan)
    assert all(st.fused_blocks == frozenset({"b1"}) for st in stages)
    np.testing.assert_array_equal(
        _stages_out(tiny_qnet, x, tuned=plan),
        cu.run_qnet(tiny_qnet, x, device="cpu").numpy())


def test_wrong_candidate_never_selected(tiny_qnet):
    def evil_candidates(pop):
        cands = op_candidates(pop)
        if cands:
            base = cands[0].fn
            cands.append(Candidate("evil", {}, lambda x, f=base: f(x) + 1))
        return cands

    plan = tune_qnet(tiny_qnet, batch=2, device="cpu",
                     measure=_fake_measure({"evil": 0.0}),
                     candidates_fn=evil_candidates)
    assert plan.entries
    for key, choice in plan.entries.items():
        assert choice.route != "evil", key
        if not key.startswith("irb:"):
            assert "evil" in choice.disqualified, key


def test_unrunnable_candidate_is_disqualified_and_logged(tiny_qnet, capsys):
    def broken_candidates(pop):
        cands = _torch_ops(pop)
        if cands:
            def boom(x):
                raise RuntimeError("kernel failed to build")
            cands.append(Candidate("pallas_pw", {"block_m": 16}, boom))
        return cands

    plan = tune_qnet(tiny_qnet, batch=2, device="cpu", verbose=True,
                     measure=_fake_measure({"pallas_pw": 0.0}),
                     candidates_fn=broken_candidates)
    for key, choice in plan.entries.items():
        if not key.startswith("irb:"):
            assert "pallas_pw[block_m=16]" in choice.disqualified, key
            assert choice.route != "pallas_pw"
    err = capsys.readouterr().err
    assert "pallas_pw[block_m=16] disqualified: raised RuntimeError: " \
           "kernel failed to build" in err


def test_empty_and_foreign_caches_resolve_nothing(tiny_qnet):
    x = _images(seed=1)
    want = cu.run_qnet(tiny_qnet, x, device="cpu").numpy()
    empty = TunedPlan("cpu", ("tiny",), 2, {})
    assert empty.resolve(tiny_qnet, backend="cpu") == ({}, set())
    np.testing.assert_array_equal(_stages_out(tiny_qnet, x, tuned=empty),
                                  want)
    plan = CC.compile_net(tiny_qnet.spec)
    _, _, op, in_hw = next(d for d in plan.op_descriptors()
                           if d[2].kind == G.DW)
    foreign = TunedPlan("cuda", ("tiny",), 2, {
        op_key(op, in_hw, "cuda"): RouteChoice.make("dw_shifts", us=1.0)})
    assert foreign.resolve(tiny_qnet, plan, backend="cpu") == ({}, set())
    pq = cu.prepare_qnet(tiny_qnet, device="cpu", tuned=foreign)
    assert pq.routes == {}
    assert foreign.coverage(pq) == 0.0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        foreign.resolve(tiny_qnet)  # a bare QNet defaults to CUDA


def test_resolve_with_defaults_fills_misses(tiny_qnet):
    """A partial cache never serves below the untuned routes: on the card
    (op kernels and the fused body on) uncovered DW/PW/DENSE ops take K3 /
    K2 and an uncovered fusable Body block K4 (the tiny net's `b1` is a
    Head block, so it stays per op); the covered op keeps its route; with
    the flags off nothing is filled."""
    plan = CC.compile_net(tiny_qnet.spec)
    descs = plan.op_descriptors()
    _, _, dw, dw_hw = next(d for d in descs if d[2].kind == G.DW)
    cache = TunedPlan("cuda", ("tiny",), 2, {
        op_key(dw, dw_hw, "cuda"): RouteChoice.make("dw_shifts", us=1.0)})
    routes, fused = cache.resolve_with_defaults(
        tiny_qnet, plan, backend="cuda", op_kernels=True,
        body_fast_path=True)
    assert routes[dw.name] == ("dw_shifts", {})
    for _, _, op, _ in descs:
        if op.kind in (G.PW, G.DENSE):
            assert routes[op.name] == ("pallas_pw", {})
    assert "stem/conv" not in routes and fused == set()
    assert cache.resolve_with_defaults(tiny_qnet, plan, backend="cuda") == (
        {dw.name: ("dw_shifts", {})}, set())


@pytest.mark.parametrize("model", ["mobilenet_v2", "efficientnet_compact"])
def test_foreign_cache_serves_the_untuned_routes(model):
    """A cache of another backend resolves to exactly the untuned stages'
    routes: K4 on every fusable Body block, K3 / K2 on the other DW and
    PW/DENSE ops and on every SE squeeze, the hsigmoid excite on its torch
    op; the launches `ops.served_launches(plan)` works out are these."""
    from repro_torch.kernels import ops as K

    q = Q.load_qnet(fixture_paths(model, 8)[0])
    plan = CC.compile_net(q.spec)
    foreign = load_tuned(os.path.join(TUNED_DIR, f"{model}_act8_cpu.json"))
    foreign = dataclasses.replace(foreign, backend="cuda", entries={
        k.replace(":cpu", ":cuda"): v for k, v in foreign.entries.items()})
    assert foreign.resolve(q, plan, backend="cpu") == ({}, set())
    kw = dict(device="cpu", body_fast_path="on", op_kernels="on")
    untuned = compile_stages(q, **kw)[0]
    tuned = compile_stages(q, tuned=foreign, **kw)[0]
    assert tuned.pq.routes == untuned.pq.routes
    assert tuned.fused_blocks == untuned.fused_blocks == frozenset(
        b.name for b in plan.blocks_for(CC.BODY) if K.fusable_irb(b))
    se = [b.se for b in q.spec.blocks if b.se is not None]
    assert bool(se) == (model == "efficientnet_compact")
    for s in se:
        assert untuned.pq.routes[s.squeeze.name] == ("pallas_pw", {})
        assert s.excite.name not in untuned.pq.routes
    assert K.served_launches(plan) == K.served_launches(
        plan, routes=tuned.pq.routes, fused=tuned.fused_blocks)


def test_tuned_refuses_fixed_point(tiny_qnet):
    plan = TunedPlan("cpu", ("tiny",), 2, {})
    with pytest.raises(ValueError, match="fixed_point"):
        compile_stages(tiny_qnet, device="cpu", tuned=plan, fixed_point=True)
    with pytest.raises(ValueError, match="fixed_point"):
        VisionEngine(tiny_qnet, device="cpu", tuned=plan, fixed_point=True)
    # the routes a prepared net carries are float-requant: fixed point
    # ignores them and stays the reference's
    x = _images()
    routed = cu.prepare_qnet(tiny_qnet, device="cpu", routes={
        "b1/dw": ("pallas_dw", {}), "b1/expand": ("int_ref", {})})
    np.testing.assert_array_equal(
        cu.run_qnet(routed, x, fixed_point=True).numpy(),
        cu.run_qnet(tiny_qnet, x, device="cpu", fixed_point=True).numpy())


def test_plan_carries_tuned_to_stage_compiler(tiny_qnet):
    tuned = tune_qnet(tiny_qnet, batch=2, device="cpu",
                      measure=_fake_measure({"dw_shifts": 0.1}))
    plan = CC.compile_net(tiny_qnet.spec, tuned=tuned)
    assert plan.tuned is tuned
    stages = compile_stages(tiny_qnet, plan, device="cpu")
    assert all(st.pq is stages[0].pq for st in stages)
    assert stages[0].pq.routes["b1/dw"] == ("dw_shifts", {})


def test_edp_flips_traffic_dominated_block_latency_does_not(tiny_qnet):
    from repro_torch.energy import PowerModel

    times = {"per_op": 1.0, "fused_irb": 1.1,
             "int_ref": 1.0, "int_f32": 0.5, "dw_shifts": 0.5}
    power = PowerModel(busy_w=1e-9, source="test")
    lat = tune_qnet(tiny_qnet, batch=2, device="cpu",
                    measure=_fake_measure(times))
    edp = tune_qnet(tiny_qnet, batch=2, device="cpu",
                    measure=_fake_measure(times), objective="edp",
                    power=power)

    def irb(p, want):
        return {v.route for k, v in p.entries.items()
                if k.startswith("irb:") == want}

    assert irb(lat, True) == {"per_op"} and irb(edp, True) == {"fused_irb"}
    assert {k: v.route for k, v in lat.entries.items()
            if not k.startswith("irb:")} == {
        k: v.route for k, v in edp.entries.items() if not k.startswith("irb:")}
    assert edp.meta["objective"] == "edp"
    assert edp.meta["power"]["busy_w"] == 1e-9
    assert next(v.us for k, v in edp.entries.items()
                if k.startswith("irb:")) == pytest.approx(1.1e6)
    x = _images()
    np.testing.assert_array_equal(
        _stages_out(tiny_qnet, x, tuned=edp),
        cu.run_qnet(tiny_qnet, x, device="cpu").numpy())


def test_unknown_objective_and_missing_card_raise(tiny_qnet):
    with pytest.raises(ValueError, match="objective"):
        tune_qnet(tiny_qnet, batch=2, measure=_fake_measure({}),
                  objective="joules", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tune_qnet(tiny_qnet, batch=2, measure=_fake_measure({}))


def test_end_to_end_check_refuses_a_drifting_plan(tiny_qnet, monkeypatch):
    """A route that drifts only inside `run_block` (a tuner bug the per-op
    gate cannot see) must make the tuner raise, never emit the plan."""
    real = cu.run_qop

    def drifting(x, pop, fixed_point=False, route=None):
        y = real(x, pop, fixed_point, route)
        return y + 1 if route is not None and route[0] == "dw_shifts" else y

    def candidates(pop):  # the per-op gate sees the undrifted routes
        return [Candidate(r, {}, lambda x, r=r: real(x, pop, route=(r, {})))
                for r in ("int_ref", "dw_shifts")
                if r in cu.OP_ROUTES[pop.spec.kind]]

    monkeypatch.setattr(cu, "run_qop", drifting)
    with pytest.raises(RuntimeError, match="drifted"):
        tune_qnet(tiny_qnet, batch=2, device="cpu",
                  measure=_fake_measure({"dw_shifts": 0.1}),
                  candidates_fn=candidates)


def test_validation_drops_what_the_port_cannot_run(tiny_qnet):
    """Attach time, never serve time: a JAX Pallas tile K2 is not built
    for is dropped (the route stays), K3's row tile is dropped, a route the
    op's kind cannot take, an unknown op and an `int_f32` route on an op
    past the 2^24 bound are dropped; serving the result is bit-exact."""
    pq = cu.prepare_qnet(tiny_qnet, device="cpu")
    inexact = dataclasses.replace(pq.ops["b1/project"], f32_exact=False)
    pq = dataclasses.replace(pq, ops={**pq.ops, "b1/project": inexact})
    routed = cu.prepare_qnet(pq, device="cpu", routes={
        "b1/expand": ("pallas_pw", {"block_m": 256, "block_n": 64,
                                    "block_k": 64}),
        "b1/dw": ("pallas_dw", {"block_h": 16}),
        "tail/pw": ("dw_shifts", {}),
        "b1/project": ("int_f32", {}),
        "nope": ("int_ref", {}),
        "classifier/fc": ("pallas_pw", {"block_m": 16, "block_n": 16,
                                        "block_k": 32}),
        "stem/conv": ("int_f32", {}),
    })
    assert routed.routes == {
        "b1/expand": ("pallas_pw", {"block_n": 64}),
        "b1/dw": ("pallas_dw", {}),
        "classifier/fc": ("pallas_pw", {"block_m": 16, "block_n": 16,
                                        "block_k": 32}),
        "stem/conv": ("int_f32", {}),
    }
    # the float32 stem route keeps its weights ready on the device
    assert routed.ops["stem/conv"].w_alt.dtype == torch.float32
    x = _images()
    np.testing.assert_array_equal(
        cu.run_qnet(routed, x).numpy(),
        cu.run_qnet(tiny_qnet, x, device="cpu").numpy())


# ---------------------------------------------------------------------------
# (d) both tuners agree under one fake timer
# ---------------------------------------------------------------------------

TIMES = {"int_ref": 5.0, "dw_shifts": 0.5, "int_f32": 0.25, "per_op": 1.0,
         "fused_irb": 0.5}


def _both_nets(tmp_path):
    """(name, port QNet, JAX QNet) of the golden KWS net and the small 2-D
    net (the port's own calibration, written by the port and read by the
    JAX loader, so both packages hold the same integers)."""
    qnet_path, _ = fixture_paths("dscnn_kws", 8)
    kws = ("dscnn_kws", Q.load_qnet(qnet_path),
           RQ.load_qnet(qnet_path, build_net("dscnn_kws", 8)))
    tiny = layers.make_calibrated_qnet(
        convert.netspec_from_reference(r_tiny_net()), device="cpu")
    path = str(tmp_path / "tiny.qnet")
    Q.save_qnet(tiny, path)
    return [kws, ("tiny", tiny, RQ.load_qnet(path, r_tiny_net()))]


def test_both_tuners_pick_the_same_routes(tmp_path):
    """JAX `tune_qnet(include_pallas=False)` and the port's tuner without
    kernel candidates, one fake timer that ranks by route name: the same
    keys, the same route at each, except block keys where the JAX fused
    kernel is disqualified (ROADMAP F4: its epilogue is not bit-exact with
    `cu.run_block`; the port's K4 is), listed here."""

    def measure(fn, x, candidate=None):
        return TIMES.get(candidate.route, 1.0)

    f4_keys = {}
    for name, pq, rq in _both_nets(tmp_path):
        ours = tune_qnet(pq, batch=2, measure=measure, device="cpu",
                         candidates_fn=_torch_ops)
        ref = r_tune_qnet(rq, batch=2, measure=measure, include_pallas=False,
                          verify_end_to_end=False)
        assert ours.entries.keys() == ref.entries.keys(), name
        f4_keys[name] = sorted(k for k, v in ref.entries.items()
                               if "fused_irb" in v.disqualified)
        for key, want in ref.entries.items():
            got = ours.entries[key]
            assert not got.disqualified, key
            if key in f4_keys[name]:
                assert key.startswith("irb:") and got.route == "fused_irb"
                continue
            assert (got.route, got.params) == (want.route, want.params), key
            assert got.n_candidates == want.n_candidates, key
        assert {v.route for v in ours.entries.values()} >= (
            {"dw_shifts", "int_f32"})
    # at these sizes the JAX fused kernel passes its gate (F4 shows at
    # alpha 1.0), so no key is excepted
    assert f4_keys == {"dscnn_kws": [], "tiny": []}


# ---------------------------------------------------------------------------
# (e) every eligible route forced on random small NetSpecs
# ---------------------------------------------------------------------------

FUZZ = [  # stem_ch, n_body, expand, kernel, stride, bits, body_ch, seed, act
    (8, 1, 2, 3, 2, 4, 8, 11, 0),
    (16, 2, 1, 5, 1, 8, 16, 12, 0b100110011001),
    (8, 2, 2, 5, 2, 8, 16, 13, 0b011000101101),
]
ROUTES = ("int_ref", "int_f32", "dw_shifts", "pallas_pw", "pallas_dw")


@pytest.mark.parametrize("case", FUZZ, ids=lambda c: f"seed{c[7]}")
def test_forced_routes_match_the_reference(case, tmp_path):
    stem_ch, n_body, expand, kernel, stride, bits, body_ch, seed, act = case
    rnet = _mixed_act_bits(_rand_netspec(stem_ch, n_body, expand, kernel,
                                         stride, bits, body_ch), act)
    qnet = layers.make_calibrated_qnet(convert.netspec_from_reference(rnet),
                                       bits=bits, seed=seed, device="cpu")
    path = str(tmp_path / "fuzz.qnet")
    Q.save_qnet(qnet, path)
    rq = RQ.load_qnet(path, rnet)
    x = np.random.default_rng(seed).uniform(-1, 1, (2, 16, 16, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda t: RCU.run_qnet(rq, t))(jnp.asarray(x)))
    pq = cu.prepare_qnet(qnet, device="cpu")
    forced = 0
    for route in ROUTES:
        routes = {name: (route, {}) for name, pop in pq.ops.items()
                  if route in cu.OP_ROUTES.get(pop.spec.kind, ())}
        routed = cu.prepare_qnet(pq, device="cpu", routes=routes)
        forced += len(routed.routes)
        np.testing.assert_array_equal(cu.run_qnet(routed, x).numpy(), want,
                                      err_msg=route)
    assert forced > 2 * len(pq.ops)


# ---------------------------------------------------------------------------
# python -m repro_torch.tune
# ---------------------------------------------------------------------------


def test_tune_cli_golden_writes_caches_both_packages_load(tmp_path, capsys):
    TUNE_CLI.main(["--golden", "--models", "dscnn_kws", "--device", "cpu",
                   "--repeats", "1", "--out-dir", str(tmp_path)])
    path = tmp_path / "dscnn_kws_act8_cpu.json"
    assert str(path) in capsys.readouterr().out
    plan = load_tuned(str(path))
    assert plan.backend == "cpu" and plan.tuned_batch == 2
    rq = RQ.load_qnet(fixture_paths("dscnn_kws", 8)[0],
                      build_net("dscnn_kws", 8))
    assert r_load_tuned(str(path)).coverage(rq) == 1.0


@pytest.mark.parametrize("argv", [["--precision"], ["--check-pareto", "x"],
                                  ["--golden"]])
def test_tune_cli_refuses_what_is_not_ported_or_not_there(argv, tmp_path):
    """No card and no `--device`: the tuner and the search raise; a Pareto
    artifact that is not there fails its check. (The mixed-precision
    search is ported: `tests/test_torch_precision.py` drives it.)"""
    if argv[0] == "--check-pareto":
        with pytest.raises(FileNotFoundError):
            TUNE_CLI.main(["--check-pareto", str(tmp_path / argv[1])])
        return
    if torch.cuda.is_available():
        pytest.skip("a card is there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TUNE_CLI.main(argv)
