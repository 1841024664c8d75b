"""Observability, the energy model and power-capped multi-model serving
through the PyTorch port (`serve/vision/`, `serve/stream.py`), against the
JAX package on the CPU at the golden 32x32 size.

Each case runs once on each package, with identical inputs, identical fake
clocks, a fresh `Tracer` and `MetricsRegistry` each, and the same power
model, and requires equal answers: served logits bit for bit, result
statuses and latencies, shed/deferred request ids, `dispatch_log`,
`EngineStats` (every field but the port's `device`; `replicas` is 1 on
both), the whole Chrome trace document (names, phases, categories, tracks,
args and timestamps), the metrics snapshot and its Prometheus text. The
cases are those of `tests/test_obs_serving.py` (traced drains, lifecycle
coverage, obs-on exactness, retrace leaks, empty and all-expired drains,
the shared multi-model timeline) and of `tests/test_serve_vision.py`
(power cap, the shared fleet budget, the router's refusals), plus the
three stream observability cases of `tests/test_streaming.py` with
`StreamEngine.stats()`'s energy keys.

The JAX engines compile one stage chain per model for the module: its
`compile_stages` is wrapped so that a later engine over the same net reuses
the jitted stages (their counters reset). The port's engines are built
fresh for every case.
"""
from __future__ import annotations

import json
import math
import types

import jax  # noqa: F401  (the reference side)
import numpy as np
import pytest

import repro.energy as R_EN
import repro.obs as R_OBS
from repro.core import qnet as R_Q
from repro.serve import stream as R_ST
from repro.serve.vision import MultiModelEngine as R_MM
from repro.serve.vision import VisionEngine as R_VE
from repro.serve.vision import engine as R_ENGINE
import repro_torch.energy as P_EN
import repro_torch.obs as P_OBS
from repro_torch.core import qnet as P_Q
from repro_torch.serve import stream as P_ST
from repro_torch.serve.vision import MultiModelEngine as P_MM
from repro_torch.serve.vision import VisionEngine as P_VE
from tests.regen_golden import fixture_paths

HW = 32


class FakeClock:
    """Every read ticks by `step`; `advance` moves time by hand."""

    def __init__(self, t0: float = 0.0, step: float = 0.0):
        self.t = t0
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(scope="module")
def jax_stage_cache():
    """One jitted stage chain per JAX net for the module (see the module
    docstring): each later engine gets the same stages, counters reset."""
    real = R_ENGINE.compile_stages
    cache = {}

    def cached(qnet, plan=None, **kw):
        key = (id(qnet), tuple(sorted((k, repr(v)) for k, v in kw.items())))
        if key not in cache:
            cache[key] = (qnet, real(qnet, plan, **kw))
        stages = cache[key][1]
        for st in stages:
            st.invocations = st.retraces = 0
            st.allowed_batches = st.on_retrace = None
        return stages

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(R_ENGINE, "compile_stages", cached)
        yield


def _side(pkg):
    """Both packages' entry points under one set of names."""
    if pkg == "jax":
        return types.SimpleNamespace(
            name="jax", VE=R_VE, MM=R_MM, obs=R_OBS, en=R_EN, ST=R_ST,
            load=R_Q.load_qnet, kw={})
    return types.SimpleNamespace(
        name="torch", VE=P_VE, MM=P_MM, obs=P_OBS, en=P_EN, ST=P_ST,
        load=P_Q.load_qnet, kw={"device": "cpu"})


@pytest.fixture(scope="module")
def sides(jax_stage_cache):
    out = {}
    for pkg in ("jax", "torch"):
        side = _side(pkg)
        side.mnv2 = side.load(fixture_paths("mobilenet_v2", 8)[0])
        side.effnet = side.load(fixture_paths("efficientnet_compact", 8)[0])
        out[pkg] = side
    return out


def _images(n, seed=7):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, HW, HW, 3)).astype(np.float32)


def _power(side):
    return side.en.PowerModel(busy_w=18.0, idle_w=4.0, source="test")


def _fat_energy(side, j_per_image, idle_w=0.0):
    """A synthetic EnergyReport with an exact J/image (the governor cases
    need batch energies that dominate the budget)."""
    op = side.en.OpEnergy(name="fat", cu="body", kind="pw", key="", us=1.0,
                          source="analytic", macs=1, bytes_moved=1,
                          compute_j=j_per_image, memory_j=0.0)
    return side.en.EnergyReport(
        net="fake", backend="cpu",
        power=side.en.PowerModel(busy_w=max(10.0, idle_w + 1.0),
                                 idle_w=idle_w, source="test"),
        ops=(op,))


def _engine(side, qnet, clock, *, obs=True, name="m", tracer=None,
            reg=None, **kw):
    if obs:
        kw.update(tracer=tracer, metrics=reg)
    kw.setdefault("power_model", _power(side))
    return side.VE(qnet, clock=clock, name=name, **side.kw, **kw)


def _results(res):
    return {k: (r.status, None if r.logits is None else r.logits,
                r.latency_s) for k, r in res.items()}


def _stats(eng):
    d = eng.stats().as_dict()
    d.pop("device", None)
    assert d.pop("replicas") == 1
    return d


def _assert_same(a, b, where="value"):
    """Equal structures: numpy arrays bit for bit, floats exactly (NaN
    equals NaN), everything else by ==."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
        assert np.asarray(a).dtype == np.asarray(b).dtype, where
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), \
            f"{where}: keys {sorted(a)} != {sorted(b)}"
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b), where
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


def _both(sides, case):
    """Run `case(side)` on both packages; require equal observables."""
    got = {pkg: case(side) for pkg, side in sides.items()}
    _assert_same(got["jax"], got["torch"], "jax vs torch")
    return got["torch"]


def _obs_out(tracer, reg):
    return {"trace": tracer.to_chrome(), "snapshot": reg.snapshot(),
            "prometheus": reg.to_prometheus()}


# ---------------------------------------------------------------------------
# test_obs_serving.py: traced drains
# ---------------------------------------------------------------------------


def _traced_drain(side, n=4, **kw):
    clock = FakeClock(step=1e-3)
    tracer = side.obs.Tracer(clock, origin_s=0.0)
    reg = side.obs.MetricsRegistry()
    eng = _engine(side, side.mnv2, clock, buckets=(2,), tracer=tracer,
                  reg=reg, **kw)
    rids = [eng.submit(img) for img in _images(n)]
    res = eng.run()
    assert sorted(res) == rids
    return {"results": _results(res), "stats": _stats(eng),
            **_obs_out(tracer, reg)}


def test_traced_drain_equals_reference(sides):
    out = _both(sides, _traced_drain)
    doc = out["trace"]
    assert P_OBS.validate_chrome_trace(doc) == []
    events = doc["traceEvents"]

    def named(ph, name):
        return [ev for ev in events if ev["ph"] == ph and ev["name"] == name]

    assert {ev["id"] for ev in named("b", "request")} == set(out["results"])
    assert all(ev["args"]["status"] == "ok" for ev in named("e", "request"))
    assert len(named("b", "queue_wait")) == 4
    assert len(named("X", "form_batch")) == 2
    dispatches = [ev for ev in events if ev["ph"] == "X"
                  and ev["name"].startswith("dispatch:")]
    assert len(dispatches) == 2 * 4
    assert all(ev["tid"] >= P_OBS.trace.TID_STAGE0 for ev in dispatches)
    assert len(named("X", "drain")) == 1
    assert len(named("X", "harvest")) == 2
    summary = P_OBS.summarize_trace(doc)
    assert summary["requests"]["by_status"] == {"ok": 4}
    assert summary["queue_wait"]["n"] == 4
    snap = out["snapshot"]
    assert snap["counters"]['serve_requests_completed_total{model="m"}'] == 4
    assert snap["counters"]['serve_micro_batches_total{model="m"}'] == 2
    json.dumps(snap, allow_nan=False)


def test_traced_drain_deterministic_across_runs(sides):
    """Fresh fake clock + fresh tracer, same inputs: byte-identical
    exported traces on the port, equal to the reference's."""
    torch_side = sides["torch"]
    doc1 = _traced_drain(torch_side)["trace"]
    doc2 = _traced_drain(torch_side)["trace"]
    assert json.dumps(doc1, sort_keys=True) == json.dumps(doc2,
                                                          sort_keys=True)
    assert doc1 == _traced_drain(sides["jax"])["trace"]


@pytest.mark.parametrize("route", ["reference", "kernels"])
def test_obs_on_is_bit_exact(sides, route):
    """Obs on serves the logits obs off serves, on either route, and both
    equal the reference's."""
    kw = ({} if route == "reference"
          else dict(body_fast_path="on", op_kernels="on"))
    torch_side = sides["torch"]
    plain = _engine(torch_side, torch_side.mnv2, FakeClock(step=1e-3),
                    obs=False, buckets=(2,), **kw)
    rids = [plain.submit(img) for img in _images(4)]
    want = plain.run()
    got = _traced_drain(torch_side, **kw)["results"]
    ref = _traced_drain(sides["jax"])["results"]
    for rid in rids:
        np.testing.assert_array_equal(got[rid][1], want[rid].logits)
        np.testing.assert_array_equal(got[rid][1], ref[rid][1])


# ---------------------------------------------------------------------------
# retrace leaks, empty and all-expired drains
# ---------------------------------------------------------------------------


def _retrace_leak(side):
    clock = FakeClock(step=1e-3)
    tracer = side.obs.Tracer(clock, origin_s=0.0)
    reg = side.obs.MetricsRegistry()
    eng = _engine(side, side.mnv2, clock, buckets=(2,), tracer=tracer,
                  reg=reg)
    head = eng.stages[0]
    before = dict(eng.stats().stage_retraces)
    x3, x2 = _images(3), _images(2)
    if side.name == "torch":
        import torch
        x3, x2 = torch.from_numpy(x3), torch.from_numpy(x2)
    with pytest.warns(RuntimeWarning, match="retrace at non-bucketed"):
        head(x3)  # 3 is not a bucket
    after_leak = dict(eng.stats().stage_retraces)
    head(x2)  # a bucket: silent
    head(x3)  # a shape already seen: no second count
    return {"before": before, "after_leak": after_leak,
            "stats": _stats(eng), **_obs_out(tracer, reg)}


def test_retrace_leak_warns_and_counts(sides):
    out = _both(sides, _retrace_leak)
    cu = "head"
    assert out["before"] == {s: 0 for s in out["before"]}
    assert out["after_leak"][cu] == 1
    assert out["stats"]["stage_retraces"][cu] == 1
    key = f'serve_stage_retraces_total{{cu="{cu}",model="m"}}'
    assert out["snapshot"]["counters"][key] == 1
    assert [ev["name"] for ev in out["trace"]["traceEvents"]
            if ev["ph"] == "i"] == [f"retrace:{cu}"]


def _no_traffic(side):
    clock = FakeClock(step=1e-3)
    tracer = side.obs.Tracer(clock, origin_s=0.0)
    reg = side.obs.MetricsRegistry()
    eng = _engine(side, side.mnv2, clock, buckets=(2,), tracer=tracer,
                  reg=reg)
    assert eng.run() == {}
    return {"stats": _stats(eng), **_obs_out(tracer, reg)}


def test_stats_and_snapshot_defined_with_no_traffic(sides):
    out = _both(sides, _no_traffic)
    assert out["stats"]["n_ok"] == 0 and out["stats"]["pad_fraction"] == 0.0
    json.dumps(out["snapshot"], allow_nan=False)


def _all_expired(side):
    clock = FakeClock(t0=100.0, step=1e-3)
    tracer = side.obs.Tracer(clock, origin_s=100.0)
    reg = side.obs.MetricsRegistry()
    eng = _engine(side, side.mnv2, clock, buckets=(2,), tracer=tracer,
                  reg=reg)
    rid = eng.submit(_images(1)[0], deadline_s=1.0)  # long past
    return {"results": _results(eng.run()), "rid": rid,
            "stats": _stats(eng), **_obs_out(tracer, reg)}


def test_all_expired_drain_closes_spans_and_counts(sides):
    out = _both(sides, _all_expired)
    assert out["results"][out["rid"]][0] == "expired"
    assert out["stats"]["n_expired"] == 1
    snap = out["snapshot"]
    json.dumps(snap, allow_nan=False)
    assert snap["counters"]['serve_requests_expired_total{model="m"}'] == 1
    assert snap["histograms"][
        'serve_request_latency_seconds{model="m"}']["p50"] is None
    assert P_OBS.validate_chrome_trace(out["trace"]) == []
    assert P_OBS.summarize_trace(out["trace"])["requests"]["by_status"] == {
        "expired": 1}


# ---------------------------------------------------------------------------
# multi-model: one shared timeline, EDF, refusals
# ---------------------------------------------------------------------------


def _multimodel(side, *, deadlines=False, n=2):
    clock = FakeClock(step=1e-3)
    tracer = side.obs.Tracer(clock, origin_s=0.0)
    reg = side.obs.MetricsRegistry()
    mm = side.MM({
        "mnv2": _engine(side, side.mnv2, clock, buckets=(2,), name="mnv2",
                        tracer=tracer, reg=reg),
        "effnet": _engine(side, side.effnet, clock, buckets=(2,),
                          name="effnet", tracer=tracer, reg=reg),
    }, clock=clock)
    handles = []
    for i, img in enumerate(_images(n)):
        dl = {}
        if deadlines:  # effnet's requests are the tighter ones
            dl = {"mnv2": 10.0 + i, "effnet": 5.0 + i}
        handles.append(mm.submit("mnv2", img, deadline_s=dl.get("mnv2")))
        handles.append(mm.submit("effnet", img,
                                 deadline_s=dl.get("effnet")))
    res = mm.run()
    assert sorted(res) == sorted(handles)
    return {"results": _results(res), "dispatch_log": list(mm.dispatch_log),
            "stats": {m: _stats(e) for m, e in mm.engines.items()},
            **_obs_out(tracer, reg)}


@pytest.mark.parametrize("deadlines", [False, True],
                         ids=["no_deadlines", "edf"])
def test_multimodel_shared_tracer_one_timeline(sides, deadlines):
    out = _both(sides, lambda s: _multimodel(s, deadlines=deadlines, n=4))
    doc = out["trace"]
    assert P_OBS.validate_chrome_trace(doc) == []
    events = doc["traceEvents"]
    cats = {ev["cat"] for ev in events
            if ev.get("ph") == "b" and ev["name"] == "request"}
    assert cats == {"request:mnv2", "request:effnet"}
    assert P_OBS.summarize_trace(doc)["requests"]["completed"] == 8
    instants = [ev for ev in events
                if ev["ph"] == "i" and ev["name"] == "router_dispatch"]
    assert len(instants) == len(out["dispatch_log"]) == 4
    for m in ("mnv2", "effnet"):
        n = sum(1 for name, _ in out["dispatch_log"] if name == m)
        assert out["snapshot"]["counters"][
            f'router_dispatch_total{{model="{m}"}}'] == n
    if deadlines:  # the tighter model dispatches first in every round
        assert [m for m, _ in out["dispatch_log"]][:2] == ["effnet", "mnv2"]


def _multimodel_plain(side):
    """The router without obs: logits of both nets equal the reference's."""
    clock = FakeClock(step=1e-4)
    mm = side.MM({
        "a": _engine(side, side.mnv2, clock, obs=False, buckets=(2,),
                     name="a"),
        "b": _engine(side, side.effnet, clock, obs=False, buckets=(2,),
                     name="b")}, clock=clock)
    for i, img in enumerate(_images(3)):
        mm.submit("a" if i % 2 == 0 else "b", img)
        mm.submit("b", img)
    res = mm.run()
    return {"results": _results(res), "dispatch_log": list(mm.dispatch_log),
            "stats": {m: _stats(e) for m, e in mm.engines.items()}}


def test_multimodel_without_obs_equals_reference(sides):
    _both(sides, _multimodel_plain)


def _refusals(side):
    """Each refusal's exception type and message."""
    out = {}

    def caught(key, fn):
        with pytest.raises(ValueError) as e:  # AdmissionError is one too
            fn()
        out[key] = (type(e.value).__name__, str(e.value))

    c1, c2 = FakeClock(), FakeClock()
    e1 = _engine(side, side.mnv2, c1, obs=False, buckets=(2,))
    e2 = _engine(side, side.effnet, c2, obs=False, buckets=(2,))
    caught("mixed_clocks", lambda: side.MM({"a": e1, "b": e2}))
    busy = _engine(side, side.mnv2, c1, obs=False, buckets=(2,))
    busy.submit(_images(1)[0])
    caught("rebind_busy", lambda: side.MM({"a": busy}, clock=FakeClock()))
    mm = side.MM({"a": e1, "b": e2}, clock=c1)
    caught("unknown_model", lambda: mm.submit("c", _images(1)[0]))
    caught("no_engines", lambda: side.MM({}))
    owned = _engine(side, side.mnv2, c1, obs=False, buckets=(2,),
                    energy=_fat_energy(side, 1.0), power_budget_w=10.0)
    other = _engine(side, side.effnet, c1, obs=False, buckets=(2,),
                    energy=_fat_energy(side, 1.0))
    caught("double_governor",
           lambda: side.MM({"a": owned, "b": other}, power_budget_w=5.0))
    caught("budget_below_idle",
           lambda: _engine(side, side.mnv2, c1, obs=False, buckets=(2,),
                           energy=_fat_energy(side, 1.0, idle_w=5.0),
                           power_budget_w=4.0))
    return out


def test_router_and_budget_refusals_equal_reference(sides):
    out = _both(sides, _refusals)
    assert out["unknown_model"][0] == "AdmissionError"
    assert {k: v[0] for k, v in out.items() if k != "unknown_model"} == {
        k: "ValueError" for k in out if k != "unknown_model"}


# ---------------------------------------------------------------------------
# test_serve_vision.py: power-capped dispatch
# ---------------------------------------------------------------------------


def _obs_pair(side, clock, obs):
    if not obs:
        return None, None
    return side.obs.Tracer(clock, origin_s=0.0), side.obs.MetricsRegistry()


def _power_cap(side, obs):
    """1 J/image, 10 W over 1 s: at most 2 bucket-4 batches a window."""
    clock = FakeClock(step=1e-4)
    tracer, reg = _obs_pair(side, clock, obs)
    eng = _engine(side, side.mnv2, clock, obs=obs, tracer=tracer, reg=reg,
                  buckets=(4,), energy=_fat_energy(side, 1.0),
                  power_budget_w=10.0, power_window_s=1.0, shed_slo=0)
    slos = {eng.submit(img, slo=i % 2): i % 2
            for i, img in enumerate(_images(12))}
    results, watts, deferred = {}, [], []
    for _ in range(8):  # drain over advancing windows
        results.update(eng.run())
        deferred.append(sorted(r.rid for r in eng._queue))
        watts.append(eng._governor.watts(clock.t))
        assert watts[-1] <= 10.0 + 1e-9
        if not eng.pending():
            break
        clock.advance(0.5)
    assert not eng.pending()
    out = {"results": _results(results), "slos": slos, "watts": watts,
           "deferred": deferred, "stats": _stats(eng)}
    if obs:
        out.update(_obs_out(tracer, reg))
    return out


@pytest.mark.parametrize("obs", [False, True], ids=["obs_off", "obs_on"])
def test_power_cap_stays_under_budget_zero_high_slo_drops(sides, obs):
    out = _both(sides, lambda s: _power_cap(s, obs))
    res, slos = out["results"], out["slos"]
    shed = [r for r, v in res.items() if v[0] == "shed"]
    assert shed and all(slos[r] == 0 for r in shed)
    assert all(res[r][0] == "ok" for r, slo in slos.items() if slo == 1)
    assert out["stats"]["n_shed"] == len(shed)
    assert out["stats"]["n_deferred"] > 0
    assert all(v[1] is None for v in res.values() if v[0] != "ok")
    if obs:
        assert P_OBS.validate_chrome_trace(out["trace"]) == []
        assert any(ev["name"] == "power_cap"
                   for ev in out["trace"]["traceEvents"])


def _generous(side, obs):
    clock = FakeClock(step=1e-4)
    tracer, reg = _obs_pair(side, clock, obs)
    eng = _engine(side, side.mnv2, clock, obs=obs, tracer=tracer, reg=reg,
                  buckets=(4,), energy=_fat_energy(side, 1e-3),
                  power_budget_w=100.0)
    for img in _images(8):
        eng.submit(img, slo=0)
    out = {"results": _results(eng.run()), "stats": _stats(eng)}
    if obs:
        out.update(_obs_out(tracer, reg))
    return out


@pytest.mark.parametrize("obs", [False, True], ids=["obs_off", "obs_on"])
def test_power_cap_generous_budget_never_sheds(sides, obs):
    out = _both(sides, lambda s: _generous(s, obs))
    assert all(v[0] == "ok" for v in out["results"].values())
    assert out["stats"]["n_shed"] == out["stats"]["n_deferred"] == 0


def _deferred(side, obs):
    clock = FakeClock(step=1e-4)
    tracer, reg = _obs_pair(side, clock, obs)
    eng = _engine(side, side.mnv2, clock, obs=obs, tracer=tracer, reg=reg,
                  buckets=(2,), energy=_fat_energy(side, 1.0),
                  power_budget_w=6.0, power_window_s=1.0, shed_slo=-1)
    imgs = _images(6)
    now = clock.t
    r_live = eng.submit(imgs[0], slo=1, deadline_s=now + 100.0)
    r_tight = eng.submit(imgs[1], slo=1, deadline_s=now + 0.3)
    rest = [eng.submit(img, slo=1) for img in imgs[2:]]
    results = dict(eng.run())
    deferred = [sorted(r.rid for r in eng._queue)]
    for _ in range(6):
        if not eng.pending():
            break
        clock.advance(0.6)
        results.update(eng.run())
        deferred.append(sorted(r.rid for r in eng._queue))
    out = {"results": _results(results), "ids": [r_live, r_tight, *rest],
           "deferred": deferred, "stats": _stats(eng)}
    if obs:
        out.update(_obs_out(tracer, reg))
    return out


@pytest.mark.parametrize("obs", [False, True], ids=["obs_off", "obs_on"])
def test_power_cap_deferred_requests_keep_deadlines(sides, obs):
    out = _both(sides, lambda s: _deferred(s, obs))
    res = out["results"]
    r_live, r_tight, *rest = out["ids"]
    assert res[r_tight][0] == res[r_live][0] == "ok"
    assert set(res) == set(out["ids"])
    assert all(res[r][0] in ("ok", "expired") for r in rest)
    assert out["stats"]["n_shed"] == 0


def _fleet_budget(side, obs):
    clock = FakeClock(step=1e-4)
    tracer, reg = _obs_pair(side, clock, obs)
    engines = {
        "m": _engine(side, side.mnv2, clock, obs=obs, tracer=tracer,
                     reg=reg, buckets=(2,), energy=_fat_energy(side, 1.0),
                     name="m"),
        "e": _engine(side, side.effnet, clock, obs=obs, tracer=tracer,
                     reg=reg, buckets=(2,), energy=_fat_energy(side, 1.0),
                     name="e"),
    }
    router = side.MM(engines, power_budget_w=5.0)
    assert all(e._governor is router.governor for e in engines.values())
    handles = [router.submit("m" if i % 2 == 0 else "e", img, slo=1)
               for i, img in enumerate(_images(8))]
    def queued():
        return {m: sorted(r.rid for r in e._queue)
                for m, e in engines.items()}

    results, logs, watts = dict(router.run()), [list(router.dispatch_log)], []
    deferred = [queued()]
    for _ in range(8):
        if not any(e.pending() for e in engines.values()):
            break
        watts.append(router.governor.watts(clock.t))
        assert watts[-1] <= 5.0 + 1e-9
        clock.advance(1.0)
        results.update(router.run())
        logs.append(list(router.dispatch_log))
        deferred.append(queued())
    out = {"results": _results(results), "handles": handles,
           "dispatch_logs": logs, "watts": watts, "deferred": deferred,
           "total_j": router.governor.total_j,
           "stats": {m: _stats(e) for m, e in engines.items()}}
    if obs:
        out.update(_obs_out(tracer, reg))
    return out


@pytest.mark.parametrize("obs", [False, True], ids=["obs_off", "obs_on"])
def test_multi_model_shared_power_budget(sides, obs):
    out = _both(sides, lambda s: _fleet_budget(s, obs))
    assert all(out["results"][h][0] == "ok" for h in out["handles"])
    assert out["total_j"] > 0 and len(out["dispatch_logs"]) > 1


# ---------------------------------------------------------------------------
# test_streaming.py: stream observability and energy
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def kws():
    path = fixture_paths("dscnn_kws", 8)[0]
    return {"jax": R_Q.load_qnet(path), "torch": P_Q.load_qnet(path)}


def _stream_engine(side, qnet, hop, **kw):
    kw.setdefault("power_model", _power(side))
    return side.ST.StreamEngine(qnet, hop, **side.kw, **kw)


def _stream_counters(side, qnet):
    hop = 8
    t = [0.0]

    def clock():
        t[0] += 0.001
        return t[0]

    tracer = side.obs.Tracer(clock, origin_s=0.0)
    reg = side.obs.MetricsRegistry()
    eng = _stream_engine(side, qnet, hop, clock=clock, tracer=tracer,
                         metrics=reg, name="kws")
    frames = np.random.default_rng(0).uniform(-1, 1, (
        side.ST.frames_for_windows(3, qnet.spec.input_hw, hop),
        qnet.spec.input_ch)).astype(np.float32)
    sid = eng.open_session()
    logits = np.stack([r.logits for r in eng.push(sid, frames)])
    stats = eng.stats()
    active = reg.gauge("stream_sessions_active",
                       labels={"model": "kws"}).value
    eng.close_session(sid)
    return {"logits": logits, "stats": stats, "active": active,
            "energy_j": eng.energy_j_per_window(),
            **_obs_out(tracer, reg)}


def test_stream_obs_counters_and_trace(sides, kws):
    out = _both(sides, lambda s: _stream_counters(s, kws[s.name]))
    stats, counters = out["stats"], out["snapshot"]["counters"]
    plan = P_ST.plan_stream(kws["torch"], 8)
    assert out["active"] == 1.0
    assert out["snapshot"]["gauges"][
        'stream_sessions_active{model="kws"}'] == 0.0
    assert counters['stream_frames_computed_total{model="kws"}'] == (
        plan.frames_full + 2 * plan.frames_step) == stats[
        "frames_computed_total"]
    assert counters['stream_frames_reused_total{model="kws"}'] == 2 * (
        plan.frames_full - plan.frames_step)
    assert P_OBS.validate_chrome_trace(out["trace"]) == []
    names = {ev.get("name") for ev in out["trace"]["traceEvents"]}
    assert {"stream_prime", "stream_step"} <= names
    phases = [ev["ph"] for ev in out["trace"]["traceEvents"]
              if ev.get("name") == "stream_session:kws"]
    assert "b" in phases and "e" in phases
    # the energy keys: a measured step priced at busy watts
    assert stats["energy_j_per_window_step"] == out["energy_j"] > 0
    assert stats["watts"] > 4.0 and stats["fps_per_watt"] > 0


def _stream_batched(side, qnet):
    hop, window = 8, qnet.spec.input_hw
    t = [0.0]

    def clock():
        t[0] += 0.001
        return t[0]

    tracer = side.obs.Tracer(clock, origin_s=0.0)
    reg = side.obs.MetricsRegistry()
    eng = _stream_engine(side, qnet, hop, clock=clock, tracer=tracer,
                         metrics=reg, name="kws", batch_buckets=(4,))
    rng = np.random.default_rng(0)
    sids = [eng.open_session() for _ in range(3)]
    for sid in sids:
        eng.push(sid, rng.uniform(-1, 1, (window + hop, qnet.spec.input_ch)
                                  ).astype(np.float32), defer=True)
    res = eng.drain()
    stats = eng.stats()
    for sid in sids:
        eng.close_session(sid)
    return {"logits": {(r.sid, r.window): r.logits for r in res},
            "stats": stats, **_obs_out(tracer, reg)}


def test_batched_obs_histogram_spans_and_pads(sides, kws):
    out = _both(sides, lambda s: _stream_batched(s, kws[s.name]))
    hist = out["snapshot"]["histograms"]['stream_batch_size{model="kws"}']
    assert hist["count"] == 2 and hist["sum"] == 6.0
    assert out["snapshot"]["counters"][
        'stream_pad_rows_total{model="kws"}'] == 2.0
    stats = out["stats"]
    assert (stats["pad_rows"], stats["windows_batched"],
            stats["batched_calls"]) == (2.0, 6.0, 2.0)
    assert P_OBS.validate_chrome_trace(out["trace"]) == []
    names = {ev.get("name") for ev in out["trace"]["traceEvents"]}
    assert {"stream_prime_batched", "stream_step_batched"} <= names


def _stream_eviction(side, qnet):
    tracer = side.obs.Tracer(lambda: 1.0, origin_s=0.0)
    eng = _stream_engine(side, qnet, 8, max_sessions=1, tracer=tracer)
    eng.open_session("a")
    eng.open_session("b")  # evicts a
    return {"trace": tracer.to_chrome(), "stats": eng.stats()}


def test_eviction_closes_lifecycle_span(sides, kws):
    out = _both(sides, lambda s: _stream_eviction(s, kws[s.name]))
    ends = [ev for ev in out["trace"]["traceEvents"]
            if ev["ph"] == "e" and ev.get("name", "").startswith(
                "stream_session")]
    assert len(ends) == 1 and ends[0]["args"] == {"sid": "a",
                                                  "evicted": True}
    # before any step, the energy keys price the plan's MACs analytically
    assert out["stats"]["energy_j_per_window_step"] > 0
    assert out["stats"]["watts"] == 4.0
