"""The port's observability layer (`repro_torch.obs`) against the JAX
package's (`repro.obs`): both packages' tracers and registries are driven
with the same call sequences under identical fake clocks, and their
exports must be equal — `to_chrome()` documents, `snapshot()` dicts,
`to_prometheus()` texts, `summarize_trace`/`render_report` output,
`validate_chrome_trace` findings, histogram quantiles and merges, the
errors raised, and the CLI's output."""
from __future__ import annotations

import json

import numpy as np
import pytest

import repro.obs as R
import repro.obs.__main__ as R_MAIN
import repro.obs.trace as R_TRACE
import repro_torch.obs as P
import repro_torch.obs.__main__ as P_MAIN
import repro_torch.obs.trace as P_TRACE

PKGS = {"jax": (R, R_TRACE), "torch": (P, P_TRACE)}
NAMES = ("request", "queue_wait", "form_batch", "dispatch:head", "drain",
         "harvest")


class FakeClock:
    def __init__(self, t0: float = 0.0, step: float = 0.0):
        self.t = t0
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def _script(seed: int, n: int = 120):
    """A random but valid sequence of tracer and registry calls."""
    rng = np.random.default_rng(seed)
    ops, open_ids, t = [], [], 0.0
    for i in range(n):
        t += float(rng.uniform(0, 2e-3))
        k = int(rng.integers(0, 9))
        name = NAMES[int(rng.integers(0, len(NAMES)))]
        cat = f"request:m{int(rng.integers(0, 2))}"
        if k == 0:
            ops.append(("complete", name, t, t + float(rng.uniform(0, 1e-3)),
                        {"cat": "stage", "tid": int(rng.integers(0, 14)),
                         "args": {"rows": int(rng.integers(1, 9))}}))
        elif k == 1:
            ops.append(("instant", name, t if rng.random() < 0.5 else None,
                        {"tid": 2, "args": {"i": i}}))
        elif k == 2:
            ops.append(("counter", f"queue_depth:{cat}",
                        {"pending": int(rng.integers(0, 64))}, t))
        elif k == 3 or (k == 4 and not open_ids):
            ops.append(("async_begin", "request", i, t,
                        {"cat": cat, "args": {"model": cat}}))
            open_ids.append((i, cat))
        elif k == 4:
            rid, c = open_ids.pop(int(rng.integers(0, len(open_ids))))
            ops.append(("async_end", "request", rid, t,
                        {"cat": c, "args": {"status": "ok"
                                            if rng.random() < 0.8
                                            else "expired"}}))
        elif k == 5:
            ops.append(("name_track", int(rng.integers(0, 12)),
                        f"track{int(rng.integers(0, 3))}"))
        elif k == 6:
            ops.append(("span", name))
        elif k == 7:
            ops.append(("metric", "counter", f"c{int(rng.integers(0, 3))}",
                        {"model": cat}, float(rng.integers(0, 5))))
            ops.append(("metric", "gauge", "g", {"model": cat},
                        float(rng.normal())))
        else:
            v = float(rng.lognormal(-6, 2))
            ops.append(("metric", "histogram", "h", {"model": cat}, v))
    return ops


def _drive(pkg: str, ops, step: float = 1e-4):
    obs, _ = PKGS[pkg]
    clock = FakeClock(step=step)
    tracer = obs.Tracer(clock, process_name="serve", origin_s=0.0)
    reg = obs.MetricsRegistry()
    for op in ops:
        kind = op[0]
        if kind == "complete":
            tracer.complete(op[1], op[2], op[3], **op[4])
        elif kind == "instant":
            tracer.instant(op[1], op[2], **op[3])
        elif kind == "counter":
            tracer.counter(op[1], op[2], op[3])
        elif kind == "async_begin":
            tracer.async_begin(op[1], op[2], op[3], **op[4])
        elif kind == "async_end":
            tracer.async_end(op[1], op[2], op[3], **op[4])
        elif kind == "name_track":
            tracer.name_track(op[1], op[2])
        elif kind == "span":
            with tracer.span(op[1], cat="tune", tid=3):
                clock()
        else:
            _, typ, name, labels, v = op
            inst = getattr(reg, typ)(name, f"help {name}", labels=labels)
            act = {"counter": "inc", "gauge": "set", "histogram": "observe"}
            getattr(inst, act[typ])(v)
    doc = tracer.to_chrome()
    summary = obs.summarize_trace(doc, top=5)
    snap = reg.snapshot()
    return {"doc": doc, "snapshot": snap, "prometheus": reg.to_prometheus(),
            "summary": summary,
            "report": obs.render_report(summary, snap, top=5),
            "validate": obs.validate_chrome_trace(doc),
            "json": json.dumps(doc, allow_nan=False),
            "n": len(tracer), "registry": len(reg)}


@pytest.mark.parametrize("seed", range(8))
def test_tracer_and_registry_exports_equal_reference(seed):
    ops = _script(seed)
    got, want = _drive("torch", ops), _drive("jax", ops)
    assert got == want
    assert got["n"] > 0 and got["registry"] > 0


def test_tracer_defaults_and_null_objects_equal_reference():
    for obs, _ in PKGS.values():
        assert not obs.NULL and not obs.NULL_REGISTRY
        assert obs.NULL.to_chrome() == {"traceEvents": []}
        assert obs.NULL_REGISTRY.counter("x").inc() is None
    assert [getattr(P_TRACE, t) for t in P_TRACE.__all__
            if t.startswith("TID_")] == [
        getattr(R_TRACE, t) for t in R_TRACE.__all__ if t.startswith("TID_")]
    assert P_TRACE.TID_STAGE0 == 10
    docs = [obs.Tracer(FakeClock(t0=5.0, step=0.5)).to_chrome()
            for obs, _ in PKGS.values()]
    assert docs[0] == docs[1]
    with pytest.raises(ValueError, match="cannot save the null tracer"):
        P.NULL.save("x.json")


def _bad_docs():
    ok = {"ph": "X", "name": "a", "pid": 0, "tid": 0, "ts": 0.0, "dur": 1.0}
    return [
        [],
        {"traceEvents": {}},
        {"traceEvents": [1]},
        {"traceEvents": [dict(ok, ph="Q")]},
        {"traceEvents": [dict(ok, name="")]},
        {"traceEvents": [dict(ok, pid="0")]},
        {"traceEvents": [dict(ok, ts="0")]},
        {"traceEvents": [dict(ok, dur=-1.0)]},
        {"traceEvents": [{"ph": "C", "name": "c", "pid": 0, "tid": 0,
                          "ts": 0.0}]},
        {"traceEvents": [{"ph": "b", "name": "r", "pid": 0, "tid": 1,
                          "ts": 0.0, "id": 1}]},
        {"traceEvents": [{"ph": "e", "name": "r", "cat": "request",
                          "pid": 0, "tid": 1, "ts": 0.0, "id": 1}]},
        {"traceEvents": [{"ph": "b", "name": "r", "cat": "request",
                          "pid": 0, "tid": 1, "ts": 0.0, "id": 1}] * 2},
        {"traceEvents": [ok, {"ph": "M", "name": "thread_name", "pid": 0,
                              "tid": 3, "args": {"name": "x"}}]},
    ]


@pytest.mark.parametrize("i", range(len(_bad_docs())))
def test_validate_findings_equal_reference(i):
    doc = _bad_docs()[i]
    assert P.validate_chrome_trace(doc) == R.validate_chrome_trace(doc)


def _errors(obs):
    """The message of each refusal of the metrics layer."""
    out = []
    reg = obs.MetricsRegistry()
    for fn in (lambda: reg.counter("c").inc(-1),
               lambda: (reg.counter("x"), reg.gauge("x")),
               lambda: (reg.histogram("h", buckets=(1, 2)),
                        reg.histogram("h", buckets=(1, 3))),
               lambda: obs.Histogram("h", ()),
               lambda: obs.Histogram("h", (2, 1)),
               lambda: obs.Histogram("h", (1, float("inf"))),
               lambda: obs.Histogram("a", (1,)).merge(
                   obs.Histogram("b", (2,)))):
        with pytest.raises(ValueError) as e:
            fn()
        out.append(str(e.value))
    return out


def test_metric_refusals_equal_reference():
    assert _errors(P) == _errors(R)


@pytest.mark.parametrize("seed", range(4))
def test_histogram_quantiles_and_merge_equal_reference(seed):
    rng = np.random.default_rng(seed)
    buckets = tuple(sorted(set(np.round(rng.uniform(0, 1, 6), 3).tolist())))
    parts = [rng.uniform(-0.2, 1.2, int(rng.integers(0, 40)))
             for _ in range(3)]

    def run(obs):
        hs = []
        for vals in parts:
            h = obs.Histogram("h", buckets)
            for v in vals:
                h.observe(float(v))
            hs.append(h)
        m = hs[0].merge(hs[1]).merge(hs[2])
        return ([m.counts, m.sum, m.count]
                + [m.quantile(q) for q in (0.0, 0.1, 0.5, 0.95, 0.99, 1.0)])

    assert run(P) == run(R)


def test_registry_save_and_cli_equal_reference(tmp_path, capsys):
    ops = _script(11)
    outs = {}
    for pkg, main in (("jax", R_MAIN), ("torch", P_MAIN)):
        obs, _ = PKGS[pkg]
        clock = FakeClock(step=1e-4)
        tracer = obs.Tracer(clock, origin_s=0.0)
        reg = obs.MetricsRegistry()
        for op in ops:
            if op[0] == "complete":
                tracer.complete(op[1], op[2], op[3], **op[4])
            elif op[0] == "metric":
                getattr(reg, op[1])(op[2], labels=op[3])
        d = tmp_path / pkg
        d.mkdir()
        tracer.save(str(d / "t.json"))
        reg.save(str(d / "m.json"))
        reg.save(str(d / "m.prom"))
        capsys.readouterr()
        rc = (main.main(["summarize", "--trace", str(d / "t.json"),
                         "--metrics", str(d / "m.json"), "--top", "3"]),
              main.main(["validate", "--trace", str(d / "t.json")]))
        out = capsys.readouterr()
        outs[pkg] = (rc, out.out.replace(str(d), "<dir>"),
                     (d / "t.json").read_text(), (d / "m.json").read_text(),
                     (d / "m.prom").read_text())
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][0] == (0, 0)
