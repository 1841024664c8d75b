"""The port's vision serving (stage compiler, pipelined executor,
`VisionEngine`) on the CPU against the JAX package's golden fixtures, with
the kernel routes on (their plain versions run here), plus the engine's
fake-clock EDF, expiry and padding cases of `tests/test_serve_vision.py`."""
import os

import numpy as np
import pytest
import torch

from repro_torch.core import cu, qnet as Q
from repro_torch.kernels import ops as K
from repro_torch.serve.vision import (
    AdmissionError,
    PipelinedExecutor,
    VisionEngine,
    compile_stages,
)
from tests.regen_golden import CASES, fixture_paths

GOLDEN_2D = [c for c in CASES if c[0] != "dscnn_kws"]
ROUTES = {"fused+kernels": dict(body_fast_path="on", op_kernels="on"),
          "reference": dict(body_fast_path="off", op_kernels="off")}


class FakeClock:
    """Deterministic injectable time source: every read ticks by `step`,
    plus manual `advance` for deadline scenarios."""

    def __init__(self, t0: float = 0.0, step: float = 0.0):
        self.t = t0
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _load(case):
    qnet_path, npz_path = fixture_paths(*case)
    fix = np.load(npz_path)
    stages = sorted(k for k in fix.files if k.startswith("stage"))
    return (Q.load_qnet(qnet_path), fix["input"], [fix[k] for k in stages],
            fix["logits"])


@pytest.fixture(scope="module", params=GOLDEN_2D,
                ids=lambda c: f"{c[0]}_act{c[1]}")
def golden(request):
    return _load(request.param)


@pytest.fixture(scope="module")
def mnv2():
    return _load(("mobilenet_v2", 8))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_stage_chain_matches_golden_per_stage(golden, route):
    qnet, x, acts, logits = golden
    stages = compile_stages(qnet, device="cpu", **ROUTES[route])
    assert [s.spec.cu for s in stages] == ["head", "body", "tail",
                                           "classifier"]
    y = torch.from_numpy(x)
    for i, st in enumerate(stages):
        y = st(y)
        if i < len(stages) - 1:
            np.testing.assert_array_equal(
                y.numpy(), acts[i].astype(np.int32), err_msg=st.spec.cu)
    np.testing.assert_array_equal(y.numpy(), logits)
    assert all(st.invocations == 1 for st in stages)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_engine_matches_golden(golden, route):
    qnet, x, _, logits = golden
    eng = VisionEngine(qnet, buckets=(x.shape[0],), device="cpu",
                       **ROUTES[route])
    rids = [eng.submit(img) for img in x]
    res = eng.run()
    np.testing.assert_array_equal(
        np.stack([res[r].logits for r in rids]), logits)
    assert eng.stats().stage_invocations == {
        "head": 1, "body": 1, "tail": 1, "classifier": 1}


def test_engine_from_artifact_routes_ops_through_kernels(mnv2, monkeypatch):
    """On the served route every Body block of MobileNetV2 takes the fused
    kernel and the Head/Tail/Classifier DW/PW/DENSE ops a per-op kernel:
    3 pointwise, 1 depthwise and 16 fused-IRB calls a micro-batch. (Here
    the wrappers run their plain versions, which launch nothing, so the
    calls are counted by spies.)"""
    _, x, _, logits = mnv2
    calls = {}

    def spy(fn):
        def wrapped(*args, **kwargs):
            calls[fn.__name__] = calls.get(fn.__name__, 0) + 1
            return fn(*args, **kwargs)
        return wrapped

    for name in ("pointwise_conv_q", "depthwise_conv_q", "fused_irb_q"):
        monkeypatch.setattr(K, name, spy(getattr(K, name)))
    eng = VisionEngine.from_artifact(
        fixture_paths("mobilenet_v2", 8)[0], buckets=(2,), device="cpu",
        body_fast_path="on", op_kernels="on")
    rids = [eng.submit(img) for img in x]
    res = eng.run()
    assert calls == {"pointwise_conv_q": 3, "depthwise_conv_q": 1,
                     "fused_irb_q": 16}
    assert K.launch_counts() == {"pointwise_conv_q": 0,
                                 "depthwise_conv_q": 0, "fused_irb_q": 0,
                                 "quant_matmul": 0, "decode_attention": 0}
    np.testing.assert_array_equal(
        np.stack([res[r].logits for r in rids]), logits)


def test_pipeline_executor_ordering_and_abandoned_drain(mnv2):
    qnet, x, _, _ = mnv2
    pq = cu.prepare_qnet(qnet, device="cpu")
    pipe = PipelinedExecutor(compile_stages(pq, device="cpu"))
    batches = [torch.from_numpy(np.roll(x, i, axis=0)) for i in range(3)]
    for _ in pipe.stream(enumerate(batches)):
        break  # abandon with batches still in flight
    assert not pipe.busy
    outs = pipe.run(batches)
    assert len(outs) == 3
    for b, y in zip(batches, outs):
        np.testing.assert_array_equal(y.numpy(), cu.run_qnet(pq, b).numpy())


def test_odd_tail_is_bucket_padded(mnv2):
    qnet, x, _, _ = mnv2
    eng = VisionEngine(qnet, buckets=(2, 4), device="cpu")
    imgs = np.concatenate([x] * 4)[:7]  # -> 4 + 4 (pad 1)
    rids = [eng.submit(img) for img in imgs]
    res = eng.run()
    st = eng.stats()
    assert (st.n_ok, st.micro_batches) == (7, 2)
    assert st.pad_fraction == pytest.approx(1 / 8)
    ref = cu.run_qnet(eng.pq, imgs).numpy()
    np.testing.assert_array_equal(np.stack([res[r].logits for r in rids]),
                                  ref)  # pad rows never leak


def test_admission_rejects_shape_dtype_and_full_queue(mnv2):
    qnet, x, _, _ = mnv2
    eng = VisionEngine(qnet, buckets=(2,), device="cpu", max_queue=2)
    eng.submit(x[0])
    with pytest.raises(AdmissionError, match="shape"):
        eng.submit(np.zeros((16, 16, 3), np.float32))
    with pytest.raises(AdmissionError, match="dtype"):
        eng.submit(np.zeros(x[0].shape, np.uint8))
    eng.submit(x[1])
    with pytest.raises(AdmissionError, match="queue full"):
        eng.submit(x[0])
    eng.run()
    assert eng.pending() == 0
    eng.submit(x[0])  # a drained queue admits again


def test_fake_clock_expiry_is_deterministic(mnv2):
    qnet, x, _, _ = mnv2
    clock = FakeClock(t0=100.0)
    eng = VisionEngine(qnet, buckets=(2,), device="cpu", clock=clock)
    dead = eng.submit(x[0], deadline_s=50.0)  # already past the fake now
    live = eng.submit(x[0], deadline_s=200.0)
    later = eng.submit(x[0], deadline_s=101.0)
    clock.advance(5.0)  # 105.0: 'later' expires before the drain
    res = eng.run()
    assert res[dead].status == res[later].status == "expired"
    assert res[dead].logits is None
    assert res[live].status == "ok"
    st = eng.stats()
    assert (st.n_ok, st.n_expired, st.micro_batches) == (1, 2, 1)


def test_fake_clock_edf_dispatch_order(mnv2):
    """Tighter deadlines land in earlier micro-batches: with a ticking
    clock, completion times follow deadline order batch by batch."""
    qnet, x, _, _ = mnv2
    clock = FakeClock(t0=0.0, step=1e-4)
    eng = VisionEngine(qnet, buckets=(2,), device="cpu", clock=clock)
    d = {eng.submit(x[0], deadline_s=dl, now=0.0): dl
         for dl in (300.0, 110.0, 150.0, 120.0)}
    res = eng.run()
    assert all(r.status == "ok" for r in res.values())
    lat = [res[r].latency_s for r in sorted(d, key=lambda r: d[r])]
    assert lat[0] == lat[1] < lat[2] == lat[3], lat


def test_fake_clock_padding_tail(mnv2):
    qnet, x, _, _ = mnv2
    clock = FakeClock(t0=0.0)
    eng = VisionEngine(qnet, buckets=(2, 4), device="cpu", clock=clock)
    for img in np.concatenate([x] * 3)[:5]:
        eng.submit(img)
    res = eng.run()
    st = eng.stats()
    assert (st.n_ok, st.micro_batches) == (5, 2)
    assert st.pad_fraction == pytest.approx(1 / 6)
    assert all(r.status == "ok" for r in res.values())


def test_all_expired_stats_nan_safe(mnv2):
    qnet, x, _, _ = mnv2
    eng = VisionEngine(qnet, buckets=(2,), device="cpu",
                       clock=FakeClock(t0=1000.0))
    for img in x:
        eng.submit(img, deadline_s=1.0)
    assert all(r.status == "expired" for r in eng.run().values())
    st = eng.stats()
    assert (st.n_ok, st.n_expired, st.micro_batches) == (0, 2, 0)
    assert np.isnan(st.latency_p50_s) and np.isnan(st.latency_p95_s)
    assert st.fps == 0.0 and st.pad_fraction == 0.0
    st.as_dict()


def test_mixed_precision_artifact_served_equals_reference():
    """Per-op activation widths (4 and 8 bits, changing between blocks):
    the served route with every kernel on equals the JAX `run_qnet`."""
    import jax.numpy as jnp

    from repro.core import cu as rcu, qnet as RQ

    path = os.path.join(os.path.dirname(__file__), "..", "experiments",
                        "precision", "mobilenet_v2_cpu_mix4of8_top2.qnet")
    x = np.random.default_rng(0).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(rcu.run_qnet(RQ.load_qnet(path), jnp.asarray(x)))
    eng = VisionEngine.from_artifact(path, buckets=(2,), device="cpu",
                                     body_fast_path="on", op_kernels="on")
    rids = [eng.submit(img) for img in x]
    res = eng.run()
    np.testing.assert_array_equal(np.stack([res[r].logits for r in rids]),
                                  want)


@pytest.mark.parametrize("case", GOLDEN_2D + [("efficientnet_compact_h128",
                                               8)],
                         ids=lambda c: f"{c[0]}_act{c[1]}")
def test_served_launches_match_the_routed_calls(case, monkeypatch):
    """`ops.served_launches(plan)`, worked out from the CU plan alone,
    equals the kernel calls one micro-batch makes on the served route (the
    wrappers run their plain versions here, so spies count the calls), on
    every 2-D golden and the full-size compact EfficientNet: 31 pointwise
    and 10 depthwise calls, no fusable block."""
    from repro_torch.core import compiler as CC

    if case[0] == "efficientnet_compact_h128":
        qnet_path = os.path.join(os.path.dirname(__file__), "golden_torch",
                                 "efficientnet_compact_h128_act8.qnet")
    else:
        qnet_path = fixture_paths(*case)[0]
    qnet = Q.load_qnet(qnet_path)
    calls = dict.fromkeys(K.launch_counts(), 0)

    def spy(fn):
        def wrapped(*args, **kwargs):
            calls[fn.__name__] += 1
            return fn(*args, **kwargs)
        return wrapped

    for name in ("pointwise_conv_q", "depthwise_conv_q", "fused_irb_q"):
        monkeypatch.setattr(K, name, spy(getattr(K, name)))
    eng = VisionEngine(qnet, buckets=(1,), device="cpu",
                       body_fast_path="on", op_kernels="on")
    hw = qnet.spec.input_hw
    eng.submit(np.zeros((hw, hw, 3), np.float32))
    eng.run()
    want = K.served_launches(CC.compile_net(qnet.spec))
    assert calls == want
    if case[0] == "efficientnet_compact_h128":
        assert (want["pointwise_conv_q"], want["depthwise_conv_q"],
                want["fused_irb_q"]) == (31, 10, 0)
