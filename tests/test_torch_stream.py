"""Streaming 1-D serving through the PyTorch port (`serve/stream.py`),
against the JAX package on the same numpy-seeded inputs.

  * `plan_stream` equals the JAX planner field for field (KWS with and
    without residual blocks, HAR) at every hop of the window, and refuses
    what it refuses, with the same message;
  * `StreamEngine` windows equal the JAX `cu.run_qnet` over each full
    window bit for bit, in float-multiplier and fixed-point mode (the JAX
    side of fixed point runs inside a scoped `jax.enable_x64(True)`: without
    it the JAX requant wraps in int32, ROADMAP F1), and the frozen
    `stream_logits` of `tests/golden/dscnn_kws_act8.npz`;
  * batched `drain()` equals the serial path; `step_many`, LRU eviction,
    close/reopen, push validation, transactional push, the session-table
    byte counts and the `batched_traces` bound behave as in the reference;
  * the full-width KWS and HAR fixtures (`tests/torch_stream_cases.py`).

The deterministic cases of `tests/test_streaming.py`, with fixed seeds in
place of hypothesis. Regenerate the full-width fixtures with the JAX
package:

    PYTHONPATH=src python -m tests.test_torch_stream --regen
"""
from __future__ import annotations

import dataclasses
import os
import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_stream_cases as SC  # noqa: E402

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops here are small: torch's intra-op threads add only
    dispatch cost, and in a parallel test run they oversubscribe the cores
    (the full-width KWS drain took about 90 s under `-n 6`, against well
    under a second on one thread). The bits do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# fixture regeneration (JAX package, CPU)
# ---------------------------------------------------------------------------


def regen() -> None:
    """Build, calibrate and quantize each full-width 1-D net with the JAX
    package, freeze it, and store the reference's logits over every
    session's windows (one batched `cu.run_qnet` a mode)."""
    import jax
    import jax.numpy as jnp

    from repro.core import cu, qnet as Q
    from repro.models import dscnn1d
    from repro.models.layers import make_calibrated_qnet

    builders = {"dscnn_kws": dscnn1d.build_kws, "dscnn_har": dscnn1d.build_har}
    for case, c in SC.CASES.items():
        qnet_path, npz_path = SC.paths(case)
        build = dict(c["build"])
        net = builders[build.pop("model")](**build)
        qnet = make_calibrated_qnet(net, bits=8, seed=0)
        Q.save_qnet(qnet, qnet_path, build=c["build"],
                    provenance={"derivation": "make_calibrated_qnet",
                                "seed": 0, "n_cal": 2})
        qnet = Q.load_qnet(qnet_path)  # answers come from the frozen file
        x = jnp.asarray(SC.windows(case))
        arrays = {"logits_float": np.asarray(cu.run_qnet(qnet, x),
                                             np.float32)}
        if c["fixed"]:
            with jax.enable_x64(True):
                arrays["logits_fixed"] = np.asarray(
                    cu.run_qnet(qnet, x, fixed_point=True), np.float32)
        np.savez_compressed(npz_path, **arrays)
        size = (os.path.getsize(qnet_path) + os.path.getsize(npz_path)) / 1024
        print(f"[stream] {case}: {x.shape[0]} windows, {size:.0f} KiB -> "
              f"{c['name']}.*")


# ---------------------------------------------------------------------------
# nets: small calibrated 1-D nets from the JAX package, shared by module
# ---------------------------------------------------------------------------

# name -> how the JAX QNet is made: a frozen artifact, or ("kws", builder
# kwargs, calibration seed) for a small net calibrated here
NETS = {
    # k3, stem stride 2, 16 channels, act8 (the conformance golden)
    "kws_golden": os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "golden", "dscnn_kws_act8.qnet"),
    "kws_k5_s1_res_b4": ("kws", dict(input_t=32, input_ch=4, channels=8,
                                     n_blocks=2, num_classes=5, kernel=5,
                                     stem_stride=1, bits=4, residual=True),
                         7),
    "kws_full": SC.paths("kws")[0],
    "har_full": SC.paths("har")[0],  # three stride-2 DW k5 blocks
}


@pytest.fixture(scope="module")
def nets():
    """name -> (JAX QNet, the port's QNet holding the same parameters)."""
    from repro.core import qnet as RQ
    from repro.models import dscnn1d
    from repro.models.layers import make_calibrated_qnet
    from repro_torch.convert import qnet_from_reference

    out = {}
    for name, how in NETS.items():
        if isinstance(how, str):
            ref = RQ.load_qnet(how)
        else:
            _, kw, seed = how
            ref = make_calibrated_qnet(dscnn1d.build_kws(**kw), seed=seed)
        out[name] = (ref, qnet_from_reference(ref))
    return out


def _stream(rng, n_windows, window, hop, ch):
    return rng.uniform(-1, 1, (window + (n_windows - 1) * hop, ch)).astype(
        np.float32)


def _jax_windows(ref, frames, window, hop, fixed):
    """The JAX `cu.run_qnet` over every hop-aligned full window, one jitted
    batched call (rows are independent); fixed point under a scoped x64."""
    import jax
    import jax.numpy as jnp

    from repro.core import cu as rcu

    n = (len(frames) - window) // hop + 1
    x = jnp.asarray(np.stack([frames[i * hop:i * hop + window]
                              for i in range(n)]))
    with jax.enable_x64(fixed):
        return np.asarray(jax.jit(lambda v: rcu.run_qnet(
            ref, v, fixed_point=fixed))(x))


def _push_all(eng, sid, frames, rng=None, chunk=None):
    """Push `frames` into `sid` in chunks; return the stacked logits."""
    out, i = [], 0
    while i < len(frames):
        n = chunk or int(rng.integers(1, 9))
        out += eng.push(sid, frames[i:i + n])
        i += n
    return np.stack([r.logits for r in out])


# ---------------------------------------------------------------------------
# planner: field for field, refusals with the reference's messages
# ---------------------------------------------------------------------------


def _plan_or_error(module, qnet, hop):
    try:
        plan = module.plan_stream(qnet, hop)
    except module.StreamError as e:
        return "refused", str(e)
    return dataclasses.asdict(plan), plan.reuse_fraction


@pytest.mark.parametrize("name", list(NETS))
def test_plan_stream_matches_jax_at_every_hop(nets, name):
    from repro.serve import stream as RST
    from repro_torch.serve import stream as ST

    ref, own = nets[name]
    window = own.spec.input_hw
    planned = 0
    for hop in range(0, window + 2):
        got, want = _plan_or_error(ST, own, hop), _plan_or_error(
            RST, ref, hop)
        assert got == want, hop
        planned += got[0] != "refused"
    assert planned > 0


def test_plan_halo_is_cheaper_than_full_window(nets):
    from repro_torch.serve import stream as ST

    plan = ST.plan_stream(nets["kws_golden"][1], hop=4)
    assert 0 < plan.frames_step < plan.frames_full
    assert plan.reuse_fraction > 0.25
    assert plan.macs_step < plan.macs_full
    assert plan.bytes_step < plan.bytes_full
    assert plan.buffer_bytes > 0


@pytest.mark.parametrize("name", ["kws_golden", "kws_k5_s1_res_b4",
                                  "har_full"])
def test_plan_pointwise_passes_halo_through_unchanged(nets, name):
    """PW layers do not grow the recomputed region: that is what keeps the
    MAC-dominant layers O(hop + halo)."""
    from repro_torch.serve import stream as ST

    own = nets[name][1]
    hop = 16 if name == "har_full" else 4
    for bs in ST.plan_stream(own, hop).blocks:
        by_name = {os_.name: os_ for os_ in bs.ops}
        for os_ in bs.ops:
            dw = by_name.get(os_.name.replace("/pw", "/dw"))
            if os_.name.endswith("/pw") and dw is not None:
                assert (os_.lout, os_.rout) == (dw.lout, dw.rout)


def test_full_width_kws_plan_numbers():
    """The numbers the full-width workload is described by: 98 of 250 conv
    frames computed a window at hop 4, 18,090 ring-buffer bytes a session."""
    from repro_torch.core import qnet as Q
    from repro_torch.serve import stream as ST

    plan = ST.plan_stream(Q.load_qnet(SC.paths("kws")[0]), 4)
    assert (plan.frames_step, plan.frames_full) == (98, 250)
    assert plan.buffer_bytes == 18090
    assert plan.blocks[1].ops[0].merged is not None


def _stub(spec):
    """A duck-typed net for the planner: it reads the spec, the first op's
    input quantizer and each op's output quantizer only."""
    ops = {op.name: types.SimpleNamespace(in_scale=0.5, in_zp=0.0,
                                          out_scale=0.5, out_zp=0.0)
           for _, op in spec.all_ops()}
    return types.SimpleNamespace(
        spec=spec, ops=ops, res_q={b.name: (0.5, 0.0) for b in spec.blocks})


def _refusal_specs(G):
    def op(name, kind, k=1, s=1, act=G.RELU6, cin=4, cout=4):
        return G.OpSpec(name, kind, cin, cout, k, s, act, 8, 8)

    stem = G.BlockSpec("stem", (op("stem/conv", G.CONV1D, 3, 1),))
    tail = G.BlockSpec("tail", (op("tail/pw", G.PW),), avgpool=True)
    fc = G.BlockSpec("fc", (op("fc", G.DENSE, act=G.NONE),))

    def net(*blocks):
        return G.NetSpec("stub", tuple(blocks), 16, 4, 4)

    return {
        "dense_before_pool": net(stem, fc, tail),
        "no_pool": net(stem, G.BlockSpec("ds", (op("ds/pw", G.PW),)), fc),
        "residual_stride": net(stem, G.BlockSpec(
            "res", (op("res/dw", G.DW1D, 3, 2), op("res/pw", G.PW)),
            residual=True), tail, fc),
        "hsigmoid": net(stem, G.BlockSpec(
            "hs", (op("hs/pw", G.PW, act=G.HSIGMOID),)), tail, fc),
        "se": net(stem, G.BlockSpec(
            "se_blk", (op("se_blk/dw", G.DW1D, 3),),
            se=G.SESpec(4, 2, 8, "se_blk/se"), se_after="se_blk/dw"),
            tail, fc),
        "dw2d_before_pool": net(stem, G.BlockSpec(
            "dw", (op("dw/dw1d", G.DW1D, 3), op("dw/dw", G.DW, 3))),
            tail, fc),
    }


@pytest.mark.parametrize("case", ["dense_before_pool", "no_pool",
                                  "residual_stride", "hsigmoid", "se",
                                  "dw2d_before_pool"])
def test_plan_refusals_match_jax_on_handmade_nets(case):
    from repro.core import graph as RG
    from repro.serve import stream as RST
    from repro_torch.core import graph as G
    from repro_torch.serve import stream as ST

    got = _plan_or_error(ST, _stub(_refusal_specs(G)[case]), 4)
    want = _plan_or_error(RST, _stub(_refusal_specs(RG)[case]), 4)
    assert got[0] == "refused" and got == want


@pytest.mark.parametrize("model,hop", [("mobilenet_v2", 4),
                                       ("efficientnet_compact", 4)])
def test_plan_refuses_2d_and_se_nets_like_jax(model, hop):
    from repro.core import qnet as RQ
    from repro.serve import stream as RST
    from repro_torch.core import qnet as Q
    from repro_torch.serve import stream as ST
    from tests.regen_golden import fixture_paths

    path = fixture_paths(model, 8)[0]
    got = _plan_or_error(ST, Q.load_qnet(path), hop)
    assert got[0] == "refused" and "1-D" in got[1]
    assert got == _plan_or_error(RST, RQ.load_qnet(path), hop)


# ---------------------------------------------------------------------------
# windows: bit for bit against the JAX run_qnet over full windows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fixed", [False, True], ids=["float", "fixed"])
@pytest.mark.parametrize("name,hop,seed", [
    ("kws_golden", 4, 0), ("kws_golden", 16, 1), ("kws_k5_s1_res_b4", 8, 2),
    ("kws_k5_s1_res_b4", 1, 3), ("kws_full", 4, 4), ("har_full", 16, 5),
    ("har_full", 40, 6)])
def test_stream_engine_matches_jax_windows(nets, name, hop, seed, fixed):
    """A random chunking of a seeded stream; every window's logits, primed
    or stepped, equal the JAX package's `run_qnet` on that window."""
    from repro_torch.serve import stream as ST

    ref, own = nets[name]
    window, ch = own.spec.input_hw, own.spec.input_ch
    rng = np.random.default_rng(seed)
    frames = _stream(rng, 5, window, hop, ch)
    eng = ST.StreamEngine(own, hop, fixed_point=fixed, device=CPU)
    got = _push_all(eng, eng.open_session(), frames, rng=rng)
    want = _jax_windows(ref, frames, window, hop, fixed)
    assert got.shape == (5, own.spec.num_classes)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, ST.reference_windows(own, frames, window, hop,
                                  fixed_point=fixed, device=CPU))


def test_stream_engine_matches_frozen_stream_logits():
    """`tests/golden/dscnn_kws_act8.npz`: the frozen per-window logits of
    the JAX full-window route, hop = window / 8."""
    from repro_torch.core import qnet as Q
    from repro_torch.serve import stream as ST
    from tests.regen_golden import STREAM_HOP, fixture_paths

    qnet_path, npz_path = fixture_paths("dscnn_kws", 8)
    fix = np.load(npz_path)
    eng = ST.StreamEngine(Q.load_qnet(qnet_path), STREAM_HOP, device=CPU)
    got = _push_all(eng, eng.open_session(), fix["stream_frames"], chunk=5)
    np.testing.assert_array_equal(got, fix["stream_logits"])


@pytest.mark.parametrize("case", ["kws", "har"])
def test_full_width_fixture_drain(case):
    """The full-width workload as `chip_smoke.py`'s `[stream]` drives it:
    every session staged with `push(defer=True)`, advanced by `drain()`
    through the bucketed batches, in each mode the fixture holds; 0 logits
    differ from the JAX package's."""
    from repro_torch.core import qnet as Q
    from repro_torch.serve import stream as ST

    c = SC.CASES[case]
    qnet_path, npz_path = SC.paths(case)
    fix = np.load(npz_path)
    qnet = Q.load_qnet(qnet_path)
    frames = SC.frames(case)
    modes = [False, True] if c["fixed"] else [False]
    for fixed in modes:
        eng = ST.StreamEngine(qnet, c["hop"], fixed_point=fixed, device=CPU,
                              max_sessions=c["sessions"],
                              batch_buckets=SC.BUCKETS)
        sids = [eng.open_session() for _ in range(c["sessions"])]
        for sid, fr in zip(sids, frames):
            assert eng.push(sid, fr, defer=True) == []
        by = {(r.sid, r.window): r.logits for r in eng.drain()}
        got = np.stack([by[(sid, w)] for sid in sids
                        for w in range(c["windows"])])
        want = fix["logits_fixed" if fixed else "logits_float"]
        assert int(np.sum(got != want)) == 0
        st = eng.stats()
        assert st["windows"] == c["sessions"] * c["windows"]
        assert st["batched_traces"] <= 2 * len(eng.batch_buckets)


# ---------------------------------------------------------------------------
# batched stepping: drain / step_many
# ---------------------------------------------------------------------------


def _per_session(results):
    by = {}
    for r in results:
        by.setdefault(r.sid, []).append(r)
    for rs in by.values():
        assert [r.window for r in rs] == list(range(rs[0].window,
                                                    rs[0].window + len(rs)))
    return by


@pytest.fixture(scope="module")
def kws(nets):
    return nets["kws_golden"][1]


def _ref(qnet, frames, hop, fixed=False):
    from repro_torch.serve import stream as ST

    return ST.reference_windows(qnet, frames, qnet.spec.input_hw, hop,
                                fixed_point=fixed, device=CPU)


@pytest.mark.parametrize("fixed", [False, True], ids=["float", "fixed"])
@pytest.mark.parametrize("n,seed", [(3, 0), (5, 1), (8, 2), (9, 3)])
def test_batched_drain_matches_serial_and_reference(kws, n, seed, fixed):
    """n sessions through bucketed batched prime/step calls equal, per
    session, the serial single-session path and the full windows. n sweeps
    padding (3, 5), an exact bucket (8) and a max chunk + straggler (9)."""
    from repro_torch.serve import stream as ST

    hop, window = 8, kws.spec.input_hw
    rng = np.random.default_rng(seed)
    streams = [_stream(rng, 4, window, hop, kws.spec.input_ch)
               for _ in range(n)]
    serial = ST.StreamEngine(kws, hop, max_sessions=n, device=CPU,
                             fixed_point=fixed)
    got_serial = [np.stack([r.logits for r in serial.push(
        serial.open_session(), s)]) for s in streams]
    batched = ST.StreamEngine(kws, hop, max_sessions=n, device=CPU,
                              fixed_point=fixed)
    sids = [batched.open_session() for _ in range(n)]
    for sid, s in zip(sids, streams):
        assert batched.push(sid, s, defer=True) == []
    by = _per_session(batched.drain())
    assert batched.stats()["windows_batched"] > 0
    for i, sid in enumerate(sids):
        got = np.stack([r.logits for r in by[sid]])
        np.testing.assert_array_equal(got, _ref(kws, streams[i], hop, fixed))
        np.testing.assert_array_equal(got, got_serial[i])


def test_full_reduce_pool_fallback_keeps_the_bits(kws, monkeypatch):
    """Past T * qmax >= 2^24 the step takes the full f32 reduce instead of
    the incremental channel sum; on a net inside the bound both give the
    same windows (forced here: no real window is that long)."""
    from repro_torch.serve import stream as ST

    hop = 4
    frames = _stream(np.random.default_rng(13), 5, kws.spec.input_hw, hop,
                     kws.spec.input_ch)
    fs, inc = ST._pool_stream(ST.plan_stream(kws, hop))
    assert inc and fs.tout * 255 < 2 ** 24
    monkeypatch.setattr(ST, "_pool_stream", lambda plan: (fs, False))
    eng = ST.StreamEngine(kws, hop, device=CPU)
    got = _push_all(eng, eng.open_session(), frames, chunk=7)
    assert "pool_sum" not in eng._sessions["s0"].buffers
    np.testing.assert_array_equal(got, _ref(kws, frames, hop))


def test_interleaved_sessions_stay_isolated(kws):
    from repro_torch.serve import stream as ST

    hop, window = 8, kws.spec.input_hw
    rng = np.random.default_rng(11)
    streams = {t: _stream(rng, 4, window, hop, kws.spec.input_ch)
               for t in ("a", "b")}
    eng = ST.StreamEngine(kws, hop, device=CPU)
    got = {t: [] for t in streams}
    pos = {t: 0 for t in streams}
    while any(pos[t] < len(streams[t]) for t in streams):
        t = str(rng.choice(list(streams)))
        if pos[t] >= len(streams[t]):
            continue
        n = int(rng.integers(1, 7))
        got[t] += eng.push(eng.open_session(t), streams[t][pos[t]:pos[t] + n])
        pos[t] += n
    for t, frames in streams.items():
        np.testing.assert_array_equal(
            np.stack([r.logits for r in got[t]]), _ref(kws, frames, hop))


def test_window_results_are_ordered_and_flagged(kws):
    from repro_torch.serve import stream as ST

    hop = 8
    frames = _stream(np.random.default_rng(0), 3, kws.spec.input_hw, hop,
                     kws.spec.input_ch)
    eng = ST.StreamEngine(kws, hop, device=CPU)
    results = eng.push(eng.open_session(), frames)
    assert [r.window for r in results] == [0, 1, 2]
    assert [r.streamed for r in results] == [False, True, True]


def test_drain_mixed_phase_groups(kws):
    """One drain round holds a prime group and a step group; a just-primed
    session steps in the next round."""
    from repro_torch.serve import stream as ST

    hop, window, ch = 8, kws.spec.input_hw, kws.spec.input_ch
    rng = np.random.default_rng(3)
    frames = {f"old{i}": _stream(rng, 3, window, hop, ch) for i in range(3)}
    frames.update({f"new{i}": _stream(rng, 2, window, hop, ch)
                   for i in range(3)})
    eng = ST.StreamEngine(kws, hop, device=CPU)
    got = {sid: [] for sid in frames}
    for i in range(3):
        eng.open_session(f"old{i}")
        eng.push(f"old{i}", frames[f"old{i}"][:window], defer=True)
    for sid, rs in _per_session(eng.drain()).items():
        got[sid] += rs
    for i in range(3):
        eng.push(f"old{i}", frames[f"old{i}"][window:], defer=True)
        eng.open_session(f"new{i}")
        eng.push(f"new{i}", frames[f"new{i}"], defer=True)
    for sid, rs in _per_session(eng.drain()).items():
        got[sid] += rs
    for sid, fr in frames.items():
        np.testing.assert_array_equal(
            np.stack([r.logits for r in got[sid]]), _ref(kws, fr, hop))


def test_step_many_advances_exactly_one_hop(kws):
    from repro_torch.serve import stream as ST

    hop, window, ch = 8, kws.spec.input_hw, kws.spec.input_ch
    rng = np.random.default_rng(1)
    eng = ST.StreamEngine(kws, hop, device=CPU)
    sids = [eng.open_session() for _ in range(4)]
    streams = {}
    for sid in sids:
        streams[sid] = _stream(rng, 3, window, hop, ch)
        eng.push(sid, streams[sid][:window])
        eng.push(sid, streams[sid][window:], defer=True)
    r1 = eng.step_many(sids + sids[:1])  # a repeated sid steps once
    assert sorted(r.window for r in r1) == [1] * 4
    r2 = eng.step_many(sids)
    assert sorted(r.window for r in r2) == [2] * 4
    assert eng.step_many(sids) == []
    for sid in sids:
        got = np.stack([r.logits for r in r1 + r2 if r.sid == sid])
        np.testing.assert_array_equal(got, _ref(kws, streams[sid], hop)[1:])
    with pytest.raises(KeyError):
        eng.step_many(["nope"])


def test_eviction_between_stage_and_drain_drops_only_victim(kws):
    from repro_torch.serve import stream as ST

    hop, window, ch = 8, kws.spec.input_hw, kws.spec.input_ch
    rng = np.random.default_rng(5)
    eng = ST.StreamEngine(kws, hop, max_sessions=2, device=CPU)
    frames = {sid: _stream(rng, 2, window, hop, ch) for sid in "abc"}
    for sid in "ab":
        eng.open_session(sid)
        eng.push(sid, frames[sid], defer=True)
    eng.open_session("c")  # evicts "a" (LRU) with its staged frames
    eng.push("c", frames["c"], defer=True)
    by = _per_session(eng.drain())
    assert set(by) == {"b", "c"}
    assert eng.stats()["sessions_evicted"] == 1.0
    for sid in "bc":
        np.testing.assert_array_equal(
            np.stack([r.logits for r in by[sid]]), _ref(kws, frames[sid], hop))


def test_batched_traces_bounded_by_buckets(kws):
    """Arbitrary fleet sizes run at most one prime and one step program a
    bucket."""
    from repro_torch.serve import stream as ST

    hop, window, ch = 8, kws.spec.input_hw, kws.spec.input_ch
    rng = np.random.default_rng(2)
    eng = ST.StreamEngine(kws, hop, batch_buckets=(2, 4), max_sessions=16,
                          device=CPU)
    for round_i, n in enumerate((2, 3, 5, 6, 4)):
        sids = [eng.open_session(f"r{round_i}_{i}") for i in range(n)]
        for sid in sids:
            eng.push(sid, rng.uniform(-1, 1, (window + hop, ch)).astype(
                np.float32), defer=True)
        eng.drain()
    st = eng.stats()
    assert st["batched_traces"] == 2 * len(eng.batch_buckets)
    eng.warm([2, 4, 3])
    assert eng.stats()["batched_traces"] == 2 * len(eng.batch_buckets) + 2


def test_drain_without_buckets_falls_back_to_serial(kws):
    from repro_torch.serve import stream as ST

    hop, window, ch = 8, kws.spec.input_hw, kws.spec.input_ch
    rng = np.random.default_rng(9)
    eng = ST.StreamEngine(kws, hop, batch_buckets=(), device=CPU)
    frames = {eng.open_session(): _stream(rng, 1, window, hop, ch)
              for _ in range(3)}
    for sid, fr in frames.items():
        eng.push(sid, fr, defer=True)
    by = _per_session(eng.drain())
    assert set(by) == set(frames)
    st = eng.stats()
    assert st["windows_batched"] == 0 and st["batched_calls"] == 0
    assert st["batched_traces"] == 0
    for sid, fr in frames.items():
        np.testing.assert_array_equal(
            np.stack([r.logits for r in by[sid]]), _ref(kws, fr, hop))


# ---------------------------------------------------------------------------
# session table
# ---------------------------------------------------------------------------


def _zeros(qnet, n=1):
    return np.zeros((n, qnet.spec.input_ch), np.float32)


def test_lru_eviction_at_capacity(kws):
    from repro_torch.serve import stream as ST

    eng = ST.StreamEngine(kws, 8, max_sessions=2, device=CPU)
    a, b = eng.open_session("a"), eng.open_session("b")
    eng.push(a, _zeros(kws))  # a now MRU
    eng.open_session("c")  # evicts b (LRU)
    assert eng.sessions_active == 2
    with pytest.raises(KeyError):
        eng.push(b, _zeros(kws))
    assert eng.stats()["sessions_evicted"] == 1.0


def test_close_and_reopen_session(kws):
    from repro_torch.serve import stream as ST

    eng = ST.StreamEngine(kws, 8, device=CPU)
    sid = eng.open_session("s")
    assert eng.open_session("s") == sid  # reopen is a no-op
    assert eng.sessions_active == 1
    eng.close_session(sid)
    assert eng.sessions_active == 0
    with pytest.raises(KeyError):
        eng.close_session(sid)


def test_push_validates_inputs(kws):
    from repro_torch.serve import stream as ST

    eng = ST.StreamEngine(kws, 8, device=CPU)
    with pytest.raises(KeyError):
        eng.push("nope", _zeros(kws))
    sid = eng.open_session()
    with pytest.raises(ValueError):
        eng.push(sid, np.zeros((1, kws.spec.input_ch + 1), np.float32))
    with pytest.raises(ValueError):
        eng.push(sid, np.zeros((kws.spec.input_ch,), np.float32))


def test_engine_refuses_bad_arguments(kws):
    from repro_torch.serve import stream as ST

    with pytest.raises(ValueError):
        ST.StreamEngine(kws, 8, max_sessions=0, device=CPU)
    with pytest.raises(ValueError):
        ST.StreamEngine(kws, 8, batch_buckets=(0, 2), device=CPU)
    with pytest.raises(ST.StreamError, match="stride"):
        ST.StreamEngine(kws, 3, device=CPU)


def test_auto_sid_skips_user_supplied_collisions(kws):
    from repro_torch.serve import stream as ST

    eng = ST.StreamEngine(kws, 8, device=CPU)
    user = eng.open_session("s1")
    eng.push(user, _zeros(kws, 3), defer=True)
    assert eng.open_session() == "s0"
    fresh = eng.open_session()  # counter hits 1 -> "s1" taken -> skip
    assert fresh not in ("s0", "s1")
    assert eng.sessions_active == 3
    assert len(eng._sessions[fresh].pending) == 0
    assert len(eng._sessions["s1"].pending) == 3


def test_push_is_transactional_on_step_failure(kws, monkeypatch):
    from repro_torch.serve import stream as ST

    hop, window = 8, kws.spec.input_hw
    frames = _stream(np.random.default_rng(4), 2, window, hop,
                     kws.spec.input_ch)
    eng = ST.StreamEngine(kws, hop, device=CPU)
    sid = eng.open_session()
    eng.push(sid, frames[:window])  # primed
    buffers = eng._sessions[sid].buffers

    def boom(*a, **k):
        raise RuntimeError("device OOM")

    monkeypatch.setattr(eng, "_step", boom)
    with pytest.raises(RuntimeError, match="OOM"):
        eng.push(sid, frames[window:])
    assert len(eng._sessions[sid].pending) == hop  # frames NOT lost
    assert eng._sessions[sid].windows == 1  # no phantom window
    assert eng._sessions[sid].buffers is buffers
    monkeypatch.undo()
    res = eng.push(sid, _zeros(kws, 0))
    np.testing.assert_array_equal(np.stack([r.logits for r in res]),
                                  _ref(kws, frames, hop)[1:])


def test_push_is_transactional_on_prime_failure(kws, monkeypatch):
    from repro_torch.serve import stream as ST

    hop, window = 8, kws.spec.input_hw
    frames = _stream(np.random.default_rng(6), 1, window, hop,
                     kws.spec.input_ch)
    eng = ST.StreamEngine(kws, hop, device=CPU)
    sid = eng.open_session()

    def boom(*a, **k):
        raise RuntimeError("prime failed")

    monkeypatch.setattr(eng, "_prime", boom)
    with pytest.raises(RuntimeError, match="prime"):
        eng.push(sid, frames)
    sess = eng._sessions[sid]
    assert len(sess.pending) == window and sess.buffers is None
    monkeypatch.undo()
    res = eng.push(sid, _zeros(kws, 0))
    np.testing.assert_array_equal(np.stack([r.logits for r in res]),
                                  _ref(kws, frames, hop))


def test_drain_is_transactional_on_batched_step_failure(kws, monkeypatch):
    from repro_torch.serve import stream as ST

    hop, window, ch = 8, kws.spec.input_hw, kws.spec.input_ch
    rng = np.random.default_rng(12)
    eng = ST.StreamEngine(kws, hop, device=CPU)
    streams = {eng.open_session(): _stream(rng, 2, window, hop, ch)
               for _ in range(3)}
    for sid, fr in streams.items():
        eng.push(sid, fr[:window])
        eng.push(sid, fr[window:], defer=True)

    def boom(*a, **k):
        raise RuntimeError("device OOM")

    monkeypatch.setattr(eng, "_step", boom)
    with pytest.raises(RuntimeError):
        eng.drain()
    assert all(len(eng._sessions[sid].pending) == hop for sid in streams)
    monkeypatch.undo()
    by = _per_session(eng.drain())
    for sid, fr in streams.items():
        np.testing.assert_array_equal(by[sid][0].logits,
                                      _ref(kws, fr, hop)[1])


def test_reopen_refreshes_last_used(kws):
    from repro_torch.serve import stream as ST

    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]

    eng = ST.StreamEngine(kws, 8, clock=clock, device=CPU)
    eng.open_session("a")
    stale = eng._sessions["a"].last_used
    eng.open_session("b")
    eng.open_session("a")
    assert eng._sessions["a"].last_used > stale
    assert next(reversed(eng._sessions)) == "a"


def test_fake_clock_drives_the_timing_stats(kws):
    """`clock=` is the only time source: the prime and step times replay
    exactly under a fake clock."""
    from repro_torch.serve import stream as ST

    t = [0.0]

    def clock():
        t[0] += 0.25
        return t[0]

    eng = ST.StreamEngine(kws, 8, clock=clock, device=CPU)
    frames = _stream(np.random.default_rng(0), 3, kws.spec.input_hw, 8,
                     kws.spec.input_ch)
    eng.push(eng.open_session(), frames)
    st = eng.stats()
    assert (st["prime_s"], st["step_s"]) == (0.25, 0.5)
    assert st["fps_streamed"] == 4.0


def test_session_table_bytes(kws):
    """Primed ring buffers plus the float32 staging of every session."""
    from repro_torch.serve import stream as ST

    hop, window, ch = 8, kws.spec.input_hw, kws.spec.input_ch
    rng = np.random.default_rng(8)
    eng = ST.StreamEngine(kws, hop, device=CPU)
    eng.open_session("cold")
    assert eng.session_table_bytes() == 0
    sid = eng.open_session()
    eng.push(sid, rng.uniform(-1, 1, (hop, ch)).astype(np.float32),
             defer=True)
    pend = hop * ch * 4
    assert eng.session_table_buffer_bytes() == 0
    assert eng.session_table_pending_bytes() == pend
    eng.push(sid, rng.uniform(-1, 1, (window - hop + 3, ch)).astype(
        np.float32))
    st = eng.stats()
    assert st["session_table_buffer_bytes"] == eng.plan.buffer_bytes
    assert st["session_table_pending_bytes"] == 3 * ch * 4
    assert st["session_table_bytes"] == eng.plan.buffer_bytes + 3 * ch * 4
    bufs = eng._sessions[sid].buffers
    assert all(v.dtype == torch.uint8 for k, v in bufs.items()
               if k != "pool_sum")
    assert sum(v.numel() for k, v in bufs.items()
               if k != "pool_sum") == eng.plan.buffer_bytes


def test_stats_keys_match_the_reference_but_energy(kws, nets):
    """Every key of the reference's `stats()`, the three energy keys
    included since the energy model's port (before any step they price
    the plan's MACs and bytes analytically on the CPU's power curve, in
    both packages)."""
    from repro.serve import stream as RST
    from repro_torch.serve import stream as ST

    own = ST.StreamEngine(kws, 8, device=CPU).stats()
    ref = RST.StreamEngine(nets["kws_golden"][0], 8).stats()
    assert set(own) == set(ref)
    for k in ("frames_per_window_full", "frames_per_window_step",
              "macs_per_window_full", "macs_per_window_step",
              "session_buffer_bytes", "bytes_per_window_full",
              "bytes_per_window_step", "reuse_fraction",
              "energy_j_per_window_step", "watts", "fps_per_watt"):
        assert own[k] == ref[k], k


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--regen", action="store_true",
                    help="rewrite the fixtures with the JAX package")
    if ap.parse_args().regen:
        regen()
