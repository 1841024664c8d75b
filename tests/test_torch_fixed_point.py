"""The fixed-point datapath and the 1-D ops of the PyTorch port, against the
JAX package on the same numpy-seeded inputs, bit for bit.

Fixed point is the FPGA's integer 'Approximator' requant: acc * mantissa in
int64, rounded half away from zero by a shift. The JAX side of every
fixed-point comparison runs inside a scoped `jax.enable_x64(True)`: without
it the JAX requant wraps in int32 (ROADMAP F1). One guard test shows that
x64 moves nothing else: the JAX float-mode logits under x64 equal the frozen
float goldens.

  * `requantize_fixedpoint` against JAX and an int64 numpy oracle
    (negative accumulators, shift 0, shifts over 40);
  * `residual_fixed_consts` and `int_residual_add` against JAX;
  * `run_qnet(fixed_point=True)` on the five goldens of `tests/golden/`,
    and `VisionEngine(fixed_point=True)` against it;
  * `int_conv1d`, `int_conv1d_f32` and `int_depthwise1d_shifts` over
    kernels 3/5, strides 1/2 and asymmetric pads; the DS-CNN builders
    against JAX's NetSpecs; the `dscnn_kws_act8` golden stages and logits;
  * the full-width MobileNetV2 fixture in fixed point
    (`tests/golden_torch/mobilenet_v2_alpha1_224_act8_fixed.npz`).

Regenerate that fixture with the JAX package:

    PYTHONPATH=src python -m tests.test_torch_fixed_point --regen
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "golden_torch")
MNV2 = os.path.join(FIXTURE_DIR, "mobilenet_v2_alpha1_224_act8")
MNV2_FIXED = MNV2 + "_fixed.npz"
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


def regen() -> None:
    """The JAX `run_qnet(fixed_point=True)` logits of the full-width
    MobileNetV2 fixture's 8 images, under a scoped x64."""
    import jax
    import jax.numpy as jnp

    from repro.core import cu, qnet as Q
    from tests.test_torch_fullwidth import images

    qnet = Q.load_qnet(MNV2 + ".qnet")
    with jax.enable_x64(True):
        pq = cu.prepare_qnet(qnet)  # int64 mantissas; same bits as qnet
        logits = np.asarray(cu.run_qnet(pq, jnp.asarray(images()),
                                        fixed_point=True), np.float32)
    np.savez_compressed(MNV2_FIXED, logits=logits)
    print(f"[fixed_point] {logits.shape} -> {MNV2_FIXED}")


# ---------------------------------------------------------------------------
# requant and skip-add against JAX (x64 scoped) and an int64 oracle
# ---------------------------------------------------------------------------


def _oracle_requant(acc, mant, shift):
    """round(acc * mant * 2^-shift), half away from zero, in numpy int64."""
    wide = acc.astype(np.int64) * mant.astype(np.int64)
    sh = shift.astype(np.int64)
    half = np.where(sh > 0, np.left_shift(np.int64(1), np.maximum(sh - 1, 0)),
                    0)
    return ((wide + np.where(wide >= 0, half, -half)) >> sh).astype(np.int32)


def _jax_requant(acc, mant, shift):
    import jax
    import jax.numpy as jnp

    from repro.core.integer_ops import requantize_fixedpoint

    with jax.enable_x64(True):
        return np.asarray(requantize_fixedpoint(
            jnp.asarray(acc, jnp.int32), jnp.asarray(mant, jnp.int64),
            jnp.asarray(shift, jnp.int32)))


def _port_requant(acc, mant, shift):
    from repro_torch.core.integer_ops import requantize_fixedpoint

    return requantize_fixedpoint(torch.from_numpy(acc),
                                 torch.from_numpy(mant),
                                 torch.from_numpy(shift)).numpy()


def test_quantize_multiplier_matches_reference():
    from repro.core.integer_ops import quantize_multiplier as ref
    from repro_torch.core.integer_ops import quantize_multiplier

    m = np.concatenate([np.random.default_rng(0).uniform(1e-5, 0.5, 256),
                        [1.0, 0.5, 0.25, 1e-5, 0.999999999]])
    for got, want in zip(quantize_multiplier(m), ref(m)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_requant_matches_jax_and_oracle_on_the_reference_cases():
    """The 256 cases of the JAX package's own fixed-point test."""
    from repro_torch.core.integer_ops import quantize_multiplier

    rng = np.random.default_rng(0)
    acc = rng.integers(-(2**20), 2**20, (256,)).astype(np.int32)
    mant, shift = quantize_multiplier(rng.uniform(1e-5, 0.5, (256,)))
    want = _oracle_requant(acc, mant, shift)
    np.testing.assert_array_equal(_port_requant(acc, mant, shift), want)
    np.testing.assert_array_equal(_jax_requant(acc, mant, shift), want)


@pytest.mark.parametrize("shift", [0, 1, 2, 17, 31, 40, 44, 47])
def test_requant_shift_edges(shift):
    """Negative accumulators, ties (exact halves) on both signs, shift 0
    (no rounding bias) and shifts over 40 (multipliers near 1e-5)."""
    rng = np.random.default_rng(shift)
    acc = np.concatenate([
        rng.integers(-(2**31), 2**31 - 1, 200),
        [0, 1, -1, 2**31 - 1, -(2**31), 3, -3, 5, -5]]).astype(np.int32)
    mant = np.concatenate([
        rng.integers(2**30, 2**31, 200),
        [2**30] * 9]).astype(np.int64)
    if shift > 0:  # ties: acc * mant an odd multiple of 2^(shift-1)
        mant[-4:] = np.int64(1) << max(shift - 1, 0)
    shifts = np.full(acc.shape, shift, np.int32)
    want = _oracle_requant(acc, mant, shifts)
    np.testing.assert_array_equal(_port_requant(acc, mant, shifts), want)
    np.testing.assert_array_equal(_jax_requant(acc, mant, shifts), want)


def _res_cases():
    rng = np.random.default_rng(5)
    out = []
    for _ in range(6):
        a_s, b_s, y_s = rng.uniform(0.005, 0.05, 3)
        a_z, b_z, y_z = rng.uniform(-40, 0, 3)
        out.append(tuple(float(v) for v in (a_s, a_z, b_s, b_z, y_s, y_z)))
    out.append((0.02, 0.0, 0.02, 0.0, 0.02, 0.0))
    return out


@pytest.mark.parametrize("scales", _res_cases())
def test_residual_fixed_consts_and_int_add_match_jax(scales):
    import jax
    import jax.numpy as jnp

    from repro.core import integer_ops as rio
    from repro_torch.core import integer_ops as io

    consts = io.residual_fixed_consts(*scales)
    assert consts == rio.residual_fixed_consts(*scales)
    rng = np.random.default_rng(len(str(scales)))
    a = rng.integers(0, 256, (4, 19, 8)).astype(np.int32)
    b = rng.integers(0, 256, (4, 19, 8)).astype(np.int32)
    with jax.enable_x64(True):
        want = np.asarray(rio.int_residual_add(jnp.asarray(a),
                                               jnp.asarray(b), consts, 255))
    got = io.int_residual_add(torch.from_numpy(a), torch.from_numpy(b),
                              consts, 255)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# whole nets: the five goldens
# ---------------------------------------------------------------------------


def _golden_ids(c):
    return f"{c[0]}_act{c[1]}"


@pytest.fixture(scope="module")
def goldens():
    """Per golden: the port's prepared net, its inputs, frozen float logits,
    and the JAX logits under x64 in float and fixed-point mode: one jitted
    JAX `run_qnet` a golden and mode (eager, each op of it would compile on
    its own, and that costs more than a minute here)."""
    import jax
    import jax.numpy as jnp

    from repro.core import cu as rcu, qnet as RQ
    from repro_torch.core import cu, qnet as Q
    from tests.regen_golden import CASES, fixture_paths

    out = {}
    for model, bits in CASES:
        qnet_path, npz_path = fixture_paths(model, bits)
        fix = np.load(npz_path)
        ref = RQ.load_qnet(qnet_path)
        x = jnp.asarray(fix["input"])
        with jax.enable_x64(True):
            fixed = np.asarray(jax.jit(
                lambda v, r=ref: rcu.run_qnet(r, v, fixed_point=True))(x))
            float64on = np.asarray(jax.jit(
                lambda v, r=ref: rcu.run_qnet(r, v))(x))
        out[(model, bits)] = dict(
            pq=cu.prepare_qnet(Q.load_qnet(qnet_path), device=CPU),
            fix=fix, jax_fixed=fixed, jax_float_x64=float64on)
    return out


from tests.regen_golden import CASES as _CASES  # noqa: E402


@pytest.mark.parametrize("case", _CASES, ids=_golden_ids)
def test_x64_moves_only_the_requant(goldens, case):
    """Guard: under the scoped x64 the JAX float-mode logits equal the
    frozen float goldens, so x64 changes nothing but the fixed-point
    requant's width."""
    g = goldens[case]
    np.testing.assert_array_equal(g["jax_float_x64"], g["fix"]["logits"])


@pytest.mark.parametrize("case", _CASES, ids=_golden_ids)
def test_run_qnet_fixed_point_matches_jax(goldens, case):
    from repro_torch.core import cu

    g = goldens[case]
    got = cu.run_qnet(g["pq"], g["fix"]["input"], fixed_point=True).numpy()
    np.testing.assert_array_equal(got, g["jax_fixed"])
    # the float path is untouched by the new argument
    np.testing.assert_array_equal(
        cu.run_qnet(g["pq"], g["fix"]["input"]).numpy(), g["fix"]["logits"])


@pytest.mark.parametrize("case", [c for c in _CASES if c[0] != "dscnn_kws"],
                         ids=_golden_ids)
def test_vision_engine_fixed_point_equals_run_qnet(goldens, case):
    from repro_torch.serve.vision import VisionEngine

    g = goldens[case]
    eng = VisionEngine(g["pq"], device=CPU, fixed_point=True, buckets=(2,))
    rids = [eng.submit(img) for img in g["fix"]["input"]]
    res = eng.run()
    got = np.stack([res[r].logits for r in rids])
    np.testing.assert_array_equal(got, g["jax_fixed"])


@pytest.mark.parametrize("flag", ["body_fast_path", "op_kernels"])
def test_fixed_point_refuses_kernels_on(flag):
    from repro_torch.core import qnet as Q
    from repro_torch.serve.vision import VisionEngine, compile_stages
    from tests.regen_golden import fixture_paths

    qnet = Q.load_qnet(fixture_paths("mobilenet_v2", 8)[0])
    with pytest.raises(ValueError, match="fixed_point"):
        compile_stages(qnet, device=CPU, fixed_point=True, **{flag: "on"})
    with pytest.raises(ValueError, match="fixed_point"):
        VisionEngine(qnet, device=CPU, fixed_point=True, **{flag: "on"})
    # "auto" serves fixed point through the reference ops
    stages = compile_stages(qnet, device=CPU, fixed_point=True,
                            **{flag: "auto"})
    assert not any(st.pq.routes or st.fused_blocks for st in stages)


def test_residual_consts_prepared_once_match_jax():
    """`PreparedQNet.res_fixed` equals the JAX prepared net's."""
    from repro.core import cu as rcu, qnet as RQ
    from repro_torch.core import cu, qnet as Q
    from tests.regen_golden import fixture_paths

    path = fixture_paths("mobilenet_v2", 8)[0]
    want = rcu.prepare_qnet(RQ.load_qnet(path)).res_fixed
    got = cu.prepare_qnet(Q.load_qnet(path), device=CPU).res_fixed
    assert got and got == want


def test_fullwidth_mobilenet_v2_fixed_point_fixture():
    """Image 0 of the full-width MobileNetV2 fixture in fixed point: equal
    to the JAX x64 logits stored in the fixture."""
    from repro_torch.core import cu, qnet as Q
    from tests.test_torch_fullwidth import images

    want = np.load(MNV2_FIXED)["logits"]
    assert want.shape == (8, 1000)
    pq = cu.prepare_qnet(Q.load_qnet(MNV2 + ".qnet"), device=CPU)
    got = cu.run_qnet(pq, images()[:1], fixed_point=True).numpy()
    np.testing.assert_array_equal(got, want[:1])


# ---------------------------------------------------------------------------
# 1-D ops and the DS-CNN builders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("pad", ["SAME", "VALID", (0, 0), (2, 1), (1, 3),
                                 (0, 4)])
def test_conv1d_ops_match_jax(k, s, pad):
    import jax.numpy as jnp

    from repro.core import integer_ops as rio
    from repro_torch.core import integer_ops as io

    rng = np.random.default_rng(k * 10 + s)
    x = rng.integers(0, 256, (3, 17, 6)).astype(np.int32)
    w = rng.integers(-127, 128, (k, 6, 5)).astype(np.int32)
    wd = rng.integers(-127, 128, (k, 6)).astype(np.int32)
    want = np.asarray(rio.int_conv1d(jnp.asarray(x), jnp.asarray(w), s, pad))
    xt = torch.from_numpy(x)
    got = io.int_conv1d(xt, torch.from_numpy(w.astype(np.float64)), s, pad)
    np.testing.assert_array_equal(got.numpy(), want)
    assert io.f32_accum_exact(w, 255)
    got = io.int_conv1d_f32(xt, torch.from_numpy(w.astype(np.float32)), s,
                            pad)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(rio.int_conv1d_f32(
            jnp.asarray(x), jnp.asarray(w), s, pad)))
    if pad == "VALID":
        return  # the reference's shifted depthwise takes SAME or (lo, hi)
    want = np.asarray(rio.int_depthwise1d_shifts(
        jnp.asarray(x), jnp.asarray(wd), s, pad))
    np.testing.assert_array_equal(
        want, np.asarray(rio.int_conv1d(jnp.asarray(x),
                                        jnp.asarray(wd[:, None, :]), s,
                                        pad, groups=6)))
    got = io.int_depthwise1d_shifts(xt, torch.from_numpy(wd), s, pad)
    np.testing.assert_array_equal(got.numpy(), want)


def test_conv1d_f32_keeps_cudnn_tf32_setting():
    from repro_torch.core import integer_ops as io

    before = torch.backends.cudnn.allow_tf32
    x = torch.zeros((1, 8, 2), dtype=torch.int32)
    io.int_conv1d_f32(x, torch.ones((3, 2, 2)), 1)
    assert torch.backends.cudnn.allow_tf32 == before


_KWS_KW = [{}, dict(input_t=32, input_ch=4, channels=8, n_blocks=2),
           dict(kernel=5, stem_stride=1, residual=True, bits=4),
           dict(last_ch=40, num_classes=5, first_conv_bits=6)]
_HAR_KW = [{}, dict(input_t=64, stem_channels=6, channels=[8, 12]),
           dict(kernel=3, bits=4, last_ch=24)]


@pytest.mark.parametrize("family,kw", [("kws", k) for k in _KWS_KW]
                         + [("har", k) for k in _HAR_KW])
def test_dscnn_builders_match_jax(family, kw):
    from repro.models import dscnn1d as ref
    from repro_torch.convert import netspec_from_reference
    from repro_torch.core import qnet as Q
    from repro_torch.models import dscnn1d

    fn = "build_kws" if family == "kws" else "build_har"
    got = getattr(dscnn1d, fn)(**kw)
    assert got == netspec_from_reference(getattr(ref, fn)(**kw))
    assert got.spatial_rank == 1
    assert Q.build_netspec({"model": f"dscnn_{family}", **kw}) == got


def test_dscnn_kws_golden_stages_and_logits():
    """`tests/golden/dscnn_kws_act8`: the port rebuilds the net from the
    artifact's build record, and every CU stage's activations and the
    logits equal the frozen ones."""
    from repro_torch.core import compiler as CC, cu, qnet as Q
    from tests.regen_golden import fixture_paths

    qnet_path, npz_path = fixture_paths("dscnn_kws", 8)
    fix = np.load(npz_path)
    pq = cu.prepare_qnet(Q.load_qnet(qnet_path), device=CPU)
    assert pq.spec.spatial_rank == 1
    np.testing.assert_array_equal(cu.run_qnet(pq, fix["input"]).numpy(),
                                  fix["logits"])
    stages = sorted(k for k in fix.files if k.startswith("stage"))
    s, z = cu.input_qparams(pq)
    y = cu.quantize_input(torch.from_numpy(fix["input"]), pq.input_scale, z)
    sigs = CC.compile_net(pq.spec).stage_signatures()
    assert [sig.cu for sig in sigs] == [k.split("_")[1] for k in stages]
    for sig, key in zip(sigs, stages):
        y, s, z = cu.run_blocks(y, sig.blocks, pq, s, z)
        np.testing.assert_array_equal(y.numpy(), fix[key].astype(np.int32),
                                      err_msg=key)


def test_qnet_from_reference_carries_1d_kinds_and_fixed_point():
    from repro.core import qnet as RQ
    from repro_torch.convert import qnet_from_reference
    from repro_torch.core import cu, graph as G, qnet as Q
    from tests.regen_golden import fixture_paths

    qnet_path, npz_path = fixture_paths("dscnn_kws", 8)
    conv = qnet_from_reference(RQ.load_qnet(qnet_path))
    own = Q.load_qnet(qnet_path)
    assert conv.spec == own.spec
    kinds = {op.kind for _, op in conv.spec.all_ops()}
    assert {G.CONV1D, G.DW1D} <= kinds
    for name, q in own.ops.items():
        for f in ("w_q", "mantissa", "shift", "mult", "bias_q"):
            np.testing.assert_array_equal(getattr(conv.ops[name], f),
                                          getattr(q, f))
        assert conv.ops[name].mantissa.dtype == np.int64
    x = np.load(npz_path)["input"]
    np.testing.assert_array_equal(
        cu.run_qnet(conv, x, device=CPU, fixed_point=True).numpy(),
        cu.run_qnet(own, x, device=CPU, fixed_point=True).numpy())


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--regen", action="store_true",
                    help="rewrite the fixture with the JAX package")
    if ap.parse_args().regen:
        regen()
