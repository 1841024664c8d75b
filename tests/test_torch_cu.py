"""The port's reference interpreter (`repro_torch.core.cu`) against the
frozen golden fixtures of the JAX package (`tests/golden/`), exactly:
`run_qnet` logits and the per-stage `run_blocks` walk, plus the datapath
pieces against their JAX counterparts on identical numpy inputs."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import cu as rcu, integer_ops as rio
from repro_torch.core import compiler as CC, cu, integer_ops as io, qnet as Q
from tests.regen_golden import CASES, fixture_paths

GOLDEN_2D = [c for c in CASES if c[0] != "dscnn_kws"]


@pytest.fixture(scope="module", params=GOLDEN_2D,
                ids=lambda c: f"{c[0]}_act{c[1]}")
def golden(request):
    qnet_path, npz_path = fixture_paths(*request.param)
    fix = np.load(npz_path)
    stages = sorted(k for k in fix.files if k.startswith("stage"))
    pq = cu.prepare_qnet(Q.load_qnet(qnet_path), device="cpu")
    return pq, fix["input"], [fix[k] for k in stages], fix["logits"]


def test_run_qnet_matches_golden(golden):
    pq, x, _, logits = golden
    np.testing.assert_array_equal(cu.run_qnet(pq, x).numpy(), logits)


def test_run_blocks_per_stage_matches_golden(golden):
    pq, x, acts, _ = golden
    s, z = cu.input_qparams(pq)
    y = cu.quantize_input(torch.from_numpy(x), pq.input_scale, z)
    sigs = CC.compile_net(pq.spec).stage_signatures()
    assert len(sigs) == len(acts)
    for sig, want in zip(sigs, acts):
        y, s, z = cu.run_blocks(y, sig.blocks, pq, s, z)
        np.testing.assert_array_equal(y.numpy(), want.astype(np.int32),
                                      err_msg=sig.cu)
        assert (s, z) == cu.propagate_qparams(sig.blocks, pq.qnet, *(
            cu.input_qparams(pq) if sig is sigs[0] else prev))
        prev = (s, z)


def test_run_qnet_prepares_an_unprepared_net():
    qnet_path, npz_path = fixture_paths("mobilenet_v2", 4)
    fix = np.load(npz_path)
    got = cu.run_qnet(Q.load_qnet(qnet_path), fix["input"], device="cpu")
    np.testing.assert_array_equal(got.numpy(), fix["logits"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_input_matches_reference(seed):
    x = np.random.default_rng(seed).uniform(-1, 1, (4, 9, 9, 3)).astype(
        np.float32)
    scale, zp = 2.0 / 255.0, -128.0
    want = np.asarray(rcu.quantize_input(jnp.asarray(x), scale, zp, 8))
    got = cu.quantize_input(torch.from_numpy(x),
                            torch.tensor(scale, dtype=torch.float32), zp)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,k,s", [((2, 9, 9, 8), 3, 1),
                                       ((2, 11, 13, 8), 3, 2),
                                       ((1, 12, 12, 16), 5, 2)])
def test_depthwise_shifts_and_conv_match_reference(shape, k, s):
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, shape).astype(np.int32)
    w = rng.integers(-127, 128, (k, k, shape[-1])).astype(np.int32)
    want = np.asarray(rio.int_depthwise_shifts(jnp.asarray(x),
                                               jnp.asarray(w), s))
    got = io.int_depthwise_shifts(torch.from_numpy(x), torch.from_numpy(w), s)
    np.testing.assert_array_equal(got.numpy(), want)
    wc = rng.integers(-127, 128, (k, k, shape[-1], 5)).astype(np.int32)
    want = np.asarray(rio.int_conv2d(jnp.asarray(x), jnp.asarray(wc), s))
    got = io.int_conv2d(torch.from_numpy(x),
                        torch.from_numpy(wc.astype(np.float64)), s)
    np.testing.assert_array_equal(got.numpy(), want)


def test_f32_accum_exact_matches_reference():
    rng = np.random.default_rng(5)
    for cols, qmax in ((16, 255), (1280, 255), (4000, 255), (64, 15)):
        w = rng.integers(-127, 128, (cols, 8)).astype(np.int8)
        assert io.f32_accum_exact(w, qmax) == rio.f32_accum_exact(w, qmax)


def test_float32_accumulation_refuses_tf32(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        io.int_pointwise(torch.zeros(2, 4, dtype=torch.int32),
                         torch.zeros(4, 3, dtype=torch.float32))



# ROADMAP F13: the falsifying example that
# `tests/test_prepared_fastpath.py::test_fuzz_fast_path_matches_reference`
# replays, frozen with JAX's outputs (regenerate with `PYTHONPATH=src python
# -m tests.test_torch_cu --regen`, ~30 s)
F13_SEED = 35567
F13_QNET, F13_NPZ = (os.path.join(os.path.dirname(__file__), "golden_torch",
                                  "fuzz_f13_mix.{}".format(ext))
                     for ext in ("qnet", "npz"))


def _f13_net():
    from tests.test_prepared_fastpath import _mixed_act_bits, _rand_netspec

    return _mixed_act_bits(_rand_netspec(8, 1, 2, 5, 1, 8, 16), 1030171)


def regen_f13():
    """JAX's calibrated qnet of F13's net and its `run_qnet` logits on the
    fuzz test's input, float and fixed-point requant (in int64: without
    x64 the reference's wraps in int32, ROADMAP F1)."""
    import jax

    from repro.core import qnet as RQ
    from repro.models import layers as RL

    ref = RL.make_calibrated_qnet(_f13_net(), seed=F13_SEED % 7)
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(F13_SEED),
                                      (2, 16, 16, 3), minval=-1, maxval=1))
    logits = np.asarray(rcu.run_qnet(ref, jnp.asarray(x)))
    with jax.enable_x64(True):
        fixed = np.asarray(rcu.run_qnet(ref, jnp.asarray(x),
                                        fixed_point=True))
    RQ.save_qnet(ref, F13_QNET, provenance={
        "fuzz": "_rand_netspec(8, 1, 2, 5, 1, 8, 16), act_plan 1030171",
        "calibration_seed": F13_SEED % 7, "input_seed": F13_SEED})
    np.savez(F13_NPZ, input=x, logits=logits, logits_fixed=fixed)


def test_reference_fault_f13_net_holds_on_every_port_route():
    """ROADMAP F13: on this net JAX's stage executors are one LSB off its
    own `run_qnet`. The port's reference interpreter, prepared path,
    stage executors and engine all equal JAX's `run_qnet` (the frozen
    logits) bit for bit, float and fixed-point requant, and
    `verify_export` proves every route."""
    from repro_torch.convert import netspec_from_reference
    from repro_torch.serve.vision import VisionEngine, compile_stages
    from repro_torch.train.vision import verify_export

    qnet = Q.load_qnet(F13_QNET, net=netspec_from_reference(_f13_net()))
    fix = np.load(F13_NPZ)
    x = fix["input"]
    pq = cu.prepare_qnet(qnet, device="cpu")
    for fixed, want in ((False, fix["logits"]), (True, fix["logits_fixed"])):
        got = {"reference": cu.run_qnet(qnet, x, device="cpu",
                                        fixed_point=fixed),
               "prepared": cu.run_qnet(pq, x, fixed_point=fixed)}
        y = torch.from_numpy(x)
        for st in compile_stages(pq, fixed_point=fixed, device="cpu"):
            y = st(y)
        got["stage-executors"] = y
        eng = VisionEngine(pq, buckets=(2,), fixed_point=fixed, device="cpu")
        rids = [eng.submit(img) for img in x]
        res = eng.run()
        got["engine"] = np.stack([res[r].logits for r in rids])
        for route, out in got.items():
            out = out.numpy() if isinstance(out, torch.Tensor) else out
            np.testing.assert_array_equal(out, want, err_msg=(route, fixed))
    report = verify_export(qnet, x, device="cpu")
    assert {"reference", "prepared", "stage-executors",
            "engine"} <= set(report["routes"])


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--regen", action="store_true",
                    help="rewrite F13's fixture with the JAX package")
    if ap.parse_args().regen:
        regen_f13()
