"""The port's reference interpreter (`repro_torch.core.cu`) against the
frozen golden fixtures of the JAX package (`tests/golden/`), exactly:
`run_qnet` logits and the per-stage `run_blocks` walk, plus the datapath
pieces against their JAX counterparts on identical numpy inputs."""
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
