"""Full-width MobileNetV2 (alpha 1.0, 224x224x3, 1000 classes, act8), the
same net mixed 4/6/8-bit, and the full-size compact EfficientNet (H=128,
1000 classes, act8) through the PyTorch port, against the JAX package's
`cu.run_qnet` logits.

The fixtures `tests/golden_torch/mobilenet_v2_alpha1_224_act8.{qnet,npz}`,
`tests/golden_torch/mobilenet_v2_alpha1_224_mix468.{qnet,npz}` (4-bit
weights; the Body blocks' activations cycle 8, 4, 6 block by block through
`repro.tune.precision.block_allocation`, so every change of width falls on
some block boundary; stem, tail and classifier at 8) and
`tests/golden_torch/efficientnet_compact_h128_act8.{qnet,npz}` freeze
each quantized net and the JAX reference's answers on 8 images:

  * `logits` [8, 1000] float32 — `repro.core.cu.run_qnet` on the images,
  * `stage_sha256` [n_stages, 8] — sha256 of each image's uint8 CU-stage
    output (`cu.run_blocks` per stage), so a mismatch names the first stage
    that differs, and `stage_names` [n_stages].

The images are not stored: both sides regenerate them from the seed
(`images()`, at the net's input size). Regenerate a fixture with the JAX
package:

    PYTHONPATH=src python -m tests.test_torch_fullwidth --regen
    PYTHONPATH=src python -m tests.test_torch_fullwidth --regen efficientnet_compact
    PYTHONPATH=src python -m tests.test_torch_fullwidth --regen mobilenet_v2_mix468

At this size the JAX fused-IRB formula drifts from `run_qnet` (ROADMAP F4),
so the CPU test below, which runs the port's plain fused-IRB version on all
16 Body blocks, is what shows the port's fused form keeps `run_qnet`'s bits.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np
import pytest
import torch

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "golden_torch")
BASE = os.path.join(FIXTURE_DIR, "mobilenet_v2_alpha1_224_act8")
QNET_PATH, NPZ_PATH = BASE + ".qnet", BASE + ".npz"
BUILD = {"model": "mobilenet_v2", "alpha": 1.0, "input_hw": 224, "bits": 8,
         "num_classes": 1000}
EFFNET_BASE = os.path.join(FIXTURE_DIR, "efficientnet_compact_h128_act8")
EFFNET_BUILD = {"model": "efficientnet_compact", "input_hw": 128, "bits": 8,
                "num_classes": 1000}
MIX_BASE = os.path.join(FIXTURE_DIR, "mobilenet_v2_alpha1_224_mix468")
# the Body blocks' widths cycle through MIX_CYCLE; the rest stay at act_bits
MIX_BUILD = {"model": "mobilenet_v2", "alpha": 1.0, "input_hw": 224,
             "bits": 4, "num_classes": 1000, "act_bits": 8}
MIX_CYCLE = (8, 4, 6)
# net -> (fixture path without extension, build record)
FIXTURES = {"mobilenet_v2": (BASE, BUILD),
            "efficientnet_compact": (EFFNET_BASE, EFFNET_BUILD),
            "mobilenet_v2_mix468": (MIX_BASE, MIX_BUILD)}
N_IMAGES = 8


def images(hw: int = 224) -> np.ndarray:
    """A fixture's 8 input images, [8, hw, hw, 3] float32 in [-1, 1]."""
    return np.random.default_rng(0).uniform(
        -1, 1, (N_IMAGES, hw, hw, 3)).astype(np.float32)


def stage_digests(act: np.ndarray) -> list:
    """sha256 of each image's stage output, taken over its uint8 bytes."""
    u8 = np.ascontiguousarray(np.asarray(act).astype(np.uint8))
    return [hashlib.sha256(row.tobytes()).hexdigest() for row in u8]


def regen(name: str = "mobilenet_v2") -> None:
    """Build, calibrate and quantize the net with the JAX package, freeze it,
    and store the reference's logits and per-stage digests."""
    import jax.numpy as jnp

    from repro.core import compiler as CC, cu, qnet as Q
    from repro.models import efficientnet as effn, mobilenet_v2 as mnv2
    from repro.models.layers import make_calibrated_qnet

    base, build = FIXTURES[name]
    if name == "mobilenet_v2_mix468":
        from repro.tune.precision import block_allocation

        uniform = Q.build_netspec(build)
        body = [b.name for b in uniform.blocks if b.name.startswith("irb")]
        build = dict(build, op_act_bits=block_allocation(
            uniform, {n: MIX_CYCLE[i % len(MIX_CYCLE)]
                      for i, n in enumerate(body)}))
        net = Q.build_netspec(build)
    else:
        kw = {k: v for k, v in build.items() if k != "model"}
        net = {"mobilenet_v2": mnv2.build,
               "efficientnet_compact": effn.build_compact}[name](**kw)
    qnet = make_calibrated_qnet(net, bits=build["bits"], seed=0)
    os.makedirs(FIXTURE_DIR, exist_ok=True)
    qnet_path, npz_path = base + ".qnet", base + ".npz"
    Q.save_qnet(qnet, qnet_path, build=build,
                provenance={"derivation": "make_calibrated_qnet", "seed": 0,
                            "n_cal": 2})
    qnet = Q.load_qnet(qnet_path)  # answers come from the frozen artifact
    x = jnp.asarray(images(build["input_hw"]))
    logits = np.asarray(cu.run_qnet(qnet, x), np.float32)
    sigs = CC.compile_net(qnet.spec).stage_signatures()
    s, z = cu.input_qparams(qnet)
    y = cu.quantize_input(x, s, z, 8)
    names, digests = [], []
    for sig in sigs:
        y, s, z = cu.run_blocks(y, sig.blocks, qnet, s, z)
        act = np.asarray(y)
        assert act.min() >= 0 and act.max() <= 255, sig.cu
        names.append(sig.cu)
        digests.append(stage_digests(act))
    walked = (np.asarray(y, np.float32) + np.float32(z)) * np.float32(s)
    assert np.array_equal(walked, logits), "stage walk != run_qnet"
    np.savez_compressed(npz_path, logits=logits,
                        stage_names=np.asarray(names),
                        stage_sha256=np.asarray(digests))
    size = (os.path.getsize(qnet_path) + os.path.getsize(npz_path)) / 2**20
    print(f"[fullwidth] {len(names)} stages, {size:.1f} MiB -> {base}.*")


# ---------------------------------------------------------------------------
# tests (the port only: the fixture holds the reference's answers)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fixture():
    fix = np.load(NPZ_PATH)
    return {k: fix[k] for k in fix.files}


@pytest.fixture(scope="module")
def image0():
    return images()[:1]


def test_fullwidth_run_qnet_equals_reference_logits(fixture, image0):
    """The port's reference interpreter, image 0: logits and every stage
    digest equal the JAX package's."""
    from repro_torch.core import compiler as CC, cu, qnet as Q

    pq = cu.prepare_qnet(Q.load_qnet(QNET_PATH), device="cpu")
    np.testing.assert_array_equal(
        cu.run_qnet(pq, image0).numpy(), fixture["logits"][:1])
    s, z = cu.input_qparams(pq)
    y = cu.quantize_input(torch.from_numpy(image0), pq.input_scale, z)
    for i, sig in enumerate(CC.compile_net(pq.spec).stage_signatures()):
        y, s, z = cu.run_blocks(y, sig.blocks, pq, s, z)
        assert stage_digests(y.numpy()) == [fixture["stage_sha256"][i][0]], \
            f"stage {i} ({sig.cu}) differs"


def test_fullwidth_engine_fused_body_equals_reference_logits(fixture, image0):
    """The served route on the CPU: all 16 Body blocks through the plain
    fused-IRB version, Head/Tail/Classifier through the plain per-op
    kernels. Equal to `run_qnet` bit for bit, where the JAX fused formula
    is not (F4)."""
    from repro_torch.kernels import ops as K
    from repro_torch.serve.vision import VisionEngine

    eng = VisionEngine.from_artifact(QNET_PATH, device="cpu", buckets=(1,),
                                     body_fast_path="on", op_kernels="on")
    body = [st for st in eng.stages if st.spec.cu == "body"][0]
    assert sum(K.fusable_irb(b) for b in body.spec.blocks) == 16
    rid = eng.submit(image0[0])
    res = eng.run()
    np.testing.assert_array_equal(res[rid].logits, fixture["logits"][0])


@pytest.fixture(scope="module")
def effnet_fixture():
    fix = np.load(EFFNET_BASE + ".npz")
    return {k: fix[k] for k in fix.files}


def test_fullwidth_efficientnet_engine_equals_reference_logits(
        effnet_fixture):
    """The full-size compact EfficientNet (H=128, 1000 classes) on the
    served route on the CPU: every DW op (3x3 and 5x5, stride 1 and 2)
    through the plain depthwise version, every PW and DENSE op through the
    plain pointwise version, SE gates as torch ops (no block is fusable).
    Two of the fixture's images, equal to the JAX `run_qnet` logits bit for
    bit; the Head's output equals its stored digests too."""
    from repro_torch.kernels import ops as K
    from repro_torch.serve.vision import VisionEngine

    x = images(EFFNET_BUILD["input_hw"])[:2]
    eng = VisionEngine.from_artifact(EFFNET_BASE + ".qnet", device="cpu",
                                     buckets=(2,), body_fast_path="on",
                                     op_kernels="on")
    assert not any(K.fusable_irb(b) for st in eng.stages
                   for b in st.spec.blocks)
    rids = [eng.submit(img) for img in x]
    res = eng.run()
    np.testing.assert_array_equal(np.stack([res[r].logits for r in rids]),
                                  effnet_fixture["logits"][:2])
    head = eng.stages[0].run(torch.from_numpy(x))
    assert stage_digests(head.numpy()) == list(
        effnet_fixture["stage_sha256"][0][:2])


@pytest.fixture(scope="module")
def mix_fixture():
    fix = np.load(MIX_BASE + ".npz")
    return {k: fix[k] for k in fix.files}


def test_fullwidth_mixed_widths_run_qnet_equals_reference_logits(
        mix_fixture):
    """The mixed 4/6/8 net (each Body block's input quantized at its
    neighbour's width): the port's `run_qnet` on all 8 images, 0 of 8000
    logits apart from the JAX package's, and every stage digest equal."""
    from repro_torch.core import compiler as CC, cu, graph as G, qnet as Q

    qnet = Q.load_qnet(MIX_BASE + ".qnet")
    widths = [b.ops[0].act_bits for b in qnet.spec.blocks
              if b.name.startswith("irb")]
    assert widths == [MIX_CYCLE[i % 3] for i in range(len(widths))]
    assert {op.act_bits for _, op in qnet.spec.all_ops()} == {4, 6, 8}
    assert all(len({op.act_bits for op in b.ops}) == 1
               for b in qnet.spec.blocks)
    assert G.op_act_bits(qnet.spec)["stem/conv"] == 8
    pq = cu.prepare_qnet(qnet, device="cpu")
    x = images()
    np.testing.assert_array_equal(cu.run_qnet(pq, x).numpy(),
                                  mix_fixture["logits"])
    s, z = cu.input_qparams(pq)
    y = cu.quantize_input(torch.from_numpy(x), pq.input_scale, z)
    for i, sig in enumerate(CC.compile_net(pq.spec).stage_signatures()):
        y, s, z = cu.run_blocks(y, sig.blocks, pq, s, z)
        assert stage_digests(y.numpy()) == list(
            mix_fixture["stage_sha256"][i]), f"stage {i} ({sig.cu}) differs"


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--regen", nargs="?", const="mobilenet_v2",
                    choices=sorted(FIXTURES),
                    help="rewrite a net's fixture with the JAX package "
                         "(default: mobilenet_v2)")
    net = ap.parse_args().regen
    if net:
        regen(net)
