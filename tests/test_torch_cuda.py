"""The port's CUDA kernels against their plain PyTorch versions on the card,
over geometries the main path does not reach (odd sizes, 5x5, stride 2,
nonzero zero points, residual, ragged tiles, every pointwise tile), and the
served golden route on the card. Exact equality everywhere. Imports no
JAX: the machine with the card need not have it.

Marked `cuda`: they skip where there is no card. On a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as K
from repro_torch.kernels.depthwise_conv import (
    depthwise_conv_q,
    depthwise_conv_q_plain,
)
from repro_torch.kernels.fused_irb import fused_irb_q, fused_irb_q_plain
from repro_torch.kernels.pointwise_conv import (
    BLOCKS_K,
    BLOCKS_M,
    BLOCKS_N,
    pointwise_conv_q,
    pointwise_conv_q_plain,
)
from repro_torch.serve.vision import VisionEngine

pytestmark = pytest.mark.cuda
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _rand(rng, dev, shape, lo, hi, dtype):
    return torch.from_numpy(rng.integers(lo, hi, shape)).to(dtype).to(dev)


def _consts(rng, dev, n, zx=0, wsum=None):
    mult = torch.from_numpy(rng.uniform(0.0005, 0.01, n).astype(
        np.float32)).to(dev)
    bias = _rand(rng, dev, n, -20, 20, torch.int32)
    zpc = (zx * wsum).to(torch.int32) if wsum is not None else \
        torch.zeros(n, dtype=torch.int32, device=dev)
    return mult, zpc, bias


def _equal(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert torch.equal(got, want), int((got - want).abs().max())


@pytest.mark.parametrize("tile", [(m, n, k) for m in BLOCKS_M
                                  for n in BLOCKS_N for k in BLOCKS_K])
def test_pointwise_every_tile(dev, tile):
    rng = np.random.default_rng(0)
    x = _rand(rng, dev, (3, 9, 11, 40), 0, 256, torch.int32)
    w = _rand(rng, dev, (40, 70), -127, 128, torch.int8)
    mult, zpc, bias = _consts(rng, dev, 70, -117, w.to(torch.int32).sum(0))
    bm, bn, bk = tile
    _equal(pointwise_conv_q(x, w, mult, zpc, bias, qmax=255, block_m=bm,
                            block_n=bn, block_k=bk),
           pointwise_conv_q_plain(x, w, mult, zpc, bias, qmax=255))


@pytest.mark.parametrize("shape,cin,cout", [
    ((8,), 1280, 1000), ((2, 7, 7), 320, 1280), ((1, 3, 5), 100, 36),
    ((4, 56, 56), 24, 144)])
def test_pointwise_shapes(dev, shape, cin, cout):
    rng = np.random.default_rng(1)
    x = _rand(rng, dev, (*shape, cin), 0, 256, torch.int32)
    w = _rand(rng, dev, (cin, cout), -127, 128, torch.int8)
    mult, zpc, bias = _consts(rng, dev, cout, 3, w.to(torch.int32).sum(0))
    _equal(pointwise_conv_q(x, w, mult, zpc, bias, qmax=255),
           pointwise_conv_q_plain(x, w, mult, zpc, bias, qmax=255))


@pytest.mark.parametrize("h,w,c,k,s", [
    (8, 8, 16, 3, 1), (11, 13, 8, 3, 2), (12, 12, 32, 5, 1), (10, 9, 24, 5, 2),
    (112, 112, 32, 3, 1), (56, 56, 144, 3, 2)])
def test_depthwise(dev, h, w, c, k, s):
    rng = np.random.default_rng(2)
    x = _rand(rng, dev, (2, h, w, c), 0, 256, torch.int32)
    wq = _rand(rng, dev, (k, k, c), -127, 128, torch.int8)
    mult, zpc, bias = _consts(rng, dev, c, 5, wq.to(torch.int32).sum((0, 1)))
    kw = dict(kernel=k, stride=s, qmax=255)
    _equal(depthwise_conv_q(x, wq, mult, zpc, bias, **kw),
           depthwise_conv_q_plain(x, wq, mult, zpc, bias, **kw))


@pytest.mark.parametrize("h,w,c,e,co,k,s,res", [
    (8, 8, 8, 32, 16, 3, 1, False),
    (9, 9, 8, 24, 16, 3, 2, False),
    (12, 19, 16, 96, 24, 3, 2, False),   # ragged last tile column
    (14, 14, 32, 144, 32, 3, 1, True),   # residual
    (13, 11, 24, 72, 24, 5, 1, True),    # 5x5, odd, residual, ragged
    (10, 10, 16, 96, 40, 5, 2, False),
    (7, 7, 160, 960, 320, 3, 1, False),  # irb16 geometry
    (57, 55, 17, 100, 17, 3, 1, True),   # C, E not multiples of 4
])
def test_fused_irb(dev, h, w, c, e, co, k, s, res):
    rng = np.random.default_rng(3)
    x = _rand(rng, dev, (2, h, w, c), 0, 256, torch.int32)
    w1 = _rand(rng, dev, (c, e), -127, 128, torch.int8)
    w2 = _rand(rng, dev, (k, k, e), -127, 128, torch.int8)
    w3 = _rand(rng, dev, (e, co), -127, 128, torch.int8)
    s1 = _consts(rng, dev, e, -120, w1.to(torch.int32).sum(0))
    s2 = _consts(rng, dev, e)
    s3 = _consts(rng, dev, co)
    args = (x, w1, *s1, w2, *s2, w3, *s3)
    kw = dict(kernel=k, stride=s, qmax=255, residual=res,
              res_q=(0.05, -7.0, 0.04, -110.0, 0.06, -3.0) if res else None)
    _equal(fused_irb_q(*args, **kw), fused_irb_q_plain(*args, **kw))


@pytest.mark.parametrize("model,bits", [("mobilenet_v2", 4),
                                        ("mobilenet_v2", 8),
                                        ("efficientnet_compact", 4),
                                        ("efficientnet_compact", 8)])
def test_served_golden_on_card(dev, model, bits):
    """The JAX package's 2-D goldens (read without JAX: the files are numpy
    and JSON), served on the card: MobileNetV2 through the fused kernel,
    the compact EfficientNet's SE blocks (hsigmoid gate, 5x5 depthwise)
    through the per-op kernels."""
    base = os.path.join(GOLDEN, f"{model}_act{bits}")
    fix = np.load(base + ".npz")
    eng = VisionEngine.from_artifact(base + ".qnet", buckets=(2,),
                                     device=dev)
    K.reset_launch_counts()
    rids = [eng.submit(img) for img in fix["input"]]
    res = eng.run()
    if model == "mobilenet_v2":
        assert K.launch_counts() == {"pointwise_conv_q": 3,
                                     "depthwise_conv_q": 1,
                                     "fused_irb_q": 16}
    np.testing.assert_array_equal(np.stack([res[r].logits for r in rids]),
                                  fix["logits"])
