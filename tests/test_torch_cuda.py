"""The port's CUDA kernels against their plain PyTorch versions on the card,
over geometries the main path does not reach (odd sizes, 5x5, stride 2,
nonzero zero points, residual, ragged tiles, every pointwise tile), and the
served golden route on the card; then the fixed-point requant, the integer
skip-add, the 1-D convolutions (float64 and float32 `F.conv1d`), fixed-point
`run_qnet` and the streaming engine on its full-width fixtures, each against
the port on the CPU; then the training front end (a tiny config trained on
the card against the CPU port, restart bitwise on the card, export proven
bit-exact through K2-K4), the route autotuner and tuned serving (both
golden nets and both full-width fixtures tuned on the card), and the
mixed-precision search (a small search timed on the card, its mixed export
served there equal to the CPU). Exact
equality for the integer kernels and
routes. The split-K, split-E, variant and determinism cases check `plan`'s
choices through the kernels' per-variant counters.
The float LM kernels sum in another order than their plain versions: the
quantized matmul is held at rtol 1e-5 / atol 1e-3 and decode attention at
rtol 1e-5 / atol 1e-5, the JAX tests' tolerances (bf16 outputs: one bf16
rounding apart). Imports no JAX: the machine with the card need not have
it.

Marked `cuda`: they skip where there is no card. On a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import ops as K
from repro_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_plain,
)
from repro_torch.kernels.depthwise_conv import (
    depthwise_conv_q,
    depthwise_conv_q_plain,
)
from repro_torch.kernels import fused_irb as FI
from repro_torch.kernels.fused_irb import fused_irb_q, fused_irb_q_plain
from repro_torch.kernels.pointwise_conv import (
    BLOCKS_K,
    BLOCKS_M,
    BLOCKS_N,
    plan as pw_plan,
    pointwise_conv_q,
    pointwise_conv_q_plain,
)
from repro_torch.kernels.quant_matmul import (
    plan as qmm_plan,
    quant_matmul,
    quant_matmul_plain,
)
from repro_torch.core.qnet import load_qnet
from repro_torch.models.lm.common import kv_quant
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


@pytest.mark.parametrize("shape,cin,cout,block_k", [
    ((8,), 1280, 1000, None),  # the Classifier's launch
    ((1, 3, 5), 100, 36, 32),  # K not a multiple of 32: a short last slice
    ((2,), 37, 20, 32),        # K % 4 != 0: x read a value at a time
])
def test_pointwise_split_k(dev, shape, cin, cout, block_k):
    """Few rows: K split across blocks, the int32 partials added by the
    epilogue pass; the same bits as the plain version, one launch."""
    rng = np.random.default_rng(5)
    x = _rand(rng, dev, (*shape, cin), 0, 256, torch.int32)
    w = _rand(rng, dev, (cin, cout), -127, 128, torch.int8)
    mult, zpc, bias = _consts(rng, dev, cout, -9, w.to(torch.int32).sum(0))
    m = x.numel() // cin
    assert pw_plan(m, cin, cout, block_k=block_k).splits > 1
    K.reset_launch_counts()
    got = pointwise_conv_q(x, w, mult, zpc, bias, qmax=255, block_k=block_k)
    assert pointwise_conv_q.launches == 1
    assert pointwise_conv_q.variants == {"single": 0, "split_k": 1}
    _equal(got, pointwise_conv_q_plain(x, w, mult, zpc, bias, qmax=255))


@pytest.mark.parametrize("value", [0, 255])
@pytest.mark.parametrize("shape,cin,cout", [((8,), 1280, 1000),
                                            ((2, 14, 14), 32, 16)])
def test_pointwise_extreme_inputs(dev, value, shape, cin, cout):
    """All-0 and all-255 activations (the ends of the kernel's u8 domain)
    against weights at both ends of int8."""
    rng = np.random.default_rng(6)
    x = torch.full((*shape, cin), value, dtype=torch.int32, device=dev)
    w = torch.from_numpy(np.where(rng.random((cin, cout)) < 0.5, -128,
                                  127).astype(np.int8)).to(dev)
    mult, zpc, bias = _consts(rng, dev, cout, 0)
    mult = mult * 0.01  # keep some outputs off the clip
    _equal(pointwise_conv_q(x, w, mult, zpc, bias, qmax=255),
           pointwise_conv_q_plain(x, w, mult, zpc, bias, qmax=255))


@pytest.mark.parametrize("h,w,c,k,s", [
    (8, 8, 16, 3, 1), (11, 13, 8, 3, 2), (12, 12, 32, 5, 1), (10, 9, 24, 5, 2),
    (112, 112, 32, 3, 1), (56, 56, 144, 3, 2),
    # C % 4 != 0 (one channel a thread), W not a multiple of the 4-wide run
    (9, 13, 17, 3, 1), (9, 13, 17, 3, 2), (10, 11, 17, 5, 1),
    (10, 11, 17, 5, 2), (7, 9, 3, 3, 1), (7, 9, 3, 3, 2), (8, 6, 3, 5, 1),
    (8, 6, 3, 5, 2), (12, 10, 32, 3, 1), (5, 7, 8, 5, 1)])
def test_depthwise(dev, h, w, c, k, s):
    rng = np.random.default_rng(2)
    x = _rand(rng, dev, (2, h, w, c), 0, 256, torch.int32)
    wq = _rand(rng, dev, (k, k, c), -127, 128, torch.int8)
    mult, zpc, bias = _consts(rng, dev, c, 5, wq.to(torch.int32).sum((0, 1)))
    kw = dict(kernel=k, stride=s, qmax=255)
    _equal(depthwise_conv_q(x, wq, mult, zpc, bias, **kw),
           depthwise_conv_q_plain(x, wq, mult, zpc, bias, **kw))


def _dw_case(dev, shape, k, seed=2):
    rng = np.random.default_rng(seed)
    x = _rand(rng, dev, shape, 0, 256, torch.int32)
    wq = _rand(rng, dev, (k, k, shape[-1]), -127, 128, torch.int8)
    consts = _consts(rng, dev, shape[-1], 5, wq.to(torch.int32).sum((0, 1)))
    return x, wq, *consts


def test_depthwise_head_batch8(dev):
    """The Head's launch at batch 8 (8 x 112 x 112 x 32, 3x3, stride 1),
    one launch, equal bits over two calls."""
    args = _dw_case(dev, (8, 112, 112, 32), 3)
    kw = dict(kernel=3, stride=1, qmax=255)
    K.reset_launch_counts()
    got = depthwise_conv_q(*args, **kw)
    assert depthwise_conv_q.launches == 1
    _equal(got, depthwise_conv_q_plain(*args, **kw))
    _equal(depthwise_conv_q(*args, **kw), got)


@pytest.mark.parametrize("h,w,c,e,co,k,s,res", [
    (8, 8, 8, 32, 16, 3, 1, False),
    (9, 9, 8, 24, 16, 3, 2, False),
    (12, 19, 16, 96, 24, 3, 2, False),   # ragged last tile column
    (14, 14, 32, 144, 32, 3, 1, True),   # residual
    (13, 11, 24, 72, 24, 5, 1, True),    # 5x5, odd, residual, ragged
    (10, 10, 16, 96, 40, 5, 2, False),
    (7, 7, 160, 960, 320, 3, 1, False),  # irb16 geometry
    (57, 55, 17, 100, 17, 3, 1, True),   # C, E not multiples of 4
    # E split (4 slices: 32, 32, 32, 4), E not a multiple of splits x 32
    (9, 9, 8, 100, 16, 3, 1, False),
    (9, 7, 12, 100, 12, 5, 1, True),
    (7, 7, 160, 960, 160, 3, 1, True),   # irb14/15 geometry, residual
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


def _irb_case(dev, b, h, w, c, e, co, k, s, res, seed=4):
    rng = np.random.default_rng(seed)
    x = _rand(rng, dev, (b, h, w, c), 0, 256, torch.int32)
    w1 = _rand(rng, dev, (c, e), -127, 128, torch.int8)
    w2 = _rand(rng, dev, (k, k, e), -127, 128, torch.int8)
    w3 = _rand(rng, dev, (e, co), -127, 128, torch.int8)
    args = (x, w1, *_consts(rng, dev, e, -120, w1.to(torch.int32).sum(0)),
            w2, *_consts(rng, dev, e), w3, *_consts(rng, dev, co))
    kw = dict(kernel=k, stride=s, qmax=255, residual=res,
              res_q=(0.05, -7.0, 0.04, -110.0, 0.06, -3.0) if res else None)
    return args, kw


# (b, h, w, c, e, co, k, s, residual): MobileNetV2's 7x7 and 14x14 blocks at
# batch 8, a 28x28 one (a single slice), and E = 100 in 4 slices
IRB_SPLIT_CASES = [
    (8, 7, 7, 160, 960, 160, 3, 1, True),    # irb14/15
    (8, 7, 7, 160, 960, 320, 3, 1, False),   # irb16
    (8, 14, 14, 96, 576, 160, 3, 2, False),  # irb13
    (8, 14, 14, 64, 384, 64, 3, 1, True),    # irb7..9
    (8, 28, 28, 32, 192, 32, 3, 1, True),    # irb4/5: one slice
    (2, 9, 9, 8, 100, 16, 3, 1, False),
]


@pytest.mark.parametrize("case", IRB_SPLIT_CASES, ids=str)
def test_fused_irb_plan_choice_is_recorded(dev, case):
    """The launch took the variant `plan` chose (split E or one slice), once,
    and gave the plain version's bits."""
    args, kw = _irb_case(dev, *case)
    b, h, w, c, e, co, k, s, _ = case
    splits = FI.plan(b, h, w, c, e, co, k, s).splits
    assert (splits > 1) == (h <= 14 or e == 100)
    K.reset_launch_counts()
    got = fused_irb_q(*args, **kw)
    assert fused_irb_q.launches == 1
    assert fused_irb_q.variants == {"single": int(splits == 1),
                                    "split_e": int(splits > 1)}
    _equal(got, fused_irb_q_plain(*args, **kw))


@pytest.mark.parametrize("case", IRB_SPLIT_CASES[:2], ids=str)
def test_fused_irb_forced_one_slice_at_7x7(dev, case, monkeypatch):
    """At 7x7 a plan forced to one slice (one block walks all of E) gives
    the bits of the split launch and of the plain version."""
    args, kw = _irb_case(dev, *case)
    split = fused_irb_q(*args, **kw)
    p = FI.plan(*case[:-1])
    assert p.splits > 1
    one = p._replace(splits=1, eslice=-(-case[4] // FI.CHUNK) * FI.CHUNK)
    monkeypatch.setattr(FI, "plan", lambda *a: one)
    K.reset_launch_counts()
    got = fused_irb_q(*args, **kw)
    assert fused_irb_q.variants == {"single": 1, "split_e": 0}
    _equal(got, split)
    _equal(got, fused_irb_q_plain(*args, **kw))


def test_depthwise_and_fused_irb_deterministic(dev):
    """Two calls give equal bits: K3 at the Head's shape, K4 split in 30
    slices at 7x7 and in 6 at 14x14."""
    args = _dw_case(dev, (8, 112, 112, 32), 3, seed=7)
    kw = dict(kernel=3, stride=1, qmax=255)
    _equal(depthwise_conv_q(*args, **kw), depthwise_conv_q(*args, **kw))
    for case in IRB_SPLIT_CASES[1], IRB_SPLIT_CASES[3]:
        args, kw = _irb_case(dev, *case, seed=8)
        _equal(fused_irb_q(*args, **kw), fused_irb_q(*args, **kw))


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
                                     "fused_irb_q": 16, "quant_matmul": 0,
                                     "decode_attention": 0}
    np.testing.assert_array_equal(np.stack([res[r].logits for r in rids]),
                                  fix["logits"])


@pytest.mark.parametrize("model,bits", [("mobilenet_v2", 8),
                                        ("efficientnet_compact", 4)])
def test_pointwise_inputs_lie_in_kernel_domain_on_card(dev, model, bits,
                                                       monkeypatch):
    """K2 narrows its int32 x to u8 unchecked: every activation the served
    route hands it on the card lies in its domain [0, 255]."""
    from repro_torch.core.qnet import load_qnet
    from repro_torch.serve.vision.stages import compile_stages

    seen, real = [], K.pointwise_conv_q

    def spy(x_q, *args, **kw):
        seen.append((int(x_q.min()), int(x_q.max())))
        return real(x_q, *args, **kw)

    monkeypatch.setattr(K, "pointwise_conv_q", spy)
    base = os.path.join(GOLDEN, f"{model}_act{bits}")
    x = torch.from_numpy(np.load(base + ".npz")["input"]).to(dev)
    for stage in compile_stages(load_qnet(base + ".qnet"), device=dev):
        x = stage.run(x)
    assert len(seen) >= 3
    assert all(0 <= lo and hi <= 255 for lo, hi in seen), seen


@pytest.mark.parametrize("model,bits", [("mobilenet_v2", 4),
                                        ("mobilenet_v2", 8)])
def test_fused_irb_inputs_lie_in_kernel_domain_on_card(dev, model, bits,
                                                       monkeypatch):
    """K4 narrows its int32 x to u8 unchecked (`narrow4`): every input the
    served route hands it on the card lies in its domain [0, 255], one call
    a fused block."""
    from repro_torch.core.qnet import build_netspec, load_qnet, read_qnet_meta
    from repro_torch.serve.vision.stages import compile_stages

    seen, real = [], K.fused_irb_q

    def spy(x_q, *args, **kw):
        seen.append((int(x_q.min()), int(x_q.max())))
        return real(x_q, *args, **kw)

    monkeypatch.setattr(K, "fused_irb_q", spy)
    base = os.path.join(GOLDEN, f"{model}_act{bits}")
    spec = build_netspec(read_qnet_meta(base + ".qnet")["build"])
    x = torch.from_numpy(np.load(base + ".npz")["input"]).to(dev)
    for stage in compile_stages(load_qnet(base + ".qnet"),
                                body_fast_path="on", device=dev):
        x = stage.run(x)
    assert len(seen) == sum(K.fusable_irb(b) for b in spec.blocks) == 16
    assert all(0 <= lo and hi <= 255 for lo, hi in seen), seen


# ---------------------------------------------------------------------------
# LM kernels: quantized matmul (K5) and decode attention (K6)
# ---------------------------------------------------------------------------

QMM_TOL = dict(rtol=1e-5, atol=1e-3)
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_OUT_TOL = dict(rtol=2**-7, atol=1e-5)  # one bf16 rounding apart


def _normal(rng, shape, dev, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
        device=dev, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 7, 8, 16, 17, 33, 64, 512])
@pytest.mark.parametrize("n", [24, 512])
@pytest.mark.parametrize("k,group", [(256, None), (256, 128), (136, 8)])
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul(dev, bits, k, group, n, m, dtype):
    """Ragged M, N and K (136 = 4 tiles of 32 and 8), scale groups that
    straddle the kernel's K tile; bf16 x comes with bf16 scales."""
    rng = np.random.default_rng(10)
    w = _normal(rng, (k, n), dev) * k ** -0.5
    wq, sc = K.quantize_weight_for_matmul(w, bits=bits, group_size=group)
    x = _normal(rng, (m, k), dev, dtype)
    sc = sc.to(dtype)
    got = quant_matmul(x, wq, sc, bits=bits)
    want = quant_matmul_plain(x, wq, sc, bits=bits)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (m, n)
    torch.testing.assert_close(got, want, **QMM_TOL)


@pytest.mark.parametrize("m,k,n,group,bits,variant", [
    (8, 256, 512, None, 8, "decode"),
    (16, 256, 512, 128, 4, "decode"),
    (17, 256, 512, None, 8, "mma"),
    (64, 256, 512, 128, 4, "mma"),
    (8, 136, 512, 8, 4, "tiled"),    # groups of 8: not a 16-deep k step
    (33, 136, 512, 8, 8, "tiled"),
    (8, 256, 24, None, 8, "tiled"),  # 24-byte weight rows
])
def test_quant_matmul_plan_variant(dev, m, k, n, group, bits, variant):
    """`plan` picks the variant from the shapes, and that variant ran."""
    rng = np.random.default_rng(16)
    wq, sc = K.quantize_weight_for_matmul(_normal(rng, (k, n), dev), bits=bits,
                                          group_size=group)
    x = _normal(rng, (m, k), dev, torch.bfloat16)
    assert qmm_plan(m, k, n, group or k, bits, x.dtype).variant == variant
    K.reset_launch_counts()
    got = quant_matmul(x, wq, sc, bits=bits)
    assert quant_matmul.launches == 1
    assert quant_matmul.variants == {v: int(v == variant)
                                     for v in ("tiled", "decode", "mma")}
    torch.testing.assert_close(got, quant_matmul_plain(x, wq, sc, bits=bits),
                               **QMM_TOL)


@pytest.mark.parametrize("m,k,n,group,dtype", [
    (8, 8192, 2048, None, torch.float32),    # decode, 32 slices of K
    (8, 2048, 1024, 128, torch.bfloat16),
    (512, 2048, 512, None, torch.bfloat16),  # mma, 4 slices of K
    (96, 2048, 256, 128, torch.float32),     # mma, three bf16 terms
])
def test_quant_matmul_deterministic(dev, m, k, n, group, dtype):
    """Split K, partials added in a fixed order: two calls, the same bits."""
    rng = np.random.default_rng(17)
    wq, sc = K.quantize_weight_for_matmul(_normal(rng, (k, n), dev) * k ** -0.5,
                                          bits=4, group_size=group)
    x = _normal(rng, (m, k), dev, dtype)
    assert qmm_plan(m, k, n, group or k, 4, dtype).splits > 1
    a, b = quant_matmul(x, wq, sc, bits=4), quant_matmul(x, wq, sc, bits=4)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    torch.testing.assert_close(a, quant_matmul_plain(x, wq, sc, bits=4),
                               **QMM_TOL)


def test_quant_matmul_f32_x_bf16_scales(dev):
    """`init_linear`'s layout: f32 activations, bf16 scales [1, N]."""
    rng = np.random.default_rng(11)
    wq = torch.from_numpy(rng.integers(-127, 128, (300, 70)).astype(
        np.int8)).to(dev)
    sc = (torch.rand(1, 70, device=dev) * 0.01).to(torch.bfloat16)
    x = _normal(rng, (5, 300), dev)
    torch.testing.assert_close(quant_matmul(x, wq, sc, bits=8),
                               quant_matmul_plain(x, wq, sc, bits=8),
                               **QMM_TOL)


def _cache(rng, dev, b, s, kv, dh, kind):
    k, v = _normal(rng, (b, s, kv, dh), dev), _normal(rng, (b, s, kv, dh), dev)
    if kind.startswith("int8"):
        (k, ks), (v, vs) = kv_quant(k), kv_quant(v)
        if kind == "int8_f32":
            ks, vs = ks.float(), vs.float()
        return k, v, ks, vs
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    return k.to(dtype), v.to(dtype), None, None


@pytest.mark.parametrize("kind", ["int8", "int8_f32", "bf16", "f32"])
@pytest.mark.parametrize("rep,dh", [(1, 32), (4, 64), (8, 128)])
@pytest.mark.parametrize("s,vlen", [(64, 64), (100, 37), (300, 300),
                                    (300, 129)])
def test_decode_attention(dev, kind, rep, dh, s, vlen):
    """S not a multiple of the kernel's tile; rep 8 x dh 128 needs more
    than 48 KB of shared memory; kv_len as an int and as a 0-dim device
    tensor."""
    rng = np.random.default_rng(12)
    b, kv = 2, 3
    q = _normal(rng, (b, kv, rep, dh), dev)
    k, v, ks, vs = _cache(rng, dev, b, s, kv, dh, kind)
    want = decode_attention_plain(q, k, v, vlen, ks, vs)
    got = decode_attention(q, k, v, vlen, ks, vs)
    got_t = decode_attention(q, k, v, torch.tensor(vlen, dtype=torch.int32,
                                                   device=dev), ks, vs)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **ATTN_TOL)
    assert torch.equal(got, got_t)


def test_decode_attention_bf16_queries(dev):
    rng = np.random.default_rng(13)
    q = _normal(rng, (2, 2, 4, 64), dev, torch.bfloat16)
    k, v, ks, vs = _cache(rng, dev, 2, 200, 2, 64, "int8")
    got = decode_attention(q, k, v, 150, ks, vs)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, decode_attention_plain(q, k, v, 150, ks,
                                                           vs),
                               **BF16_OUT_TOL)


def test_lm_kernels_refuse_before_launch(dev):
    """A wrong type or a non-contiguous input raises before any launch."""
    K.reset_launch_counts()
    rng = np.random.default_rng(14)
    x = _normal(rng, (8, 64), dev)
    wq = torch.zeros((64, 32), dtype=torch.int8, device=dev)
    sc = torch.ones((1, 32), device=dev)
    with pytest.raises(TypeError):
        quant_matmul(x.to(torch.float16), wq, sc, bits=8)
    with pytest.raises(TypeError):
        quant_matmul(x, wq.to(torch.uint8), sc, bits=8)
    with pytest.raises(TypeError):
        quant_matmul(x, wq, sc.to(torch.float16), bits=8)
    with pytest.raises(ValueError, match="contiguous"):
        quant_matmul(_normal(rng, (64, 8), dev).t(), wq, sc, bits=8)
    with pytest.raises(ValueError, match="contiguous"):
        quant_matmul(x, torch.zeros((32, 64), dtype=torch.int8,
                                    device=dev).t(), sc, bits=8)
    q = _normal(rng, (1, 2, 4, 16), dev)
    k, v, ks, vs = _cache(rng, dev, 1, 40, 2, 16, "int8")
    with pytest.raises(TypeError):
        decode_attention(q.to(torch.float16), k, v, 40, ks, vs)
    with pytest.raises(TypeError):
        decode_attention(q, k.to(torch.int16), v.to(torch.int16), 40)
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                         v, 40, ks, vs)
    with pytest.raises(TypeError):
        decode_attention(q, k, v, torch.tensor(40, device=dev), ks, vs)
    assert K.launch_counts()["quant_matmul"] == 0
    assert K.launch_counts()["decode_attention"] == 0


def test_lm_entry_points_count_launches(dev):
    rng = np.random.default_rng(15)
    wq, sc = K.quantize_weight_for_matmul(_normal(rng, (128, 64), dev),
                                          bits=4, group_size=32)
    q = _normal(rng, (2, 1, 8, 16), dev)
    k, v, ks, vs = _cache(rng, dev, 2, 70, 2, 16, "int8")
    K.reset_launch_counts()
    y = K.quantized_linear(_normal(rng, (2, 3, 128), dev, torch.bfloat16),
                           wq, sc, bits=4)
    o = K.decode_attend(q, {"k": k, "v": v, "k_scale": ks, "v_scale": vs},
                        60)
    torch.cuda.synchronize()
    assert y.shape == (2, 3, 64) and y.dtype == torch.bfloat16
    assert o.shape == (2, 1, 8, 16)
    assert K.launch_counts() == {"pointwise_conv_q": 0, "depthwise_conv_q": 0,
                                 "fused_irb_q": 0, "quant_matmul": 1,
                                 "decode_attention": 1}


# K6 at the [lm] phase's shape (Llama-3.2-1B: B 8, KV 8, rep 4, dh 64, S 4096)
LM_SHAPE = (8, 8, 4, 64, 4096)


@pytest.fixture(scope="module")
def lm_caches(dev):
    b, kv, rep, dh, s = LM_SHAPE
    rng = np.random.default_rng(40)
    q = _normal(rng, (b, kv, rep, dh), dev)
    k, v = _normal(rng, (b, s, kv, dh), dev), _normal(rng, (b, s, kv, dh), dev)
    (k8, ks), (v8, vs) = kv_quant(k), kv_quant(v)
    return q, {"int8": (k8, v8, ks, vs),
               "bf16": (k.to(torch.bfloat16), v.to(torch.bfloat16), None,
                        None)}


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("kv_len", [1, 511, 512, 513, 3001, 4096])
def test_decode_attention_lm_shape(dev, lm_caches, kind, kv_len):
    """The [lm] shape splits S (`split_s`, counted once a call); kv_len on
    both sides of split boundaries, as an int and as a device tensor, gives
    the same bits, within tolerance of the plain version."""
    q, caches = lm_caches
    k, v, ks, vs = caches[kind]
    K.reset_launch_counts()
    got = decode_attention(q, k, v, kv_len, ks, vs)
    got_t = decode_attention(q, k, v, torch.tensor(kv_len, dtype=torch.int32,
                                                   device=dev), ks, vs)
    assert decode_attention.launches == 2
    assert decode_attention.variants == {"single": 0, "split_s": 2}
    torch.testing.assert_close(
        got, decode_attention_plain(q, k, v, kv_len, ks, vs), **ATTN_TOL)
    assert torch.equal(got, got_t)


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_decode_attention_forced_one_split(dev, lm_caches, kind,
                                           monkeypatch):
    """A plan forced to one split (one block walks all of S, no merge) is
    within tolerance of the split launch and of the plain version."""
    q, caches = lm_caches
    k, v, ks, vs = caches[kind]
    split = decode_attention(q, k, v, 3001, ks, vs)
    p = DA.plan(*LM_SHAPE, k.dtype)
    assert p.splits > 1
    one = p._replace(variant="single", splits=1, per_split=LM_SHAPE[-1])
    monkeypatch.setattr(DA, "plan", lambda *a, **kw: one)
    K.reset_launch_counts()
    got = decode_attention(q, k, v, 3001, ks, vs)
    assert decode_attention.variants == {"single": 1, "split_s": 0}
    torch.testing.assert_close(got, split, **ATTN_TOL)
    torch.testing.assert_close(
        got, decode_attention_plain(q, k, v, 3001, ks, vs), **ATTN_TOL)


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_decode_attention_deterministic(dev, lm_caches, kind):
    """Splits merged in a fixed order, no atomics: two calls, the same
    bits."""
    q, caches = lm_caches
    k, v, ks, vs = caches[kind]
    n = torch.tensor(4096, dtype=torch.int32, device=dev)
    a = decode_attention(q, k, v, n, ks, vs)
    b = decode_attention(q, k, v, n, ks, vs)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_decode_attention_unaligned_cache_scalar_path(dev, kind):
    """Caches one element past a 16-byte boundary (an offset view) take the
    scalar loads, within tolerance of the plain version and of the aligned
    16-byte path."""
    rng = np.random.default_rng(41)
    b, s, kv, rep, dh = 2, 300, 2, 4, 64
    q = _normal(rng, (b, kv, rep, dh), dev)
    k, v, ks, vs = _cache(rng, dev, b, s, kv, dh, kind)

    def offset(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    ku, vu = offset(k), offset(v)
    assert ku.data_ptr() % 16 and vu.data_ptr() % 16 and ku.is_contiguous()
    assert not DA.layout(kv, rep, dh, k.dtype, aligned=False).vec
    assert DA.layout(kv, rep, dh, k.dtype).vec
    got = decode_attention(q, ku, vu, 257, ks, vs)
    torch.testing.assert_close(
        got, decode_attention_plain(q, k, v, 257, ks, vs), **ATTN_TOL)
    torch.testing.assert_close(got, decode_attention(q, k, v, 257, ks, vs),
                               **ATTN_TOL)


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("kv,dh", [(4, 32), (2, 32), (8, 16)])
def test_decode_attention_heads_a_warp(dev, kind, kv, dh):
    """Short rows: a warp reads adjacent kv heads of a position together."""
    rng = np.random.default_rng(42)
    b, s, rep = 2, 300, 4
    q = _normal(rng, (b, kv, rep, dh), dev)
    k, v, ks, vs = _cache(rng, dev, b, s, kv, dh, kind)
    assert DA.layout(kv, rep, dh, k.dtype).heads > 1
    torch.testing.assert_close(decode_attention(q, k, v, 290, ks, vs),
                               decode_attention_plain(q, k, v, 290, ks, vs),
                               **ATTN_TOL)


@pytest.mark.parametrize("drift", ["blocks_per_sm", "rows", "vec"])
def test_decode_attention_launcher_refuses_a_drifted_layout(dev, monkeypatch,
                                                            drift):
    """The launcher takes the wrapper's layout and only checks it: another
    blocks an SM than its launch bounds, rows it has no instantiation
    for, or 16-byte loads of an unaligned cache are refused, not run."""
    rng = np.random.default_rng(43)
    b, s, kv, rep, dh = 2, 300, 2, 4, 64
    q = _normal(rng, (b, kv, rep, dh), dev)
    k, v, ks, vs = _cache(rng, dev, b, s, kv, dh, "int8")
    if drift == "vec":  # one byte past a 16-byte boundary
        k, v = (torch.empty(t.numel() + 1, dtype=t.dtype,
                            device=dev)[1:].view(t.shape) for t in (k, v))
    p, lay = DA.launch_plan(q, k, v)
    bad = {"blocks_per_sm": lay._replace(blocks_per_sm=lay.blocks_per_sm + 1),
           "rows": lay._replace(rows=8),  # int8 has no 8-row kernel
           "vec": DA.layout(kv, rep, dh, k.dtype)}[drift]
    bad_p = DA.plan(b, kv, rep, dh, s, k.dtype, aligned=bad.vec)
    if drift == "rows":  # the shared memory of the drifted layout
        bad_p = bad_p._replace(smem_bytes=DA.smem_bytes(
            bad, 1, dh, bad_p.tile, quant=True))
    assert bad != lay
    monkeypatch.setattr(DA, "launch_plan", lambda *a: (bad_p, bad))
    with pytest.raises(RuntimeError, match="launch failed"):
        decode_attention(q, k, v, 257, ks, vs)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# fixed point, the 1-D ops and the streaming engine on the card, against the
# port on the CPU (which the CPU tests hold against the JAX package)
# ---------------------------------------------------------------------------


def _on(dev, *arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


@pytest.mark.parametrize("shift", [0, 1, 2, 17, 31, 40, 44, 47])
def test_requantize_fixedpoint_on_card(dev, shift):
    """int64 products, the sign * 2^(shift-1) rounding bias and the
    arithmetic right shift on CUDA, at the shift edges: negative
    accumulators, ties, shift 0, shifts over 40."""
    from repro_torch.core.integer_ops import requantize_fixedpoint

    rng = np.random.default_rng(100 + shift)
    acc = np.concatenate([rng.integers(-(2**31), 2**31 - 1, 4096),
                          [0, 1, -1, 2**31 - 1, -(2**31), 3, -3, 5, -5]]
                         ).astype(np.int32)
    mant = rng.integers(2**30, 2**31, acc.size).astype(np.int64)
    if shift > 0:
        mant[-4:] = np.int64(1) << (shift - 1)
    sh = np.full(acc.shape, shift, np.int32)
    want = requantize_fixedpoint(*(torch.from_numpy(a)
                                   for a in (acc, mant, sh)))
    got = requantize_fixedpoint(*_on(dev, acc, mant, sh))
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("seed", range(4))
def test_int_residual_add_on_card(dev, seed):
    from repro_torch.core.integer_ops import (int_residual_add,
                                              residual_fixed_consts)

    rng = np.random.default_rng(200 + seed)
    a_s, b_s, y_s = rng.uniform(0.005, 0.05, 3)
    a_z, b_z, y_z = rng.uniform(-40, 0, 3)
    consts = residual_fixed_consts(a_s, a_z, b_s, b_z, y_s, y_z)
    a, b = (rng.integers(0, 256, (8, 25, 64)).astype(np.int32)
            for _ in range(2))
    want = int_residual_add(torch.from_numpy(a), torch.from_numpy(b),
                            consts, 255)
    got = int_residual_add(*_on(dev, a, b), consts, 255)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("k,s", [(3, 1), (5, 2), (5, 1)])
@pytest.mark.parametrize("pad", ["SAME", (0, 0), (2, 1), (1, 3)])
def test_conv1d_ops_on_card(dev, k, s, pad):
    """`F.conv1d` in float64, and in float32 with cuDNN's TF32 off inside
    the op (left on outside, its default), equal the CPU port; so does the
    shifted int32 depthwise."""
    from repro_torch.core import integer_ops as io

    rng = np.random.default_rng(10 * k + s)
    x = rng.integers(0, 256, (64, 49, 10)).astype(np.int32)
    w = rng.integers(-127, 128, (k, 10, 64)).astype(np.int32)
    wd = rng.integers(-127, 128, (k, 10)).astype(np.int32)
    xc = torch.from_numpy(x)
    want = io.int_conv1d(xc, torch.from_numpy(w.astype(np.float64)), s, pad)
    xd, w64, w32 = _on(dev, x, w.astype(np.float64), w.astype(np.float32))
    assert torch.equal(io.int_conv1d(xd, w64, s, pad).cpu(), want)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        assert io.f32_accum_exact(w, 255)
        got = io.int_conv1d_f32(xd, w32, s, pad)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = before
    assert torch.equal(got.cpu(), want)
    want = io.int_depthwise1d_shifts(xc, torch.from_numpy(wd), s, pad)
    got = io.int_depthwise1d_shifts(xd, *_on(dev, wd), s, pad)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("model,bits", [("mobilenet_v2", 4),
                                        ("mobilenet_v2", 8),
                                        ("efficientnet_compact", 4),
                                        ("efficientnet_compact", 8),
                                        ("dscnn_kws", 8)])
def test_run_qnet_fixed_point_on_card(dev, model, bits):
    """The goldens in fixed point on the card equal the CPU port, which the
    CPU tests hold against the JAX package under x64."""
    from repro_torch.core import cu

    base = os.path.join(GOLDEN, f"{model}_act{bits}")
    qnet, x = load_qnet(base + ".qnet"), np.load(base + ".npz")["input"]
    want = cu.run_qnet(qnet, x, device="cpu", fixed_point=True)
    got = cu.run_qnet(qnet, x, device=dev, fixed_point=True)
    assert torch.equal(got.cpu(), want)


def _stream_cases():
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_stream_cases
    return torch_stream_cases


@pytest.mark.parametrize("case,fixed", [("kws", False), ("kws", True),
                                        ("har", False)])
def test_stream_engine_on_card(dev, case, fixed):
    """The full-width streaming fixtures served on the card through
    `drain()`'s bucketed batches: 0 logits differ from the fixture (the JAX
    package's `run_qnet` over every window, which the CPU port equals)."""
    from repro_torch.serve.stream import StreamEngine

    SC = _stream_cases()
    c = SC.CASES[case]
    qnet_path, npz_path = SC.paths(case)
    want = np.load(npz_path)["logits_fixed" if fixed else "logits_float"]
    eng = StreamEngine(load_qnet(qnet_path), c["hop"], fixed_point=fixed,
                       device=dev, max_sessions=c["sessions"],
                       batch_buckets=SC.BUCKETS)
    assert eng.device.type == "cuda"
    sids = [eng.open_session() for _ in range(c["sessions"])]
    for sid, fr in zip(sids, SC.frames(case)):
        eng.push(sid, fr, defer=True)
    by = {(r.sid, r.window): r.logits for r in eng.drain()}
    got = np.stack([by[(sid, w)] for sid in sids
                    for w in range(c["windows"])])
    assert int(np.sum(got != want)) == 0
    bufs = eng._sessions[sids[0]].buffers
    assert all(v.device.type == "cuda" for v in bufs.values())
    # one session stepped alone on the card equals its batched rows
    one = StreamEngine(load_qnet(qnet_path), c["hop"], fixed_point=fixed,
                       device=dev)
    res = one.push(one.open_session(), SC.frames(case)[0])
    np.testing.assert_array_equal(np.stack([r.logits for r in res]),
                                  want[:c["windows"]])


# ---------------------------------------------------------------------------
# observability, the energy model and multi-model serving on the card
# ---------------------------------------------------------------------------


def _golden(model, bits):
    base = os.path.join(GOLDEN, f"{model}_act{bits}")
    return base + ".qnet", np.load(base + ".npz")


@pytest.mark.parametrize("model,bits", [("mobilenet_v2", 8),
                                        ("efficientnet_compact", 4),
                                        ("efficientnet_compact", 8)])
def test_obs_on_is_bit_exact_on_card(dev, model, bits):
    """A traced, metered drain on the card serves the logits of an
    untraced one and of the JAX package's goldens; the trace validates,
    every request span is closed, and each stage's dispatch is a span on
    its own track."""
    from repro_torch.obs import MetricsRegistry, Tracer, validate_chrome_trace

    path, fix = _golden(model, bits)
    x = np.concatenate([fix["input"]] * 2)
    got = {}
    for obs in (False, True):
        tracer, reg = (Tracer(), MetricsRegistry()) if obs else (None, None)
        eng = VisionEngine.from_artifact(path, buckets=(2,), device=dev,
                                         tracer=tracer, metrics=reg)
        rids = [eng.submit(img) for img in x]
        res = eng.run()
        got[obs] = np.stack([res[r].logits for r in rids])
    np.testing.assert_array_equal(got[True], got[False])
    np.testing.assert_array_equal(got[True], np.concatenate([fix["logits"]]
                                                            * 2))
    doc = tracer.to_chrome()
    assert validate_chrome_trace(doc) == []
    ends = [ev for ev in doc["traceEvents"]
            if ev["ph"] == "e" and ev["name"] == "request"]
    assert sorted(ev["id"] for ev in ends) == rids
    dispatch = {ev["name"]: ev["tid"] for ev in doc["traceEvents"]
                if ev["ph"] == "X" and ev["name"].startswith("dispatch:")}
    assert dispatch == {f"dispatch:{st.spec.cu}": 10 + i
                        for i, st in enumerate(eng.stages)}
    snap = reg.snapshot()
    assert snap["counters"]['serve_requests_completed_total{model="default"}'
                            ] == len(x)
    st = eng.stats()
    assert st.device == str(dev) and st.power_source == "constant:cuda"
    assert st.fps_per_watt > 0 and st.stage_retraces == {
        s.spec.cu: 0 for s in eng.stages}


@pytest.mark.parametrize("bits", [4, 8])
def test_multimodel_engine_on_card_serves_both_goldens(dev, bits):
    """`MultiModelEngine` over MobileNetV2 and the compact EfficientNet on
    the card, one shared tracer: both nets' logits equal the goldens, each
    micro-batch launches what `ops.served_launches` works out from its
    plan, and the router dispatched each net's micro-batches."""
    from repro_torch.core import compiler as CC
    from repro_torch.obs import Tracer, validate_chrome_trace
    from repro_torch.serve.vision import MultiModelEngine

    tracer = Tracer()
    engines, fixes = {}, {}
    for model in ("mobilenet_v2", "efficientnet_compact"):
        path, fixes[model] = _golden(model, bits)
        engines[model] = VisionEngine.from_artifact(
            path, buckets=(2,), device=dev, tracer=tracer, name=model)
    mm = MultiModelEngine(engines)
    handles = {m: [mm.submit(m, img) for img in f["input"]]
               for m, f in fixes.items()}
    K.reset_launch_counts()
    res = mm.run()
    want = dict.fromkeys(K.launch_counts(), 0)
    for eng in engines.values():
        for k, v in K.served_launches(CC.compile_net(eng.pq.spec)).items():
            want[k] += v
    assert K.launch_counts() == want
    for m, hs in handles.items():
        np.testing.assert_array_equal(
            np.stack([res[h].logits for h in hs]), fixes[m]["logits"])
    assert sorted(m for m, _ in mm.dispatch_log) == sorted(engines)
    assert validate_chrome_trace(tracer.to_chrome()) == []


def test_power_capped_fleet_on_card(dev):
    """The fleet budget on the card: with the measured `cuda` idle draw and
    the modeled J/image, a budget just above idle defers work; the rolling
    watts stay under it at every run, no slo=1 request is shed, and every
    request is accounted for once the windows have passed."""
    from repro_torch.serve.vision import MultiModelEngine

    t = [0.0]

    def clock():
        t[0] += 1e-4
        return t[0]

    engines, fixes = {}, {}
    for model in ("mobilenet_v2", "efficientnet_compact"):
        path, fixes[model] = _golden(model, 8)
        engines[model] = VisionEngine.from_artifact(
            path, buckets=(2,), device=dev, name=model, shed_slo=0)
    idle = engines["mobilenet_v2"].energy.power.idle_w
    per_batch = max(2 * e.energy.j_per_image for e in engines.values())
    mm = MultiModelEngine(engines, clock=clock,
                          power_budget_w=idle + 1.5 * per_batch / 0.01,
                          power_window_s=0.01)
    slos = {}
    for i in range(6):
        for m, f in fixes.items():
            slos[mm.submit(m, f["input"][i % 2], slo=i % 2)] = i % 2
    results = {}
    for _ in range(20):
        results.update(mm.run())
        assert mm.governor.watts(t[0]) <= mm.governor.budget_w * (1 + 1e-9)
        if not any(mm.pending().values()):
            break
        t[0] += 0.02
    assert set(results) == set(slos)
    assert all(results[h].status == "ok" for h, s in slos.items() if s == 1)
    stats = mm.stats()
    assert sum(s.n_deferred for s in stats.values()) > 0
    assert sum(s.n_ok + s.n_shed + s.n_expired for s in stats.values()) == \
        len(slos)
    for h, r in results.items():
        if r.status == "ok":
            f = fixes[h[0]]
            i = [k for k in slos if k[0] == h[0]].index(h)
            np.testing.assert_array_equal(r.logits, f["logits"][i % 2])


# --- the training front end on the card -------------------------------------

# the JAX trainer test's config (tests/test_train_vision.py)
TRAIN_CFG = dict(model="mobilenet_v2", alpha=0.35, input_hw=16,
                 num_classes=4, float_steps=4, qat_steps=4, batch=8,
                 anneal_from=8, calibrate_every=2, ckpt_every=2)


def _train_state(result):
    from repro_torch.train import tree as T
    from repro_torch.train import vision as V
    return T.leaves((result.params, result.opt_state,
                     V._obs_tree(result.observers)))


def test_train_steps_on_card_match_cpu(dev):
    """Every step of the config's schedule (float with BN batch stats,
    BN fusion, QAT at 8 then 4 activation bits) run on the card from the
    CPU run's params, optimizer state and batch: loss, gradients, updated
    params, BN running stats, fake-quantized activations and each online
    quantization round's observers within `repro_torch.train.parity`'s
    tolerances (the CPU tests' against the reference). The card's own run
    is finite."""
    from repro_torch.train import parity as P
    from repro_torch.train import vision as V

    cfg = V.VisionTrainConfig(**TRAIN_CFG)
    rep = P.verify_train_steps(cfg, device=dev)
    assert rep["failures"] == [], rep["failures"]
    assert len(rep["steps"]) == cfg.total_steps and len(rep["rounds"]) == 2
    assert np.isfinite(V.train(cfg, device=dev).history["loss"]).all()


@pytest.mark.parametrize("kill_at", [3, 7])
def test_train_restart_bitwise_on_card(dev, kill_at, tmp_path):
    from repro_torch.train import vision as V

    cfg = V.VisionTrainConfig(**TRAIN_CFG)
    straight = V.train(dataclasses.replace(cfg, ckpt_every=0), device=dev)
    V.train(cfg, ckpt_dir=str(tmp_path), stop_after=kill_at, device=dev)
    resumed = V.train(cfg, ckpt_dir=str(tmp_path), resume=True, device=dev)
    a, b = _train_state(straight), _train_state(resumed)
    assert len(a) == len(b) and all(x.device == y.device for x, y in
                                    zip(a, b))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert resumed.history["loss"] == straight.history["loss"]


def test_train_and_export_bit_exact_through_kernels_on_card(dev, tmp_path):
    """Trained and exported on the card: every route proven, the proof
    launching K2-K4 as two micro-batches, the artifact's logits equal to
    the port's `cu.run_qnet` on the CPU."""
    from repro_torch.core import compiler as CC
    from repro_torch.core import cu
    from repro_torch.train import vision as V

    cfg = V.VisionTrainConfig(**TRAIN_CFG)
    path = str(tmp_path / "tiny.qnet")
    result = V.train(cfg, device=dev)
    x = V.calibration_batches(cfg, "cpu")[0].numpy()
    K.reset_launch_counts()
    qnet, report = V.export(result.params, result.net, cfg, path=path,
                            observers=result.observers, verify_batch=x,
                            device=dev)
    per = K.served_launches(CC.compile_net(qnet.spec))
    assert per["fused_irb_q"] and per["pointwise_conv_q"] \
        and per["depthwise_conv_q"]
    assert K.launch_counts() == {k: 2 * v for k, v in per.items()}
    assert report["routes"][-1] == "engine" and report["device"] == str(dev)
    cpu = cu.run_qnet(load_qnet(path), x, device="cpu").numpy()
    np.testing.assert_array_equal(report["logits"], cpu)


# ---------------------------------------------------------------------------
# the route autotuner and tuned serving on the card
# ---------------------------------------------------------------------------

FULL = os.path.join(os.path.dirname(__file__), "golden_torch")
TUNE_CASES = {
    "golden_mobilenet_v2": ("golden", "mobilenet_v2_act8", None),
    "golden_efficientnet_compact": ("golden", "efficientnet_compact_act8",
                                    None),
    "full_mobilenet_v2": ("full", "mobilenet_v2_alpha1_224_act8", 224),
    "full_efficientnet_compact": ("full", "efficientnet_compact_h128_act8",
                                  128),
}
KERNEL_ROUTES = ("pallas_pw", "pallas_dw", "fused_irb")


@pytest.fixture(scope="module", params=sorted(TUNE_CASES))
def tuned_case(request, dev):
    """(qnet, images, the JAX package's logits, the plan tuned on the card):
    the golden fixtures' 2 images, the full-width fixtures' 8 (seeded as
    `chip_smoke.images`)."""
    from repro_torch.tune import tune_qnet

    where, name, hw = TUNE_CASES[request.param]
    base = os.path.join(GOLDEN if where == "golden" else FULL, name)
    fix = np.load(base + ".npz")
    q = load_qnet(base + ".qnet")
    x = fix["input"] if hw is None else np.random.default_rng(0).uniform(
        -1, 1, (8, hw, hw, 3)).astype(np.float32)
    plan = tune_qnet(q, batch=len(x), device=dev, repeats=1)
    return q, x, fix["logits"], plan


def test_tune_on_card_writes_a_cuda_cache(tuned_case):
    """The cache is the card's (`cuda` keys), covers the net, and no
    kernel candidate (K2, K3, K4) was disqualified: each ran and equalled
    the reference op."""
    q, _, _, plan = tuned_case
    assert plan.backend == "cuda"
    assert all(k.endswith(":cuda") for k in plan.entries)
    assert plan.coverage(q, backend="cuda") == 1.0
    bad = {k: v.disqualified for k, v in plan.entries.items()
           if any(d.startswith(KERNEL_ROUTES) for d in v.disqualified)}
    assert bad == {}
    assert all(v.us > 0 for v in plan.entries.values())


def test_tuned_serving_on_card_is_bit_exact(tuned_case, dev):
    """`VisionEngine(tuned=)` on the card: the JAX package's logits bit
    for bit, with the K2-K4 launches the resolved routes call for."""
    from repro_torch.core import compiler as CC

    q, x, want, plan = tuned_case
    eng = VisionEngine(q, buckets=(len(x),), device=dev, tuned=plan)
    eng.warmup()
    rids = [eng.submit(img) for img in x]
    K.reset_launch_counts()
    res = eng.run()
    np.testing.assert_array_equal(np.stack([res[r].logits for r in rids]),
                                  want)
    st = eng.stages[0]
    assert st.pq.routes
    assert K.launch_counts() == K.served_launches(
        CC.compile_net(q.spec), routes=st.pq.routes, fused=st.fused_blocks)


@pytest.mark.parametrize("case", ["golden_mobilenet_v2",
                                  "full_efficientnet_compact"])
def test_cpu_cache_resolves_nothing_on_card(dev, case):
    """A committed CPU cache resolves no route on the card: the prepared
    net carries none, and the tuned stages fill every op with the untuned
    card routes (K3, K2 and the SE squeezes' K2, K4), launching what the
    untuned engine launches, with the reference logits."""
    from repro_torch.core import compiler as CC
    from repro_torch.core import cu
    from repro_torch.tune import load_tuned

    where, name, hw = TUNE_CASES[case]
    base = os.path.join(GOLDEN if where == "golden" else FULL, name)
    fix = np.load(base + ".npz")
    x = fix["input"] if hw is None else np.random.default_rng(0).uniform(
        -1, 1, (8, hw, hw, 3)).astype(np.float32)
    model = case.split("_", 1)[1]
    cache = load_tuned(os.path.join(os.path.dirname(__file__), "..",
                                    "experiments", "tuned",
                                    f"{model}_act8_cpu.json"))
    q = load_qnet(base + ".qnet")
    assert cu.prepare_qnet(q, device=dev, tuned=cache).routes == {}
    assert cache.resolve(q, backend="cuda") == ({}, set())
    assert cache.coverage(q, backend="cuda") == 0.0
    eng = VisionEngine(q, buckets=(len(x),), device=dev, tuned=cache)
    rids = [eng.submit(img) for img in x]
    K.reset_launch_counts()
    res = eng.run()
    np.testing.assert_array_equal(np.stack([res[r].logits for r in rids]),
                                  fix["logits"])
    assert K.launch_counts() == K.served_launches(CC.compile_net(q.spec))


# ---------------------------------------------------------------------------
# the mixed-precision search on the card
# ---------------------------------------------------------------------------

PRECISION_CFG = dict(model="mobilenet_v2", alpha=0.35, input_hw=32,
                     num_classes=10, bits=4, act_bits=4, float_steps=2,
                     qat_steps=2, batch=8, calibrate_every=0, ckpt_every=0)


@pytest.fixture(scope="module")
def precision_case(dev):
    """A small search on the card: `fake_accuracy`, the real timer (every
    kernel candidate), ladder budget 3."""
    from repro_torch.train.vision import VisionTrainConfig
    from repro_torch.tune import precision as P

    cfg = VisionTrainConfig(**PRECISION_CFG)
    result = P.search_precision(cfg, choices=(4, 6, 8), ladder_budget=3,
                                accuracy_fn=P.fake_accuracy, device=dev)
    return cfg, result


def test_precision_search_on_card_is_fully_timed(precision_case, tmp_path):
    from repro_torch.tune import precision as P

    _, result = precision_case
    assert result.backend == "cuda" and result.tuned_batch == 8
    assert {p.tuned_fraction for p in result.points} == {1.0}
    assert all(p.us_per_image > 0 for p in result.points)
    path = P.write_pareto(result, str(tmp_path / "p.json"))
    # the schema and the recorded front; how many points the front keeps
    # depends on the card's timings, not on the code
    assert P.check_pareto_artifact(path, min_points=1)["backend"] == "cuda"


def test_precision_export_on_card_serves_as_the_cpu(precision_case, dev,
                                                     tmp_path):
    """A mixed point exported on the card (its route proof through K2-K4)
    and served by `VisionEngine` there: the port's CPU `run_qnet` over the
    same artifact bit for bit, launching what the resolved routes call
    for."""
    from repro_torch.core import compiler as CC
    from repro_torch.core import cu
    from repro_torch.tune import precision as P

    cfg, result = precision_case
    point = next(p for p in result.points if p.uniform is None)
    path = str(tmp_path / "mixed.qnet")
    report = P.export_point(cfg, point, path, device=dev,
                            accuracy_impl=P.QATFinetuneAccuracy(
                                cfg, steps=1, eval_batches=1, device=dev))
    assert report["routes"][-1] == "engine" and report["device"] == str(dev)
    q = load_qnet(path)
    assert len({op.act_bits for _, op in q.spec.all_ops()}) > 1
    x = np.random.default_rng(0).uniform(-1, 1, (8, 32, 32, 3)).astype(
        np.float32)
    eng = VisionEngine(q, buckets=(8,), device=dev)
    eng.warmup()
    rids = [eng.submit(img) for img in x]
    K.reset_launch_counts()
    res = eng.run()
    np.testing.assert_array_equal(
        np.stack([res[r].logits for r in rids]),
        cu.run_qnet(q, x, device="cpu").numpy())
    st = eng.stages[0]
    assert K.launch_counts() == K.served_launches(
        CC.compile_net(q.spec), routes=st.pq.routes, fused=st.fused_blocks)


# ---------------------------------------------------------------------------
# data-parallel replicas: several replicas of the one card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("model,bits", [("mobilenet_v2", 8),
                                        ("efficientnet_compact", 4)])
def test_replicated_engine_on_card_matches_golden(dev, model, bits, n):
    """`VisionEngine(mesh=)` over n replicas of the card: the goldens' logits
    bit for bit, each replica its own constants, and n times the kernel
    launches of one replica a micro-batch."""
    from repro_torch.core import compiler as CC
    from repro_torch.core import cu
    from repro_torch.dist.sharding import data_mesh

    path, fix = _golden(model, bits)
    mesh = data_mesh(n, devices=[dev] * n)
    eng = VisionEngine.from_artifact(path, buckets=(2,), mesh=mesh)
    eng.warmup()
    rids = [eng.submit(img) for img in fix["input"]]
    K.reset_launch_counts()
    res = eng.run()
    np.testing.assert_array_equal(
        np.stack([res[r].logits for r in rids]), fix["logits"])
    per = K.served_launches(CC.compile_net(eng.pq.spec))
    assert K.launch_counts() == {k: n * v for k, v in per.items()}
    assert eng.stats().replicas == n
    pq = eng.stages[0].pq
    if n > 1:
        assert isinstance(pq, cu.ReplicatedQNet)
        for name in pq.ops:
            assert len({r.ops[name].w_acc.data_ptr()
                        for r in pq.replicas}) == n


def test_compressed_psum_on_card_equals_cpu(dev):
    from repro_torch.dist.sharding import data_mesh
    from repro_torch.train import grad_compress as GC

    rng = np.random.default_rng(3)
    trees = [{"a": torch.from_numpy(rng.standard_normal((64, 96)).astype(
        np.float32) * 10.0 ** rng.integers(-3, 3, (64, 96))).to(
        torch.bfloat16), "b": torch.from_numpy(
        rng.standard_normal(33).astype(np.float32))} for _ in range(2)]
    errs = [{k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(
        np.float32) * 1e-2) for k, v in t.items()} for t in trees]
    want = GC.compressed_psum(trees, errs, data_mesh(2, devices=["cpu"] * 2))
    got = GC.compressed_psum([{k: v.to(dev) for k, v in t.items()}
                              for t in trees],
                             [{k: v.to(dev) for k, v in e.items()}
                              for e in errs],
                             data_mesh(2, devices=[dev, dev]))
    for w_side, g_side in zip(want, got):
        for w, g in zip(w_side, g_side):
            for k in w:
                assert g[k].device == dev and torch.equal(g[k].cpu(), w[k])


def test_pipeline_on_card_equals_cpu(dev):
    """`make_pp_loss` with both stages on the card against both on the CPU
    (reduced Llama, 4 layers, f32): the LM tests' f32 bounds."""
    from repro_torch.configs import reduced_config
    from repro_torch.dist import pp
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import model as M
    from repro_torch.train import tree as T
    from repro_torch.train.parity import LM_GRAD_L2, LM_LOSS_RTOL, _rel_l2
    from repro_torch.train.train_loop import value_and_grad

    cfg = dataclasses.replace(reduced_config("llama3.2-1b"),
                              dtype="float32", n_layers=4)
    params, _ = M.init_params(cfg, 0, device="cpu")
    params["layers"] = pp.split_stage_params(params["layers"], 2)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 16))).long()
    out = {}
    for side, devs in (("cpu", ["cpu"] * 2), ("card", [dev, dev])):
        loss_fn = pp.make_pp_loss(cfg, 2, 2)
        mesh = make_mesh((2,), ("pod",), devices=devs)
        p = T.tree_map(lambda t: t.to(devs[0]), params)
        out[side] = value_and_grad(lambda q, b: loss_fn(q, b, mesh), p,
                                   tokens.to(devs[0]))
    (lw, _, gw), (lg, _, gg) = out["cpu"], out["card"]
    assert abs(float(lg) - float(lw)) / abs(float(lw)) <= LM_LOSS_RTOL
    for a, b in zip(T.leaves(gw), T.leaves(gg)):
        assert _rel_l2(a.double(), b.cpu().double()) <= LM_GRAD_L2


def test_kernel_launches_under_its_input_device(dev):
    """A kernel called on a tensor of another card than the current one
    launches there (the wrappers' device guard). Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    other = torch.device("cuda", 1 - dev.index if dev.index < 2 else 0)
    rng = np.random.default_rng(0)
    x = _rand(rng, other, (2, 7, 7, 64), 0, 256, torch.int32)
    w = _rand(rng, other, (64, 96), -127, 128, torch.int8)
    mult, zpc, bias = _consts(rng, other, 96)
    with torch.cuda.device(dev):
        got = pointwise_conv_q(x, w, mult, zpc, bias, qmax=255)
    torch.cuda.synchronize(other)
    assert got.device == other
    _equal(got.cpu(), pointwise_conv_q_plain(
        x.cpu(), w.cpu(), mult.cpu(), zpc.cpu(), bias.cpu(), qmax=255))


def test_serve_cli_replicas_on_card(dev):
    """`--vision --replicas 2`: refused on a machine with one card (JAX's
    `data_mesh` text), served where there are two."""
    from repro_torch.launch import serve as CLI

    argv = ["--vision", "--hw", "32", "--batch", "4", "--requests", "4",
            "--replicas", "2"]
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError,
                           match="replicas=2 with 1 visible devices"):
            CLI.main(argv)
        return
    out = CLI.main(argv)
    assert all(r.status == "ok" for r in out["results"].values())
    assert all(st.replicas == 2 for st in out["stats"].values())
