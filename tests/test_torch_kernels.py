"""The port's kernels' plain versions against the JAX Pallas kernels
(interpret mode, as the JAX package's own tests run them) at the shapes of
`tests/test_kernels_{pointwise,depthwise,fused_irb}.py`, and the fused-IRB
route against the JAX reference interpreter on every fusable block of the
MobileNetV2 goldens. Tolerance everywhere: exact.

On the CPU each kernel wrapper runs its plain version, so these tests also
drive the wrappers' CPU path. At the end, K2's, K4's and K5's `plan`
(which kernel variant, tile and K or E slices a launch takes on the card)
is checked for every shape the main paths and the card tests give them,
and K4's E split is emulated slice by slice against the reference."""
import itertools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import cu as rcu, integer_ops as RI, qnet as RQ
from repro.kernels.depthwise_conv import depthwise_conv_q as jax_dw
from repro.kernels.fused_irb import fused_irb_q as jax_irb
from repro.kernels.pointwise_conv import pointwise_conv_q as jax_pw
from repro_torch.core import cu
from repro_torch.convert import qnet_from_reference
from repro_torch.kernels import depthwise_conv as DW, fused_irb as FI
from repro_torch.kernels import ops as K
from repro_torch.kernels import pointwise_conv as PW
from repro_torch.kernels.common import requant_clip
from repro_torch.kernels.depthwise_conv import depthwise_conv_q
from repro_torch.kernels.fused_irb import fused_irb_q, fused_irb_q_plain
from repro_torch.kernels.pointwise_conv import pointwise_conv_q
from tests.regen_golden import build_net, fixture_paths


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a).astype(dtype))


def _pw_inputs(shape, cin, cout, *, in_qmax=15, zx=0, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, in_qmax + 1, (*shape, cin)).astype(np.int32)
    w = rng.integers(-7, 8, (cin, cout)).astype(np.int8)
    mult = rng.uniform(0.001, 0.01, cout).astype(np.float32)
    bias = rng.integers(-3, 4, cout).astype(np.int32)
    zpc = (np.int32(zx) * w.astype(np.int32).sum(0)).astype(np.int32)
    return x, w, mult, zpc, bias


@pytest.mark.parametrize("shape,cin,cout,zx,qmax", [
    ((2, 8, 8), 16, 32, 0, 15),      # PW op on NHWC activations
    ((2, 7, 7), 24, 56, 0, 15),      # odd spatial
    ((4,), 48, 10, 0, 15),           # DENSE op on [B, C] (classifier)
    ((1, 3, 5), 100, 36, 0, 15),     # C_in / C_out with no 2^7 divisor
    ((2, 6, 6), 8, 1280, 0, 15),     # wide tail pw
    ((2, 5, 5), 32, 24, -128, 15),   # nonzero input zero point
    ((2, 5, 5), 32, 24, 117, 15),
    ((2, 6, 6), 16, 16, 0, 255),     # act8
])
def test_pointwise_plain_equals_jax_kernel(shape, cin, cout, zx, qmax):
    x, w, mult, zpc, bias = _pw_inputs(shape, cin, cout, in_qmax=qmax, zx=zx)
    want = jax_pw(jnp.asarray(x), jnp.asarray(w, jnp.int32),
                  jnp.asarray(mult), jnp.asarray(zpc), jnp.asarray(bias),
                  qmax=qmax, block_m=32, block_n=32, block_k=32,
                  interpret=True)
    got = pointwise_conv_q(_t(x, np.int32), _t(w, np.int8),
                           _t(mult, np.float32), _t(zpc, np.int32),
                           _t(bias, np.int32), qmax=qmax)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pointwise_plain_clips_negatives_like_jax_kernel():
    x, w, mult, zpc, bias = _pw_inputs((2, 4, 4), 16, 8, seed=2)
    bias = bias - 10  # negative before the clip
    want = jax_pw(jnp.asarray(x), jnp.asarray(w, jnp.int32),
                  jnp.asarray(mult), jnp.asarray(zpc), jnp.asarray(bias),
                  qmax=15, block_m=16, block_n=8, block_k=16, interpret=True)
    got = pointwise_conv_q(_t(x, np.int32), _t(w, np.int8),
                           _t(mult, np.float32), _t(zpc, np.int32),
                           _t(bias, np.int32), qmax=15)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.min()) == 0


@pytest.mark.parametrize("h,w,c,k,s,bc,qmax", [
    (8, 8, 16, 3, 1, 8, 15),
    (8, 8, 16, 3, 2, 16, 15),
    (9, 9, 8, 3, 1, 8, 15),       # odd spatial
    (11, 13, 8, 3, 2, 8, 15),     # odd + rectangular + stride 2
    (12, 12, 32, 5, 1, 8, 15),    # 5x5 kernel (EfficientNet)
    (10, 10, 24, 5, 2, 8, 15),
    (16, 16, 128, 3, 1, 128, 15),
    (8, 8, 16, 3, 1, 8, 255),     # act8
])
def test_depthwise_plain_equals_jax_kernel(h, w, c, k, s, bc, qmax):
    """With zcorr = 0 (input zero point 0, as on the served path) the JAX
    kernel's float correction and the port's integer one coincide."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 16, (2, h, w, c)).astype(np.int32)
    wq = rng.integers(-7, 8, (k, k, c)).astype(np.int8)
    mult = rng.uniform(0.001, 0.01, c).astype(np.float32)
    b = rng.integers(-3, 3, c).astype(np.int32)
    want = jax_dw(jnp.asarray(x), jnp.asarray(wq, jnp.int32),
                  jnp.asarray(mult), jnp.zeros(c, jnp.float32),
                  jnp.asarray(b), kernel=k, stride=s, qmax=qmax, block_c=bc,
                  interpret=True)
    got = depthwise_conv_q(_t(x, np.int32), _t(wq, np.int8),
                           _t(mult, np.float32),
                           torch.zeros(c, dtype=torch.int32),
                           _t(b, np.int32), kernel=k, stride=s, qmax=qmax)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("h,w,c,k,s,zx,qmax", [
    (8, 8, 16, 3, 1, 5, 15),
    (11, 13, 8, 3, 2, -117, 255),  # odd + rectangular + stride 2, act8
    (12, 12, 32, 5, 1, 120, 255),  # 5x5 kernel (EfficientNet)
    (10, 9, 24, 5, 2, -3, 15),
])
def test_depthwise_plain_equals_jax_integer_ops(h, w, c, k, s, zx, qmax):
    """A nonzero input zero point: the integer correction zpc = z_x * wsum
    before the multiply, as the JAX reference interpreter's datapath
    (`int_depthwise_shifts` + `quantized_op_epilogue`) applies it."""
    rng = np.random.default_rng(4)
    x = rng.integers(0, qmax + 1, (2, h, w, c)).astype(np.int32)
    wq = rng.integers(-127, 128, (k, k, c)).astype(np.int8)
    mult = rng.uniform(0.0005, 0.01, c).astype(np.float32)
    b = rng.integers(-20, 20, c).astype(np.int32)
    wsum = wq.astype(np.int32).sum((0, 1))
    acc = RI.int_depthwise_shifts(jnp.asarray(x), jnp.asarray(wq, jnp.int32),
                                  stride=s)
    want = RI.quantized_op_epilogue(acc, jnp.asarray(zx, jnp.int32),
                                    jnp.asarray(wsum), jnp.asarray(b),
                                    jnp.asarray(mult), qmax)
    got = depthwise_conv_q(_t(x, np.int32), _t(wq, np.int8),
                           _t(mult, np.float32), _t(zx * wsum, np.int32),
                           _t(b, np.int32), kernel=k, stride=s, qmax=qmax)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("h,w,c,e,co,s,bh", [
    (8, 8, 8, 32, 16, 1, 4),
    (8, 8, 16, 64, 16, 1, 8),
    (9, 9, 8, 24, 16, 2, 4),
    (12, 16, 16, 96, 24, 2, 3),
    (8, 8, 8, 48, 8, 1, 2),
    (16, 16, 24, 144, 32, 1, 16),  # MobileNet-ish geometry
])
def test_fused_irb_plain_equals_jax_kernel(h, w, c, e, co, s, bh):
    """With zcorr = 0 and no residual the JAX kernel's float forms and the
    port's integer forms coincide."""
    rng = np.random.default_rng(1)
    x = rng.integers(0, 16, (2, h, w, c)).astype(np.int32)
    w1 = rng.integers(-7, 8, (c, e)).astype(np.int8)
    w2 = rng.integers(-7, 8, (3, 3, e)).astype(np.int8)
    w3 = rng.integers(-7, 8, (e, co)).astype(np.int8)
    stages = []
    for n in (e, e, co):
        stages.append((rng.uniform(0.001, 0.01, n).astype(np.float32),
                       rng.integers(-2, 3, n).astype(np.int32)))
    (m1, b1), (m2, b2), (m3, b3) = stages
    zf = [jnp.zeros(n, jnp.float32) for n in (e, e, co)]
    want = jax_irb(jnp.asarray(x), jnp.asarray(w1, jnp.int32),
                   jnp.asarray(m1), zf[0], jnp.asarray(b1),
                   jnp.asarray(w2, jnp.int32), jnp.asarray(m2), zf[1],
                   jnp.asarray(b2), jnp.asarray(w3, jnp.int32),
                   jnp.asarray(m3), zf[2], jnp.asarray(b3), stride=s,
                   block_h=bh, interpret=True)
    zi = [torch.zeros(n, dtype=torch.int32) for n in (e, e, co)]
    got = fused_irb_q(_t(x, np.int32), _t(w1, np.int8), _t(m1, np.float32),
                      zi[0], _t(b1, np.int32), _t(w2, np.int8),
                      _t(m2, np.float32), zi[1], _t(b2, np.int32),
                      _t(w3, np.int8), _t(m3, np.float32), zi[2],
                      _t(b3, np.int32), stride=s)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", [4, 8])
def test_fused_irb_equals_reference_run_block_on_golden(bits):
    """Every fusable block of the MobileNetV2 golden, through the fused
    route (plain version here), equals the JAX `cu.run_block` on the same
    input — residual blocks and nonzero expand zero points included."""
    qnet_path, npz_path = fixture_paths("mobilenet_v2", bits)
    ref = RQ.load_qnet(qnet_path, build_net("mobilenet_v2", bits))
    pq = cu.prepare_qnet(qnet_from_reference(ref), device="cpu")
    x = np.load(npz_path)["input"]
    s, z = rcu.input_qparams(ref)
    y = rcu.quantize_input(jnp.asarray(x), s, z, 8)
    checked = 0
    for block in ref.spec.blocks:
        want, ws, wz = rcu.run_block(y, block, ref, s, z)
        if K.fusable_irb(block):
            got, gs, gz = K.run_irb_block(
                torch.from_numpy(np.array(y)), block, pq, s, z)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=block.name)
            assert (gs, gz) == (ws, wz)
            checked += 1
        y, s, z = want, ws, wz
    assert checked == 16


def _irb_e_split(x_q, w1, m1, z1, b1, w2, m2, z2, b2, w3, m3, z3, b3, *,
                 eslice, kernel, stride, qmax, residual=False, res_q=None):
    """K4's split of E on the card, in plain PyTorch: each slice of
    `eslice` expanded channels is expanded, depthwised and projected on
    its own into an int32 partial (float64 products: exact); the partials
    are added, then the projection epilogue and the residual run once."""
    acc = 0
    for e0 in range(0, w1.shape[1], eslice):
        sl = slice(e0, e0 + eslice)
        e = PW.pointwise_conv_q_plain(x_q, w1[:, sl], m1[sl], z1[sl], b1[sl],
                                      qmax=qmax)
        d = DW.depthwise_conv_q_plain(e, w2[..., sl], m2[sl], z2[sl], b2[sl],
                                      kernel=kernel, stride=stride, qmax=qmax)
        acc = acc + torch.matmul(d.to(torch.float64),
                                 w3[sl].to(torch.float64)).to(torch.int32)
    y = requant_clip(acc, m3, b3, qmax, zpc=z3)
    if residual:
        y = cu.residual_add(x_q, res_q[0], res_q[1], y, *res_q[2:], qmax)
    return y


@pytest.mark.parametrize("bits", [4, 8])
def test_fused_irb_e_split_emulation_equals_run_block(bits):
    """Every fusable block of the MobileNetV2 goldens (the compact
    EfficientNet's blocks all carry SE, so none is fusable), cut into the E slices
    `fused_irb.plan` gives the fixture's batch and into slices of one
    chunk, equals `fused_irb_q_plain` and the JAX `cu.run_block` bit for
    bit (small widths: the goldens' own)."""
    qnet_path, npz_path = fixture_paths("mobilenet_v2", bits)
    ref = RQ.load_qnet(qnet_path, build_net("mobilenet_v2", bits))
    pq = cu.prepare_qnet(qnet_from_reference(ref), device="cpu")
    x = np.load(npz_path)["input"]
    s, z = rcu.input_qparams(ref)
    y = rcu.quantize_input(jnp.asarray(x), s, z, 8)
    checked = 0
    for block in ref.spec.blocks:
        want, ws, wz = rcu.run_block(y, block, ref, s, z)
        if K.fusable_irb(block):
            tensors, kw, _, _ = K.irb_args(block, pq, s, z)
            xt = torch.from_numpy(np.array(y))
            b, h, w, c = xt.shape
            e, c_out = tensors[0].shape[1], tensors[8].shape[1]
            p = FI.plan(b, h, w, c, e, c_out, kw["kernel"], kw["stride"])
            plain = fused_irb_q_plain(xt, *tensors, **kw)
            np.testing.assert_array_equal(plain.numpy(), np.asarray(want),
                                          err_msg=block.name)
            for eslice in sorted({p.eslice, FI.CHUNK}):
                got = _irb_e_split(xt, *tensors, eslice=eslice, **kw)
                assert torch.equal(got, plain), (block.name, eslice)
            checked += 1
        y, s, z = want, ws, wz
    assert checked == 16


def test_wrappers_refuse_other_devices():
    x = torch.zeros(1, 4, 4, 8, dtype=torch.int32, device="meta")
    z = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="no kernel"):
        pointwise_conv_q(x, torch.zeros(8, 8, dtype=torch.int8),
                         torch.zeros(8), z, z, qmax=15)
    with pytest.raises(ValueError, match="no kernel"):
        depthwise_conv_q(x, torch.zeros(3, 3, 8, dtype=torch.int8),
                         torch.zeros(8), z, z)


# ---------------------------------------------------------------------------
# K2's, K4's and K5's `plan`: a legal answer for every shape the main paths, the
# [lm] phase of chip_smoke.py and the card tests give them (plain Python,
# no card needed)
# ---------------------------------------------------------------------------

from repro_torch.configs import llama32_1b  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core.qnet import build_netspec, read_qnet_meta  # noqa: E402
from repro_torch.kernels import quant_matmul as QM  # noqa: E402
from tests import torch_lm_cases as LMC  # noqa: E402

_ROOT = os.path.dirname(__file__)
_VISION_QNETS = [os.path.join(_ROOT, "golden_torch",
                              "mobilenet_v2_alpha1_224_act8.qnet")] + [
    os.path.join(_ROOT, "golden", f"{model}_act{bits}.qnet")
    for model in ("mobilenet_v2", "efficientnet_compact") for bits in (4, 8)]


def _pw_launches(spec: G.NetSpec, batch: int):
    """(m, k, n) of every pointwise-kernel launch of the per-op route
    (the stage executors' default routes: PW/DENSE ops but the hsigmoid
    excite, and each SE squeeze on the pooled [batch, C])."""
    h, shapes = spec.input_hw, []
    for block in spec.blocks:
        for op in block.ops:
            if op.kind in (G.CONV, G.DW):
                h = -(-h // op.stride)
            elif op.kind in (G.PW, G.DENSE) and op.act != G.HSIGMOID:
                shapes.append((batch * h * h, op.in_ch, op.out_ch))
            if block.se is not None and block.se_after == op.name:
                shapes.append((batch, block.se.channels, block.se.reduced))
        if block.avgpool:
            h = 1
    return shapes


def _pw_cases():
    shapes = set()
    for path in _VISION_QNETS:
        spec = build_netspec(read_qnet_meta(path)["build"])
        for batch in (1, 2, 4, 8):
            shapes.update((m, k, n, None) for m, k, n in
                          _pw_launches(spec, batch))
    # tests/test_torch_cuda.py
    shapes.update((297, 40, 70, tile) for tile in
                  itertools.product(PW.BLOCKS_M, PW.BLOCKS_N, PW.BLOCKS_K))
    shapes.update({(8, 1280, 1000, None), (98, 320, 1280, None),
                   (15, 100, 36, None), (12544, 24, 144, None),
                   (15, 100, 36, (None, None, 32)),
                   (2, 37, 20, (None, None, 32)), (392, 32, 16, None)})
    return sorted(shapes, key=str)


@pytest.mark.parametrize("m,k,n,tile", _pw_cases(), ids=str)
def test_pointwise_plan_is_legal(m, k, n, tile):
    bm, bn, bk = tile or (None, None, None)
    p = PW.plan(m, k, n, block_m=bm, block_n=bn, block_k=bk)
    got, splits, ksplit = p
    assert got[0] in PW.BLOCKS_M and got[1] in PW.BLOCKS_N
    assert got[2] in PW.BLOCKS_K
    assert tile is None or all(t in (None, g) for t, g in zip(tile, got))
    assert splits >= 1 and ksplit % got[2] == 0  # whole k steps
    assert (splits - 1) * ksplit < k <= splits * ksplit  # none empty
    if splits > 1:  # only where the tiles leave SMs idle
        assert -(-m // got[0]) * -(-n // got[1]) < PW.SMS
    assert p.workspace_numel(m, n) == (splits * m * n if splits > 1 else 0)


def test_pointwise_plan_main_path_choices():
    """MobileNetV2's three launches a micro-batch of 8: the Head's and the
    Tail's in one slice, the Classifier's 8 rows split along K."""
    assert PW.plan(100352, 32, 16)[:2] == ((64, 16, 32), 1)
    assert PW.plan(392, 320, 1280).splits == 1
    assert PW.plan(8, 1280, 1000).splits > 1


def _irb_launches(spec: G.NetSpec, batch: int):
    """(b, h, w, c, e, c_out, kernel, stride) of every fused-IRB launch of
    the served route (`ops.fusable_irb` blocks)."""
    h, shapes = spec.input_hw, []
    for block in spec.blocks:
        if K.fusable_irb(block):
            pw1, dw, pw3 = block.ops
            shapes.append((batch, h, h, pw1.in_ch, pw1.out_ch, pw3.out_ch,
                           dw.kernel, dw.stride))
        for op in block.ops:
            if op.kind in (G.CONV, G.DW):
                h = -(-h // op.stride)
        if block.avgpool:
            h = 1
    return shapes


def _irb_cases():
    shapes = set()
    for path in _VISION_QNETS:
        spec = build_netspec(read_qnet_meta(path)["build"])
        for batch in (1, 2, 4, 8):
            shapes.update(_irb_launches(spec, batch))
    # tests/test_torch_cuda.py
    shapes.update({(2, 8, 8, 8, 32, 16, 3, 1), (2, 9, 9, 8, 24, 16, 3, 2),
                   (2, 12, 19, 16, 96, 24, 3, 2),
                   (2, 14, 14, 32, 144, 32, 3, 1),
                   (2, 13, 11, 24, 72, 24, 5, 1),
                   (2, 10, 10, 16, 96, 40, 5, 2),
                   (2, 7, 7, 160, 960, 320, 3, 1),
                   (2, 57, 55, 17, 100, 17, 3, 1),
                   (2, 9, 9, 8, 100, 16, 3, 1), (2, 9, 7, 12, 100, 12, 5, 1),
                   (2, 7, 7, 160, 960, 160, 3, 1),
                   (8, 7, 7, 160, 960, 160, 3, 1),
                   (8, 7, 7, 160, 960, 320, 3, 1),
                   (8, 14, 14, 96, 576, 160, 3, 2),
                   (8, 14, 14, 64, 384, 64, 3, 1),
                   (8, 28, 28, 32, 192, 32, 3, 1)})
    return sorted(shapes)


@pytest.mark.parametrize("b,h,w,c,e,c_out,kernel,stride", _irb_cases(),
                         ids=str)
def test_fused_irb_plan_is_legal(b, h, w, c, e, c_out, kernel, stride):
    p = FI.plan(b, h, w, c, e, c_out, kernel, stride)
    (th, tw), nacc, splits, eslice = p
    ho, wo = -(-h // stride), -(-w // stride)
    assert (th, tw) == FI.default_tile(ho, wo, c_out)
    assert nacc in FI.NACCS and th * tw * c_out <= nacc * FI.THREADS
    assert eslice >= FI.CHUNK and eslice % FI.CHUNK == 0  # whole chunks
    assert (splits - 1) * eslice < e <= splits * eslice  # none empty
    assert p.smem_bytes(c, c_out, kernel, stride) <= FI.SMEM_MAX
    tiles = -(-ho // th) * -(-wo // tw)
    if splits > 1:  # only where the tiles leave SMs idle
        assert tiles * b < PW.SMS
    assert p.workspace_numel(b * ho * wo, c_out) == (
        splits * b * ho * wo * c_out if splits > 1 else 0)


def test_fused_irb_plan_main_path_choices():
    """MobileNetV2 (alpha 1.0, 224) at batch 8: E split at 14x14 and 7x7,
    one slice at 56x56 and 28x28."""
    spec = build_netspec(read_qnet_meta(_VISION_QNETS[0])["build"])
    launches = _irb_launches(spec, 8)
    assert len(launches) == 16
    by_out = {}
    for b, h, w, c, e, c_out, k, s in launches:
        by_out.setdefault(-(-h // s), []).append(
            FI.plan(b, h, w, c, e, c_out, k, s).splits)
    assert sorted(by_out) == [7, 14, 28, 56]
    assert all(n > 1 for n in by_out[7] + by_out[14])
    assert by_out[28] == [1] * 3 and by_out[56] == [1] * 2


def _record_pointwise_inputs(monkeypatch):
    """Route `ops`' pointwise calls through a spy that keeps each input's
    (min, max); returns that list."""
    seen, real = [], K.pointwise_conv_q

    def spy(x_q, *args, **kw):
        seen.append((int(x_q.min()), int(x_q.max())))
        return real(x_q, *args, **kw)

    monkeypatch.setattr(K, "pointwise_conv_q", spy)
    return seen


@pytest.mark.parametrize("path", _VISION_QNETS[1:], ids=os.path.basename)
def test_pointwise_inputs_lie_in_kernel_domain(path, monkeypatch):
    """On the card K2 narrows its int32 x to u8 unchecked, so its domain is
    x in [0, 255]. Every activation the served route hands it (after the
    input quantizer, `requant_clip`, `residual_add`, `mean_round` and the
    SE gate) lies there, for each golden net on its fixture's images."""
    from repro_torch.core.qnet import load_qnet
    from repro_torch.serve.vision.stages import compile_stages

    seen = _record_pointwise_inputs(monkeypatch)
    x = torch.from_numpy(np.load(path[:-len(".qnet")] + ".npz")["input"])
    for stage in compile_stages(load_qnet(path), body_fast_path="on",
                                op_kernels="on", device="cpu"):
        x = stage.run(x)
    assert len(seen) >= 3  # Head, Tail and Classifier at least
    assert all(0 <= lo and hi <= 255 for lo, hi in seen), seen


def _record_irb_inputs(monkeypatch):
    """Route `ops`' fused-IRB calls through a spy that keeps each input's
    (min, max); returns that list."""
    seen, real = [], K.fused_irb_q

    def spy(x_q, *args, **kw):
        seen.append((int(x_q.min()), int(x_q.max())))
        return real(x_q, *args, **kw)

    monkeypatch.setattr(K, "fused_irb_q", spy)
    return seen


_FUSED_QNETS = [p for p in _VISION_QNETS if "efficientnet" not in p]


@pytest.mark.parametrize("path", _FUSED_QNETS, ids=os.path.basename)
def test_fused_irb_inputs_lie_in_kernel_domain(path, monkeypatch):
    """On the card K4 narrows its int32 x to u8 unchecked (`narrow4`), so
    its domain is x in [0, 255]. Every golden net with a fusable Body, on
    its fixture's images (the full-width one on its first image), through
    the served route: one call a fused block, every input in the domain."""
    from repro_torch.core.qnet import load_qnet
    from repro_torch.serve.vision.stages import compile_stages
    from tests.test_torch_fullwidth import images

    spec = build_netspec(read_qnet_meta(path)["build"])
    fused = sum(K.fusable_irb(block) for block in spec.blocks)
    assert fused == 16  # MobileNetV2's Body (the compact EfficientNet: 0)
    seen = _record_irb_inputs(monkeypatch)
    x = (images()[:1] if "golden_torch" in path
         else np.load(path[:-len(".qnet")] + ".npz")["input"])
    y = torch.from_numpy(x)
    for stage in compile_stages(load_qnet(path), body_fast_path="on",
                                device="cpu"):
        y = stage.run(y)
    assert len(seen) == fused
    assert all(0 <= lo and hi <= 255 for lo, hi in seen), seen


def _qmm_cases():
    cases = set()
    cfg = llama32_1b.get_config()
    for _, k, n in LMC.layer_linears(cfg):
        for bits, group in LMC.SCHEMES.values():
            for m, dtype in ((8, "float32"), (8, "bfloat16"),
                             (512, "bfloat16")):
                cases.add((m, k, n, group or k, bits, dtype))
    # tests/test_torch_cuda.py
    for m in (1, 7, 8, 16, 17, 33, 64, 512):
        for n in (24, 512):
            for k, group in ((256, 256), (256, 128), (136, 8)):
                for bits in (8, 4):
                    for dtype in ("float32", "bfloat16"):
                        cases.add((m, k, n, group, bits, dtype))
    cases.update({(8, 8192, 2048, 8192, 4, "float32"),
                  (8, 2048, 1024, 128, 4, "bfloat16"),
                  (512, 2048, 512, 2048, 4, "bfloat16"),
                  (96, 2048, 256, 128, 4, "float32"),
                  (5, 300, 70, 300, 8, "float32"),
                  (6, 128, 64, 32, 4, "bfloat16")})
    return sorted(cases)


@pytest.mark.parametrize("m,k,n,group,bits,dtype", _qmm_cases(), ids=str)
def test_quant_matmul_plan_is_legal(m, k, n, group, bits, dtype):
    p = QM.plan(m, k, n, group, bits, getattr(torch, dtype))
    assert p.variant in QM.VARIANTS and p.splits >= 1
    tensor_ok = ((n * bits // 8) % 16 == 0 and k % 8 == 0
                 and (group == k or group % 16 == 0))
    if p.variant == "tiled":
        assert p.splits == 1 and not tensor_ok
    else:  # group boundaries on 16-deep k steps, whole 16-byte weight rows
        assert tensor_ok and p.ksplit % QM.K_STEP == 0  # whole k steps
        assert (p.splits - 1) * p.ksplit < k <= p.splits * p.ksplit
        assert (p.variant == "decode") == (m <= QM.DECODE_MAX_M)
    assert p.workspace_numel(m, n) == (
        p.splits * m * n if p.splits > 1 else 0)
    if m == 8 and tensor_ok:  # the [lm] phase's expectations
        assert p.variant == "decode"
    if m == 512 and tensor_ok:
        assert p.variant == "mma"


def test_quant_matmul_plan_unaligned_pointers_take_tiled():
    assert QM.plan(8, 2048, 2048, 2048, 8, torch.float32,
                   aligned=False).variant == "tiled"
    assert QM.plan(512, 2048, 2048, 2048, 8, torch.bfloat16,
                   aligned=False).variant == "tiled"
