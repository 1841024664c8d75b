"""The port's kernels' plain versions against the JAX Pallas kernels
(interpret mode, as the JAX package's own tests run them) at the shapes of
`tests/test_kernels_{pointwise,depthwise,fused_irb}.py`, and the fused-IRB
route against the JAX reference interpreter on every fusable block of the
MobileNetV2 goldens. Tolerance everywhere: exact.

On the CPU each kernel wrapper runs its plain version, so these tests also
drive the wrappers' CPU path."""
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
from repro_torch.kernels import ops as K
from repro_torch.kernels.depthwise_conv import depthwise_conv_q
from repro_torch.kernels.fused_irb import fused_irb_q
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


def test_wrappers_refuse_other_devices():
    x = torch.zeros(1, 4, 4, 8, dtype=torch.int32, device="meta")
    z = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="no kernel"):
        pointwise_conv_q(x, torch.zeros(8, 8, dtype=torch.int8),
                         torch.zeros(8), z, z, qmax=15)
    with pytest.raises(ValueError, match="no kernel"):
        depthwise_conv_q(x, torch.zeros(3, 3, 8, dtype=torch.int8),
                         torch.zeros(8), z, z)
