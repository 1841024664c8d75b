"""The port's quantizers, observers, BN fusion, `quantize_net`/`save_qnet`,
AdamW and checkpoints against the JAX package's, on identical inputs made
with numpy from seeds.

Bit for bit (eager JAX on the CPU, which divides truly, as the port does):
`compute_scale_zp`, `quantize`, `dequantize`, `fake_quant` forward and its
clipped-STE gradient, `fake_quant_minmax`, the observers (true min/max and
EMA), `relu6_fused_qparams`, `quantize_net` (every field of every op, both
nets, act4 and act8, on the same float params and observers, and on the
port's own trained params and observers), the `.qnet` files read back by
either package, the 8-bit optimizer state, and checkpoints restored by
the other package. To rtol 1e-6: `fuse_bn`, `bn_apply`, and `apply_updates`
(its global norm, learning rate and bias corrections are reductions and
transcendentals that XLA and torch round differently in the last place).
"""
from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bn_fuse as RB
from repro.core import calibrate as RC
from repro.core import qnet as RQN
from repro.core import quant as RQ
from repro.models import efficientnet as R_EFFN
from repro.models import layers as RL
from repro.models import mobilenet_v2 as R_MNV2
from repro.train import checkpoint as RCK
from repro.train import optimizer as RO
from repro_torch import convert
from repro_torch.core import bn_fuse as PB
from repro_torch.core import calibrate as PC
from repro_torch.core import qnet as PQN
from repro_torch.core import quant as PQ
from repro_torch.train import checkpoint as PCK
from repro_torch.train import optimizer as PO
from repro_torch.train import tree as PT
from repro_torch.train import vision as PV

# reference programs compiled with XLA's algebraic simplifier off: it turns
# a division by a constant into a multiplication by the reciprocal, which
# eager JAX (the reference's own semantics) and the port do not
NO_ALGSIMP = {"xla_disable_hlo_passes": "algsimp"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side on one intra-op thread, as the other port test files
    under several workers: the default (every core, in each worker)
    oversubscribes the machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

CONFIGS = {
    "asym_tensor4": RQ.QuantConfig(4, symmetric=False),
    "asym_tensor8": RQ.QuantConfig(8, symmetric=False),
    "sym_channel4": RQ.QuantConfig(4, symmetric=True, channel_axis=-1),
    "sym_channel8": RQ.QuantConfig(8, symmetric=True, channel_axis=-1),
    "sym_channel0": RQ.QuantConfig(3, symmetric=True, channel_axis=0),
    "asym_channel1": RQ.QuantConfig(6, symmetric=False, channel_axis=1),
}


def _pcfg(cfg: RQ.QuantConfig) -> PQ.QuantConfig:
    kw = dataclasses.asdict(cfg)
    assert kw.pop("narrow_range")  # the port's only symmetric range
    return PQ.QuantConfig(**kw)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _eq(got, want):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _x(seed: int, shape=(4, 5, 6, 7)) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 2.0, shape).astype(np.float32)
    x.flat[::17] = 0.0  # exact zeros, and an all-positive slice
    x[..., 1] = np.abs(x[..., 1])
    return x


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", range(2, 9))
@pytest.mark.parametrize("symmetric", [False, True])
def test_quant_config_ranges(bits, symmetric):
    r = RQ.QuantConfig(bits, symmetric)
    p = PQ.QuantConfig(bits, symmetric)
    assert (p.qmin, p.qmax, p.levels) == (r.qmin, r.qmax, r.levels)
    if symmetric:
        assert PQ.symmetric_range(bits) == (r.qmin, r.qmax)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1])
def test_scale_zp_quantize_dequantize_bitwise(name, seed):
    cfg = CONFIGS[name]
    x = _x(seed)
    mn, mx = RQ.observe_range(jnp.asarray(x), cfg)
    pmn, pmx = PQ.observe_range(_t(x), _pcfg(cfg))
    _eq(pmn, mn)
    _eq(pmx, mx)
    s, z = RQ.compute_scale_zp(mn, mx, cfg)
    ps, pz = PQ.compute_scale_zp(pmn, pmx, _pcfg(cfg))
    _eq(ps, s)
    _eq(pz, z)
    q = RQ.quantize(jnp.asarray(x), s, z, cfg)
    pq = PQ.quantize(_t(x), ps, pz, _pcfg(cfg))
    _eq(pq, q)
    _eq(PQ.dequantize(pq, ps, pz, _pcfg(cfg)), RQ.dequantize(q, s, z, cfg))


def test_scale_zp_degenerate_ranges_bitwise():
    """Ranges entirely on one side of 0, and empty ones (scale -> 1)."""
    mn = np.array([0.0, -3.0, 0.5, -2.0, 0.0], np.float32)
    mx = np.array([0.0, -1.0, 4.0, 2.0, 7.25], np.float32)
    for cfg in (RQ.QuantConfig(4), RQ.QuantConfig(8),
                RQ.QuantConfig(4, True, channel_axis=0)):
        s, z = RQ.compute_scale_zp(jnp.asarray(mn), jnp.asarray(mx), cfg)
        ps, pz = PQ.compute_scale_zp(_t(mn), _t(mx), _pcfg(cfg))
        _eq(ps, s)
        _eq(pz, z)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fake_quant_forward_and_ste_gradient_bitwise(name):
    """Explicit qparams narrower than the data, so the STE mask zeroes
    part of the gradient; the forward and the gradient to x are equal bit
    for bit, and scale and zero point get none."""
    cfg = CONFIGS[name]
    x = _x(7)
    rng = np.random.default_rng(8)
    g = rng.normal(size=x.shape).astype(np.float32)
    mn, mx = RQ.observe_range(jnp.asarray(0.6 * x), cfg)
    s, z = RQ.compute_scale_zp(mn, mx, cfg)
    y, vjp = jax.vjp(lambda v: RQ.fake_quant(v, s, z, cfg), jnp.asarray(x))
    (gx,) = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_(True)
    st = _t(np.asarray(s)).requires_grad_(True)
    zt = _t(np.asarray(z)).requires_grad_(True)
    yt = PQ.fake_quant(xt, st, zt, _pcfg(cfg))
    yt.backward(_t(g))
    _eq(yt, y)
    _eq(xt.grad, gx)
    assert st.grad is None and zt.grad is None
    masked = np.asarray(gx) == 0
    assert 0 < masked.mean() < 1


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fake_quant_minmax_forward_and_gradient_bitwise(name):
    cfg = CONFIGS[name]
    x = _x(9)
    g = np.random.default_rng(10).normal(size=x.shape).astype(np.float32)
    y, vjp = jax.vjp(lambda v: RQ.fake_quant_minmax(v, cfg), jnp.asarray(x))
    (gx,) = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_(True)
    yt = PQ.fake_quant_minmax(xt, _pcfg(cfg))
    yt.backward(_t(g))
    _eq(yt, y)
    _eq(xt.grad, gx)


def test_packed_nbytes_and_int4_packing():
    for shape, bits in (((3, 3, 8, 16), 4), ((7,), 3), ((5, 5), 8)):
        assert PQ.packed_nbytes(shape, bits) == RQ.packed_nbytes(shape, bits)
    q = np.random.default_rng(0).integers(-8, 8, (6, 10)).astype(np.int32)
    p = PQ.pack_int4(_t(q))
    _eq(p, RQ.pack_int4(jnp.asarray(q)))
    _eq(PQ.unpack_int4(p, signed=True), RQ.unpack_int4(
        RQ.pack_int4(jnp.asarray(q)), signed=True))


# ---------------------------------------------------------------------------
# observers and calibration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("momentum", [None, 0.9, 0.5])
@pytest.mark.parametrize("channel_axis", [None, -1])
def test_act_observer_bitwise(momentum, channel_axis):
    """Five explicit batches through both observers: the running min/max
    (true, or EMA from the first batch on) and the qparams are equal bit
    for bit after every update."""
    cfg = RQ.QuantConfig(4, symmetric=False, channel_axis=channel_axis)
    shape = () if channel_axis is None else (7,)
    r = RC.ActObserver.init(shape, momentum=momentum)
    p = PC.ActObserver.init(shape, momentum=momentum)
    rng = np.random.default_rng(11)
    for i in range(5):
        x = rng.normal(0.3 * i, 1.0 + i, (3, 4, 4, 7)).astype(np.float32)
        r = r.update(jnp.asarray(x), cfg)
        p = p.update(_t(x), _pcfg(cfg))
        _eq(p.min_val, r.min_val)
        _eq(p.max_val, r.max_val)
        for s_r, s_p in zip(r.qparams(cfg), p.qparams(_pcfg(cfg))):
            _eq(s_p, s_r)


@pytest.mark.parametrize("bits", range(2, 9))
def test_relu6_fused_qparams_bitwise(bits):
    cfg = RQ.QuantConfig(bits)
    for s_r, s_p in zip(RC.relu6_fused_qparams(cfg),
                        PC.relu6_fused_qparams(_pcfg(cfg))):
        _eq(s_p, s_r)
    with pytest.raises(ValueError):
        PC.relu6_fused_qparams(PQ.QuantConfig(bits, symmetric=True))


def test_calibrate_continues_rounds_bitwise():
    """`calibrate` over named activations, then a second round continuing
    the first (the online-quantization mode)."""
    rng = np.random.default_rng(12)
    batches = [rng.normal(size=(2, 5, 5, 3)).astype(np.float32)
               for _ in range(3)]
    cfg = RQ.QuantConfig(8)

    def r_fn(_, b):
        return {"a": b, "b": jnp.maximum(b, 0.0) * 2.0}

    def p_fn(_, b):
        return {"a": b, "b": torch.clamp(b, min=0.0) * 2.0}

    r = RC.calibrate(r_fn, None, [jnp.asarray(b) for b in batches[:2]], cfg,
                     momentum=0.9)
    p = PC.calibrate(p_fn, None, [_t(b) for b in batches[:2]], _pcfg(cfg),
                     momentum=0.9)
    r = RC.calibrate(r_fn, None, [jnp.asarray(batches[2])], cfg, observers=r)
    p = PC.calibrate(p_fn, None, [_t(batches[2])], _pcfg(cfg), observers=p)
    assert sorted(p) == sorted(r)
    for k in r:
        _eq(p[k].min_val, r[k].min_val)
        _eq(p[k].max_val, r[k].max_val)


# ---------------------------------------------------------------------------
# BN fusion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 3, 8, 16), (3, 3, 1, 16), (16, 10)])
def test_fuse_bn_matches(shape):
    """Eqs. 4-6 to rtol 1e-6 (pow(-0.5) may round differently), for a
    conv, a depthwise and a dense weight, with and without a bias."""
    rng = np.random.default_rng(13)
    m = shape[-1]
    w = rng.normal(size=shape).astype(np.float32)
    b = rng.normal(size=(m,)).astype(np.float32)
    bn = {k: rng.uniform(lo, hi, m).astype(np.float32) for k, lo, hi in
          (("gamma", 0.5, 1.5), ("beta", -0.5, 0.5), ("mean", -1, 1),
           ("var", 0.1, 2.0))}
    rbn = RB.BNParams.from_tree({k: jnp.asarray(v) for k, v in bn.items()})
    pbn = PB.BNParams.from_tree({k: _t(v) for k, v in bn.items()})
    for bias in (b, None):
        rw, rb = RB.fuse_bn(jnp.asarray(w), None if bias is None else
                            jnp.asarray(bias), rbn)
        pw, pb = PB.fuse_bn(_t(w), None if bias is None else _t(bias), pbn)
        np.testing.assert_allclose(pw.numpy(), np.asarray(rw), rtol=1e-6)
        np.testing.assert_allclose(pb.numpy(), np.asarray(rb), rtol=1e-6,
                                   atol=1e-7)
    x = rng.normal(size=(2, 4, 4, m)).astype(np.float32)
    np.testing.assert_allclose(
        PB.bn_apply(_t(x), pbn).numpy(),
        np.asarray(RB.bn_apply(jnp.asarray(x), rbn)), rtol=1e-6, atol=1e-6)
    assert PB.bn_op_count(m, 49) == RB.bn_op_count(m, 49)
    tree = PB.BNParams.init_tree(m)
    for k, v in RB.BNParams.init_tree(m).items():
        _eq(tree[k], v)


# ---------------------------------------------------------------------------
# quantize_net and the artifact
# ---------------------------------------------------------------------------

MNV2 = dict(alpha=0.35, input_hw=16, num_classes=4)
EFFN = dict(input_hw=16, num_classes=4)


def _ref_net(model: str, bits: int):
    if model == "mobilenet_v2":
        return R_MNV2.build(bits=bits, **MNV2)
    return R_EFFN.build_compact(bits=bits, **EFFN)


@pytest.fixture(scope="module")
def float_nets():
    """Each net's float params (He-normal and small nonzero biases, drawn
    with numpy: BN already folded, as at export) and true-min/max
    observers of the reference's activations on two random batches (one
    capture program a net, its ranges read with numpy), in both packages'
    forms. act8 reuses act4's observers: the float forward does not depend
    on the bit-widths."""
    out = {}
    rng = np.random.default_rng(14)
    for model in ("mobilenet_v2", "efficientnet_compact"):
        net = _ref_net(model, 4)
        params = {}
        for _, op in net.all_ops():
            shape = op.weight_shape()
            fan_in = int(np.prod(shape[:-1])) or 1
            params[op.name] = {
                "w": (rng.normal(size=shape) * (2.0 / fan_in) ** 0.5
                      ).astype(np.float32),
                "b": (0.05 * rng.normal(size=(op.out_ch,))).astype(
                    np.float32)}
        cap = jax.jit(lambda p, x, net=net: RL.forward(p, x, net,
                                                       capture=True)[1])
        x = rng.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
        acts = cap.lower(params, x).compile(
            compiler_options=NO_ALGSIMP)(params, x)
        obs = {k: RC.ActObserver(jnp.asarray(np.min(np.asarray(a))),
                                 jnp.asarray(np.max(np.asarray(a))))
               for k, a in acts.items()}
        out[model] = (params, obs)
    return out


def _qop_fields():
    return [f.name for f in dataclasses.fields(PQN.QOp) if f.name != "spec"]


def assert_qnets_equal(p: PQN.QNet, r) -> None:
    """Every field of every op (arrays bit for bit with their dtypes,
    floats exactly), the residual quantizers and the spec."""
    assert p.spec == convert.netspec_from_reference(r.spec)
    assert list(p.ops) == list(r.ops)
    for name, rq in r.ops.items():
        pq = p.ops[name]
        for f in _qop_fields():
            a, b = getattr(pq, f), getattr(rq, f)
            if isinstance(b, (float, bool)):
                assert type(a) is type(b) and a == b, (name, f, a, b)
                assert np.signbit(a) == np.signbit(b), (name, f)
            else:
                _eq(a, b)
    assert {k: tuple(v) for k, v in p.res_q.items()} == \
        {k: tuple(v) for k, v in r.res_q.items()}


@pytest.mark.parametrize("model", ["mobilenet_v2", "efficientnet_compact"])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_net_identical(float_nets, model, bits):
    params, obs = float_nets[model]
    net = _ref_net(model, bits)
    want = RQN.quantize_net(params, net, obs)
    got = PQN.quantize_net(
        convert.params_from_reference(params, device="cpu"),
        convert.netspec_from_reference(net),
        convert.observers_from_reference(obs, device="cpu"))
    assert_qnets_equal(got, want)
    assert got.model_bytes() == want.model_bytes()


def test_quantize_net_needs_observers(float_nets):
    params, _ = float_nets["mobilenet_v2"]
    net = convert.netspec_from_reference(_ref_net("mobilenet_v2", 4))
    with pytest.raises(ValueError, match="observer"):
        PQN.quantize_net(convert.params_from_reference(params, device="cpu"),
                         net, {})


@pytest.mark.parametrize("model", ["mobilenet_v2", "efficientnet_compact"])
def test_save_qnet_files_cross_read(float_nets, model, tmp_path):
    """The port's file, read by the JAX `load_qnet`, equals the JAX
    writer's file read back; each package reads the other's; the JSON
    headers are byte for byte the same."""
    params, obs = float_nets[model]
    net = _ref_net(model, 8)
    build = {"model": model, "bits": 8, **(MNV2 if model == "mobilenet_v2"
                                           else EFFN)}
    prov = {"steps": 3, "note": "cross-read"}
    rq = RQN.quantize_net(params, net, obs)
    pq = PQN.quantize_net(convert.params_from_reference(params, device="cpu"),
                          convert.netspec_from_reference(net),
                          convert.observers_from_reference(obs, device="cpu"))
    rpath, ppath = str(tmp_path / "jax.qnet"), str(tmp_path / "torch.qnet")
    RQN.save_qnet(rq, rpath, build=build, provenance=prov)
    PQN.save_qnet(pq, ppath, build=build, provenance=prov)
    assert RQN.read_qnet_meta(ppath) == RQN.read_qnet_meta(rpath)
    with open(rpath, "rb") as a, open(ppath, "rb") as b:
        n = int.from_bytes(a.read(8), "little")
        assert b.read(8 + n)[8:] == a.read(n)
    want = RQN.load_qnet(rpath)
    assert_qnets_equal(PQN.load_qnet(ppath), RQN.load_qnet(ppath))
    assert_qnets_equal(convert.qnet_from_reference(RQN.load_qnet(ppath)),
                       want)
    assert_qnets_equal(PQN.load_qnet(rpath), want)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The port's train_and_export at the JAX trainer test's config."""
    cfg = PV.VisionTrainConfig(
        model="mobilenet_v2", alpha=0.35, input_hw=16, num_classes=4,
        float_steps=4, qat_steps=4, batch=8, anneal_from=8,
        calibrate_every=2, ckpt_every=2)
    path = str(tmp_path_factory.mktemp("trained") / "mnv2.qnet")
    result, qnet, report = PV.train_and_export(cfg, path=path, device="cpu")
    return result, qnet, report


def test_quantize_net_on_the_ports_trained_state(trained):
    """The JAX `quantize_net` on the port's final params and online-
    quantization observers equals the port's exported QNet."""
    result, qnet, report = trained
    assert report["observers_used"] and report["online_quant_rounds"] == 2
    obs = {k: RC.ActObserver(jnp.asarray(o.min_val.numpy()),
                             jnp.asarray(o.max_val.numpy()), o.momentum)
           for k, o in result.observers.items()}
    net = RQN.build_netspec(PV.build_record(result.cfg))
    want = RQN.quantize_net(convert.params_to_reference(result.params), net,
                            obs)
    assert_qnets_equal(qnet, want)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _opt_inputs(seed: int, gscale: float):
    rng = np.random.default_rng(seed)
    params = {"conv": {"w": rng.normal(size=(3, 3, 4, 8)).astype(np.float32),
                       "b": rng.normal(size=(8,)).astype(np.float32)},
              "fc": {"w": rng.normal(size=(8, 5)).astype(np.float32),
                     "b": np.zeros((5,), np.float32)}}
    grads = [jax.tree.map(
        lambda a: (gscale * rng.normal(size=a.shape)).astype(np.float32),
        params) for _ in range(3)]
    return params, grads


def _close_tree(got, want, rtol):
    gl, wl = PT.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=1e-7)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_apply_updates_matches(schedule):
    """Three AdamW steps with clipping active (global norm above 1) and
    weight decay: params, moments and metrics to rtol 1e-6."""
    params, grads = _opt_inputs(15, 1.0)
    cfg = dict(lr=1e-2, weight_decay=0.1, warmup_steps=2, total_steps=6,
               schedule=schedule)
    rp, rs = params, RO.init_state(params)
    pp = convert.params_from_reference(params, device="cpu")
    ps = PO.init_state(pp)
    for g in grads:
        rp, rs, rm = RO.apply_updates(rp, g, rs, RO.AdamWConfig(**cfg))
        pp, ps, pm = PO.apply_updates(
            pp, convert.params_from_reference(g, device="cpu"), ps,
            PO.AdamWConfig(**cfg))
        assert float(rm["grad_norm"]) > 1.0
        _close_tree(pp, rp, 1e-6)
        _close_tree(ps.m, rs.m, 1e-6)
        _close_tree(ps.v, rs.v, 1e-6)
        _eq(ps.step, rs.step)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=1e-6)


@pytest.mark.parametrize("grad_clip,gscale", [(0.0, 1.0), (1.0, 0.01)])
def test_state_bits_8_bitwise(grad_clip, gscale):
    """8-bit state (m int8 per row, v uint8 in log space): the initial
    state and the state after each of three steps equal the reference's
    bit for bit, where the gradients reach the moments unscaled (no clip,
    or a norm under the clip: the clip factor is a global-norm reduction,
    which XLA and torch sum in another order); params to rtol 1e-6."""
    params, grads = _opt_inputs(16, gscale)
    cfg = dict(lr=1e-2, weight_decay=0.1, warmup_steps=1, total_steps=4,
               grad_clip=grad_clip, state_bits=8)
    rp, rs = params, RO.init_state(params, state_bits=8)
    pp = convert.params_from_reference(params, device="cpu")
    ps = PO.init_state(pp, state_bits=8)

    def same_state(p, r):
        _eq(p.step, r.step)
        for a, b in zip(PT.leaves((p.m, p.v)), jax.tree.leaves((r.m, r.v))):
            _eq(a, b)

    same_state(ps, rs)
    for g in grads:
        rp, rs, rm = RO.apply_updates(rp, g, rs, RO.AdamWConfig(**cfg))
        pp, ps, _ = PO.apply_updates(
            pp, convert.params_from_reference(g, device="cpu"), ps,
            PO.AdamWConfig(**cfg))
        same_state(ps, rs)
        _close_tree(pp, rp, 1e-6)
    if grad_clip:
        assert float(rm["grad_norm"]) < grad_clip


def test_frozen_leaves_are_held():
    params = {"q": {"w_q": torch.ones(3, dtype=torch.int8),
                    "w": torch.ones(3)}}
    grads = {"q": {"w_q": torch.zeros(3, dtype=torch.int8),
                   "w": torch.ones(3)}}
    state = PO.init_state(params)
    assert state.m["q"]["w_q"].shape == ()
    new, _, _ = PO.apply_updates(params, grads, state,
                                 PO.AdamWConfig(weight_decay=0.5))
    assert torch.equal(new["q"]["w_q"], params["q"]["w_q"])
    assert not torch.equal(new["q"]["w"], params["q"]["w"])


# ---------------------------------------------------------------------------
# checkpoints across packages
# ---------------------------------------------------------------------------


def _ckpt_tree(seed: int, state_bits):
    """(params with BN, AdamW state, observer tree), as the trainer saves."""
    rng = np.random.default_rng(seed)
    params = {
        "stem/conv": {"w": rng.normal(size=(3, 3, 3, 8)).astype(np.float32),
                      "b": rng.normal(size=(8,)).astype(np.float32),
                      "bn": {k: rng.normal(size=(8,)).astype(np.float32)
                             for k in ("gamma", "beta", "mean", "var")}},
        "classifier/fc": {"w": rng.normal(size=(8, 4)).astype(np.float32),
                          "b": rng.normal(size=(4,)).astype(np.float32)}}
    state = RO.init_state(params, state_bits=state_bits)
    state = state._replace(step=jnp.asarray(7, jnp.int32))
    obs = {"stem/conv": {"mn": np.float32(-1.5), "mx": np.float32(2.25)},
           "classifier/fc": {"mn": np.float32(-3.0), "mx": np.float32(4.0)}}
    return params, state, obs


def _port_tree(ref):
    params, state, obs = ref
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    pstate = PO.AdamWState(
        step=t(state.step), m=jax.tree.map(t, state.m),
        v=jax.tree.map(t, state.v))
    return (jax.tree.map(t, params), pstate, jax.tree.map(t, obs))


@pytest.mark.parametrize("state_bits", [None, 8])
def test_checkpoint_written_by_jax_restored_by_port(state_bits, tmp_path):
    ref = _ckpt_tree(17, state_bits)
    d = str(tmp_path)
    RCK.save(d, 5, ref, extra={"fused": False})
    template = _port_tree(_ckpt_tree(99, state_bits))
    got, step = PCK.restore(d, template)
    assert step == 5 == PCK.latest_step(d)
    assert isinstance(got[1], PO.AdamWState)
    for a, b in zip(PT.leaves(got), jax.tree.leaves(ref)):
        _eq(a, b)


@pytest.mark.parametrize("state_bits", [None, 8])
def test_checkpoint_written_by_port_restored_by_jax(state_bits, tmp_path):
    ref = _ckpt_tree(18, state_bits)
    d = str(tmp_path)
    t = PCK.save(d, 3, _port_tree(ref), async_=True, extra={"fused": True})
    t.join()
    got, step = RCK.restore(d, _ckpt_tree(98, state_bits))
    assert step == 3 == RCK.latest_step(d)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        _eq(np.asarray(a), np.asarray(b))
    with open(os.path.join(d, "step_00000003", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["treedef"] == str(jax.tree.structure(ref))
    assert manifest["extra"] == {"fused": True}


def test_checkpoint_bfloat16_and_rotation(tmp_path):
    """bf16 leaves travel bit-cast to uint16 with a dtype tag, both ways;
    `keep` bounds the step directories."""
    import ml_dtypes
    rng = np.random.default_rng(19)
    a = rng.normal(size=(4, 6)).astype(ml_dtypes.bfloat16)
    d_ref, d_port = str(tmp_path / "r"), str(tmp_path / "p")
    RCK.save(d_ref, 1, {"x": a, "y": np.arange(3, dtype=np.int32)})
    got, _ = PCK.restore(d_ref, {"x": torch.zeros(4, 6, dtype=torch.bfloat16),
                                 "y": torch.zeros(3, dtype=torch.int32)})
    assert got["x"].dtype == torch.bfloat16
    _eq(got["x"].float(), a.astype(np.float32))
    for step in range(1, 5):
        PCK.save(d_port, step, {"x": got["x"], "y": got["y"]}, keep=2)
    assert sorted(os.listdir(d_port)) == ["LATEST", "step_00000003",
                                          "step_00000004"]
    back, step = RCK.restore(d_port, {"x": a, "y": np.zeros(3, np.int32)})
    assert step == 4
    assert np.asarray(back["x"]).dtype == a.dtype
    _eq(np.asarray(back["x"]).view(np.uint16), a.view(np.uint16))
    with pytest.raises(ValueError, match="leaves"):
        PCK.restore(d_port, {"x": got["x"]})
