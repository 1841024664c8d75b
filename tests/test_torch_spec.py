"""The port's spec layer and artifact reader against the JAX package:
NetSpec constructors, the CU compiler (`compile_net`, `stage_signatures` and
the architecture knobs), `.qnet` loading, and `convert.qnet_from_reference`.
"""
import os

import numpy as np
import pytest

from repro.core import compiler as RCC, qnet as RQ
from repro.models import efficientnet as reffn, mobilenet_v2 as rmnv2
from repro_torch import convert
from repro_torch.core import compiler as CC, qnet as Q
from repro_torch.models import efficientnet as effn, mobilenet_v2 as mnv2
from tests.regen_golden import CASES, build_net, fixture_paths

GOLDEN_2D = [c for c in CASES if c[0] != "dscnn_kws"]

NETS = [
    ("mnv2_a0.35_h32_bw4", lambda m: m.build(alpha=0.35, input_hw=32,
                                             num_classes=10)),
    ("mnv2_a1.0_h224_bw8", lambda m: m.build(alpha=1.0, input_hw=224,
                                             bits=8)),
    ("mnv2_a0.75_h160_bw6", lambda m: m.build(alpha=0.75, input_hw=160,
                                              bits=6, num_classes=100)),
    ("effn_compact_h32", lambda m: m.build_compact(input_hw=32,
                                                   num_classes=10)),
    ("effn_compact_h128_bw8", lambda m: m.build_compact(bits=8)),
    ("effn_w1.1_d1.2_h64", lambda m: m.build(width=1.1, depth=1.2,
                                             input_hw=64)),
]


def _pair(name_fn):
    name, fn = name_fn
    ref_mod, port_mod = ((rmnv2, mnv2) if name.startswith("mnv2")
                         else (reffn, effn))
    return fn(ref_mod), fn(port_mod)


@pytest.mark.parametrize("nb", NETS, ids=[b[0] for b in NETS])
def test_netspecs_equal_reference(nb):
    ref, port = _pair(nb)
    assert convert.netspec_from_reference(ref) == port
    assert port.count_macs() == ref.count_macs()
    assert port.n_params() == ref.n_params()
    assert port.model_bits() == ref.model_bits()


def _sig(s):
    return (s.cu, tuple(b.name for b in s.blocks), s.in_hw, s.in_ch,
            s.out_hw, s.out_ch)


@pytest.mark.parametrize("nb", NETS, ids=[b[0] for b in NETS])
def test_compile_net_equals_reference(nb):
    ref, port = _pair(nb)
    rplan, plan = RCC.compile_net(ref), CC.compile_net(port)
    assert [(a.cu, a.block.name, a.invocation) for a in plan.schedule] == \
        [(a.cu, a.block.name, a.invocation) for a in rplan.schedule]
    assert [_sig(s) for s in plan.stage_signatures()] == \
        [_sig(s) for s in rplan.stage_signatures()]
    assert [(cu, b.name, op.name, hw)
            for cu, b, op, hw in plan.op_descriptors()] == \
        [(cu, b.name, op.name, hw)
         for cu, b, op, hw in rplan.op_descriptors()]
    assert plan.parallel_ops() == rplan.parallel_ops()
    assert plan.buffer_bytes() == rplan.buffer_bytes()
    assert plan.body_invocations == rplan.body_invocations


QOP_ARRAYS = ("w_q", "w_scale", "wsum", "bias_q", "mult", "mantissa",
              "shift")
QOP_FLOATS = ("in_scale", "in_zp", "out_scale", "out_zp", "clip")


def _assert_qnets_equal(port, ref):
    assert port.spec == convert.netspec_from_reference(ref.spec)
    assert set(port.ops) == set(ref.ops)
    for name, q in port.ops.items():
        r = ref.ops[name]
        for f in QOP_ARRAYS:
            a, b = np.asarray(getattr(q, f)), np.asarray(getattr(r, f))
            assert a.dtype == b.dtype, (name, f)
            np.testing.assert_array_equal(a, b, err_msg=f"{name}.{f}")
        for f in QOP_FLOATS:
            assert getattr(q, f) == getattr(r, f), (name, f)
    assert port.res_q == {k: tuple(v) for k, v in ref.res_q.items()}


@pytest.mark.parametrize("case", GOLDEN_2D, ids=lambda c: f"{c[0]}_act{c[1]}")
def test_golden_qnet_loads_equal_to_reference(case):
    """Array for array, from the artifact's own build record and from an
    explicit NetSpec; the header reads alike too."""
    path, _ = fixture_paths(*case)
    ref = RQ.load_qnet(path, build_net(*case))
    _assert_qnets_equal(Q.load_qnet(path), ref)
    _assert_qnets_equal(Q.load_qnet(
        path, convert.netspec_from_reference(ref.spec)), ref)
    assert Q.read_qnet_meta(path) == RQ.read_qnet_meta(path)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}_act{c[1]}")
def test_qnet_from_reference_equals_loaded_artifact(case):
    path, _ = fixture_paths(*case)
    ref = RQ.load_qnet(path, build_net(*case))
    _assert_qnets_equal(convert.qnet_from_reference(ref), ref)


def test_build_record_act_bit_rewrites_match_reference():
    for rec in ({"model": "mobilenet_v2", "alpha": 0.35, "input_hw": 32,
                 "bits": 8, "act_bits": 4, "num_classes": 10},
                {"model": "efficientnet_compact", "input_hw": 32, "bits": 4,
                 "num_classes": 10,
                 "op_act_bits": {"mb1/expand": 8, "mb1/dw": 6}}):
        assert Q.build_netspec(rec) == convert.netspec_from_reference(
            RQ.build_netspec(rec))


def test_unsupported_family_raises():
    with pytest.raises(ValueError, match="not supported"):
        Q.build_netspec({"model": "resnet50", "bits": 8})
    with pytest.raises(ValueError, match="unknown model family"):
        RQ.build_netspec({"model": "resnet50", "bits": 8})


MIXED = os.path.join(os.path.dirname(__file__), "..", "experiments",
                     "precision", "mobilenet_v2_cpu_mix4of8_top2.qnet")


def test_mixed_precision_artifact_loads_equal_to_reference():
    """A heterogeneous-bit artifact rebuilds its per-op `op_act_bits`
    allocation from its own build record, as the reference does."""
    ref = RQ.load_qnet(MIXED)
    port = Q.load_qnet(MIXED)
    _assert_qnets_equal(port, ref)
    assert {op.act_bits for _, op in port.spec.all_ops()} == {4, 8}
