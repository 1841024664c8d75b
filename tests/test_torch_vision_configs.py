"""The port's vision design points (`configs/mobilenet_v2.py`,
`configs/efficientnet_compact.py`, standalone modules as in the JAX
package, which registers them nowhere) against the port's `build`
functions and the JAX package's `get_config`: the same NetSpec (through
`convert.netspec_from_reference`), exactly."""
import pytest

from repro.configs import efficientnet_compact as RE
from repro.configs import mobilenet_v2 as RM
from repro_torch import convert
from repro_torch.configs import efficientnet_compact as PE
from repro_torch.configs import mobilenet_v2 as PM
from repro_torch.models import efficientnet as effn
from repro_torch.models import mobilenet_v2 as mnv2


def test_design_space_equals_reference():
    assert PM.ALPHAS == RM.ALPHAS and PM.RESOLUTIONS == RM.RESOLUTIONS


@pytest.mark.parametrize("kw", [{}, {"alpha": 1.0, "bits": 8},
                                {"alpha": 0.35, "input_hw": 96,
                                 "num_classes": 10}],
                         ids=["defaults", "a1.0-w8", "a0.35-h96"])
def test_mobilenet_v2_config(kw):
    got = PM.get_config(**kw)
    assert got == mnv2.build(**{"alpha": 0.75, "input_hw": 224, "bits": 4,
                                **kw})
    assert convert.netspec_from_reference(RM.get_config(**kw)) == got


@pytest.mark.parametrize("kw", [{}, {"input_hw": 32, "num_classes": 10},
                                {"bits": 8}],
                         ids=["defaults", "h32", "w8"])
def test_efficientnet_compact_config(kw):
    got = PE.get_config(**kw)
    assert got == effn.build_compact(**{"input_hw": 128, "bits": 4, **kw})
    assert convert.netspec_from_reference(RE.get_config(**kw)) == got
