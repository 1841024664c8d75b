"""MobileNet-V2 design points (the paper's own case study, Sec. 5.1).

Counterpart of `repro/configs/mobilenet_v2.py`: the same design space and
defaults, over the port's `models.mobilenet_v2.build`."""
from repro_torch.models import mobilenet_v2 as _m

# the paper's Table 2 design space
ALPHAS = (1.0, 0.75, 0.5, 0.35)
RESOLUTIONS = (224, 192, 160, 128, 96)


def get_config(alpha: float = 0.75, input_hw: int = 224, bits: int = 4, **kw):
    return _m.build(alpha=alpha, input_hw=input_hw, bits=bits, **kw)
