"""Compact EfficientNet (the paper's second case study, Sec. 5.2).

Counterpart of `repro/configs/efficientnet_compact.py`: the same defaults,
over the port's `models.efficientnet.build_compact`."""
from repro_torch.models import efficientnet as _e


def get_config(input_hw: int = 128, bits: int = 4, **kw):
    return _e.build_compact(input_hw=input_hw, bits=bits, **kw)
