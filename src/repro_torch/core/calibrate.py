"""Calibration and post-training ReLU6 fusion (DeepDive front end, Sec. 3).

Counterpart of `repro/core/calibrate.py`. After BN-fused QAT the held-out
stream is run once more to extract each layer's activation range; ReLU6
activations get the fused quantizer h^pq: [0, 6] -> [0, 2^BW - 1], so the
integer clip to [0, 2^BW - 1] IS the ReLU6.

  * `ActObserver`         running min/max (or EMA) per tensor or channel
  * `calibrate`           drive a model over batches, collecting observers
  * `relu6_fused_qparams` h^pq: scale = 6 / (2^BW - 1), zp = 0
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from repro_torch.core.quant import QuantConfig, compute_scale_zp, observe_range


@dataclasses.dataclass
class ActObserver:
    """Running range observer. Functional: `update` returns a new one. Its
    tensors follow the activations' device."""

    min_val: torch.Tensor
    max_val: torch.Tensor
    momentum: Optional[float] = None  # None = true min/max; else EMA

    @staticmethod
    def init(shape=(), momentum: Optional[float] = None,
             device=None) -> "ActObserver":
        return ActObserver(
            min_val=torch.full(shape, float("inf"), device=device),
            max_val=torch.full(shape, float("-inf"), device=device),
            momentum=momentum)

    def update(self, x: torch.Tensor, cfg: QuantConfig) -> "ActObserver":
        mn, mx = observe_range(x.detach(), cfg)
        old_mn = self.min_val.to(mn.device)
        old_mx = self.max_val.to(mx.device)
        if self.momentum is None:
            return ActObserver(torch.minimum(old_mn, mn),
                               torch.maximum(old_mx, mx), None)
        m = self.momentum
        # separate multiplies and add, as the reference's eager ops (no FMA)
        init = torch.isinf(old_mn)
        new_mn = torch.where(init, mn, m * old_mn + (1 - m) * mn)
        new_mx = torch.where(init, mx, m * old_mx + (1 - m) * mx)
        return ActObserver(new_mn, new_mx, m)

    def qparams(self, cfg: QuantConfig) -> Tuple[torch.Tensor, torch.Tensor]:
        return compute_scale_zp(self.min_val, self.max_val, cfg)


def relu6_fused_qparams(cfg: QuantConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h^pq: [0, 6] -> [0, 2^BW - 1]: S = 6 / (2^BW - 1) as float32,
    m_zp = 0; the integer clip to [0, 2^BW - 1] realizes ReLU6 exactly."""
    if cfg.symmetric:
        raise ValueError("ReLU6 fusion requires the asymmetric representation")
    return (torch.tensor(6.0 / cfg.qmax, dtype=torch.float32),
            torch.tensor(0.0, dtype=torch.float32))


def calibrate(
    apply_fn: Callable[..., Dict[str, torch.Tensor]],
    params,
    batches: Iterable,
    act_cfg: QuantConfig,
    observers: Optional[Dict[str, ActObserver]] = None,
    momentum: Optional[float] = None,
) -> Dict[str, ActObserver]:
    """Run `apply_fn(params, batch)` (a dict of named activations) over
    the batches and return per-name observers. `observers` continues an
    earlier round and `momentum` seeds new observers as EMA trackers:
    together, the online quantization mode of the QAT trainer."""
    observers = dict(observers) if observers else {}
    with torch.no_grad():
        for batch in batches:
            acts = apply_fn(params, batch)
            for name, x in acts.items():
                obs = observers.get(name)
                if obs is None:
                    shape = () if act_cfg.channel_axis is None else (
                        x.shape[act_cfg.channel_axis],)
                    obs = ActObserver.init(shape, momentum=momentum,
                                           device=x.device)
                observers[name] = obs.update(x, act_cfg)
    return observers


__all__ = ["ActObserver", "relu6_fused_qparams", "calibrate"]
