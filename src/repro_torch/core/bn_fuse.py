"""Batch-Normalization fusing (DeepDive front end, Sec. 3.1, Eqs. 3-6).

Counterpart of `repro/core/bn_fuse.py`. Folds a BN that follows a conv or
linear operator into the operator's weights and bias:

    v_hat = (sigma^2 + eps)^(-1/2)                      (Eq. 4)
    W_hat = W * diag(gamma * v_hat)    (per out-channel) (Eq. 5)
    B_hat = B + (xi - gamma * mu * v_hat)               (Eq. 6)

Weight layouts: conv2d HWIO [K, K, Cin, Cout], depthwise [K, K, 1, C],
linear [Din, Dout]: the output channel is last in all three.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# the one epsilon of batch-statistics normalization, running-stat folding
# and Eq. 4 fusion alike
BN_EPS = 1e-5


@dataclasses.dataclass
class BNParams:
    gamma: torch.Tensor  # BN weight
    beta: torch.Tensor  # BN bias (xi in the paper)
    mean: torch.Tensor  # running mu
    var: torch.Tensor  # running sigma^2
    eps: float = BN_EPS

    @classmethod
    def from_tree(cls, tree, eps: float = BN_EPS) -> "BNParams":
        """From the {'gamma', 'beta', 'mean', 'var'} leaves of a parameter
        tree (the training-side storage format)."""
        return cls(gamma=tree["gamma"], beta=tree["beta"],
                   mean=tree["mean"], var=tree["var"], eps=eps)

    def as_tree(self):
        return {"gamma": self.gamma, "beta": self.beta,
                "mean": self.mean, "var": self.var}

    @staticmethod
    def init_tree(channels: int, dtype=torch.float32, device=None):
        """Identity-BN leaves: gamma=1, beta=0, N(0, 1) running stats."""
        return {
            "gamma": torch.ones((channels,), dtype=dtype, device=device),
            "beta": torch.zeros((channels,), dtype=dtype, device=device),
            "mean": torch.zeros((channels,), dtype=dtype, device=device),
            "var": torch.ones((channels,), dtype=dtype, device=device),
        }


def fuse_bn(w: torch.Tensor, b: Optional[torch.Tensor], bn: BNParams,
            out_axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W_hat, B_hat) per Eqs. 4-6 (a conv bias is scaled too)."""
    v_hat = (bn.var + bn.eps) ** -0.5  # Eq. 4
    g = bn.gamma * v_hat
    shape = [1] * w.ndim
    shape[out_axis % w.ndim] = -1
    w_hat = w * g.reshape(shape)  # Eq. 5
    if b is None:
        b = torch.zeros_like(bn.mean)
    b_hat = b * g + (bn.beta - bn.gamma * bn.mean * v_hat)  # Eq. 6
    return w_hat, b_hat


def bn_apply(x: torch.Tensor, bn: BNParams, channel_axis: int = -1
             ) -> torch.Tensor:
    """Inference-mode BN, Eq. 3: what fusion must reproduce."""
    shape = [1] * x.ndim
    shape[channel_axis % x.ndim] = -1
    v_hat = (bn.var + bn.eps) ** -0.5
    return (x - bn.mean.reshape(shape)) * (bn.gamma * v_hat).reshape(shape) \
        + bn.beta.reshape(shape)


def bn_op_count(num_channels: int, spatial: int) -> int:
    """Ops a standalone BN layer costs at inference (a mul and an add an
    element): fusion removes them (the paper's ~4 % computation cut)."""
    return 2 * num_channels * spatial


__all__ = ["BN_EPS", "BNParams", "fuse_bn", "bn_apply", "bn_op_count"]
