"""Float side of the NetSpec IR: init, forward, QAT forward, calibration.

Counterpart of `repro/models/layers.py`: a functional CNN whose parameters
are a tree keyed by op name (`{"w", "b"[, "bn"]}`, with the reference's
names and layouts: HWIO weights, NHWC activations, NTC for the 1-D ops),
so checkpoints and `convert.params_from_reference` map one to one. Three
modes share one traversal:

  * float (`qat=False`), BN folded from its running stats or, with
    `bn_stats=`, normalized with the batch's own moments (pre-training);
  * `qat=True`: fake-quantized weights and activations (online
    quantization);
  * `capture=True`: the named intermediate activations for calibration.

The convolutions run as `F.conv2d`/`F.conv1d` on an NCHW (NCT) view of the
NHWC (NTC) tensor, which is the channels-last layout those kernels take.
Where the form differs from the reference's:

  * padding: "SAME" pads a stride-2 window asymmetrically (the extra row
    and column at the bottom and right), which `F.conv2d(padding="same")`
    refuses for stride > 1, so the pads are explicit;
  * variance: the batch variance is the biased one (`jnp.var`), so
    `correction=0` (torch's default is the unbiased one).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import graph as G
from repro_torch.core.bn_fuse import BN_EPS, BNParams, fuse_bn
from repro_torch.core.quant import QuantConfig, fake_quant_minmax
from repro_torch.kernels.common import same_pad_amount


@contextlib.contextmanager
def exact_f32():
    """Float32 as the CPU computes it, inside the scope only: TF32 off for
    cuDNN convolutions and cuBLAS matmuls (cuDNN's defaults to on), and
    cuDNN held to deterministic algorithms without autotuning (its default
    backward-weight algorithms are not deterministic), so a rerun from a
    checkpoint on the card repeats the straight run bit for bit. The other
    ops of the training path (elementwise, reductions, `torch.matmul`,
    the native depthwise kernels, `mean` backward) are deterministic on one
    stream; the loss reads its label through a one-hot product, not a
    gather, whose CUDA backward adds with atomics."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark,
            matmul.allow_tf32)
    cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = False, True, False
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark,
         matmul.allow_tf32) = prev


# ---------------------------------------------------------------------------
# primitive float ops (NHWC, HWIO)
# ---------------------------------------------------------------------------


def _pads(size: int, kernel: int, stride: int, padding) -> Tuple[int, int]:
    if padding == "SAME":
        lo, hi, _ = same_pad_amount(size, kernel, stride)
        return lo, hi
    if padding == "VALID":
        return 0, 0
    raise ValueError(f"padding {padding!r}")


def conv2d(x, w, stride=1, padding="SAME", groups=1):
    """x [B, H, W, Cin], w [K, K, Cin/groups, Cout] -> [B, H', W', Cout]."""
    kh, kw = w.shape[0], w.shape[1]
    top, bottom = _pads(x.shape[1], kh, stride, padding)
    left, right = _pads(x.shape[2], kw, stride, padding)
    xc = x.permute(0, 3, 1, 2)
    wc = w.to(x.dtype).permute(3, 2, 0, 1)
    if (top, left) == (bottom, right):
        y = F.conv2d(xc, wc, stride=stride, padding=(top, left),
                     groups=groups)
    else:
        y = F.conv2d(F.pad(xc, (left, right, top, bottom)), wc,
                     stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


def depthwise_conv2d(x, w, stride=1, padding="SAME"):
    """w: [K, K, 1, C]: groups == C, no channel reduction (Fig. 2c)."""
    return conv2d(x, w, stride=stride, padding=padding, groups=x.shape[-1])


def pointwise_conv2d(x, w):
    """w: [1, 1, Cin, Cout] or [Cin, Cout]: channel-only mixing (a matmul
    over the last axis, any rank)."""
    if w.ndim == 4:
        w = w[0, 0]
    return torch.matmul(x, w.to(x.dtype))


def conv1d(x, w, stride=1, padding="SAME", groups=1):
    """Temporal conv: x [B, T, Cin], w [K, Cin/groups, Cout]."""
    lo, hi = _pads(x.shape[1], w.shape[0], stride, padding)
    xt = x.permute(0, 2, 1)
    wt = w.to(x.dtype).permute(2, 1, 0)
    if lo == hi:
        y = F.conv1d(xt, wt, stride=stride, padding=lo, groups=groups)
    else:
        y = F.conv1d(F.pad(xt, (lo, hi)), wt, stride=stride, groups=groups)
    return y.permute(0, 2, 1)


def depthwise_conv1d(x, w, stride=1, padding="SAME"):
    """w: [K, 1, C]: groups == C, temporal-only mixing."""
    return conv1d(x, w, stride=stride, padding=padding, groups=x.shape[-1])


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def hsigmoid(x):
    """Eq. 1: ReLU6(x + 3) / 6."""
    return relu6(x + 3.0) / 6.0


def apply_act(x, act: str):
    if act == G.RELU6:
        return relu6(x)
    if act == G.HSIGMOID:
        return hsigmoid(x)
    if act == G.NONE:
        return x
    raise ValueError(f"unknown activation {act!r}")


def global_avg_pool(x):
    """Mean over the spatial or temporal axes ((1, 2) NHWC, (1,) NTC)."""
    return x.mean(dim=tuple(range(1, x.ndim - 1)))


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------


def _generator(seed_or_gen) -> torch.Generator:
    if isinstance(seed_or_gen, torch.Generator):
        return seed_or_gen
    return torch.Generator().manual_seed(int(seed_or_gen))


def init_op_params(gen: torch.Generator, op: G.OpSpec,
                   dtype=torch.float32, bn: bool = False,
                   device=None) -> Dict[str, torch.Tensor]:
    """He-normal weights drawn from `gen` (a CPU generator, so a seed gives
    the same weights on every device), zero bias, optional identity BN."""
    shape = op.weight_shape()
    fan_in = op.kernel * op.kernel * (op.in_ch if op.kind != G.DW else 1)
    if op.kind == G.CONV1D:
        fan_in = op.kernel * op.in_ch
    elif op.kind == G.DW1D:
        fan_in = op.kernel
    elif op.kind == G.DENSE:
        fan_in = op.in_ch
    std = (2.0 / max(fan_in, 1)) ** 0.5
    w = (std * torch.randn(shape, generator=gen, dtype=dtype)).to(device)
    p = {"w": w, "b": torch.zeros((op.out_ch,), dtype=dtype, device=device)}
    if bn:
        p["bn"] = BNParams.init_tree(op.out_ch, dtype, device)
    return p


def init_params(seed_or_gen, net: G.NetSpec, dtype=torch.float32,
                bn: bool = False, device=None):
    """Parameter tree keyed by op name, drawn in op order from one
    `torch.Generator` (or a seed for one). These are the port's own draws,
    not the reference's `PRNGKey` ones: tests carry the reference's
    parameters across with `convert.params_from_reference`.

    `bn=True` attaches BatchNorm leaves to every conv operator (not the
    classifier, not the SE gate convs)."""
    gen = _generator(seed_or_gen)
    se_names = set()
    for b in net.blocks:
        if b.se is not None:
            se_names.update((b.se.squeeze.name, b.se.excite.name))
    params = {}
    for _, op in net.all_ops():
        op_bn = bn and op.kind != G.DENSE and op.name not in se_names
        params[op.name] = init_op_params(gen, op, dtype, bn=op_bn,
                                         device=device)
    return params


def fuse_bn_params(params):
    """Fold every op's BN leaves into (w, b), Eqs. 4-6: the float-pretrain
    -> QAT boundary, and the shape of every exported net."""
    fused = {}
    for name, p in params.items():
        if "bn" in p:
            w, b = fuse_bn(p["w"], p["b"], BNParams.from_tree(p["bn"]),
                           out_axis=-1)
            fused[name] = {"w": w, "b": b}
        else:
            fused[name] = dict(p)
    return fused


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def weight_channel_axis(op: G.OpSpec) -> int:
    """Output-channel axis of the op's weight (per-channel quant axis)."""
    return -1


def _apply_op(x, op: G.OpSpec, p, *, qat: bool, bn_stats=None):
    w, b = p["w"], p["b"]
    use_batch_stats = bn_stats is not None and "bn" in p
    if "bn" in p and not use_batch_stats:
        # BN-fused execution (QAT and float eval): fake quant sees the
        # deployed weights (Sec. 3.1)
        w, b = fuse_bn(w, b, BNParams.from_tree(p["bn"]), out_axis=-1)
    if qat:
        w = fake_quant_minmax(w, QuantConfig(
            op.bits, symmetric=True, channel_axis=weight_channel_axis(op)))
    if op.kind == G.CONV:
        y = conv2d(x, w, stride=op.stride)
    elif op.kind == G.DW:
        y = depthwise_conv2d(x, w, stride=op.stride)
    elif op.kind == G.CONV1D:
        y = conv1d(x, w, stride=op.stride)
    elif op.kind == G.DW1D:
        y = depthwise_conv1d(x, w, stride=op.stride)
    elif op.kind == G.PW:
        y = pointwise_conv2d(x, w)
    elif op.kind == G.DENSE:
        y = torch.matmul(x, w.to(x.dtype))
    else:
        raise ValueError(op.kind)
    y = y + b.to(y.dtype)
    if use_batch_stats:
        # float pre-training: this batch's moments normalize, and go to the
        # train step, which keeps the running stats outside the gradient
        dims = tuple(range(y.ndim - 1))
        mean = y.mean(dim=dims)
        var = y.var(dim=dims, correction=0)
        bn = p["bn"]
        y = (y - mean) * torch.rsqrt(var + BN_EPS) * bn["gamma"] + bn["beta"]
        bn_stats[op.name] = {"mean": mean.detach(), "var": var.detach()}
    y = apply_act(y, op.act)
    if qat and op.act != G.NONE:
        # online activation quantization at the op's activation BW
        y = fake_quant_minmax(y, QuantConfig(op.act_bits, False, None))
    return y


def _apply_block(x, block: G.BlockSpec, params, *, qat, capture, bn_stats):
    y = x
    for op in block.ops:
        y = _apply_op(y, op, params[op.name], qat=qat, bn_stats=bn_stats)
        if capture is not None:
            capture[op.name] = y
        if block.se is not None and block.se_after == op.name:
            y = _apply_se(y, block.se, params, qat=qat, capture=capture)
    if block.residual and x.shape == y.shape:
        y = x + y
        if capture is not None:
            capture[block.name + "/residual"] = y
    if block.avgpool:
        y = global_avg_pool(y)
        if capture is not None:
            capture[block.name + "/avgpool"] = y
    return y


def _apply_se(x, se: G.SESpec, params, *, qat, capture):
    s = global_avg_pool(x)  # squeeze: global spatial features
    s = _apply_op(s, se.squeeze, params[se.squeeze.name], qat=qat)
    s = _apply_op(s, se.excite, params[se.excite.name], qat=qat)
    if capture is not None:
        capture["se_gate"] = s
    return x * s.reshape(s.shape[0], *([1] * (x.ndim - 2)), s.shape[-1])


def forward(
    params,
    x: torch.Tensor,
    net: G.NetSpec,
    *,
    qat: bool = False,
    capture: bool = False,
    bn_stats: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Run the network on x (NHWC, or NTC for a 1-D net). Returns (logits,
    activations or None).

    `bn_stats`: a dict runs BN ops on batch statistics (float
    pre-training) and is filled with each op's batch moments; None folds
    the running stats into the weights (QAT and inference)."""
    acts: Optional[Dict[str, torch.Tensor]] = {} if capture else None
    y = x
    for block in net.blocks:
        y = _apply_block(y, block, params, qat=qat, capture=acts,
                         bn_stats=bn_stats)
    return y, acts


def make_calibrated_qnet(net: G.NetSpec, *, bits: int = 4, seed: int = 0,
                         n_cal: int = 2, device=None):
    """The demo deployment recipe in one call: random init (a
    `torch.Generator` seeded with `seed`) -> calibrate activations on
    `n_cal` random batches of 2 in [-1, 1] (generator seeds 0..n_cal-1)
    -> quantize to an integer QNet. The draws are the port's own, not the
    reference's `PRNGKey` ones, so the QNet is not the reference's
    `make_calibrated_qnet(seed)`; the golden fixtures come from the JAX
    package. The calibration forward runs on `device` (CUDA unless the
    caller passes another)."""
    from repro_torch.core.calibrate import calibrate
    from repro_torch.core.cu import resolve_device
    from repro_torch.core.qnet import quantize_net

    dev = resolve_device(device)
    params = init_params(seed, net, device=dev)

    def apply_fn(p, b):
        return forward(p, b, net, capture=True)[1]

    cal = [(torch.rand((2, *net.input_shape()),
                       generator=torch.Generator().manual_seed(i)) * 2 - 1
            ).to(dev) for i in range(n_cal)]
    with exact_f32():
        obs = calibrate(apply_fn, params, cal, QuantConfig(bits, False, None))
    return quantize_net(params, net, obs)


__all__ = [
    "exact_f32",
    "conv2d",
    "depthwise_conv2d",
    "conv1d",
    "depthwise_conv1d",
    "pointwise_conv2d",
    "relu6",
    "hsigmoid",
    "apply_act",
    "global_avg_pool",
    "init_op_params",
    "init_params",
    "fuse_bn_params",
    "weight_channel_axis",
    "forward",
    "make_calibrated_qnet",
]
