"""QNet-level wrappers around the hand-written kernels.

Counterpart of `repro/kernels/ops.py`: these adapt a `PreparedQNet`'s
device-resident constants to the raw kernel signatures. Which CU op takes
which kernel:

    op kind    kernel (CUDA tensor; plain PyTorch version on the CPU)
    -------    -----------------------------------------------------
    PW/DENSE   pointwise_conv.pointwise_conv_q
    DW         depthwise_conv.depthwise_conv_q
    IRB        fused_irb.fused_irb_q (the Body CU's expand -> dw -> project)
    CONV       none: the stem runs as a float64 torch convolution (exact;
               a tuned route may take float32 under the 2^24 bound); the
               SE gate, residual add and avgpool are torch ops too

Every route here uses the reference interpreter's integer zero-point
correction and residual form, so it is bit-exact with `core/cu.py`.

The LM entry points, as in the JAX package: `quantize_weight_for_matmul`
and `quantized_linear` (weight-only W8/W4 linear through
`quant_matmul.quant_matmul`) and `decode_attend` (grouped decode attention
over a KV-cache dict through `decode_attention.decode_attention`). No
model calls them yet: the JAX LM computes its linears and attention in
plain jnp, and so will the port's.

`launch_counts()` reads the kernels' launch counters; K2, K4 and K5 also
count their launches by variant (`pointwise_conv_q.variants`,
`fused_irb_q.variants`, `quant_matmul.variants`). `served_launches(plan)`
works out from a net's CU plan the launches one micro-batch makes through
the stage executors, on the default routes or (`routes=`, `fused=`) on a
resolved selection.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import compiler as _CC
from repro_torch.core import cu as _cu
from repro_torch.core import graph as G
from repro_torch.core.quant import pack_int4, symmetric_range
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.depthwise_conv import depthwise_conv_q
from repro_torch.kernels.fused_irb import fused_irb_q
from repro_torch.kernels.pointwise_conv import pointwise_conv_q
from repro_torch.kernels.quant_matmul import quant_matmul

KERNELS = (pointwise_conv_q, depthwise_conv_q, fused_irb_q, quant_matmul,
           decode_attention)


def launch_counts() -> Dict[str, int]:
    """{kernel name: launches since the last reset}."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    """Zero every launch counter, and the per-variant counters of the
    kernels that have variants."""
    for k in KERNELS:
        k.launches = 0
        if hasattr(k, "variants"):
            k.variants = dict.fromkeys(k.variants, 0)


def served_launches(plan: _CC.CUPlan, routes=None,
                    fused=None) -> Dict[str, int]:
    """{kernel name: launches} of one micro-batch through the stage
    executors: a block in `fused` is one fused-IRB launch, and every op of
    the other blocks (the SE squeeze included) launches the kernel its
    route names, K2 for `pallas_pw` and K3 for `pallas_dw`. Without
    `routes`, those of the stages compiled on the card with no cache
    (`compile_stages`' defaults: K4 for each fusable Body block, K3 / K2
    for the other DW and PW/DENSE ops)."""
    if routes is None:
        from repro_torch.tune.cache import TunedPlan

        routes, fused = TunedPlan(
            backend="cuda", nets=(), tuned_batch=0, entries={}
        ).resolve_with_defaults(plan.net, plan, backend="cuda",
                                op_kernels=True, body_fast_path=True)
    kernel_of = {"pallas_pw": "pointwise_conv_q",
                 "pallas_dw": "depthwise_conv_q"}
    n = dict.fromkeys(launch_counts(), 0)
    for block in plan.net.blocks:
        if block.name in (fused or ()):
            n["fused_irb_q"] += 1
            continue
        ops = block.ops + ((block.se.squeeze,) if block.se else ())
        for op in ops:
            route = routes.get(op.name, ("", {}))[0]
            if route in kernel_of and op.act != G.HSIGMOID:
                n[kernel_of[route]] += 1
    return n


def run_pw_qop(x_q: torch.Tensor, pop: _cu.PreparedQOp, *, block_m=None,
               block_n=None, block_k=None) -> torch.Tensor:
    """Pointwise / dense op through the pointwise kernel. Clips to
    [0, qmax] like the reference epilogue, linear ops included. `block_*`
    are a tuned route's tile (`pointwise_conv.BLOCKS_*`; None: `plan`'s)."""
    return pointwise_conv_q(x_q, pop.w_kern, pop.mult, pop.zpc, pop.bias_q,
                            qmax=pop.qmax, block_m=block_m, block_n=block_n,
                            block_k=block_k)


def run_dw_qop(x_q: torch.Tensor, pop: _cu.PreparedQOp) -> torch.Tensor:
    """Depthwise op through the depthwise kernel, integer correction form.
    The kernel has one layout, so a tuned route carries no params."""
    return depthwise_conv_q(x_q, pop.w_kern, pop.mult, pop.zpc, pop.bias_q,
                            kernel=pop.spec.kernel, stride=pop.spec.stride,
                            qmax=pop.qmax)


def fusable_irb(block: G.BlockSpec) -> bool:
    """True when `block` fits the fused Body-CU kernel: the canonical
    expand -> dw -> project shape with no squeeze-excitation branch and one
    activation bit-width (the kernel clips all three stages with a single
    qmax, so mixed act_bits would requantize wrongly)."""
    return (
        len(block.ops) == 3
        and block.se is None
        and block.ops[0].kind == G.PW
        and block.ops[1].kind == G.DW
        and block.ops[2].kind == G.PW
        and not block.avgpool
        and len({op.act_bits for op in block.ops}) == 1
    )


def irb_args(block: G.BlockSpec, pq: _cu.PreparedQNet, in_s: float,
             in_z: float):
    """(positional tensors, keyword args, out_s, out_z) of `fused_irb_q`
    for one fusable block of a prepared net."""
    q1, q2, q3 = (pq.ops[op.name] for op in block.ops)
    tensors = (q1.w_kern, q1.mult, q1.zpc, q1.bias_q,
               q2.w_kern, q2.mult, q2.zpc, q2.bias_q,
               q3.w_kern, q3.mult, q3.zpc, q3.bias_q)
    kw = dict(kernel=q2.spec.kernel, stride=q2.spec.stride, qmax=q3.qmax,
              residual=block.residual)
    out_s, out_z = q3.out_scale, q3.out_zp
    if block.residual:
        y_s, y_z = pq.res_q[block.name]
        kw["res_q"] = (in_s, in_z, q3.out_scale, q3.out_zp, y_s, y_z)
        out_s, out_z = y_s, y_z
    return tensors, kw, out_s, out_z


def run_irb_block(x_q: torch.Tensor, block: G.BlockSpec,
                  pq: _cu.PreparedQNet, in_s: float, in_z: float):
    """Body-CU invocation: a fusable IRB through the fused kernel.
    Returns (y_q, out_s, out_z)."""
    if not fusable_irb(block):
        raise ValueError(f"{block.name} does not fit the fused-IRB kernel")
    tensors, kw, out_s, out_z = irb_args(block, pq, in_s, in_z)
    return fused_irb_q(x_q, *tensors, **kw), out_s, out_z


# ---------------------------------------------------------------------------
# LM-side weight-only quantized linear (per-channel / grouped, BW in {4, 8})
# and grouped decode attention
# ---------------------------------------------------------------------------


def quantize_weight_for_matmul(w: torch.Tensor, bits: int = 4,
                               group_size: Optional[int] = None):
    """[K, N] float -> (w_q, scales [G, N]), symmetric per (k-group, out
    column): scale = amax / qmax (1 where amax is 0), w_q = clip(round(w /
    scale)) in [-qmax, qmax], int8 [K, N] at 8 bits or packed uint8
    [K, N/2] at 4. The same bits as the JAX function: true division, round
    half to even, in w's dtype."""
    k, n = w.shape
    group_size = k if group_size is None else group_size
    qmin, qmax = symmetric_range(bits)
    wg = w.reshape(k // group_size, group_size, n)
    amax = wg.abs().amax(dim=1)
    # a 0-dim device tensor: PyTorch's CUDA division by a host scalar
    # multiplies by its reciprocal, which can round differently
    qmax_t = torch.full((), qmax, dtype=w.dtype, device=w.device)
    scale = torch.where(amax > 0, amax / qmax_t, 1.0)
    q = torch.clamp(torch.round(wg / scale[:, None, :]), qmin, qmax)
    q = q.reshape(k, n).to(torch.int32)
    if bits == 4:
        return pack_int4(q), scale
    return q.to(torch.int8), scale


def quantized_linear(x: torch.Tensor, w_q: torch.Tensor,
                     w_scale: torch.Tensor, bits: int = 4) -> torch.Tensor:
    """y = x @ dequant(w_q), x [..., K] -> [..., N] in x's dtype, through
    the quantized-matmul kernel (f32 inside)."""
    lead, k = x.shape[:-1], x.shape[-1]
    y = quant_matmul(x.reshape(-1, k).contiguous(), w_q, w_scale, bits=bits)
    return y.reshape(*lead, y.shape[-1]).to(x.dtype)


def decode_attend(q: torch.Tensor, kv_cache: Dict[str, torch.Tensor],
                  kv_len) -> torch.Tensor:
    """Flash-decode attention over a model KV-cache dict.

    q: [B, 1, H, dh] (one new token); kv_cache: {"k", "v"[, "k_scale",
    "v_scale"]} with k/v [B, S, KV, dh]; query head h = g * rep + r reads kv
    head g. Returns [B, 1, H, dh]."""
    b, _, h, dh = q.shape
    kv = kv_cache["k"].shape[2]
    qg = q.reshape(b, kv, h // kv, dh).contiguous()
    out = decode_attention(qg, kv_cache["k"], kv_cache["v"], kv_len,
                           kv_cache.get("k_scale"), kv_cache.get("v_scale"))
    return out.reshape(b, 1, h, dh)


__all__ = [
    "quantize_weight_for_matmul",
    "quantized_linear",
    "decode_attend",
    "launch_counts",
    "reset_launch_counts",
    "run_pw_qop",
    "run_dw_qop",
    "fusable_irb",
    "irb_args",
    "run_irb_block",
]
