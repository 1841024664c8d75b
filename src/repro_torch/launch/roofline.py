"""Roofline terms of one device's step, from a trace of the step.

    compute    = FLOPs(per device)                 / peak_FLOP/s(card)
    memory     = bytes read and written(per device) / HBM_bw(card)
    collective = collective operand bytes          / link_bw(card)

Counterpart of `repro/launch/roofline.py`. The reference reads its terms
from an XLA executable: FLOPs and bytes from `compiled.cost_analysis()` of
the SPMD-partitioned module, collective bytes by parsing the optimized HLO
text (`collective_bytes`). The port has no compiler and no HLO, so XLA's
HLO parsers have no counterpart here. Its terms come from running the step
under `trace_step` (on meta devices in the dry-run: shapes without data):

  * FLOPs: the matmul-class ops (mm, bmm, addmm, convolutions,
    attention) of the forward, the backward and every recomputation, by
    `torch.utils.flop_counter`'s formulas (`FlopCounterMode`'s, applied in
    the one dispatch mode that counts the bytes too); XLA also counts
    elementwise FLOPs, so the port's count is the smaller;
  * bytes: every op's input and output bytes (`_OpCounter`), one device's
    program op by op as eager PyTorch runs it: the traffic of the eager
    program, not the bytes the step's function needs (its parameters,
    state and saved activations read and written once), so the memory
    term falls where ops are fused, as XLA's `bytes accessed` counts its
    fused program. View and aliasing ops move none; collectives are
    counted under collective bytes, not here;
  * collective bytes: the operand bytes of every collective the step ran,
    by kind, from the mesh's counter (`dist/sharding.py`), which each
    collective of the port feeds (backward passes included);
  * memory: the live bytes of every storage the step allocated, followed
    to its release (a storage's Python object lives as long as its
    storage, saved activations included), with their peak: the port's own
    reckoning, where the reference reads XLA's buffer assignment.

Hardware constants: one NVIDIA H100 SXM (80 GB HBM3, 700 W):
989e12 bf16 FLOP/s dense and 3.35e12 B/s HBM (NVIDIA's H100 data sheet,
SXM column, without sparsity); 450e9 B/s of NVLink a direction (NVIDIA's
data sheet: 900 GB/s of NVLink 4 bandwidth a GPU, both directions).
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.dist import sharding as S

PEAK_FLOPS = 989e12  # bf16 dense, H100 SXM data sheet
HBM_BW = 3.35e12  # bytes/s, H100 SXM data sheet
LINK_BW = 450e9  # bytes/s a direction, NVLink 4 (900 GB/s both ways)

_COLLECTIVES = S.COLLECTIVE_KINDS


def shape_bytes(shape, dtype: torch.dtype) -> int:
    """Bytes of a tensor of `shape` and torch `dtype`."""
    n = 1
    for d in shape:
        n *= int(d)
    return n * torch.empty((), dtype=dtype).element_size()


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a tree (a `Sharded` counts one device's
    block)."""
    total = 0
    for leaf in tree_leaves(tree, is_leaf=lambda x: isinstance(x, S.Sharded)):
        if isinstance(leaf, S.Sharded):
            leaf = leaf.parts[0]
        if isinstance(leaf, torch.Tensor):
            total += shape_bytes(leaf.shape, leaf.dtype)
    return total


def _aliases(func) -> bool:
    """Does the op return one of its inputs or a view of one?"""
    return any(r.alias_info is not None for r in func._schema.returns)


class _OpCounter(TorchDispatchMode):
    """FLOPs of the matmul-class ops (`FlopCounterMode`'s formulas), bytes
    every op reads and writes, and the live bytes of the storages the
    traced program allocates (each released when its storage is)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.live = 0
        self.peak = 0
        self._open = set()

    def _free(self, key: int, nbytes: int) -> None:
        self._open.discard(key)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flops = flop_registry.get(func._overloadpacket)
        if flops is not None:
            self.flops += flops(*args, **kwargs, out_val=out)
        if _aliases(func):
            return out
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not S.in_collective():
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.hbm_bytes += sum(shape_bytes(t.shape, t.dtype)
                                  for t in ins + outs)
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._open:
                continue
            nbytes = st.nbytes()
            self._open.add(key)
            self.live += nbytes
            weakref.finalize(st, self._free, key, nbytes).atexit = False
        self.peak = max(self.peak, self.live)
        return out


@dataclasses.dataclass
class StepTrace:
    """What `trace_step` saw of one device's step."""

    flops: float
    hbm_bytes: float
    collectives: Dict[str, int]
    peak_live_bytes: int  # most bytes the step itself held at once
    seconds: float
    output: object = None


def trace_step(fn, mesh=None) -> StepTrace:
    """Run `fn()` once, counting its FLOPs, bytes and (on `mesh`) its
    collectives' operand bytes; the output is kept in the result."""
    if mesh is not None:
        mesh.collectives.reset()
    counter = _OpCounter()
    t0 = time.perf_counter()
    with counter:
        out = fn()
    seconds = time.perf_counter() - t0
    coll = (mesh.collectives.snapshot() if mesh is not None
            else {**{k: 0 for k in _COLLECTIVES}, "n_ops": 0})
    return StepTrace(float(counter.flops), float(counter.hbm_bytes),
                     coll, counter.peak, seconds, out)


@dataclasses.dataclass
class Roofline:
    flops: float  # per device
    hbm_bytes: float  # per device
    coll_bytes: float  # per device (operand bytes)
    coll_detail: Dict[str, int]
    n_devices: int

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def summary(self) -> Dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.coll_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "collectives": self.coll_detail,
        }


def from_trace(trace: StepTrace, n_devices: int) -> Roofline:
    """The roofline of a traced step (the reference's `from_compiled`)."""
    coll = dict(trace.collectives)
    total_coll = sum(v for k, v in coll.items() if k != "n_ops")
    return Roofline(trace.flops, trace.hbm_bytes, total_coll, coll,
                    n_devices)


def model_flops(cfg, shape, n_active_params: int) -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (inference) per the assignment."""
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active_params * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active_params * tokens
    # decode: one token per sequence
    return 2.0 * n_active_params * shape.global_batch


__all__ = [
    "Roofline", "from_trace", "trace_step", "StepTrace", "shape_bytes",
    "tensor_bytes", "model_flops", "PEAK_FLOPS", "HBM_BW", "LINK_BW",
]
