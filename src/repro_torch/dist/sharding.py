"""Meshes, logical-axis placement rules and data-parallel replicas.

Counterpart of `repro/dist/sharding.py`. The JAX package is single-
controller: one Python process drives every device of a mesh. So is the
port:

  * a `Mesh` is an array of `torch.device`s with named axes (`devices`,
    `axis_names`, `shape`, as the JAX Mesh has them). A device may stand in
    it more than once: `data_mesh(2, devices=["cuda:0", "cuda:0"])` is the
    counterpart of `XLA_FLAGS=--xla_force_host_platform_device_count=N`,
    two replicas on one card;
  * a placement is a `NamedSharding(mesh, spec)`, `spec` a `P` (the
    PartitionSpec: one entry a dim, a mesh axis name, a tuple of them, or
    None), normalized as JAX normalizes it;
  * a placed value (`place`) is a `Sharded`: the block each device of the
    mesh holds, in the mesh's device order. A replicated value holds one
    tensor a device; a batch-sharded one its row blocks in replica order.
    On a mesh of one device a placed value is the tensor itself on that
    device, as a JAX array on one device is one buffer.

Logical axes (model code names axes 'batch', 'heads', 'ffn', 'vocab',
'embed', ...; `logical_to_spec` maps them onto the active mesh):
  * 'batch'   -> every data-parallel mesh axis present (('pod', 'data') on a
                 multi-pod mesh, ('data',) on a single pod)
  * 'heads' / 'ffn' / 'vocab' / 'experts' -> 'model' (tensor parallelism)
  * 'embed'   -> 'data' under FSDP, else None
  * a name that IS a mesh axis passes through verbatim

`shard(x, *axes)` returns `x`: a layout hint that never changes a number.
The port has no partitioner to read such hints; a program that runs on a
mesh partitions itself (explicit SPMD, `models/lm/model.py` for the LMs):
each op runs on each device's block in mesh order, and the collectives
below join those steps.

Collectives over mesh axes (`psum`, `enter`, `all_gather`,
`reduce_scatter`, `pmax`): each takes the blocks of every executed device
and returns theirs, a sum being a left fold in mesh order (XLA's CPU
all-reduce order, as `compressed_psum`'s). All but `pmax` are autograd
functions with explicit backward passes, so that one backward pass over a
partitioned program trains every block, as `jax.grad` does through GSPMD:
all-gather's backward is a reduce-scatter and reduce-scatter's an
all-gather, psum's is the identity and `enter`'s (the identity) is a
psum. That pairing holds because a value replicated over an axis carries
one cotangent, which each device holds whole (Megatron's f and g): a
replicated loss is differentiated on every device with a cotangent of 1.
Where every member of a gather's group goes on to compute the same thing
(batch rows replicated over 'data' under FSDP), `all_gather(whole=True)`
keeps each member's own block of its whole cotangent instead. Every
collective adds its operand bytes (one device's) by kind to its mesh's
`collectives` counter, backward passes included: the port's stand-in for
the collective bytes the reference reads from its HLO.

On a mesh of meta devices (the dry-run's 256 and 512 chips) one device's
program stands for every device's: a meta tensor has a shape and no
values, and every device's block has the same shape (`_fit_spec_to_shape`
splits only what divides), so a placed value holds the block of the
mesh's first device alone and each collective takes that block for every
member of its group.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import threading
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

# mesh axes that carry data parallelism, outermost first
_DATA_AXES = ("pod", "data")
# logical axes that map onto the tensor-parallel mesh axis
_MODEL_AXES = frozenset({"heads", "ffn", "vocab", "experts"})


class P(tuple):
    """A PartitionSpec: one entry a dim. An entry is None (not split), a
    mesh axis name, or a tuple of names (split over their product); a tuple
    of one name is that name and an empty tuple is None, as JAX stores
    them."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e

        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")


class CollectiveCounter:
    """Operand bytes of the collectives run on a mesh, by kind, one
    device's (every device of a group moves the same), and their number."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.bytes = {k: 0 for k in COLLECTIVE_KINDS}
        self.n_ops = 0

    def add(self, kind: str, nbytes: int) -> None:
        self.bytes[kind] += int(nbytes)
        self.n_ops += 1

    def snapshot(self) -> dict:
        return {**self.bytes, "n_ops": self.n_ops}


class Mesh:
    """Devices on named axes: `devices` an object array of `torch.device`s
    whose dims are `axis_names`; `shape` maps each name to its extent.
    `collectives` counts what the collectives on it moved. On a mesh of
    meta devices (`symmetric`) the first device's program stands for all
    (`executed` is (0,); see the module docstring)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        from repro_torch.core.cu import resolve_device

        arr = np.asarray(devices, dtype=object)
        flat = np.empty(arr.size, dtype=object)
        for i, d in enumerate(arr.reshape(-1)):
            flat[i] = resolve_device(d)
        self.devices = flat.reshape(arr.shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {self.devices.shape} for "
                             f"axes {self.axis_names}")
        self.symmetric = all(d.type == "meta" for d in flat)
        self.executed = (0,) if self.symmetric else tuple(range(flat.size))
        self.collectives = CollectiveCounter()
        self._groups = {}

    def groups(self, axes: Sequence[str]) -> Tuple[Tuple[int, ...], ...]:
        """For each flat device index, the flat indices of its group over
        `axes` (the devices that differ from it only along `axes`), in
        mesh order."""
        axes = tuple(a for a in self.axis_names if a in axes)
        if axes not in self._groups:
            idx = np.arange(self.size).reshape(self.devices.shape)
            pos = [self.axis_names.index(a) for a in axes]
            rest = [i for i in range(idx.ndim) if i not in pos]
            rows = idx.transpose(rest + pos).reshape(
                -1, math.prod(idx.shape[i] for i in pos) if pos else 1)
            out = [None] * self.size
            for row in rows:
                for i in row:
                    out[int(i)] = tuple(int(j) for j in row)
            self._groups[axes] = tuple(out)
        return self._groups[axes]

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(
            zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_list(self) -> Tuple[torch.device, ...]:
        """The devices in flat (row-major) order."""
        return tuple(self.devices.reshape(-1))

    def coords(self, i: int) -> dict:
        """Axis name -> index of the flat `i`-th device."""
        return dict(zip(self.axis_names,
                        np.unravel_index(i, self.devices.shape)))

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and self.device_list == other.device_list)

    def __hash__(self) -> int:
        return hash((self.axis_names, self.devices.shape,
                     tuple(str(d) for d in self.device_list)))

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"[{', '.join(str(d) for d in self.device_list)}])")


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A placement: `spec` laid out on `mesh`."""

    mesh: Mesh
    spec: P


class _State(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None
        self.fsdp: bool = False


_STATE = _State()


def current_mesh() -> Optional[Mesh]:
    return _STATE.mesh


@contextlib.contextmanager
def use_mesh(mesh: Mesh, fsdp: bool = False):
    """Activate `mesh` for `shard` / `axis_size` within the context."""
    prev = (_STATE.mesh, _STATE.fsdp)
    _STATE.mesh, _STATE.fsdp = mesh, fsdp
    try:
        yield mesh
    finally:
        _STATE.mesh, _STATE.fsdp = prev


def axis_size(name: str) -> int:
    """Size of a mesh axis under the active mesh (1 when absent / no mesh)."""
    mesh = _STATE.mesh
    if mesh is None:
        return 1
    return int(dict(mesh.shape).get(name, 1))


def logical_to_spec(axes: Sequence[Optional[str]], mesh: Mesh,
                    fsdp: bool = False) -> P:
    """Logical axis names -> the spec for `mesh` (see the module rules)."""
    present = set(mesh.axis_names)
    out = []
    for ax in axes:
        if ax is None:
            out.append(None)
        elif ax == "batch":
            out.append(tuple(a for a in _DATA_AXES if a in present))
        elif ax == "embed":
            out.append("data" if (fsdp and "data" in present) else None)
        elif ax in _MODEL_AXES:
            out.append("model" if "model" in present else None)
        elif ax in present:
            out.append(ax)
        else:
            out.append(None)
    return P(*out)


def _names(entry) -> Tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


def _extent(entry, mesh: Mesh) -> int:
    sizes = dict(mesh.shape)
    return math.prod(int(sizes[n]) for n in _names(entry))


def _fit_spec_to_shape(spec: P, shape: Tuple[int, ...], mesh: Mesh) -> P:
    """Drop split axes whose mesh extent does not divide the dim size (a
    vocab that is not a multiple of the TP degree stays whole)."""
    out = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        if entry is None:
            out.append(None)
            continue
        extent = _extent(entry, mesh)
        out.append(entry if extent > 0 and dim % extent == 0 else None)
    return P(*out)


def shard(x, *axes: Optional[str]):
    """The logical layout of `x` under the active mesh: a hint that never
    changes a number, so `x` itself."""
    return x


def named_sharding(mesh: Mesh, axes: Sequence[Optional[str]],
                   fsdp: bool = False) -> NamedSharding:
    """A placement from logical axes (`()` -> fully replicated)."""
    return NamedSharding(mesh, logical_to_spec(axes, mesh, fsdp))


def _is_axes(x: Any) -> bool:
    """A logical-axes leaf: a (possibly empty) tuple of names / Nones."""
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, str) for a in x)


def _map_axes(fn, logical, shapes=None):
    if _is_axes(logical):
        return fn(logical, shapes)
    if isinstance(logical, dict):
        return {k: _map_axes(fn, v, None if shapes is None else shapes[k])
                for k, v in logical.items()}
    if isinstance(logical, (list, tuple)):
        kids = [_map_axes(fn, v, None if shapes is None else shapes[i])
                for i, v in enumerate(logical)]
        return type(logical)(kids) if isinstance(logical, list) \
            else tuple(kids)
    raise TypeError(f"not a tree of logical axes: {logical!r}")


def tree_shardings(logical, mesh: Mesh, fsdp: bool = False, shapes=None):
    """A tree of logical-axes tuples -> the same tree of placements.

    `shapes` (an aligned tree of tensors or anything with `.shape`) fits
    each spec to its leaf: an axis that does not divide its dim is
    dropped."""

    def one(axes, leaf):
        spec = logical_to_spec(axes, mesh, fsdp)
        if leaf is not None:
            spec = _fit_spec_to_shape(spec, tuple(leaf.shape), mesh)
        return NamedSharding(mesh, spec)

    return _map_axes(one, logical, shapes)


# ---------------------------------------------------------------------------
# serving replication: a 1-D 'data' mesh and placement
# ---------------------------------------------------------------------------


def visible_devices(device=None) -> Tuple[torch.device, ...]:
    """The devices of `device`'s type this process sees, as JAX counts
    them: every CUDA device (`torch.cuda.device_count()`), or one CPU.
    CUDA unless `device` names another type; raises without a card."""
    from repro_torch.core.cu import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (torch.device(dev.type),)


def data_mesh(replicas: Optional[int] = None, devices=None,
              device=None) -> Mesh:
    """1-D data-parallel mesh over the first `replicas` devices ('data').

    The serving analogue of DeepDive's CU replication: every replica holds
    the full integer datapath (constants replicated), micro-batches split
    along 'data'. `devices` defaults to `visible_devices(device)`; a list
    may name one device several times (several replicas on one card)."""
    devs = list(visible_devices(device) if devices is None else devices)
    n = len(devs) if replicas is None else int(replicas)
    if n <= 0 or n > len(devs):
        raise ValueError(f"replicas={n} with {len(devs)} visible devices")
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devs[:n]):
        arr[i] = d
    return Mesh(arr, ("data",))


def replicated(mesh: Mesh) -> NamedSharding:
    """Fully-replicated placement on `mesh` (the constant/weight sharding)."""
    return NamedSharding(mesh, P())


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-dim 'data' split (the activation/micro-batch sharding)."""
    return NamedSharding(mesh, P("data"))


def _slices(sharding: NamedSharding, i: int, shape) -> Tuple[slice, ...]:
    """The block of a value of `shape` that the mesh's flat `i`-th device
    holds under `sharding`."""
    mesh, spec = sharding.mesh, sharding.spec
    sizes, at = dict(mesh.shape), mesh.coords(i)
    out = []
    for d, dim in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        if entry is None:
            out.append(slice(0, dim))
            continue
        extent, pos = _extent(entry, mesh), 0
        for name in _names(entry):
            pos = pos * int(sizes[name]) + int(at[name])
        if dim % extent:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"{extent} ways ({entry!r})")
        step = dim // extent
        out.append(slice(pos * step, (pos + 1) * step))
    return tuple(out)


class Sharded:
    """A value placed on a mesh of several devices: `parts[k]` is the block
    the mesh's `executed[k]`-th device holds under `sharding` (every
    device's, in flat order; on a meta mesh the first device's alone)."""

    __slots__ = ("parts", "sharding")

    def __init__(self, parts: Sequence[torch.Tensor],
                 sharding: NamedSharding):
        self.parts = tuple(parts)
        self.sharding = sharding

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def shape(self) -> torch.Size:
        part, spec = self.parts[0].shape, self.sharding.spec
        return torch.Size(
            n * (_extent(spec[d], self.mesh)
                 if d < len(spec) and spec[d] is not None else 1)
            for d, n in enumerate(part))

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def is_cuda(self) -> bool:
        return any(p.is_cuda for p in self.parts)

    def map(self, fn) -> "Sharded":
        """`fn(part, i)` on every device's block, the layout kept."""
        return Sharded([fn(p, i) for i, p in enumerate(self.parts)],
                       self.sharding)

    def gather(self, device="cpu") -> torch.Tensor:
        """The whole value as one tensor on `device`."""
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        seen = set()
        for i, part in enumerate(self.parts):
            sl = _slices(self.sharding, i, out.shape)
            key = tuple((s.start, s.stop) for s in sl)
            if key not in seen:
                seen.add(key)
                out[sl] = part.to(device)
        return out

    def cpu(self) -> torch.Tensor:
        return self.gather("cpu")

    def __repr__(self) -> str:
        return (f"Sharded(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"spec={self.sharding.spec!r}, mesh={self.mesh!r})")


def _put(t: torch.Tensor, dev: torch.device, non_blocking: bool,
         copy: bool) -> torch.Tensor:
    if non_blocking and dev.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()  # a pinned copy, so the upload runs async
    return t.to(dev, non_blocking=non_blocking, copy=copy).contiguous()


def place(x, sharding: NamedSharding, *, non_blocking: bool = False):
    """`x` laid out as `sharding` says: a `Sharded` of every device's block
    (each its own copy, also where a device stands twice in the mesh), or
    on a mesh of one device the tensor on it. With `non_blocking`, host
    blocks bound for a card go through pinned memory and upload async."""
    x = torch.as_tensor(x)
    mesh = sharding.mesh
    if mesh.size == 1:
        return _put(x, mesh.device_list[0], non_blocking, copy=False)
    devs = mesh.device_list
    return Sharded([_put(x[_slices(sharding, i, x.shape)], devs[i],
                         non_blocking, copy=True)
                    for i in mesh.executed], sharding)


def replicate(x, mesh: Optional[Mesh]):
    """Place one tensor replicated across `mesh`; `x` itself when `mesh`
    is None, so callers never branch on distribution."""
    if mesh is None:
        return x
    return place(x, replicated(mesh))


def parts_of(x) -> Tuple[torch.Tensor, ...]:
    """The device blocks of a placed value (a tensor is its own block)."""
    return x.parts if isinstance(x, Sharded) else (x,)


def spec_axes(spec: P) -> Tuple[str, ...]:
    """The mesh axes a spec splits over."""
    return tuple(n for e in spec if e is not None for n in _names(e))


def leafwise(fn, *xs):
    """`fn` on every device's block of the placed values `xs` (plain
    tensors and scalars are every device's), the first `Sharded`'s layout
    kept; `fn(*xs)` where none is a `Sharded`."""
    lead = next((x for x in xs if isinstance(x, Sharded)), None)
    if lead is None:
        return fn(*xs)
    return Sharded([fn(*(x.parts[k] if isinstance(x, Sharded) else x
                         for x in xs)) for k in range(len(lead.parts))],
                   lead.sharding)


# ---------------------------------------------------------------------------
# collectives over mesh axes (explicit SPMD; see the module docstring)
# ---------------------------------------------------------------------------


class _Flag(threading.local):
    def __init__(self):
        self.on = False


_IN_COLLECTIVE = _Flag()


def in_collective() -> bool:
    """Is a collective moving data now? (Its copies and sums are not the
    program's own work: a trace counts them as collective bytes.)"""
    return _IN_COLLECTIVE.on


@contextlib.contextmanager
def _moving():
    prev, _IN_COLLECTIVE.on = _IN_COLLECTIVE.on, True
    try:
        yield
    finally:
        _IN_COLLECTIVE.on = prev


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _members(mesh: Mesh, axes) -> list:
    """For each executed device, the positions in `executed` of its group
    over `axes`, in mesh order (the first device's for every member on a
    meta mesh)."""
    groups = mesh.groups(axes)
    if mesh.symmetric:
        return [[0] * len(groups[0])]
    return [list(groups[i]) for i in mesh.executed]


def _fold(xs, members, op):
    """out[k] = op-fold of xs over k's group, left to right, on k's device;
    each group's result is computed once and copied to its other members
    (every device its own buffer)."""
    out, done = [None] * len(members), {}
    for k, grp in enumerate(members):
        key = tuple(grp)
        dev = xs[k].device
        if key not in done:
            acc = xs[grp[0]].to(dev, copy=True)
            for j in grp[1:]:
                acc = op(acc, xs[j].to(dev))
            done[key] = acc
            out[k] = acc
        else:
            out[k] = done[key].to(dev, copy=True)
    return out


def _psum_parts(xs, members):
    return _fold(xs, members, torch.add)


class _PSum(torch.autograd.Function):
    """Forward: the sum over each group (an all-reduce). Backward: the
    identity (the sum is replicated over the group; its one cotangent
    stands on every member)."""

    @staticmethod
    def forward(ctx, mesh, axes, *xs):
        mesh.collectives.add("all-reduce", _nbytes(xs[0]))
        with _moving():
            return tuple(_psum_parts(xs, _members(mesh, axes)))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *gs)


class _Enter(torch.autograd.Function):
    """Forward: the identity (a value replicated over `axes` entering work
    split over them). Backward: the sum of the members' partial
    cotangents (an all-reduce)."""

    @staticmethod
    def forward(ctx, mesh, axes, *xs):
        ctx.mesh, ctx.axes = mesh, axes
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        ctx.mesh.collectives.add("all-reduce", _nbytes(gs[0]))
        with _moving():
            return (None, None, *_psum_parts(gs, _members(ctx.mesh,
                                                          ctx.axes)))


def _gather(xs, mesh: Mesh, axis: str, dim: int) -> tuple:
    """Each group's blocks along `axis` concatenated along `dim` in mesh
    order, on each member's device."""
    mesh.collectives.add("all-gather", _nbytes(xs[0]))
    with _moving():
        return tuple(torch.cat([xs[j].to(xs[k].device) for j in grp],
                               dim=dim)
                     for k, grp in enumerate(_members(mesh, (axis,))))


def _positions(mesh: Mesh, axis: str) -> list:
    """Each executed device's index in its group along `axis`."""
    if mesh.symmetric:
        return [0]
    return [mesh.groups((axis,))[i].index(i) for i in mesh.executed]


def _reduce_scatter(xs, mesh: Mesh, axis: str, dim: int, size: int):
    """Each group's sum along `axis`, each member keeping its own block
    of `size` along `dim`."""
    mesh.collectives.add("reduce-scatter", _nbytes(xs[0]))
    with _moving():
        total = _psum_parts(xs, _members(mesh, (axis,)))
        return [t.narrow(dim, p * size, size).contiguous()
                for t, p in zip(total, _positions(mesh, axis))]


class _AllGather(torch.autograd.Function):
    """Forward: each group's blocks concatenated along `dim` in mesh order.
    Backward: a reduce-scatter (the sum of the members' cotangents, each
    member keeping its own block)."""

    @staticmethod
    def forward(ctx, mesh, axis, dim, *xs):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.size = xs[0].shape[dim]
        return _gather(xs, mesh, axis, dim)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None, *_reduce_scatter(gs, ctx.mesh, ctx.axis,
                                                   ctx.dim, ctx.size))


class _AllGatherWhole(torch.autograd.Function):
    """An all-gather whose members go on to compute the same thing (batch
    rows replicated over the data axes): each holds the whole cotangent,
    so the backward keeps its own block of it and sums nothing, as GSPMD
    transposes a gather into a replicated value."""

    @staticmethod
    def forward(ctx, mesh, axis, dim, *xs):
        ctx.dim, ctx.size = dim, xs[0].shape[dim]
        ctx.pos = _positions(mesh, axis)
        return _gather(xs, mesh, axis, dim)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None, *(
            g.narrow(ctx.dim, p * ctx.size, ctx.size).contiguous()
            for g, p in zip(gs, ctx.pos)))


class _ReduceScatter(torch.autograd.Function):
    """Forward: each group's sum along `axis`, each member keeping its own
    block along `dim` (a psum followed by the device's slice). Backward:
    an all-gather of the members' cotangents (each member's block of the
    sum was consumed by that member alone)."""

    @staticmethod
    def forward(ctx, mesh, axis, dim, *xs):
        size = xs[0].shape[dim] // len(_members(mesh, (axis,))[0])
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return tuple(_reduce_scatter(xs, mesh, axis, dim, size))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None, *_gather(gs, ctx.mesh, ctx.axis, ctx.dim))


def _axes(mesh: Mesh, axes) -> Tuple[str, ...]:
    """`axes` present on `mesh` with more than one device."""
    sizes = dict(mesh.shape)
    return tuple(a for a in axes if sizes.get(a, 1) > 1)


def psum(xs, mesh: Mesh, axes) -> list:
    """The sum of each device's block over its group along `axes`; the
    blocks themselves where those axes hold one device."""
    axes = _axes(mesh, axes)
    return list(_PSum.apply(mesh, axes, *xs)) if axes else list(xs)


def enter(xs, mesh: Mesh, axes) -> list:
    """Blocks replicated over `axes` entering work split over them: the
    same values, whose cotangents are summed over the group."""
    axes = _axes(mesh, axes)
    return list(_Enter.apply(mesh, axes, *xs)) if axes else list(xs)


def all_gather(xs, mesh: Mesh, axis: str, dim: int,
               whole: bool = False) -> list:
    """Each device's group's blocks (along `axis`) joined along `dim`.
    The backward sums the members' partial cotangents (a reduce-scatter);
    with `whole`, where every member computes the same thing from the
    gathered value, it keeps each member's own block of its cotangent."""
    if not _axes(mesh, (axis,)):
        return list(xs)
    dim = dim % xs[0].dim()
    fn = _AllGatherWhole if whole else _AllGather
    return list(fn.apply(mesh, axis, dim, *xs))


def reduce_scatter(xs, mesh: Mesh, axis: str, dim: int) -> list:
    """The sum of each device's block over its group along `axis`, split
    along `dim` among the members, each keeping its own block."""
    if not _axes(mesh, (axis,)):
        return list(xs)
    dim = dim % xs[0].dim()
    return list(_ReduceScatter.apply(mesh, axis, dim, *xs))


def pmax(xs, mesh: Mesh, axes) -> list:
    """The elementwise maximum over each group along `axes` (no gradient:
    a statistic, as `jax.lax.stop_gradient` of a max)."""
    axes = _axes(mesh, axes)
    if not axes:
        return list(xs)
    mesh.collectives.add("all-reduce", _nbytes(xs[0]))
    with torch.no_grad(), _moving():
        return _fold([x.detach() for x in xs], _members(mesh, axes),
                     torch.maximum)


__all__ = [
    "shard",
    "axis_size",
    "use_mesh",
    "current_mesh",
    "logical_to_spec",
    "named_sharding",
    "tree_shardings",
    "data_mesh",
    "replicated",
    "batch_sharding",
    "replicate",
    "P",
    "Mesh",
    "NamedSharding",
    "Sharded",
    "place",
    "parts_of",
    "visible_devices",
    "COLLECTIVE_KINDS",
    "CollectiveCounter",
    "in_collective",
    "spec_axes",
    "leafwise",
    "psum",
    "enter",
    "all_gather",
    "reduce_scatter",
    "pmax",
]
