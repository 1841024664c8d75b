"""Mesh construction.

Counterpart of `repro/launch/mesh.py`. `make_mesh` lays devices out on
named axes; `make_host_mesh` is the degenerate (data, model) mesh over the
visible devices that tests, examples and the LM training driver use;
`make_production_mesh` the reference's production shapes:

  * single pod: (data=16, model=16) = 256 devices;
  * multi-pod: (pod=2, data=16, model=16) = 512 devices; the 'pod' axis
    carries data parallelism across pods, so only gradient all-reduces
    cross it.

The dry-run builds it over `device="meta"` (512 meta devices, the
counterpart of `--xla_force_host_platform_device_count=512`): devices
with shapes and no memory, on which one device's program stands for all.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.dist.sharding import Mesh, visible_devices


def make_mesh(shape, axes, devices=None, device=None) -> Mesh:
    """The first prod(`shape`) of `devices` (default: the visible devices
    of `device`'s type, CUDA unless named) on the axes `axes`."""
    devs = list(visible_devices(device) if devices is None else devices)
    n = math.prod(shape)
    if n > len(devs):
        raise ValueError(f"mesh {tuple(shape)} needs {n} devices, "
                         f"{len(devs)} visible")
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devs[:n]):
        arr[i] = d
    return Mesh(arr.reshape(tuple(shape)), tuple(axes))


def make_production_mesh(multi_pod: bool = False, devices=None,
                         device=None) -> Mesh:
    """(16, 16) on ('data', 'model'), or (2, 16, 16) on ('pod', 'data',
    'model'), over `devices` (default: as many `device`s as the mesh has,
    where `device` is meta; else the visible devices of its type)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if devices is None and device is not None \
            and torch.device(device).type == "meta":
        devices = ["meta"] * math.prod(shape)
    return make_mesh(shape, axes, devices=devices, device=device)


def make_host_mesh(model_parallel: int = 1, devices=None,
                   device=None) -> Mesh:
    """(data, model) mesh over however many devices there are."""
    devs = list(visible_devices(device) if devices is None else devices)
    n = len(devs)
    return make_mesh((n // model_parallel, model_parallel),
                     ("data", "model"), devices=devs)


__all__ = ["make_mesh", "make_production_mesh", "make_host_mesh"]
