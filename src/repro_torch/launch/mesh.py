"""Mesh construction.

Counterpart of `repro/launch/mesh.py`. `make_mesh` lays devices out on
named axes; `make_host_mesh` is the degenerate (data, model) mesh over the
visible devices that tests, examples and the LM training driver use. The
reference's `make_production_mesh` (the 256- and 512-chip TPU pods) waits
for the dry-run (ROADMAP queue 1 item 13).
"""
from __future__ import annotations

import math

import numpy as np

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


def make_host_mesh(model_parallel: int = 1, devices=None,
                   device=None) -> Mesh:
    """(data, model) mesh over however many devices there are."""
    devs = list(visible_devices(device) if devices is None else devices)
    n = len(devs)
    return make_mesh((n // model_parallel, model_parallel),
                     ("data", "model"), devices=devs)


__all__ = ["make_mesh", "make_host_mesh"]
