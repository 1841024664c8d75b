"""Checkpoint / restore with async write and rotation.

Counterpart of `repro/train/checkpoint.py`, with its on-disk format, so
either package restores the other's checkpoints:

    <dir>/step_000042/
        manifest.json       step, leaf count, tree structure, dtype tags,
                            caller metadata ("extra")
        arrays.npz          the leaves a0, a1, ... in the reference's leaf
                            order (`train/tree.py`)
    <dir>/LATEST            the newest complete step directory

  * writes are atomic: a tmp directory renamed into place, LATEST updated
    last, so a preempted writer never corrupts the restore path;
  * `save(async_=True)` copies every tensor to the host before its thread
    starts, then writes while the caller trains on;
  * `keep` rotation bounds the disk.

numpy has no bfloat16 or float8: those leaves are stored bit-cast to a
same-width unsigned integer with a dtype tag in the manifest, the
reference's encoding, done here with torch's own dtypes (no `ml_dtypes`).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.dist.sharding import Sharded, place
from repro_torch.train import tree as T

# torch dtype -> (manifest tag, integer dtype of the same width)
_BITCAST = {
    torch.bfloat16: ("bfloat16", torch.int16, np.uint16),
    torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8, np.uint8),
    torch.float8_e5m2: ("float8_e5m2", torch.uint8, np.uint8),
}
_BITCAST_BACK = {tag: (dt, ti) for dt, (tag, ti, _) in _BITCAST.items()}


def _encode(x) -> tuple:
    """(numpy array, dtype tag) of a leaf, on the host (a placed leaf
    whole)."""
    if isinstance(x, Sharded):
        x = x.gather("cpu")
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in _BITCAST:
            tag, ti, npu = _BITCAST[x.dtype]
            return x.view(ti).cpu().numpy().view(npu), tag
        a = x.cpu().numpy()
        return a, str(a.dtype)
    a = np.asarray(x)
    return a, str(a.dtype)


def _decode(a: np.ndarray, tag: str, device) -> torch.Tensor:
    if tag in _BITCAST_BACK:
        dt, ti = _BITCAST_BACK[tag]
        signed = a.view(np.int16) if ti == torch.int16 else a
        return torch.from_numpy(np.array(signed)).view(dt).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3,
         async_: bool = False, extra: Optional[dict] = None):
    """Copy the tree to the host and write a checkpoint. Returns the
    writer thread when async."""
    leaves, treedef = T.flatten(tree)
    encoded = [_encode(x) for x in leaves]
    np_leaves = [e[0] for e in encoded]
    dtype_tags = [e[1] for e in encoded]
    treedef_s = T.treedef_str(treedef)

    def _write():
        os.makedirs(ckpt_dir, exist_ok=True)
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"a{i}": a for i, a in enumerate(np_leaves)})
        manifest = {
            "step": step,
            "n_leaves": len(np_leaves),
            "treedef": treedef_s,
            "dtypes": dtype_tags,
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
            f.write(os.path.basename(final))
        os.replace(os.path.join(ckpt_dir, "LATEST.tmp"),
                   os.path.join(ckpt_dir, "LATEST"))
        _rotate(ckpt_dir, keep)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def _rotate(ckpt_dir: str, keep: int):
    steps = sorted(
        d for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    marker = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
        return None
    return int(name.split("_")[1])


def restore(ckpt_dir: str, target_tree: Any, *, step: Optional[int] = None,
            device=None, shardings: Any = None):
    """Load into the structure of `target_tree`. Each leaf goes to
    `device`, or to the device of the target's leaf in its place (the CPU
    where that is not a tensor). With `shardings` (a tree of placements
    aligned with the target: `dist.sharding.tree_shardings`, `replicated`,
    `batch_sharding`, or None for a leaf placed as without it) each leaf
    is placed as its sharding says instead (`dist.sharding.place`: one
    tensor a device where it is replicated, the rows split over 'data';
    the tensor itself on a mesh of one device); a placed leaf of the
    target (`Sharded`) with no sharding given is placed as it is. Returns
    (tree, step)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = [z[f"a{i}"] for i in range(len(z.files))]
    tags = manifest.get("dtypes") or [str(a.dtype) for a in arrays]
    leaves, treedef = T.flatten(target_tree)
    if len(arrays) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(arrays)} leaves, target expects {len(leaves)}")
    shard_leaves = (T.flatten_up_to(treedef, shardings)
                    if shardings is not None else [None] * len(leaves))
    out = []
    for a, tag, like, sh in zip(arrays, tags, leaves, shard_leaves):
        if sh is None and isinstance(like, Sharded):
            sh = like.sharding
        if sh is not None:
            out.append(place(_decode(a, tag, "cpu"), sh))
            continue
        dev = device if device is not None else (
            like.device if isinstance(like, torch.Tensor) else "cpu")
        out.append(_decode(a, tag, dev))
    return T.unflatten(treedef, out), step


__all__ = ["save", "restore", "latest_step"]
