"""Deterministic synthetic data streams: LM tokens and labeled images.

Counterpart of `repro/data/pipeline.py` (a copy: numpy alone). Batches are
generated counter-based from (seed, step[, host]), so a run restarted from
a checkpoint resumes the exact stream (no repeated batches), a change of
the data-parallel world size re-partitions it deterministically, and no
host I/O is needed. Both corpora are learnable: each LM token follows the
previous one by a small jump, each image's label sets its spatial pattern.

The tokens stay int32 numpy arrays; the trainer widens them to int64
where it indexes with them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    vocab: int = 32000
    seq_len: int = 1024
    global_batch: int = 32
    n_hosts: int = 1
    host_id: int = 0


def _rng_for(cfg: DataConfig, step: int) -> np.random.Generator:
    # counter-based: a fresh generator per (seed, step, host) triple
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id]))


def lm_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Host-local shard of the global batch for `step`."""
    if cfg.global_batch % cfg.n_hosts:
        raise ValueError(f"global batch {cfg.global_batch} is not a "
                         f"multiple of {cfg.n_hosts} hosts")
    local = cfg.global_batch // cfg.n_hosts
    rng = _rng_for(cfg, step)
    # next token = previous + a jump in [1, 16], so a model can learn it
    tokens = np.zeros((local, cfg.seq_len), np.int32)
    tokens[:, 0] = rng.integers(0, cfg.vocab, local)
    jumps = rng.integers(1, 17, (local, cfg.seq_len))
    for t in range(1, cfg.seq_len):
        tokens[:, t] = (tokens[:, t - 1] + jumps[:, t]) % cfg.vocab
    return {"tokens": tokens}


def lm_stream(cfg: DataConfig, start_step: int = 0) -> Iterator[Dict]:
    step = start_step
    while True:
        yield lm_batch(cfg, step)
        step += 1


def image_batch(seed: int, step: int, batch: int, hw: int, classes: int,
                channels: int = 3) -> Dict[str, np.ndarray]:
    """Learnable synthetic image classification (class-conditional blobs)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    labels = rng.integers(0, classes, batch)
    # class-dependent spatial frequency pattern + noise
    xx, yy = np.meshgrid(np.linspace(0, 1, hw), np.linspace(0, 1, hw))
    imgs = np.empty((batch, hw, hw, channels), np.float32)
    for i, c in enumerate(labels):
        freq = 1 + (c % 5)
        phase = (c // 5) * 0.7
        base = np.sin(2 * np.pi * freq * xx + phase) * np.cos(
            2 * np.pi * freq * yy - phase)
        imgs[i] = base[..., None] + 0.3 * rng.standard_normal((hw, hw, channels))
    return {"images": imgs.astype(np.float32), "labels": labels.astype(np.int32)}


__all__ = ["DataConfig", "lm_batch", "lm_stream", "image_batch"]
