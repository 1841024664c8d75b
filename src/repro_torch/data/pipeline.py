"""Deterministic synthetic image stream for the vision trainer.

Counterpart of `repro/data/pipeline.py` (`image_batch` only, a copy: numpy
alone). Batches are generated counter-based from (seed, step), so a run
restarted from a checkpoint resumes the exact stream, and the labels are
learnable (class-conditional spatial patterns plus noise).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


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


__all__ = ["image_batch"]
