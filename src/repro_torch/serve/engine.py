"""Batched LM serving engine: prefill + decode over a fixed pool of slots.

Counterpart of `repro/serve/engine.py`, with the same semantics: requests
are taken from the queue in order, `batch_slots` at a time; each batch's
prompts are right-aligned and left-padded with token 0 (the padding is not
masked, as in the reference), prefilled together, and every slot then
advances in lockstep from `pos = plen` until each request has `max_new`
tokens. Greedy requests (temperature 0) take the argmax; the others sample
with the engine's own `torch.Generator` (Gumbel-max, as
`jax.random.categorical`), so their draws are not the JAX engine's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.cu import resolve_device
from repro_torch.models.lm import model as M
from repro_torch.models.lm.config import LMConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S] int32
    max_new: int = 32
    temperature: float = 0.0
    out: Optional[List[int]] = None


class Engine:
    """Serves `Request`s with `params` (on `device`: CUDA unless named)."""

    def __init__(self, cfg: LMConfig, params, batch_slots: int = 4,
                 max_len: int = 512, seed: int = 0, device=None):
        self.cfg = cfg
        self.params = params
        self.b = batch_slots
        self.max_len = max_len
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self._queue: List[Request] = []
        self._done: Dict[int, List[int]] = {}

    def submit(self, req: Request):
        req.out = []
        self._queue.append(req)

    def run(self) -> Dict[int, List[int]]:
        """Drain the queue, `batch_slots` requests at a time."""
        while self._queue:
            batch = self._queue[: self.b]
            self._queue = self._queue[self.b:]
            self._run_batch(batch)
        done, self._done = self._done, {}
        return done

    @torch.inference_mode()
    def _run_batch(self, reqs: List[Request]):
        cfg = self.cfg
        plen = max(len(r.prompt) for r in reqs)
        b = len(reqs)
        toks = np.zeros((b, plen), np.int64)
        for i, r in enumerate(reqs):  # right-align the prompts
            toks[i, plen - len(r.prompt):] = r.prompt
        logits, cache = M.prefill(
            self.params, cfg, torch.from_numpy(toks).to(self.device),
            max_len=self.max_len)
        pos = plen
        live = np.ones(b, bool)
        max_new = max(r.max_new for r in reqs)
        cur = self._sample(logits[:, 0], reqs)
        for i, r in enumerate(reqs):
            r.out.append(int(cur[i]))
        for _ in range(max_new - 1):
            token = torch.from_numpy(cur).to(self.device)[:, None]
            logits, cache = M.decode_step(self.params, cfg, token, cache,
                                          pos)
            pos += 1
            cur = self._sample(logits[:, 0], reqs)
            for i, r in enumerate(reqs):
                if live[i] and len(r.out) < r.max_new:
                    r.out.append(int(cur[i]))
                if len(r.out) >= r.max_new:
                    live[i] = False
            if not live.any():
                break
        for r in reqs:
            self._done[r.rid] = r.out

    def _sample(self, logits, reqs) -> np.ndarray:
        """[B, V] logits -> [B] int64 tokens on the host."""
        greedy = torch.argmax(logits, dim=-1)
        temps = torch.tensor([r.temperature for r in reqs],
                             dtype=torch.float32, device=logits.device)
        if not bool((temps != 0).any()):
            return greedy.cpu().numpy()
        scaled = logits / torch.clamp_min(temps, 1e-6)[:, None]
        tiny = torch.finfo(torch.float32).tiny
        u = torch.rand(scaled.shape, generator=self.gen, dtype=torch.float32,
                       device=logits.device).clamp_min(tiny)
        sampled = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
        return torch.where(temps == 0, greedy, sampled).cpu().numpy()


__all__ = ["Engine", "Request"]
