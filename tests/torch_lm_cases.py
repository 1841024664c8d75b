"""Inputs of the full-width LM-op cases at Llama-3.2-1B widths, made with
numpy from fixed seeds, so that the JAX package (which wrote the golden
`tests/golden_torch/llama32_1b_lm_ops.npz`), the port's CPU test and
`chip_smoke.py` on the card all compute from the same values. numpy only:
the machine with the card has no JAX.

Linears: the 7 of one decoder layer (q, k, v, o, gate, up, down) and the
tied `lm_head`, weights N(0, 1) * K**-0.5 as `init_linear` draws them.
Decode attention: B = 8, H = 32, KV = 8, dh = 64, S = 4096.
"""
from __future__ import annotations

import numpy as np

# (bits, group size; None = one group, per channel)
SCHEMES = {"w8": (8, None), "w4": (4, None), "w4g128": (4, 128)}
GOLDEN_SCHEMES = ("w8", "w4g128")  # the golden leaves lm_head out too
DECODE_B, DECODE_S = 8, 4096
# (name, int8 cache, kv_len)
DECODE_CASES = (("int8_4096", True, 4096), ("int8_3001", True, 3001),
                ("bf16_3001", False, 3001))


def layer_linears(cfg):
    """[(name, K, N)] of one decoder layer, then the tied lm_head."""
    d, hd, f = cfg.d_model, cfg.head_dim, cfg.d_ff
    return [("q", d, cfg.n_heads * hd), ("k", d, cfg.n_kv_heads * hd),
            ("v", d, cfg.n_kv_heads * hd), ("o", cfg.n_heads * hd, d),
            ("gate", d, f), ("up", d, f), ("down", f, d),
            ("lm_head", d, cfg.vocab)]


def _seed(name: str) -> int:
    return 1000 + sum(ord(c) * 31 ** i for i, c in enumerate(name)) % 10**6


def weight(name: str, k: int, n: int) -> np.ndarray:
    """f32 [K, N], N(0, 1) * K**-0.5."""
    rng = np.random.default_rng(_seed("w:" + name))
    return rng.standard_normal((k, n), dtype=np.float32) * np.float32(k**-0.5)


def activations(name: str, m: int, k: int) -> np.ndarray:
    """f32 [M, K], N(0, 1)."""
    rng = np.random.default_rng(_seed(f"x{m}:" + name))
    return rng.standard_normal((m, k), dtype=np.float32)


def decode_inputs(cfg):
    """(q [B, 1, H, dh], k [B, S, KV, dh], v [B, S, KV, dh]), f32 N(0, 1)."""
    rng = np.random.default_rng(_seed("decode"))
    b, s, h, kv, dh = (DECODE_B, DECODE_S, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim)
    q = rng.standard_normal((b, 1, h, dh), dtype=np.float32)
    k = rng.standard_normal((b, s, kv, dh), dtype=np.float32)
    v = rng.standard_normal((b, s, kv, dh), dtype=np.float32)
    return q, k, v
