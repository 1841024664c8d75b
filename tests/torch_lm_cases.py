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


# --- the served model (`tests/golden_torch/llama32_1b_serve.npz`) ---------
# Llama-3.2-1B at its published widths, depth cut to 2 layers, in f32:
# numpy-seeded weights in the JAX model's parameter tree, 4 prompts of 12
# tokens, prefill then 8 greedy decode steps.
SERVE_LAYERS, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, SERVE_MAX_LEN = (
    2, 4, 12, 8, 32)
SERVE_VOCAB_IDS = 256  # the logits stored: these ids (seeded) + the argmax


def _padded_vocab(cfg) -> int:
    return -(-cfg.vocab // 512) * 512


def serve_params(cfg):
    """The dense, tied-embedding parameter tree of `init_params` (stacked
    layers [L, ...]) for `cfg`, f32: weights N(0, 1) * K**-0.5, the embedding
    N(0, 1) * D**-0.5, norm scales 1 + N(0, 1) * 0.1."""
    d, hd, f, n = cfg.d_model, cfg.head_dim, cfg.d_ff, cfg.n_layers

    def w(name, k, nout):
        rng = np.random.default_rng(_seed("serve:" + name))
        return (rng.standard_normal((n, k, nout), dtype=np.float32)
                * np.float32(k**-0.5))

    def norm(name, shape):
        rng = np.random.default_rng(_seed("serve:" + name))
        return 1 + np.float32(0.1) * rng.standard_normal(
            shape, dtype=np.float32)

    rng = np.random.default_rng(_seed("serve:embed"))
    embed = rng.standard_normal((_padded_vocab(cfg), d), dtype=np.float32)
    embed *= np.float32(d**-0.5)
    return {
        "embed": embed,
        "ln_f": {"scale": norm("ln_f", (d,))},
        "layers": {
            "ln1": {"scale": norm("ln1", (n, d))},
            "mix": {"wq": {"w": w("wq", d, cfg.n_heads * hd)},
                    "wk": {"w": w("wk", d, cfg.n_kv_heads * hd)},
                    "wv": {"w": w("wv", d, cfg.n_kv_heads * hd)},
                    "wo": {"w": w("wo", cfg.n_heads * hd, d)}},
            "ln2": {"scale": norm("ln2", (n, d))},
            "ffn": {"wi": {"w": w("wi", d, f)}, "wg": {"w": w("wg", d, f)},
                    "wo": {"w": w("wo_ffn", f, d)}},
        },
    }


def serve_prompts(cfg) -> np.ndarray:
    """int32 [SERVE_BATCH, SERVE_PROMPT] token ids."""
    rng = np.random.default_rng(_seed("serve:prompts"))
    return rng.integers(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)).astype(
        np.int32)


def serve_vocab_ids(cfg) -> np.ndarray:
    """The sorted vocab ids whose logits the golden keeps."""
    rng = np.random.default_rng(_seed("serve:ids"))
    return np.sort(rng.choice(cfg.vocab, SERVE_VOCAB_IDS, replace=False))
