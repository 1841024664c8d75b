"""Configuration of the LM-family architectures.

Counterpart of `repro/models/lm/config.py`: `LMConfig` is a field-for-field
copy (a plain dataclass), so the port reads the same widths as the JAX
package. Per-architecture values live in `repro_torch/configs/<id>.py`.
`ShapeSpec` and `SHAPES` are the dry-run's four input-shape cells
(`launch/dryrun.py`), the reference's values.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    dense_residual: bool = False  # arctic: dense MLP in parallel with MoE
    capacity_factor: float = 1.25

    # --- hybrid (RG-LRU / Griffin) ---
    block_pattern: Tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    lru_width: int = 0
    conv_width: int = 4
    local_window: int = 0

    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256

    # --- encoder-decoder ---
    n_enc_layers: int = 0
    n_dec_layers: int = 0

    # --- modality frontend stubs ---
    frontend: Optional[str] = None  # 'vision' | 'audio' -> precomputed embeds
    frontend_len: int = 0  # number of frontend embedding positions

    # --- numerics / quantization (the paper's knobs applied to LMs) ---
    dtype: str = "bfloat16"
    quant_bits: Optional[int] = None  # None=fp; 8/4 = weight-only quantized serve
    remat: str = "none"  # none | full | dots
    # Unroll layer scans. Production keeps scan (O(1) HLO); the dry-run
    # unrolls so cost_analysis counts every layer (while bodies are counted
    # once by HloCostAnalysis — see launch/roofline.py).
    scan_unroll: bool = False

    # --- §Perf hillclimb levers (all default-off == paper-faithful baseline) ---
    kv_bits: Optional[int] = None  # int8 KV cache (paper's quant on the cache)
    rglru_diagonal_gates: bool = False  # Griffin-style diagonal r/i gates
    rglru_chunk: int = 0  # chunked RG-LRU scan (0 = full associative scan)

    def __post_init__(self):
        if self.head_dim is None and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_causal_lm(self) -> bool:
        return self.family in ("dense", "moe", "hybrid", "ssm", "vlm")

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch run long_500k decode? (SSM state / local window)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Approximate parameter count (used for MODEL_FLOPS and reporting)."""
        d, v = self.d_model, self.vocab
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d  # lm head
        hd = self.head_dim or 0

        def attn_params():
            return d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d

        def dense_mlp(ff):
            return 3 * d * ff  # SwiGLU: wi, wg, wo

        if self.family in ("dense", "vlm"):
            n += self.n_layers * (attn_params() + dense_mlp(self.d_ff))
        elif self.family == "moe":
            per = attn_params() + self.n_experts * dense_mlp(self.moe_d_ff)
            if self.dense_residual:
                per += dense_mlp(self.d_ff)
            if self.n_shared_experts:
                per += dense_mlp(self.shared_d_ff)
            n += self.n_layers * per
        elif self.family == "hybrid":
            n_attn = sum(
                1 for i in range(self.n_layers)
                if self.block_pattern[i % len(self.block_pattern)] == "attn"
            )
            n_rec = self.n_layers - n_attn
            rec = 2 * d * self.lru_width + self.conv_width * self.lru_width + \
                2 * self.lru_width + self.lru_width * d
            n += n_attn * attn_params() + n_rec * rec + self.n_layers * dense_mlp(self.d_ff)
        elif self.family == "ssm":
            d_in = self.ssm_expand * d
            nh = d_in // self.ssm_head_dim
            per = d * (2 * d_in + 2 * self.ssm_state + nh) + 4 * d_in + d_in * d
            n += self.n_layers * per
        elif self.family in ("encdec", "audio"):
            enc = self.n_enc_layers * (attn_params() + dense_mlp(self.d_ff))
            dec = self.n_dec_layers * (2 * attn_params() + dense_mlp(self.d_ff))
            n += enc + dec
        return n

    def active_param_count(self) -> int:
        """Activated params per token (MoE: only top-k experts count)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        hd = self.head_dim or 0
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        per = attn + self.top_k * 3 * d * self.moe_d_ff
        if self.dense_residual:
            per += 3 * d * self.d_ff
        if self.n_shared_experts:
            per += 3 * d * self.shared_d_ff
        n = self.vocab * d * (1 if self.tie_embeddings else 2)
        return n + self.n_layers * per


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


SHAPES = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)


__all__ = ["LMConfig", "ShapeSpec", "SHAPES"]
