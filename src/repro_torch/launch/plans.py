"""Per-architecture runtime plans (the tunable knobs the perf loop iterates).

A plan sets, per (arch [, shape]): FSDP on/off, remat policy, gradient
accumulation, serve-time weight quantization. Baselines are chosen by napkin
math to FIT (see EXPERIMENTS.md §Dry-run); §Perf iterations override these
via `plan_for(arch, **overrides)`.

Counterpart of `repro/launch/plans.py`, copied value for value (pure
data): the port's dry-run (`launch/dryrun.py`) reads the same plans.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class RunPlan:
    fsdp: bool = False
    remat: str = "none"  # none | dots | full
    grad_accum: int = 1
    quant_bits: Optional[int] = None  # serve-time weight quantization
    capacity_factor: float = 1.25
    # §Perf levers (default off == baseline)
    kv_bits: Optional[int] = None
    rglru_diagonal_gates: bool = False
    rglru_chunk: int = 0
    opt_bits: Optional[int] = None  # int8 AdamW m/v (8-bit-Adam style)
    accum_dtype: str = "float32"  # grad-accumulation buffer dtype
    ssm_chunk: int = 0  # override Mamba-2 SSD chunk length (0 = config default)


# Baseline plans, the reference's. Its napkin math, for a TPU v5e chip (bf16
# params + f32 AdamW m/v, 16 GB of HBM a chip; an H100 holds 80 GB):
#   params_bytes/chip = 2N / shards;  opt = 8N / shards (fsdp shards both).
# Anything over ~2B params wants FSDP; >100B also wants grad_accum to bound
# activation+MoE-buffer memory; all train shapes use remat to cut scan
# residuals.
PLANS: Dict[str, RunPlan] = {
    "recurrentgemma-2b": RunPlan(fsdp=False, remat="full", grad_accum=4),
    "arctic-480b": RunPlan(fsdp=True, remat="full", grad_accum=8,
                           capacity_factor=1.0, opt_bits=8,
                           accum_dtype="bfloat16"),
    # §Perf cell C: capacity 1.0 + ga4 (C3) — -43% compute, fits v5p
    "qwen2-moe-a2.7b": RunPlan(fsdp=True, remat="full", grad_accum=4,
                               capacity_factor=1.0),
    "qwen3-32b": RunPlan(fsdp=True, remat="full", grad_accum=8),
    "llama3.2-1b": RunPlan(fsdp=False, remat="full", grad_accum=2),
    "granite-3-2b": RunPlan(fsdp=False, remat="full", grad_accum=4),
    "codeqwen1.5-7b": RunPlan(fsdp=True, remat="full", grad_accum=4),
    "phi-3-vision-4.2b": RunPlan(fsdp=True, remat="full", grad_accum=4),
    "seamless-m4t-large-v2": RunPlan(fsdp=False, remat="full", grad_accum=2),
    "mamba2-1.3b": RunPlan(fsdp=False, remat="full", grad_accum=4),
}


def plan_for(arch: str, **overrides) -> RunPlan:
    base = PLANS.get(arch, RunPlan())
    return dataclasses.replace(base, **overrides) if overrides else base


__all__ = ["RunPlan", "PLANS", "plan_for"]
