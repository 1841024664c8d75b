"""Route autotuning: measured per-op route selection with a tuning cache
(`autotune.tune_qnet`, `cache.TunedPlan`). Counterpart of `repro/tune/`.

    plan = tune_qnet(qnet, batch=8)          # measure + verify bit-exact
    save_tuned(plan, "smoke_out/my_cuda.json")
    engine = VisionEngine(qnet, tuned=load_tuned(...))  # cache lookup

`python -m repro_torch.tune` tunes the golden and benchmark nets;
`python -m repro_torch.tune --precision` runs the mixed-precision search
(`precision.search_precision`) over the tuned timings.
"""
from repro_torch.tune.autotune import (
    Candidate,
    default_route,
    op_candidates,
    pw_tile_sweep,
    tune_qnet,
    wall_measure,
)
from repro_torch.tune.cache import (
    CACHE_VERSION,
    DW_SHIFTS,
    FUSED_IRB,
    INT_F32,
    INT_REF,
    PALLAS_DW,
    PALLAS_PW,
    PER_OP,
    RouteChoice,
    TunedPlan,
    irb_key,
    load_tuned,
    op_key,
    save_tuned,
)
from repro_torch.tune.precision import (
    LatencyTable,
    PrecisionPoint,
    PrecisionResult,
    QATFinetuneAccuracy,
    check_pareto_artifact,
    export_point,
    pareto_front,
    search_precision,
    write_pareto,
)

__all__ = [
    "Candidate",
    "default_route",
    "op_candidates",
    "pw_tile_sweep",
    "tune_qnet",
    "wall_measure",
    "CACHE_VERSION",
    "DW_SHIFTS",
    "FUSED_IRB",
    "INT_F32",
    "INT_REF",
    "PALLAS_DW",
    "PALLAS_PW",
    "PER_OP",
    "RouteChoice",
    "TunedPlan",
    "irb_key",
    "load_tuned",
    "op_key",
    "save_tuned",
    "LatencyTable",
    "PrecisionPoint",
    "PrecisionResult",
    "QATFinetuneAccuracy",
    "check_pareto_artifact",
    "export_point",
    "pareto_front",
    "search_precision",
    "write_pareto",
]
