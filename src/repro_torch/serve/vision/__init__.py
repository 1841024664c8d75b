"""Vision serving: stage compiler, pipelined scheduler, batching engine."""
from repro_torch.serve.vision.engine import (
    AdmissionError,
    EngineStats,
    MultiModelEngine,
    RequestResult,
    VisionEngine,
    VisionRequest,
)
from repro_torch.serve.vision.pipeline import PipelinedExecutor
from repro_torch.serve.vision.stages import CompiledStage, compile_stages

__all__ = [
    "AdmissionError",
    "CompiledStage",
    "EngineStats",
    "MultiModelEngine",
    "PipelinedExecutor",
    "RequestResult",
    "VisionEngine",
    "VisionRequest",
    "compile_stages",
]
