"""The port stands alone: no file of `src/repro_torch/`, nor
`chip_smoke.py`, imports JAX or the JAX package, and every entry point
(the streaming engine, fixed-point inference, the multi-model router, the
energy model's default power curve, the vision trainer, its export and its
CLI, the LM's init, cache and `Engine`, the LM serving CLI, the LM
training CLI, the AdamW state's carrier, the data mesh, the host mesh, a
replicated `VisionEngine`, the compressed all-reduce and the production
mesh included)
called without `device=` (or `backend=`) on a machine without CUDA raises
instead of running on the CPU."""
import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.convert import lm_from_reference, opt_state_from_reference
from repro_torch.core import cu, qnet as Q
from repro_torch.dist import sharding as S
from repro_torch.energy import default_power_model, estimate_energy
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as lm_train_cli
from repro_torch.launch import mesh as LMESH
from repro_torch.launch import train_vision as train_cli
from repro_torch.models import layers
from repro_torch.models.lm import model as LM
from repro_torch.serve.engine import Engine
from repro_torch.serve.stream import StreamEngine, reference_windows
from repro_torch.serve.vision import (
    MultiModelEngine,
    VisionEngine,
    compile_stages,
)
from repro_torch.train import grad_compress as GC
from repro_torch.train import optimizer as PO
from repro_torch.train import vision as V
from tests.regen_golden import fixture_paths

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]


def test_port_files_found():
    assert len(PORT_FILES) > 15
    for rel in ("kernels/ops.py", "kernels/quant_matmul.py",
                "kernels/decode_attention.py", "models/lm/common.py",
                "configs/llama32_1b.py", "serve/stream.py",
                "models/dscnn1d.py", "obs/__init__.py", "obs/__main__.py",
                "obs/trace.py", "obs/metrics.py", "obs/summary.py",
                "energy/__init__.py", "energy/power.py", "energy/model.py",
                "energy/governor.py", "tune/__init__.py", "tune/cache.py",
                "core/quant.py", "core/calibrate.py", "core/bn_fuse.py",
                "models/layers.py", "data/pipeline.py", "train/tree.py",
                "train/optimizer.py", "train/train_loop.py",
                "train/checkpoint.py", "train/vision.py",
                "train/parity.py", "launch/train_vision.py",
                "models/lm/model.py", "models/lm/moe.py",
                "models/lm/mamba2.py", "models/lm/rglru.py",
                "configs/registry.py", "serve/engine.py",
                "train/grad_compress.py", "train/straggler.py",
                "launch/train.py", "dist/__init__.py", "dist/sharding.py",
                "dist/pp.py", "launch/mesh.py", "launch/plans.py",
                "launch/roofline.py", "launch/dryrun.py",
                "launch/hillclimb.py", "configs/mobilenet_v2.py",
                "configs/efficientnet_compact.py"):
        assert ROOT / "src" / "repro_torch" / rel in PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("entry", ["prepare_qnet", "run_qnet",
                                   "run_qnet(fixed_point=True)",
                                   "compile_stages", "VisionEngine",
                                   "VisionEngine.from_artifact",
                                   "lm_from_reference", "StreamEngine",
                                   "reference_windows",
                                   "default_power_model()",
                                   "estimate_energy",
                                   "MultiModelEngine", "train",
                                   "train_and_export", "export",
                                   "verify_export", "make_calibrated_qnet",
                                   "train_vision CLI",
                                   "train_vision --check-artifact",
                                   "Engine", "init_params", "init_cache",
                                   "LM serve CLI", "LM train CLI",
                                   "opt_state_from_reference",
                                   "data_mesh()", "make_host_mesh()",
                                   "VisionEngine(mesh=)",
                                   "compressed_psum",
                                   "make_production_mesh()"])
def test_entry_points_refuse_to_run_without_cuda(entry, monkeypatch):
    path = fixture_paths("mobilenet_v2", 8)[0]
    qnet = Q.load_qnet(path)
    kws = Q.load_qnet(fixture_paths("dscnn_kws", 8)[0])
    x = np.zeros((1, 32, 32, 3), np.float32)
    frames = np.zeros((32, 6), np.float32)
    cfg = V.VisionTrainConfig(float_steps=1, qat_steps=1, batch=2)
    lm = reduced_config("llama3.2-1b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"prepare_qnet": lambda: cu.prepare_qnet(qnet),
            "run_qnet": lambda: cu.run_qnet(qnet, x),
            "run_qnet(fixed_point=True)":
                lambda: cu.run_qnet(qnet, x, fixed_point=True),
            "compile_stages": lambda: compile_stages(qnet),
            "VisionEngine": lambda: VisionEngine(qnet),
            "VisionEngine.from_artifact":
                lambda: VisionEngine.from_artifact(path),
            "lm_from_reference":
                lambda: lm_from_reference({"k": x, "v": x}),
            "StreamEngine": lambda: StreamEngine(kws, 4),
            "reference_windows":
                lambda: reference_windows(kws, frames, 32, 4),
            "default_power_model()": lambda: default_power_model(),
            "estimate_energy": lambda: estimate_energy(qnet),
            "MultiModelEngine":
                lambda: MultiModelEngine({"m": VisionEngine(qnet)}),
            "train": lambda: V.train(cfg),
            "train_and_export": lambda: V.train_and_export(cfg),
            "export": lambda: V.export({}, V.build_net(cfg), cfg),
            "verify_export": lambda: V.verify_export(qnet, x),
            "make_calibrated_qnet":
                lambda: layers.make_calibrated_qnet(V.build_net(cfg)),
            "train_vision CLI": lambda: train_cli.main(["--smoke"]),
            "train_vision --check-artifact":
                lambda: train_cli.main(["--check-artifact", path]),
            "Engine": lambda: Engine(lm, {}),
            "init_params": lambda: LM.init_params(lm),
            "init_cache": lambda: LM.init_cache(lm, 1, 8),
            "LM serve CLI":
                lambda: serve_cli.main(["--reduced", "--requests", "1"]),
            "LM train CLI":
                lambda: lm_train_cli.main(["--reduced", "--steps", "1"]),
            "opt_state_from_reference":
                lambda: opt_state_from_reference(
                    PO.AdamWState(np.zeros((), np.int32), {}, {})),
            "data_mesh()": lambda: S.data_mesh(),
            "make_host_mesh()": lambda: LMESH.make_host_mesh(),
            "VisionEngine(mesh=)":
                lambda: VisionEngine(qnet, mesh=S.data_mesh(1)),
            "compressed_psum":
                lambda: GC.compressed_psum([{"g": x}], [{"g": x}]),
            "make_production_mesh()":
                lambda: LMESH.make_production_mesh()}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
