"""The port's data-parallel replicas (`dist/sharding.py`'s mesh,
`cu.prepare_qnet(mesh=)`, `compile_stages(mesh=)`, `VisionEngine(mesh=)`,
`launch/serve.py --replicas`) on the CPU, held against the JAX package.

The port drives every replica from one process, so a mesh of two or four
replicas is a device list that names the CPU two or four times. The JAX
side needs as many devices: its references are computed once, in one
subprocess with `XLA_FLAGS=--xla_force_host_platform_device_count=8` set
before JAX is imported (as `tests/test_pipeline_parallel.py` does), and
written to a file under `tmp_path` by a module fixture: the JAX
`cu.run_qnet` logits of 8 seeded images through the two nets of
`tests/test_serve_vision.py` (alpha-0.35 MobileNetV2 and the compact
EfficientNet at 32x32, 10 classes, 4 bits: the frozen
`tests/golden/*_act4.qnet`), the engines' bucket round-up and the error
texts. Every replicated route is bit-exact; on the frozen fixtures'
stored stage activations and logits (`tests/golden/*_act{4,8}`) too."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.dist.sharding import data_mesh as jax_data_mesh
from repro_torch.core import cu, qnet as Q
from repro_torch.dist import sharding as S
from repro_torch.dist.sharding import Sharded, data_mesh
from repro_torch.launch import serve as CLI
from repro_torch.launch.mesh import make_mesh
from repro_torch.serve.vision import (
    MultiModelEngine,
    VisionEngine,
    compile_stages,
)
from repro_torch.tune import load_tuned
from tests.regen_golden import CASES, fixture_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_2D = [c for c in CASES if c[0] != "dscnn_kws"]
NETS = ("mobilenet_v2", "efficientnet_compact")
REPLICAS = (2, 4)
HW = 32

JAX_SIDE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from repro.core import cu
from repro.core.qnet import load_qnet
from repro.dist.sharding import data_mesh
from repro.launch.mesh import make_mesh
from repro.serve.vision import VisionEngine, compile_stages

out, hw = sys.argv[1], int(sys.argv[2])
paths = json.loads(sys.argv[3])
x = np.random.default_rng(7).uniform(-1, 1, (8, hw, hw, 3)).astype(
    np.float32)
arrays, texts = {"images": x}, {}
for name, path in paths.items():
    qnet = load_qnet(path)
    pq = cu.prepare_qnet(qnet)
    # jitted: the same bits as the eager interpreter, in seconds
    arrays[name] = np.asarray(jax.jit(lambda v: cu.run_qnet(pq, v))(x))
for n in (2, 4):
    eng = VisionEngine(qnet, buckets=(1, 2, 4, n, 2 * n), mesh=data_mesh(n))
    texts[f"buckets_{n}"] = list(eng.buckets)
texts["buckets_134"] = list(VisionEngine(
    qnet, buckets=(1, 3, 4), mesh=data_mesh(2)).buckets)
for n in (0, 9):
    try:
        data_mesh(n)
    except ValueError as e:
        texts[f"data_mesh_{n}"] = str(e)
try:
    compile_stages(qnet, mesh=make_mesh((2,), ("model",)))
except ValueError as e:
    texts["no_data_axis"] = str(e)
np.savez(os.path.join(out, "jax.npz"), **arrays)
with open(os.path.join(out, "jax.json"), "w") as f:
    json.dump(texts, f)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side on one intra-op thread, as the other port test files
    under several workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """(qnet paths, images, JAX logits by net, JAX texts) from the
    8-device subprocess."""
    out = tmp_path_factory.mktemp("jax_replicas")
    paths = {n: fixture_paths(n, 4)[0] for n in NETS}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + ROOT, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", JAX_SIDE, str(out), str(HW),
                          json.dumps(paths)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    arrays = dict(np.load(out / "jax.npz"))
    with open(out / "jax.json") as f:
        texts = json.load(f)
    return paths, arrays.pop("images"), arrays, texts


def cpus(n: int):
    return ["cpu"] * n


def _serve(eng, imgs):
    rids = [eng.submit(img) for img in imgs]
    res = eng.run()
    assert all(res[r].status == "ok" for r in rids)
    return np.stack([res[r].logits for r in rids])


# ---------------------------------------------------------------------------
# the mesh and its error texts
# ---------------------------------------------------------------------------


def test_data_mesh_and_its_refusals_equal_jax(jax_ref):
    texts = jax_ref[3]
    mesh = data_mesh(4, devices=cpus(8))
    assert mesh.axis_names == ("data",) and dict(mesh.shape) == {"data": 4}
    assert mesh.device_list == (torch.device("cpu"),) * 4
    assert data_mesh(device="cpu").size == 1  # one visible CPU, as JAX
    for n in (0, 9):
        with pytest.raises(ValueError) as e:
            data_mesh(n, devices=cpus(8))
        assert str(e.value) == texts[f"data_mesh_{n}"]
    with pytest.raises(ValueError) as want:
        jax_data_mesh(2)  # this process sees one JAX CPU device
    with pytest.raises(ValueError) as got:
        data_mesh(2, device="cpu")
    assert str(got.value) == str(want.value) == \
        "replicas=2 with 1 visible devices"


def test_compile_stages_refuses_a_mesh_without_data(jax_ref):
    paths, _, _, texts = jax_ref
    qnet = Q.load_qnet(paths["mobilenet_v2"])
    with pytest.raises(ValueError) as e:
        compile_stages(qnet, mesh=make_mesh((2,), ("model",),
                                            devices=cpus(2)))
    assert str(e.value) == texts["no_data_axis"]


@pytest.mark.parametrize("n", REPLICAS)
def test_bucket_round_up_equals_jax(jax_ref, n):
    paths, _, _, texts = jax_ref
    qnet = Q.load_qnet(paths["mobilenet_v2"])
    eng = VisionEngine(qnet, buckets=(1, 2, 4, n, 2 * n),
                       mesh=data_mesh(n, devices=cpus(n)))
    assert list(eng.buckets) == texts[f"buckets_{n}"]
    assert all(b % n == 0 for b in eng.buckets) and eng.replicas == n
    if n == 2:
        eng = VisionEngine(qnet, buckets=(1, 3, 4),
                           mesh=data_mesh(2, devices=cpus(2)))
        assert list(eng.buckets) == texts["buckets_134"] == [2, 4]


def test_device_and_mesh_must_agree(jax_ref):
    qnet = Q.load_qnet(jax_ref[0]["mobilenet_v2"])
    mesh = data_mesh(2, devices=cpus(2))
    eng = VisionEngine(qnet, mesh=mesh, device="cpu")
    assert eng.device == torch.device("cpu")
    with pytest.raises(ValueError, match="disagree"):
        VisionEngine(qnet, mesh=mesh, device="meta")


# ---------------------------------------------------------------------------
# replicated preparation and stages
# ---------------------------------------------------------------------------


def test_prepare_qnet_mesh_gives_each_replica_its_constants(jax_ref):
    paths, imgs, logits, _ = jax_ref
    qnet = Q.load_qnet(paths["mobilenet_v2"])
    mesh = data_mesh(3, devices=cpus(3))
    rq = cu.prepare_qnet(qnet, mesh=mesh)
    assert isinstance(rq, cu.ReplicatedQNet) and len(rq.replicas) == 3
    for name, pop in rq.replicas[0].ops.items():
        ptrs = {r.ops[name].w_acc.data_ptr() for r in rq.replicas}
        assert len(ptrs) == 3, name
        for r in rq.replicas[1:]:
            assert torch.equal(r.ops[name].w_acc, pop.w_acc)
            assert r.ops[name].f32_exact == pop.f32_exact
    # the same mesh keeps the net; another mesh re-places it; one device
    # is that device
    assert cu.prepare_qnet(rq, mesh=mesh) is rq
    two = cu.prepare_qnet(rq, mesh=data_mesh(2, devices=cpus(2)))
    assert len(two.replicas) == 2
    one = cu.prepare_qnet(rq, mesh=data_mesh(1, devices=cpus(1)))
    assert isinstance(one, cu.PreparedQNet)
    np.testing.assert_array_equal(cu.run_qnet(rq, imgs).numpy(),
                                  logits["mobilenet_v2"])


@pytest.mark.parametrize("case", GOLDEN_2D, ids=lambda c: f"{c[0]}_act{c[1]}")
def test_replicated_stage_chain_matches_golden_per_stage(case):
    qnet_path, npz_path = fixture_paths(*case)
    fix = np.load(npz_path)
    acts = [fix[k] for k in sorted(k for k in fix.files
                                   if k.startswith("stage"))]
    mesh = data_mesh(2, devices=cpus(2))
    stages = compile_stages(Q.load_qnet(qnet_path), mesh=mesh,
                            body_fast_path="on", op_kernels="on")
    y = S.place(torch.from_numpy(fix["input"]), S.batch_sharding(mesh))
    for i, st in enumerate(stages):
        y = st(y)
        assert isinstance(y, Sharded) and len(y.parts) == 2
        want = acts[i].astype(np.int32) if i < len(stages) - 1 \
            else fix["logits"]
        np.testing.assert_array_equal(y.cpu().numpy(), want,
                                      err_msg=st.spec.cu)
        assert (st.traces, st.invocations) == (1, 1)


# ---------------------------------------------------------------------------
# replicated engines against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", REPLICAS)
@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("route", ["kernels", "reference"])
def test_replicated_engine_bit_exact_with_jax(jax_ref, net, n, route):
    paths, imgs, logits, _ = jax_ref
    flag = "on" if route == "kernels" else "off"
    eng = VisionEngine.from_artifact(
        paths[net], buckets=(1, 2, 4, n, 2 * n),
        mesh=data_mesh(n, devices=cpus(n)), body_fast_path=flag,
        op_kernels=flag)
    np.testing.assert_array_equal(_serve(eng, imgs[:2 * n]),
                                  logits[net][:2 * n])
    st = eng.stats()
    assert st.replicas == n and st.n_ok == 2 * n
    assert all(v == 0 for v in st.stage_retraces.values())
    assert st.stage_invocations["head"] == st.micro_batches


@pytest.mark.parametrize("n", REPLICAS)
@pytest.mark.parametrize("case", GOLDEN_2D, ids=lambda c: f"{c[0]}_act{c[1]}")
def test_replicated_engine_matches_golden(case, n):
    """The frozen fixtures' two images over two and four replicas (the
    bucket of 2 rounds up to 4 there: two rows of padding)."""
    qnet_path, npz_path = fixture_paths(*case)
    fix = np.load(npz_path)
    eng = VisionEngine.from_artifact(qnet_path,
                                     buckets=(fix["input"].shape[0],),
                                     mesh=data_mesh(n, devices=cpus(n)),
                                     body_fast_path="on", op_kernels="on")
    np.testing.assert_array_equal(_serve(eng, fix["input"]), fix["logits"])


@pytest.mark.parametrize("case", [c for c in GOLDEN_2D if c[1] == 8],
                         ids=lambda c: c[0])
def test_replicated_tuned_engine_matches_golden(case):
    """`tuned=` from the JAX package's committed CPU cache of the net:
    the routes resolved once, every replica serving them."""
    qnet_path, npz_path = fixture_paths(*case)
    fix = np.load(npz_path)
    plan = load_tuned(os.path.join(ROOT, "experiments", "tuned",
                                   f"{case[0]}_act8_cpu.json"))
    mesh = data_mesh(2, devices=cpus(2))
    eng = VisionEngine.from_artifact(qnet_path, buckets=(2,), mesh=mesh,
                                     tuned=plan)
    routes = eng.stages[0].pq.routes
    assert routes and all(r.routes == routes
                          for r in eng.stages[0].pq.replicas)
    np.testing.assert_array_equal(_serve(eng, fix["input"]), fix["logits"])


def test_multimodel_over_replicated_engines(jax_ref):
    paths, imgs, logits, _ = jax_ref
    mesh = data_mesh(2, devices=cpus(2))
    mm = MultiModelEngine({n: VisionEngine.from_artifact(
        paths[n], buckets=(1, 2, 4), mesh=mesh, name=n) for n in NETS})
    handles = {n: [mm.submit(n, img) for img in imgs[:5]] for n in NETS}
    res = mm.run()
    for n in NETS:
        got = np.stack([res[h].logits for h in handles[n]])
        np.testing.assert_array_equal(got, logits[n][:5])
    assert {n: st.replicas for n, st in mm.stats().items()} == \
        dict.fromkeys(NETS, 2)


def test_one_replica_mesh_is_the_device_path(jax_ref):
    paths, imgs, logits, _ = jax_ref
    eng = VisionEngine.from_artifact(paths["mobilenet_v2"],
                                     buckets=(1, 2, 4),
                                     mesh=data_mesh(1, device="cpu"))
    assert eng.buckets == (1, 2, 4) and eng.replicas == 1
    assert isinstance(eng.stages[0].pq, cu.PreparedQNet)
    np.testing.assert_array_equal(_serve(eng, imgs[:3]),
                                  logits["mobilenet_v2"][:3])


# ---------------------------------------------------------------------------
# the serving CLI
# ---------------------------------------------------------------------------


def test_cli_serves_replicas_over_two_visible_devices(jax_ref, monkeypatch,
                                                      capsys):
    """`--replicas 2` with the visible CPU devices set to two, this
    package's counterpart of the JAX tests' forced device count."""
    monkeypatch.setattr(S, "visible_devices",
                        lambda device=None: (torch.device("cpu"),) * 2)
    out = CLI.main(["--vision", "--models",
                    "mobilenet_v2,efficientnet_compact", "--hw", "32",
                    "--batch", "4", "--requests", "6", "--replicas", "2",
                    "--device", "cpu"])
    results = out["results"]
    assert len(results) == 6 and all(r.status == "ok"
                                     for r in results.values())
    for handle, img in out["requests"]:
        want = cu.run_qnet(out["qnets"][handle[0]], img[None],
                           device="cpu").numpy()[0]
        np.testing.assert_array_equal(results[handle].logits, want)
    assert {m: st.replicas for m, st in out["stats"].items()} == {
        "mobilenet_v2": 2, "efficientnet_compact": 2}
    assert "2 replicas" in capsys.readouterr().out
