"""The port's distribution layer on the CPU, held against the JAX package:
the logical-axis rules (`dist/sharding.py`), the compressed all-reduce
(`train/grad_compress.compressed_psum`), pipeline parallelism
(`dist/pp.py`), `checkpoint.restore(shardings=)`, `launch/mesh.py` and
the LM training driver's host mesh.

The port drives every device of a mesh from one process, so its meshes
here are device lists that name the CPU several times. The JAX references
that need several devices (the `shard_map` bodies of `compressed_psum` and
of the pipeline's loss and gradients) run once, in one subprocess with
`XLA_FLAGS=--xla_force_host_platform_device_count=8` set before JAX is
imported, compiled without XLA's algebraic simplifier (ROADMAP F7), and
write their results under `tmp_path` (a module fixture). The spec rules
need no devices: JAX's side runs on an `AbstractMesh` in this process.

Tolerances: `compressed_psum` bit for bit at 2 and 4 replicas (XLA's CPU
all-reduce sums in replica order, a left fold, and so does the port; its
residual is XLA's fused multiply-add, rounded once);
the pipeline's loss and gradients in f32 within the LM training tests'
bounds (loss rtol 1e-5, each gradient leaf 1e-4 in relative L2;
`tests/torch_lm_train_cases.py`), against JAX's pipeline and against the
port's plain `loss_fn`."""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from jax.sharding import AbstractMesh
from repro.dist import sharding as JS
from repro_torch.configs import reduced_config
from repro_torch.dist import pp
from repro_torch.dist import sharding as S
from repro_torch.launch import mesh as LM
from repro_torch.launch import train as TRAIN_CLI
from repro_torch.models.lm import model as M
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import grad_compress as GC
from repro_torch.train import optimizer as O
from repro_torch.train import tree as T
from repro_torch.train.parity import _as_tensor, _rel_l2
from repro_torch.train.train_loop import make_train_step, value_and_grad
from tests.torch_lm_train_cases import F32_GRAD_L2, F32_LOSS_RTOL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PP_LAYERS, PP_STAGES, PP_MICRO = 4, 2, (2, 4)
PP_BATCH, PP_SEQ = 4, 16
PSUM_REPLICAS = (2, 4)

JAX_SIDE = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import warnings
warnings.simplefilter("ignore", DeprecationWarning)
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.configs import reduced_config
from repro.dist import pp
from repro.launch.mesh import make_mesh
from repro.models.lm import model as M
from repro.train import grad_compress as GC

OPTS = {"xla_allow_excess_precision": False,
        "xla_disable_hlo_passes": "algsimp"}
out = sys.argv[1]
arrays, texts = {}, {}


def compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=OPTS)(*args)


for n in (2, 4):
    z = np.load(os.path.join(out, f"psum_in_{n}.npz"))
    keys = sorted(k[2:] for k in z.files if k.startswith("g_"))
    grads = {k: jnp.asarray(z["g_" + k]) for k in keys}
    grads["h"] = grads["h"].astype(jnp.bfloat16)
    errs = {k: jnp.asarray(z["e_" + k]) for k in keys}
    mesh = make_mesh((n,), ("data",))
    spec = {k: P("data") for k in keys}
    f = shard_map(lambda g, e: GC.compressed_psum(g, e, "data"), mesh=mesh,
                  in_specs=(spec, spec), out_specs=(spec, spec),
                  check_rep=False)
    summed, resid = compiled(f, grads, errs)
    for k in keys:
        arrays[f"sum_{n}_{k}"] = np.asarray(summed[k])
        arrays[f"res_{n}_{k}"] = np.asarray(resid[k])

cfg = dataclasses.replace(reduced_config("llama3.2-1b"), dtype="float32",
                          n_layers=4)
params, _ = M.init_params(cfg, jax.random.PRNGKey(0))
for i, a in enumerate(jax.tree.leaves(params)):
    arrays[f"param_{i}"] = np.asarray(a)
tokens = jnp.asarray(np.load(os.path.join(out, "tokens.npy")))
mesh = make_mesh((2,), ("pod",))
sp = dict(params)
sp["layers"] = pp.split_stage_params(params["layers"], 2)
specs_p = jax.tree.map(lambda _: P(), params)
specs_p["layers"] = jax.tree.map(lambda _: P("pod"), sp["layers"])
for n_micro in (2, 4):
    f = shard_map(pp.make_pp_loss(cfg, n_stages=2, n_micro=n_micro),
                  mesh=mesh, in_specs=(specs_p, P()), out_specs=P(),
                  check_rep=False)
    loss, grads = compiled(jax.value_and_grad(f), sp, tokens)
    arrays[f"pp_loss_{n_micro}"] = np.asarray(loss)
    for i, g in enumerate(jax.tree.leaves(grads)):
        arrays[f"pp_grad_{n_micro}_{i}"] = np.asarray(g)

try:
    pp.split_stage_params(params["layers"], 3)
except ValueError as e:
    texts["split"] = str(e)
try:
    pp.make_pp_loss(reduced_config("recurrentgemma-2b"), 2, 2)
except NotImplementedError as e:
    texts["uniform"] = str(e)
try:
    f = shard_map(pp.make_pp_loss(cfg, n_stages=2, n_micro=2), mesh=mesh,
                  in_specs=(specs_p, P()), out_specs=P(), check_rep=False)
    jax.jit(f).lower(sp, tokens[:3])
except ValueError as e:
    texts["micro"] = str(e)
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


def psum_inputs(n: int):
    """Each replica's gradient and residual trees, stacked on a leading
    replica axis: float32 leaves over six decades, a bfloat16 leaf (`h`,
    drawn in float32 here and rounded by each side), and an all-zero
    gradient (its scale is 1)."""
    rng = np.random.default_rng(100 + n)

    def wide(*shape):
        return (rng.standard_normal(shape)
                * 10.0 ** rng.integers(-3, 3, shape)).astype(np.float32)

    g = {"a": wide(n, 24, 40), "b": wide(n, 7), "h": wide(n, 5, 6),
         "z": np.zeros((n, 9), np.float32)}
    e = {k: (1e-2 * wide(*v.shape)).astype(np.float32) for k, v in g.items()}
    return g, e


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_dist")
    for n in PSUM_REPLICAS:
        g, e = psum_inputs(n)
        np.savez(out / f"psum_in_{n}.npz",
                 **{f"g_{k}": v for k, v in g.items()},
                 **{f"e_{k}": v for k, v in e.items()})
    tokens = np.random.default_rng(1).integers(
        0, reduced_config("llama3.2-1b").vocab, (PP_BATCH, PP_SEQ)
    ).astype(np.int32)
    np.save(out / "tokens.npy", tokens)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", JAX_SIDE, str(out)],
                         capture_output=True, text=True, env=env, timeout=900)
    assert run.returncode == 0, run.stderr[-3000:]
    import json
    with open(out / "jax.json") as f:
        texts = json.load(f)
    return dict(np.load(out / "jax.npz")), texts, tokens


def cpus(n: int):
    return ["cpu"] * n


# ---------------------------------------------------------------------------
# logical axes -> specs, against JAX's on an AbstractMesh
# ---------------------------------------------------------------------------

MESHES = [((1, 1), ("data", "model")), ((2, 1), ("data", "model")),
          ((4, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]
MESH_IDS = ["x".join(map(str, shape)) for shape, _ in MESHES]
AXES = [(), ("batch",), ("batch", "seq", "embed"), ("vocab", "embed"),
        ("embed", "heads"), ("embed", "ffn"), ("experts", "embed", "ffn"),
        ("embed", "kv"), ("pod",), ("data", None), (None, "model"),
        ("batch", None, "heads", None)]
SHAPES = [(8, 6), (3, 16), (4, 5, 2), (6, 4, 8, 2), (16,)]


def _meshes(shape, names):
    n = int(np.prod(shape))
    return (AbstractMesh(shape, names),
            LM.make_mesh(shape, names, devices=cpus(n)))


@pytest.mark.parametrize("fsdp", [False, True], ids=["plain", "fsdp"])
@pytest.mark.parametrize("shape,names", MESHES, ids=MESH_IDS)
def test_logical_to_spec_and_fit_equal_jax(shape, names, fsdp):
    jmesh, tmesh = _meshes(shape, names)
    assert dict(tmesh.shape) == dict(jmesh.shape)
    for axes in AXES:
        want = JS.logical_to_spec(axes, jmesh, fsdp)
        got = S.logical_to_spec(axes, tmesh, fsdp)
        assert tuple(got) == tuple(want), axes
        for dims in SHAPES:
            assert tuple(S._fit_spec_to_shape(got, dims, tmesh)) == tuple(
                JS._fit_spec_to_shape(want, dims, jmesh)), (axes, dims)


@pytest.mark.parametrize("fsdp", [False, True], ids=["plain", "fsdp"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("shape,names", MESHES, ids=MESH_IDS)
def test_tree_shardings_equal_jax(shape, names, arch, fsdp):
    """The LM's own logical tree, with and without shape fitting."""
    import jax

    jmesh, tmesh = _meshes(shape, names)
    params, logical = M.init_params(reduced_config(arch), 0, device="cpu")
    shapes = M.tree_map(
        lambda t: jax.ShapeDtypeStruct(tuple(t.shape), np.float32), params)
    for sh in (None, shapes):
        want = jax.tree.leaves(JS.tree_shardings(logical, jmesh, fsdp, sh))
        got = T.leaves(S.tree_shardings(logical, tmesh, fsdp, sh))
        assert len(got) == len(want) > 0
        for w, g in zip(want, got):
            assert g.mesh is tmesh and tuple(g.spec) == tuple(w.spec)


def test_use_mesh_axis_size_and_shard():
    mesh = LM.make_mesh((2, 1), ("data", "model"), devices=cpus(2))
    assert S.current_mesh() is None and S.axis_size("data") == 1
    with S.use_mesh(mesh) as m:
        assert m is mesh and S.current_mesh() is mesh
        assert (S.axis_size("data"), S.axis_size("pod")) == (2, 1)
        x = torch.ones(4, 3)
        assert S.shard(x, "batch", "embed") is x
    assert S.current_mesh() is None
    # tensor parallelism over 'model' and FSDP over 'data' run for every
    # family, moe too: its loss on either mesh is the mesh-less one's
    cfg = reduced_config("qwen2-moe-a2.7b")
    params, logical = M.init_params(cfg, 0, device="cpu")
    zeros = torch.zeros((2, 8), dtype=torch.long)
    with torch.no_grad():
        want = float(M.loss_fn(params, cfg, {"tokens": zeros}))
    for other, fsdp in ((LM.make_mesh((1, 2), ("data", "model"),
                                      devices=cpus(2)), False),
                        (mesh, True)):
        with S.use_mesh(other, fsdp=fsdp) as m:
            assert m is other and S.axis_size("model") == \
                other.shape["model"]
            placed = T.tree_map(S.place, params, S.tree_shardings(
                logical, other, fsdp, params))
            tokens = S.place(zeros, S.NamedSharding(
                other, S.logical_to_spec(("batch", None), other)))
            with torch.no_grad():
                got = M.loss_fn(placed, cfg, {"tokens": tokens})
            assert isinstance(got, S.Sharded)
            assert abs(float(got.parts[0]) - want) <= 1e-4 * abs(want)
    with S.use_mesh(LM.make_mesh((1, 1), ("data", "model"),
                                 devices=cpus(1)), fsdp=True):
        assert S.axis_size("model") == 1


def test_make_mesh_and_host_mesh():
    host = LM.make_host_mesh(device="cpu")
    assert host.axis_names == ("data", "model")
    assert dict(host.shape) == {"data": 1, "model": 1}
    mesh = LM.make_mesh((2, 2, 2), ("pod", "data", "model"), devices=cpus(8))
    assert dict(mesh.shape) == {"pod": 2, "data": 2, "model": 2}
    assert LM.make_host_mesh(2, devices=cpus(4)).devices.shape == (2, 2)
    with pytest.raises(ValueError, match="needs 4 devices"):
        LM.make_mesh((2, 2), ("data", "model"), device="cpu")


@pytest.mark.parametrize("spec,shape", [((), (4, 6)), (("data",), (4, 6)),
                                        ((None, "model"), (4, 6)),
                                        ((("pod", "data"), None), (8, 3))])
def test_place_and_gather_round_trip(spec, shape):
    mesh = LM.make_mesh((2, 2, 2), ("pod", "data", "model"), devices=cpus(8))
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    sh = S.NamedSharding(mesh, S.P(*spec))
    v = S.place(x, sh)
    assert len(v.parts) == 8 and tuple(v.shape) == shape
    assert len({p.data_ptr() for p in v.parts}) == 8
    assert torch.equal(v.gather(), x)


# ---------------------------------------------------------------------------
# the compressed all-reduce
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", PSUM_REPLICAS)
def test_compressed_psum_equals_jax_bitwise(jax_ref, n):
    arrays = jax_ref[0]
    g, e = psum_inputs(n)
    grads = [{k: torch.from_numpy(v[r]).to(
        torch.bfloat16 if k == "h" else torch.float32)
        for k, v in g.items()} for r in range(n)]
    errs = [{k: torch.from_numpy(v[r]) for k, v in e.items()}
            for r in range(n)]
    sums, res = GC.compressed_psum(grads, errs,
                                   S.data_mesh(n, devices=cpus(n)))
    assert len(sums) == len(res) == n
    for k in g:
        for r in range(n):
            np.testing.assert_array_equal(
                sums[r][k].numpy(), arrays[f"sum_{n}_{k}"][r], err_msg=k)
            np.testing.assert_array_equal(
                res[r][k].numpy(), arrays[f"res_{n}_{k}"][r], err_msg=k)
        # every replica holds its own buffer of the same sum
        assert len({s[k].data_ptr() for s in sums}) == n
    # the payload is what compress_tree makes of each replica's gradient
    # (its residual keeps eager JAX's two roundings: within an ulp)
    outs = [GC.compress_tree(grads[r], errs[r]) for r in range(n)]
    for k in g:
        total = outs[0][0][k]
        for r in range(1, n):
            total = total + outs[r][0][k]
        assert torch.equal(sums[0][k], total)
        torch.testing.assert_close(res[0][k], outs[0][1][k], rtol=0,
                                   atol=float(outs[0][0][k].abs().max())
                                   * 2.0 ** -23)


@pytest.mark.parametrize("decade", [-44, -30, -3, 0, 5, 30])
def test_fused_residual_rounds_once(decade):
    """The residual equals corrected - q * scale computed exactly (float64:
    an int8 code times a float32 scale needs 32 bits) and rounded once to
    float32, for tensors at every scale, subnormal ones included, and for
    every code from -127 to 127."""
    rng = np.random.default_rng(decade + 50)
    x = rng.standard_normal(20000) * 10.0 ** rng.uniform(-3, 0, 20000)
    c = torch.from_numpy((x * 10.0 ** decade).astype(np.float32))
    q, s = GC._q(c)
    assert int(q.abs().max()) == 127
    want = (c.double() - q.double() * s.double()).float()
    got = GC._fused_residual(c, q, s)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_compressed_psum_refuses_a_mismatched_mesh():
    g = {"a": torch.ones(3)}
    with pytest.raises(ValueError, match="mesh of 2 devices"):
        GC.compressed_psum([g] * 3, [g] * 3, S.data_mesh(2, devices=cpus(2)))


# ---------------------------------------------------------------------------
# pipeline parallelism
# ---------------------------------------------------------------------------


def _pp_cfg():
    return dataclasses.replace(reduced_config("llama3.2-1b"),
                               dtype="float32", n_layers=PP_LAYERS)


def _jax_params(arrays, cfg):
    """JAX's initial weights (leaves in its order) in the port's tree."""
    like, _ = M.init_params(cfg, 0, device="cpu")
    _, treedef = T.flatten(like)
    n = len(T.leaves(like))
    return T.unflatten(treedef, [torch.from_numpy(arrays[f"param_{i}"])
                                 for i in range(n)])


@pytest.mark.parametrize("n_micro", PP_MICRO)
def test_pipeline_loss_and_grads_equal_jax_and_plain(jax_ref, n_micro):
    arrays, _, tokens_np = jax_ref
    cfg = _pp_cfg()
    params = _jax_params(arrays, cfg)
    sp = dict(params)
    sp["layers"] = pp.split_stage_params(params["layers"], PP_STAGES)
    mesh = LM.make_mesh((PP_STAGES,), ("pod",), devices=cpus(PP_STAGES))
    loss_fn = pp.make_pp_loss(cfg, PP_STAGES, n_micro)
    tokens = torch.from_numpy(tokens_np).long()
    loss, _, grads = value_and_grad(lambda p, b: loss_fn(p, b, mesh), sp,
                                    tokens)
    want = float(arrays[f"pp_loss_{n_micro}"])
    assert abs(float(loss) - want) / abs(want) <= F32_LOSS_RTOL
    jgrads = [arrays[f"pp_grad_{n_micro}_{i}"]
              for i in range(len(T.leaves(grads)))]
    for a, g in zip(jgrads, T.leaves(grads)):
        assert _rel_l2(_as_tensor(a, "cpu"), _as_tensor(g, "cpu")) \
            <= F32_GRAD_L2
    # the plain loss (Llama has no aux) and its gradients, layers split
    ploss, _, pgrads = value_and_grad(
        lambda p, b: M.loss_fn(p, cfg, {"tokens": b}), params, tokens)
    assert abs(float(loss) - float(ploss)) / abs(float(ploss)) \
        <= F32_LOSS_RTOL
    pgrads["layers"] = pp.split_stage_params(pgrads["layers"], PP_STAGES)
    for a, g in zip(T.leaves(pgrads), T.leaves(grads)):
        assert _rel_l2(_as_tensor(a, "cpu"), _as_tensor(g, "cpu")) \
            <= F32_GRAD_L2
    # the gradient reaches both stages' layers
    wq = grads["layers"]["mix"]["wq"]["w"]
    assert (wq.abs().sum(dim=tuple(range(1, wq.dim()))) > 0).all()


def test_pipeline_refusals_equal_jax(jax_ref):
    _, texts, tokens_np = jax_ref
    cfg = _pp_cfg()
    params, _ = M.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError) as e:
        pp.split_stage_params(params["layers"], 3)
    assert str(e.value) == texts["split"]
    with pytest.raises(NotImplementedError) as e:
        pp.make_pp_loss(reduced_config("recurrentgemma-2b"), 2, 2)
    assert str(e.value) == texts["uniform"]
    sp = dict(params)
    sp["layers"] = pp.split_stage_params(params["layers"], 2)
    mesh = LM.make_mesh((2,), ("pod",), devices=cpus(2))
    with pytest.raises(ValueError) as e:
        pp.make_pp_loss(cfg, 2, 2)(sp, torch.from_numpy(tokens_np[:3]), mesh)
    assert str(e.value) == texts["micro"]
    with pytest.raises(ValueError, match="no 'pod' axis"):
        pp.make_pp_loss(cfg, 2, 2)(sp, torch.from_numpy(tokens_np),
                                    S.data_mesh(2, devices=cpus(2)))


# ---------------------------------------------------------------------------
# restore(shardings=) and the training driver's mesh
# ---------------------------------------------------------------------------


def test_restore_places_replicated_and_data_leaves(tmp_path):
    tree = {"w": torch.arange(16.0).reshape(4, 4),
            "b": torch.arange(8, dtype=torch.int32).reshape(4, 2),
            "s": torch.tensor(3.0)}
    CKPT.save(str(tmp_path), 1, tree)
    mesh = S.data_mesh(2, devices=cpus(2))
    sh = {"w": S.replicated(mesh), "b": S.batch_sharding(mesh), "s": None}
    got, step = CKPT.restore(str(tmp_path), tree, shardings=sh)
    assert step == 1 and torch.equal(got["s"], tree["s"])
    w, b = got["w"], got["b"]
    assert isinstance(w, S.Sharded) and isinstance(b, S.Sharded)
    assert all(torch.equal(p, tree["w"]) for p in w.parts)
    assert w.parts[0].data_ptr() != w.parts[1].data_ptr()
    assert [p.tolist() for p in b.parts] == [tree["b"][:2].tolist(),
                                             tree["b"][2:].tolist()]
    assert torch.equal(b.gather(), tree["b"]) and b.dtype == torch.int32
    # the degenerate host mesh (the elastic-resize path) is the device
    host = LM.make_host_mesh(device="cpu")
    one, _ = CKPT.restore(str(tmp_path), tree, shardings={
        k: S.NamedSharding(host, S.P(None, None)) for k in ("w", "b")}
        | {"s": S.replicated(host)})
    assert all(torch.equal(one[k], tree[k]) for k in tree)


def test_train_driver_host_mesh_moves_no_number(tmp_path):
    """`launch/train.py` places the parameters through `tree_shardings` on
    its host mesh; the losses are those of the same steps without it."""
    losses = TRAIN_CLI.main(["--reduced", "--steps", "3", "--device", "cpu",
                             "--log-every", "100"])
    cfg = reduced_config("llama3.2-1b")
    from repro_torch.data.pipeline import DataConfig, lm_stream

    params, _ = M.init_params(cfg, 0, device="cpu")
    opt_cfg = O.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=3)
    opt_state = O.init_state(params)
    step_fn = make_train_step(cfg, opt_cfg)
    stream = lm_stream(DataConfig(seed=0, vocab=cfg.vocab, seq_len=128,
                                  global_batch=8), 0)
    want = []
    for _ in range(3):
        batch = {k: torch.from_numpy(v).long()
                 for k, v in next(stream).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        want.append(float(metrics["loss"]))
    assert losses == want
