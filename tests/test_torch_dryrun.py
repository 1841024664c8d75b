"""The port's dry-run (`launch/{dryrun,roofline,plans,hillclimb}.py`,
`launch/mesh.make_production_mesh`, `ShapeSpec`/`SHAPES`) against the JAX
package's, and its counts against analytic ones.

  * Placements: every leaf of the arguments of the train_4k and decode_32k
    cells (parameters, AdamW state, batch, KV/recurrent caches) of all ten
    archs on the 16x16 and 2x16x16 meshes has the spec JAX's dry-run gives
    it, and one device's block as many bytes as JAX's `shard_shape`: the
    per-device argument bytes equal, exactly. The JAX side runs once, in a
    subprocess (importing `repro.launch.dryrun` forces 512 host devices).
  * `depth_points` per family (the table of `tests/test_dryrun_machinery.
    py`), `_extrapolate` linear, `make_production_mesh`'s shapes,
    `ShapeSpec`/`SHAPES` and the plans equal to the reference's.
  * `run_cell` of JAX's own test cell (llama3.2-1b decode_32k on 2x16x16)
    is `ok` with FLOPs > 0; a one-layer decode cell on 16x16 counts exactly
    the matmul FLOPs and the collective bytes written out below, and two
    and three layers add exactly one layer's each (the two-point
    extrapolation is exact).
  * One cell of each partitioned family beyond the dense one is `ok`:
    mamba2's long_500k on 2x16x16 (a batch of one row, replicated over
    the data axes), recurrentgemma's train_4k on 16x16 (10 heads of 256
    split mid-head over 16), phi-3-vision's and seamless's decode_32k,
    qwen2-moe's train_4k on 16x16 (60 experts whole over 16) and arctic's
    decode_32k on 2x16x16 (128 experts, 8 a device).
  * The CLI: a cell whose step fails reports `error` with its exception
    (one made to fail here: every family partitions), long_500k is
    `skipped` for a dense arch; the hillclimb prints the three term
    deltas against its baseline and forwards `--precision` to the
    tuner.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.launch import plans as RPL
from repro.models.lm import config as RCFG
from repro_torch.configs import ARCHS, get_config
from repro_torch.dist import sharding as S
from repro_torch.launch import dryrun as D
from repro_torch.launch import hillclimb as H
from repro_torch.launch import mesh as LM
from repro_torch.launch import plans as PL
from repro_torch.launch import roofline as RL
from repro_torch.models.lm import config as PCFG
from repro_torch.models.lm import model as TM
from repro_torch.train import tree as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE_NAMES = ("train_4k", "decode_32k")

JAX_SIDE = r"""
import json, sys
from repro.launch import dryrun as D  # forces 512 host devices first
import jax
from functools import partial
from repro.configs import ARCHS
from repro.dist.sharding import named_sharding
from repro.launch.mesh import make_production_mesh
from repro.launch.plans import plan_for
from repro.models.lm import model as M
from repro.train import optimizer as O


def norm(spec):
    out = []
    for e in spec:
        if isinstance(e, tuple):
            e = None if not e else e[0] if len(e) == 1 else list(e)
        out.append(e)
    while out and out[-1] is None:
        out.pop()
    return out


out = {}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    for arch in sorted(ARCHS):
        plan = plan_for(arch)
        for name in ("train_4k", "decode_32k"):
            shape = D.shape_by_name(name)
            cfg = D.build_cfg(arch, shape, plan, scan_unroll=False)
            p_shapes, p_sh, _ = D.build_param_machinery(cfg, arch, mesh,
                                                        plan.fsdp)
            batch = D.input_specs(cfg, shape)
            if shape.mode == "train":
                opt = jax.eval_shape(
                    partial(O.init_state, state_bits=plan.opt_bits),
                    p_shapes)
                opt_sh = O.AdamWState(
                    named_sharding(mesh, ()),
                    D._opt_state_shardings(p_sh, opt.m, mesh),
                    D._opt_state_shardings(p_sh, opt.v, mesh))
                mb = {k: jax.ShapeDtypeStruct(
                    (v.shape[0] // plan.grad_accum, *v.shape[1:]), v.dtype)
                    for k, v in batch.items()}
                args = (p_shapes, opt, mb)
                shs = (p_sh, opt_sh, D.batch_shardings(mb, mesh))
            else:
                caches = jax.eval_shape(lambda: M.init_cache(
                    cfg, shape.global_batch, shape.seq_len,
                    enc_len=cfg.frontend_len))
                b_sh = D.batch_shardings(batch, mesh)
                args = (p_shapes, batch["token"], caches, batch["pos"])
                shs = (p_sh, b_sh["token"], D.cache_shardings(caches, mesh),
                       b_sh["pos"])
            leaves = []
            for a, s in zip(jax.tree.leaves(args), jax.tree.leaves(shs)):
                n = 1
                for d in s.shard_shape(a.shape):
                    n *= d
                leaves.append([norm(s.spec), n * a.dtype.itemsize])
            out[f"{arch}|{int(mp)}|{name}"] = leaves
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_placements(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_dryrun") / "placements.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", JAX_SIDE, str(path)],
                         capture_output=True, text=True, env=env, timeout=900)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(path) as f:
        return json.load(f)


def _norm(spec):
    out = [list(e) if isinstance(e, tuple) else e for e in spec]
    while out and out[-1] is None:
        out.pop()
    return out


def _port_leaves(args):
    """(spec, one device's bytes) of every argument leaf, in tree order."""
    out = []
    for leaf in T.leaves(args):
        if isinstance(leaf, S.Sharded):
            spec, block = leaf.sharding.spec, leaf.parts[0]
        else:
            spec, block = (), leaf
        out.append([_norm(spec), RL.shape_bytes(block.shape, block.dtype)])
    return out


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_placements_and_argument_bytes_equal_jax(jax_placements, arch,
                                                 multi_pod):
    for name in SHAPE_NAMES:
        want = jax_placements[f"{arch}|{int(multi_pod)}|{name}"]
        res = D.lower_cell(arch, D.shape_by_name(name), multi_pod=multi_pod)
        lowered = res["lowered"]
        got = _port_leaves(lowered.args)
        assert len(got) == len(want), (name, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            assert g == w, (name, i, g, w)
        assert RL.tensor_bytes(lowered.args) == sum(b for _, b in want)


def test_shapes_plans_and_production_mesh():
    assert [dataclasses.asdict(s) for s in PCFG.SHAPES] == \
        [dataclasses.asdict(s) for s in RCFG.SHAPES]
    assert {k: dataclasses.asdict(v) for k, v in PL.PLANS.items()} == \
        {k: dataclasses.asdict(v) for k, v in RPL.PLANS.items()}
    assert dataclasses.asdict(PL.plan_for("qwen3-32b", kv_bits=8)) == \
        dataclasses.asdict(RPL.plan_for("qwen3-32b", kv_bits=8))
    m1 = LM.make_production_mesh(device="meta")
    assert m1.axis_names == ("data", "model") and m1.devices.size == 256
    m2 = LM.make_production_mesh(multi_pod=True, device="meta")
    assert m2.axis_names == ("pod", "data", "model") and m2.size == 512
    assert dict(m2.shape) == {"pod": 2, "data": 16, "model": 16}
    assert m2.symmetric and m2.executed == (0,)
    with pytest.raises(ValueError, match="needs 256 devices"):
        LM.make_production_mesh(device="cpu")


def test_depth_points_per_family():
    shape = D.shape_by_name("train_4k")
    for arch, expect in [
        ("llama3.2-1b", (1, 2, 16)),
        ("qwen3-32b", (1, 2, 64)),
        ("mamba2-1.3b", (1, 2, 48)),
        ("recurrentgemma-2b", (5, 8, 8)),   # pattern 3 + tail 2
        ("seamless-m4t-large-v2", (1, 2, 24)),
    ]:
        cfg = D.build_cfg(arch, shape, PL.plan_for(arch), scan_unroll=False)
        assert D.depth_points(cfg) == expect, arch


def test_extrapolation_linear():
    r1 = RL.Roofline(10.0, 100.0, 5.0, {"all-reduce": 4}, 256)
    r2 = RL.Roofline(14.0, 130.0, 7.0, {"all-reduce": 6}, 256)
    full = D._extrapolate(r1, r2, 16)
    assert full.flops == 10 + 15 * 4
    assert full.hbm_bytes == 100 + 15 * 30
    assert full.coll_bytes == 5 + 15 * 2
    assert full.coll_detail["all-reduce"] == 4 + 15 * 2


def test_single_cell_multipod(tmp_path):
    rep = D.run_cell("llama3.2-1b", D.shape_by_name("decode_32k"),
                     multi_pod=True, out_dir=str(tmp_path))
    assert rep["status"] == "ok", rep
    assert rep["mesh"] == "2x16x16"
    assert rep["roofline"]["flops_per_device"] > 0
    with open(tmp_path / "llama3.2-1b__decode_32k__2x16x16.json") as f:
        assert json.load(f) == json.loads(json.dumps(rep))


def _decode_layer_counts(cfg, layers: int):
    """Analytic per-device counts of llama3.2-1b's decode_32k on 16x16 at
    `layers` layers: 8 rows a device (128 over 'data' 16), the 'model'
    axis 16 wide (2 of the 32 q heads, 32 of the 512 K and V columns, 512
    of the 8192 MLP columns, 8032 of the 128512 padded vocab columns),
    one KV head of the 8 read for both q heads over a 32768-position
    cache; activations of d_model 2048; the embedding's psum, the
    row-parallel products' partial sums and the gathered K and V columns
    in bf16, as GSPMD sums and gathers them (`common.Spmd`)."""
    b, d, m, s, hd = 8, cfg.d_model, 16, 32768, cfg.head_dim
    q_cols = cfg.n_heads * hd // m
    kv_cols = cfg.n_kv_heads * hd // m
    ff = cfg.d_ff // m
    vocab = TM.padded_vocab(cfg) // m
    per_layer = (2 * b * d * q_cols          # wq
                 + 2 * 2 * b * d * kv_cols   # wk, wv
                 + 2 * 2 * b * (q_cols // hd) * s * hd  # scores, values
                 + 2 * b * q_cols * d        # wo
                 + 3 * 2 * b * d * ff)       # wi, wg, wo
    flops = layers * per_layer + 2 * b * d * vocab  # + the tied head
    act = b * d  # one [8, 1, 2048] block's values
    coll = {"all-reduce": act * 2 + layers * 2 * act * 2,  # embed; attn, mlp
            "all-gather": layers * 2 * b * kv_cols * 2}  # K, V columns
    return flops, coll


def test_one_layer_counts_equal_the_analytic_ones(tmp_path):
    cfg = get_config("llama3.2-1b")
    shape = D.shape_by_name("decode_32k")
    seen = {}
    for layers in (1, 2, 3):
        res = D.lower_cell("llama3.2-1b", shape, multi_pod=False,
                           depth=layers)
        rl = res["lowered"].compile().roofline()
        flops, coll = _decode_layer_counts(cfg, layers)
        assert rl.flops == flops, (layers, rl.flops, flops)
        for kind in S.COLLECTIVE_KINDS:
            assert rl.coll_detail[kind] == coll.get(kind, 0), (layers, kind)
        assert rl.coll_detail["n_ops"] == 1 + 4 * layers
        seen[layers] = rl
    full = D._extrapolate(seen[1], seen[2], 3)
    assert (full.flops, full.hbm_bytes, full.coll_bytes) == (
        seen[3].flops, seen[3].hbm_bytes, seen[3].coll_bytes)


@pytest.mark.parametrize("arch,shape,multi_pod", [
    ("mamba2-1.3b", "long_500k", True),
    ("recurrentgemma-2b", "train_4k", False),
    ("phi-3-vision-4.2b", "decode_32k", False),
    ("seamless-m4t-large-v2", "decode_32k", False),
    ("qwen2-moe-a2.7b", "train_4k", False),
    ("arctic-480b", "decode_32k", True)],
    ids=lambda v: v if isinstance(v, str) else ("2x16x16" if v
                                                 else "16x16"))
def test_family_cells_are_ok(tmp_path, arch, shape, multi_pod):
    rep = D.run_cell(arch, D.shape_by_name(shape), multi_pod=multi_pod,
                     out_dir=str(tmp_path))
    assert rep["status"] == "ok", rep.get("trace", rep)
    r = rep["roofline"]
    assert r["flops_per_device"] > 0 and r["collective_bytes_per_device"] > 0
    assert rep["memory"]["argument_bytes"] > 0


def test_cli_reports_error_and_skipped_cells(tmp_path, capsys, monkeypatch):
    out = str(tmp_path)

    def fail(*args, **kwargs):
        raise NotImplementedError("a decode step made to fail")

    monkeypatch.setattr(D.M, "decode_step", fail)
    reps = D.main(["--arch", "qwen2-moe-a2.7b", "--shape", "decode_32k",
                   "--out", out])
    assert reps[0]["status"] == "error"
    assert reps[0]["error"] == ("NotImplementedError: a decode step made "
                                "to fail")
    reps = D.main(["--arch", "llama3.2-1b", "--shape", "long_500k",
                   "--multi-pod", "--out", out])
    assert reps[0]["status"] == "skipped"
    names = sorted(os.listdir(out))
    assert names == ["llama3.2-1b__long_500k__2x16x16.json",
                     "qwen2-moe-a2.7b__decode_32k__16x16.json"]
    text = capsys.readouterr().out
    assert "[dryrun] qwen2-moe-a2.7b__decode_32k__16x16: error" in text


def test_hillclimb_prints_deltas_against_its_baseline(tmp_path, capsys):
    rep = H.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                  "--tag", "kv8", "--set", "kv_bits=8",
                  "--out", str(tmp_path / "perf"),
                  "--baseline-dir", str(tmp_path / "dryrun")])
    assert rep["status"] == "ok" and rep["plan"]["kv_bits"] == 8
    assert os.path.exists(tmp_path / "dryrun" /
                          "llama3.2-1b__decode_32k__16x16.json")
    assert os.path.exists(tmp_path / "perf" /
                          "llama3.2-1b__decode_32k__16x16__kv8.json")
    lines = capsys.readouterr().out.splitlines()
    for term in H.TERMS:
        assert any(line.strip().startswith(f"{term}:") and "%" in line
                   for line in lines), term
    assert any(line.strip().startswith("bound:") for line in lines)
    assert H.parse_override("kv_bits=8") == ("kv_bits", 8)
    assert H.parse_override("fsdp=true") == ("fsdp", True)
    assert H.parse_override("quant_bits=none") == ("quant_bits", None)
    assert H.parse_override("accum_dtype=bfloat16") == (
        "accum_dtype", "bfloat16")


def test_hillclimb_forwards_precision(monkeypatch):
    import repro_torch.tune.__main__ as tune_main

    seen = []
    monkeypatch.setattr(tune_main, "main", lambda argv: seen.append(argv))
    H.main(["--precision", "--fake", "--device", "cpu"])
    assert seen == [["--precision", "--fake", "--device", "cpu"]]
