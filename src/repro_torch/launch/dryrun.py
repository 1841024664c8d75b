"""The multi-pod dry-run.

Counterpart of `repro/launch/dryrun.py`, with its functions, CLI, cell ids
and JSON keys. For every (architecture x input-shape x mesh) cell:

  1. builds the full published config on meta devices (shapes, no memory:
     the reference's `jax.ShapeDtypeStruct`s);
  2. derives parameter/optimizer/cache/batch placements from the
     logical-axis tree, and places each on the production mesh
     (`make_production_mesh(device="meta")`: 256 or 512 meta devices);
  3. "lowers" the train/prefill/decode step: binds it to those placed
     arguments;
  4. "compiles" it: runs it once on the meta devices, partitioned
     (explicit SPMD, one device's program standing for all). Running to
     the end proves the distribution config coherent: every block's shape
     meets its op's, every collective's group holds its blocks;
  5. records what the run counted (`launch/roofline.trace_step`: FLOPs,
     bytes, collective operand bytes by kind, live bytes) under the
     reference's keys into `<out>/<cell>.json`.

Memory (per device): `argument_bytes` and `output_bytes` are exact, the
sums of one device's blocks of the step's arguments and outputs;
`temp_bytes` is the most bytes the step itself held at once and
`peak_bytes` the arguments plus that: the port's own reckoning of its
eager program's storages (no donation: a train step's new parameters and
state live beside the old), where the reference reads XLA's buffer
assignment. `t_lower_s` is the seconds to build and place the arguments,
`t_compile_s` the seconds of the trace.

Cost terms: with `--method twopoint` (the default), as the reference,
traces at depths L1 and L2 (one and two super-blocks) are extrapolated to
the full depth (`_extrapolate`; the port's counts are exactly linear in
the layers, as its loop runs each one), and the full config is traced for
memory and as the proof; `--method unroll` takes the terms from the full
trace alone. Every family is partitioned (a long_500k cell's batch of one
row replicated over the data axes; the moe family's experts over 'model'
where they divide it, routed with `plan.capacity_factor` over the global
batch). A cell whose step raises reports `error` with the exception.

Usage (on a CPU: the meta devices need no card):
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] \
      [--out smoke_out/dryrun]

Results go to `smoke_out/dryrun/` unless `--out` says otherwise, never to
`experiments/dryrun/`, where the JAX package's would go.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from types import SimpleNamespace
from typing import Optional

import torch

from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.dist import sharding as S
from repro_torch.dist.sharding import named_sharding, tree_shardings, use_mesh
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.plans import plan_for
from repro_torch.models.lm import model as M
from repro_torch.models.lm.config import SHAPES, LMConfig, ShapeSpec
from repro_torch.train import optimizer as O
from repro_torch.train import tree as T
from repro_torch.train.train_loop import make_train_step

SKIP = "SKIP"
META = torch.device("meta")


def shape_by_name(name: str) -> ShapeSpec:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def cell_status(cfg: LMConfig, shape: ShapeSpec) -> str:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return SKIP  # quadratic full attention at 512k context — excluded
    return "run"


def input_specs(cfg: LMConfig, shape: ShapeSpec):
    """Meta stand-ins for every model input of this cell."""
    b, s = shape.global_batch, shape.seq_len

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=META)

    i32, f = torch.int32, torch.bfloat16
    if shape.mode in ("train", "prefill"):
        batch = {"tokens": sds((b, s), i32)}
        if cfg.family == "vlm":
            batch["embeds"] = sds((b, cfg.frontend_len, cfg.d_model), f)
        if cfg.family in ("encdec", "audio"):
            batch["enc_inputs"] = sds((b, cfg.frontend_len, cfg.d_model), f)
        return batch
    # decode: one new token against a seq_len-deep cache
    return {"token": sds((b, 1), i32), "pos": sds((), i32)}


def fitted(mesh, axes, leaf):
    spec = S._fit_spec_to_shape(S.logical_to_spec(axes, mesh),
                                tuple(leaf.shape), mesh)
    return S.NamedSharding(mesh, spec)


def batch_shardings(batch, mesh):
    def spec(name, leaf):
        if name == "pos":
            return named_sharding(mesh, ())
        return fitted(mesh, ("batch",) + (None,) * (leaf.ndim - 1), leaf)

    return {k: spec(k, v) for k, v in batch.items()}


def cache_shardings(cache_shapes, mesh):
    """Leaf-keyed placements for KV/recurrent caches (shape-fitted)."""
    return M.cache_shardings(cache_shapes, mesh)


def _opt_state_shardings(param_sh, m_shapes, mesh):
    """AdamW m/v placements: the parameter's; an int8 state's `q` the
    parameter's, its per-row scale (and zero) the first axis alone."""
    def _is_q(x):
        return isinstance(x, dict) and set(x) in (
            {"q", "scale"}, {"q", "scale", "zero"})

    def one(p_sh, m_leaf):
        if _is_q(m_leaf):
            spec = p_sh.spec
            first = spec[0] if len(spec) else None
            nd = m_leaf["scale"].ndim
            scale_sh = S.NamedSharding(
                mesh, S.P(first, *([None] * (nd - 1))) if nd else S.P())
            out = {"q": p_sh, "scale": scale_sh}
            if "zero" in m_leaf:
                out["zero"] = scale_sh
            return out
        return p_sh

    flat_p, pdef = T.flatten(param_sh)
    flat_m = T.flatten_up_to(pdef, m_shapes)
    return T.unflatten(pdef, [one(p, m) for p, m in zip(flat_p, flat_m)])


def build_param_machinery(cfg: LMConfig, arch: str, mesh, fsdp: bool):
    param_shapes, _ = M.init_params(cfg, 0, device=META)
    # logical tree from a structure-preserving reduced config — must carry
    # every flag that changes the PARAM TREE STRUCTURE
    rcfg = dataclasses.replace(
        reduced_config(arch), quant_bits=cfg.quant_bits, remat=cfg.remat,
        rglru_diagonal_gates=cfg.rglru_diagonal_gates)
    _, logical = M.init_params(rcfg, 0, device=META)
    param_sh = tree_shardings(logical, mesh, fsdp=fsdp, shapes=param_shapes)
    return param_shapes, param_sh, logical


def build_cfg(arch: str, shape: ShapeSpec, plan, *, scan_unroll: bool,
              depth: Optional[int] = None) -> LMConfig:
    is_train = shape.mode == "train"
    cfg = get_config(
        arch,
        remat=plan.remat if is_train else "none",
        quant_bits=None if is_train else plan.quant_bits,
        kv_bits=None if is_train else plan.kv_bits,
        rglru_diagonal_gates=plan.rglru_diagonal_gates,
        rglru_chunk=plan.rglru_chunk,
        scan_unroll=scan_unroll,
    )
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=plan.capacity_factor)
    if plan.ssm_chunk and cfg.family == "ssm":
        cfg = dataclasses.replace(cfg, ssm_chunk=plan.ssm_chunk)
    if depth is not None:
        if cfg.family in ("encdec", "audio"):
            cfg = dataclasses.replace(
                cfg, n_layers=2 * depth, n_enc_layers=depth,
                n_dec_layers=depth)
        else:
            cfg = dataclasses.replace(cfg, n_layers=depth)
    return cfg


def depth_points(cfg: LMConfig):
    """(L1, L2, n_super_full): depths with 1 and 2 super-blocks (+ tail),
    and the full super-block count, for the two-point extrapolation
    (per-layer cost is exactly linear in the super-block count)."""
    if cfg.family in ("encdec", "audio"):
        return 1, 2, cfg.n_enc_layers
    kinds = M.layer_kinds(cfg)
    pat, n_super, tail = M._kind_groups(kinds)
    p, t = len(pat), len(tail)
    return p + t, 2 * p + t, n_super


def _place_tree(tree, shardings):
    return T.tree_map(S.place, tree, shardings)


class Lowered:
    """A step bound to its placed arguments on a mesh (the reference's
    `jax.stages.Lowered`): `compile()` traces it once."""

    def __init__(self, fn, args, mesh):
        self.fn, self.args, self.mesh = fn, args, mesh

    def compile(self) -> "Traced":
        trace = RL.trace_step(self.fn, self.mesh)
        return Traced(trace, RL.tensor_bytes(self.args),
                      RL.tensor_bytes(trace.output), self.mesh.size)


class Traced:
    """What one trace of a step counted (the reference's `Compiled`)."""

    def __init__(self, trace, argument_bytes: int, output_bytes: int,
                 n_dev: int):
        self.trace, self.n_dev = trace, n_dev
        self.memory = SimpleNamespace(
            argument_size_in_bytes=argument_bytes,
            output_size_in_bytes=output_bytes,
            temp_size_in_bytes=trace.peak_live_bytes,
            peak_memory_in_bytes=argument_bytes + trace.peak_live_bytes)

    def memory_analysis(self):
        return self.memory

    def roofline(self) -> RL.Roofline:
        return RL.from_trace(self.trace, self.n_dev)


def lower_cell(arch: str, shape: ShapeSpec, *, multi_pod: bool,
               plan_overrides=None, scan_unroll: bool = True,
               depth: Optional[int] = None):
    """Bind one cell's step to its placed meta arguments on the production
    mesh."""
    plan = plan_for(arch, **(plan_overrides or {}))
    mesh = make_production_mesh(multi_pod=multi_pod, device=META)
    n_dev = mesh.size
    cfg = build_cfg(arch, shape, plan, scan_unroll=scan_unroll, depth=depth)
    status = cell_status(cfg, shape)
    if status == SKIP:
        return {"status": "skipped",
                "reason": "quadratic attention at 512k context"}

    param_shapes, param_sh, logical = build_param_machinery(
        cfg, arch, mesh, plan.fsdp)
    batch = input_specs(cfg, shape)
    batch_sh = batch_shardings(batch, mesh)

    accum_mult = 1
    with use_mesh(mesh, fsdp=plan.fsdp):
        params = _place_tree(param_shapes, param_sh)
        if shape.mode == "train":
            opt_cfg = O.AdamWConfig(state_bits=plan.opt_bits)
            opt_shapes = O.init_state(param_shapes, plan.opt_bits)
            # AdamW m/v take the param placements (TP [+FSDP], ZeRO-style);
            # int8 state leaves are {"q","scale"}: q takes the param's, the
            # per-row scale keeps only the first-axis split.
            m_sh = _opt_state_shardings(param_sh, opt_shapes.m, mesh)
            v_sh = _opt_state_shardings(param_sh, opt_shapes.v, mesh)
            opt = O.AdamWState(
                opt_shapes.step,
                _place_tree(opt_shapes.m, m_sh),
                _place_tree(opt_shapes.v, v_sh))
            # Trace ONE microbatch and scale the roofline terms by
            # grad_accum (its memory is the per-step peak that matters).
            accum_mult = plan.grad_accum
            if plan.grad_accum > 1:
                batch = {k: torch.empty(
                    (v.shape[0] // plan.grad_accum, *v.shape[1:]),
                    dtype=v.dtype, device=META) for k, v in batch.items()}
                batch_sh = batch_shardings(batch, mesh)
            step_fn = make_train_step(
                cfg, opt_cfg, grad_accum=1,
                accum_dtype=getattr(torch, plan.accum_dtype))
            placed = _place_tree(batch, batch_sh)
            args = (params, opt, placed)

            def fn():
                return step_fn(params, opt, placed)
        elif shape.mode == "prefill":
            max_len = shape.seq_len + (
                cfg.frontend_len if cfg.family == "vlm" else 0)
            placed = _place_tree(batch, batch_sh)
            args = (params, placed)

            def fn():
                return M.prefill(params, cfg, placed["tokens"],
                                 max_len=max_len,
                                 embeds=placed.get("embeds"),
                                 enc_inputs=placed.get("enc_inputs"))
        else:  # decode, at the cache's last position (the whole cache)
            max_len = shape.seq_len
            cache_shapes = M.init_cache(cfg, shape.global_batch, max_len,
                                        enc_len=cfg.frontend_len,
                                        device=META)
            caches = _place_tree(cache_shapes,
                                 cache_shardings(cache_shapes, mesh))
            token = S.place(batch["token"], batch_sh["token"])
            args = (params, token, caches,
                    S.place(batch["pos"], batch_sh["pos"]))

            def fn():
                return M.decode_step(params, cfg, token, caches,
                                     max_len - 1)

    return {"status": "lowered", "lowered": Lowered(fn, args, mesh),
            "cfg": cfg, "n_dev": n_dev, "plan": dataclasses.asdict(plan),
            "accum_mult": accum_mult}


def _extrapolate(r1, r2, n_super: int) -> "RL.Roofline":
    """full = r(L1) + (n_super - 1) * (r(L2) - r(L1)); exact because per-
    super-block cost is linear in the super-block count."""
    k = n_super - 1
    detail = {
        key: int(r1.coll_detail.get(key, 0)
                 + k * (r2.coll_detail.get(key, 0) - r1.coll_detail.get(key, 0)))
        for key in set(r1.coll_detail) | set(r2.coll_detail)
    }
    return RL.Roofline(
        flops=r1.flops + k * (r2.flops - r1.flops),
        hbm_bytes=r1.hbm_bytes + k * (r2.hbm_bytes - r1.hbm_bytes),
        coll_bytes=r1.coll_bytes + k * (r2.coll_bytes - r1.coll_bytes),
        coll_detail=detail,
        n_devices=r1.n_devices,
    )


def run_cell(arch: str, shape: ShapeSpec, *, multi_pod: bool, out_dir: str,
             plan_overrides=None, tag: str = "", method: str = "twopoint"):
    """One cell's report, also written to `out_dir`."""
    mesh_name = "2x16x16" if multi_pod else "16x16"
    cell_id = f"{arch}__{shape.name}__{mesh_name}" + (f"__{tag}" if tag else "")
    t0 = time.time()
    try:
        if method == "twopoint":
            # cost terms: two shallow traces, extrapolated exactly in
            # depth; memory + proof: the FULL config
            plan = plan_for(arch, **(plan_overrides or {}))
            cfg_probe = build_cfg(arch, shape, plan, scan_unroll=False)
            if cell_status(cfg_probe, shape) == SKIP:
                res = {"status": "skipped",
                       "reason": "quadratic attention at 512k context"}
            else:
                l1, l2, n_super = depth_points(cfg_probe)
                rs = []
                for d in (l1, l2):
                    rv = lower_cell(arch, shape, multi_pod=multi_pod,
                                    plan_overrides=plan_overrides,
                                    scan_unroll=True, depth=d)
                    rs.append(rv["lowered"].compile().roofline())
                res = lower_cell(arch, shape, multi_pod=multi_pod,
                                 plan_overrides=plan_overrides,
                                 scan_unroll=False)
                res["roofline_obj"] = _extrapolate(rs[0], rs[1], n_super)
        else:  # method == "unroll": one trace of the full config
            res = lower_cell(arch, shape, multi_pod=multi_pod,
                             plan_overrides=plan_overrides, scan_unroll=True)
        if res["status"] == "skipped":
            report = {"cell": cell_id, "status": "skipped",
                      "reason": res["reason"]}
        else:
            lowered = res.pop("lowered")
            t_lower = time.time() - t0
            compiled = lowered.compile()
            t_compile = time.time() - t0 - t_lower
            mem = compiled.memory_analysis()
            rl = res.pop("roofline_obj", None)
            if rl is None:
                rl = compiled.roofline()
            am = res.get("accum_mult", 1)
            if am > 1:  # one traced microbatch -> full accumulation step
                rl = RL.Roofline(rl.flops * am, rl.hbm_bytes * am,
                                 rl.coll_bytes * am, rl.coll_detail,
                                 rl.n_devices)
            cfg = res.pop("cfg")
            mf = RL.model_flops(cfg, shape, cfg.active_param_count())
            mf_per_dev = mf / res["n_dev"]
            report = {
                "cell": cell_id,
                "status": "ok",
                "arch": arch,
                "shape": shape.name,
                "mesh": mesh_name,
                "plan": res["plan"],
                "t_lower_s": round(t_lower, 1),
                "t_compile_s": round(t_compile, 1),
                "memory": {
                    "argument_bytes": mem.argument_size_in_bytes,
                    "output_bytes": mem.output_size_in_bytes,
                    "temp_bytes": mem.temp_size_in_bytes,
                    "peak_bytes": mem.peak_memory_in_bytes,
                },
                "roofline": rl.summary(),
                "model_flops_per_device": mf_per_dev,
                "useful_flops_ratio": (
                    mf_per_dev / rl.flops if rl.flops else None),
                "params": cfg.param_count(),
                "active_params": cfg.active_param_count(),
            }
    except Exception as e:  # noqa: BLE001 — dry-run must report, not die
        report = {"cell": cell_id, "status": "error",
                  "error": f"{type(e).__name__}: {e}",
                  "trace": traceback.format_exc()[-2000:]}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, cell_id + ".json"), "w") as f:
        json.dump(report, f, indent=1)
    status = report["status"]
    extra = ""
    if status == "ok":
        r = report["roofline"]
        extra = (f" bottleneck={r['bottleneck']}"
                 f" t=({r['t_compute_s']:.2e},{r['t_memory_s']:.2e},"
                 f"{r['t_collective_s']:.2e})s"
                 f" compile={report['t_compile_s']}s")
    elif status == "error":
        extra = " " + report["error"][:160]
    print(f"[dryrun] {cell_id}: {status}{extra}", flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=[s.name for s in SHAPES], default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="smoke_out/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--method", choices=("twopoint", "unroll"),
                    default="twopoint")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [shape_by_name(args.shape)] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    reports = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                path = os.path.join(
                    args.out, f"{arch}__{shape.name}__{mesh_name}.json")
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        if json.load(f).get("status") in ("ok", "skipped"):
                            print(f"[dryrun] skip existing {path}", flush=True)
                            continue
                reports.append(run_cell(arch, shape, multi_pod=mp,
                                        out_dir=args.out,
                                        method=args.method))
    return reports


if __name__ == "__main__":
    main()
