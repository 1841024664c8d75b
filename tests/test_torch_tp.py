"""Tensor parallelism, FSDP and data parallelism of the dense LMs: the
port's partitioned program (`models/lm/{common,model}.py`, explicit SPMD
over `dist/sharding.py`'s collectives) and the partitioned train step
(`train/{train_loop,optimizer}.py` on placed trees), on CPU meshes that
name the CPU several times, against the mesh-less port and the JAX
package (its single-device program: GSPMD partitions without changing
the function).

On the four dense archs reduced (f32, JAX's weights carried across, a
numpy-seeded batch), on the meshes TP (1, 2), DP (2, 1) and FSDP (2, 2):

  * the loss within `LM_LOSS_RTOL` and every gradient leaf within
    `LM_GRAD_L2` (relative L2) of the mesh-less port's and of JAX's;
  * one `make_train_step` step (AdamW from fresh state) under
    `train/parity.py`'s `LM_*` bounds (`lm_step_failures`) against JAX's
    step and against the mesh-less port's;
  * prefill and two decode steps under TP (1, 2): logits and the caches
    within `F32_TOL` (`tests/torch_lm_parity.py`) of the mesh-less port's,
    the caches split by KV heads.

Also: GQA whose KV heads do not divide the 'model' axis (one KV head over
two devices, qk_norm on: the 8-over-16 of the full widths), 8-bit AdamW
state under FSDP, `accum_dtype=bfloat16` at grad_accum 2 against JAX's
(gradients within `LM_BF16_GRAD_L2`: each microbatch's f32 gradients
differ in their last bits, which can move a bf16 rounding), the
collectives' backward passes against their transposes, the moe family
on a mesh, int8 gradient compression of the placed step (bit for bit
the gathered leaves'), and the training driver over the visible devices
for every family and with `--grad-compress`.
"""
from __future__ import annotations

import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as RO
from repro.train import train_loop as RTL
from repro_torch.configs import reduced_config
from repro_torch.convert import opt_state_from_reference, params_from_reference
from repro_torch.dist import sharding as S
from repro_torch.launch import mesh as LM
from repro_torch.models.lm import model as TM
from repro_torch.train import optimizer as PO
from repro_torch.train import parity as PP
from repro_torch.train import train_loop as PTL
from repro_torch.train import tree as PT
from repro.models.lm import model as JM
from tests.torch_lm_parity import (  # noqa: F401
    F32_TOL,
    configs,
    jax_compiled,
    one_torch_thread,
)
from tests.torch_lm_train_cases import (
    TRAIN_OPTIONS,
    jax_batch,
    jax_params,
    to_numpy_tree,
    torch_batch,
)

DENSE = ("llama3.2-1b", "qwen3-32b", "granite-3-2b", "codeqwen1.5-7b")
MESHES = {"tp": ((1, 2), False), "dp": ((2, 1), False),
          "fsdp": ((2, 2), True)}
OCFG = dict(lr=1e-3, warmup_steps=0, total_steps=10)
ROWS, SEQ = 4, 16
# 8-bit state: each row's log-space offset follows its smallest v, so a
# last-bit change of one gradient can move a whole row's codes (as in
# tests/test_torch_lm_train_step.py, measured 0.041 there)
Q8_MOMENT_L2 = 0.1


def _mesh(shape):
    return LM.make_mesh(shape, ("data", "model"),
                        devices=["cpu"] * (shape[0] * shape[1]))


def _batch(cfg, seed=3):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (ROWS, SEQ)).astype(
        np.int32)}


def _place(mesh, fsdp, params, logical, batch):
    with S.use_mesh(mesh, fsdp=fsdp):
        sh = S.tree_shardings(logical, mesh, fsdp=fsdp, shapes=params)
        placed = PT.tree_map(S.place, params, sh)
        rows = S.NamedSharding(mesh, S.logical_to_spec(("batch", None),
                                                       mesh))
        return placed, {k: S.place(v, rows) for k, v in batch.items()}


def _full(tree):
    """Placed leaves gathered whole (8-bit moments dequantized by the
    caller)."""
    return PT.tree_map(lambda x: x.gather() if isinstance(x, S.Sharded)
                       else x, tree)


def _dq(params, state, quant):
    if not quant:
        return state.m, state.v
    m = PT.tree_map(lambda p, q: PO._dq8(_full(q)), params, state.m)
    v = PT.tree_map(lambda p, q: PO._dq8_v(_full(q)), params, state.v)
    return m, v


def _side(params, grads, out, quant=False):
    new_p, state, metrics = out
    m, v = _dq(params, state, quant)
    return dict(loss=metrics["loss"], grad_norm=metrics["grad_norm"],
                lr=metrics["lr"], grads=_full(grads), params=_full(new_p),
                m=_full(m), v=_full(v))


@functools.lru_cache(maxsize=None)
def _jax_case(arch, over=(), accum=1, accum_dtype="float32", bits=None,
              order=()):
    """JAX's weights, batch (rows in `order`), loss and gradients, and one
    train step, in one compiled program."""
    jcfg, tcfg = configs(arch, "float32", **dict(over))
    params = jax_params(jcfg)
    b = _batch(jcfg)
    if order:
        b = {k: v[list(order)] for k, v in b.items()}
    ocfg = RO.AdamWConfig(**OCFG, state_bits=bits)
    step = RTL.make_train_step(jcfg, ocfg, grad_accum=accum,
                               accum_dtype=jnp.dtype(accum_dtype))
    state = RO.init_state(params, state_bits=bits)

    def prog(p, o, bb):
        loss, g = jax.value_and_grad(lambda q: JM.loss_fn(q, jcfg, bb))(p)
        return loss, g, step(p, o, bb)

    _, (loss, grads, out) = jax_compiled(prog, params, state, jax_batch(b),
                                         options=TRAIN_OPTIONS)
    return jcfg, tcfg, params, state, b, loss, grads, out


def _want(case, quant=False):
    *_, params, state, b, loss, grads, out = case
    return dict(_side(params_from_reference(to_numpy_tree(params),
                                            device="cpu"),
                      params_from_reference(to_numpy_tree(grads),
                                            device="cpu"),
                      (params_from_reference(to_numpy_tree(out[0]),
                                             device="cpu"),
                       opt_state_from_reference(to_numpy_tree(out[1]),
                                                device="cpu"), out[2]),
                      quant), loss_plain=float(loss))


def _port(tcfg, params, state, batch, mesh=None, fsdp=False, accum=1,
          accum_dtype=torch.float32, bits=None):
    """The port's gradients and one step, placed on `mesh` (or not)."""
    _, logical = TM.init_params(tcfg, 0, device="meta")
    if mesh is not None:
        params, batch = _place(mesh, fsdp, params, logical, batch)
    if mesh is not None or state is None:
        state = PO.init_state(params, bits)
    ocfg = PO.AdamWConfig(**OCFG, state_bits=bits)
    loss, _, grads = PTL.value_and_grad(
        lambda p, b: TM.loss_fn(p, tcfg, b), params, batch)
    if mesh is not None:
        grads = PTL._psum_data(grads)
    step = PTL.make_train_step(tcfg, ocfg, grad_accum=accum,
                               accum_dtype=accum_dtype)
    out = step(params, state, batch)
    return float(loss), _side(params, grads, out, bits == 8)


def _rel(a, b):
    return abs(a - b) / abs(b)


def _worst_grad(want, got):
    return max(PP._rel_l2(PP._as_tensor(a, "cpu"), PP._as_tensor(g, "cpu"))
               for a, g in zip(PT.leaves(want), PT.leaves(got)))


@pytest.mark.parametrize("mesh_id", sorted(MESHES))
@pytest.mark.parametrize("arch", DENSE)
def test_partitioned_loss_grads_and_step(arch, mesh_id):
    case = _jax_case(arch)
    _, tcfg, params, state, b = case[:5]
    tparams = params_from_reference(to_numpy_tree(params), device="cpu")
    tstate = opt_state_from_reference(to_numpy_tree(state), device="cpu")
    tb = torch_batch(b)
    want = _want(case)
    plain_loss, plain = _port(tcfg, tparams, tstate, tb)
    shape, fsdp = MESHES[mesh_id]
    mesh = _mesh(shape)
    loss, got = _port(tcfg, tparams, tstate, tb, mesh, fsdp)
    for ref, ref_loss in ((want, want["loss_plain"]), (plain, plain_loss)):
        assert _rel(loss, ref_loss) <= PP.LM_LOSS_RTOL
        assert _worst_grad(ref["grads"], got["grads"]) <= PP.LM_GRAD_L2
        err = PP.lm_step_errors(tparams, ref, got, PO.AdamWConfig(**OCFG))
        assert not PP.lm_step_failures(err), (mesh_id, err)
        assert err["sure_share"] > 0.5, err
    # the updated parameters keep their placements
    counts = mesh.collectives.snapshot()
    if mesh_id == "fsdp":
        assert counts["all-gather"] > 0 and counts["reduce-scatter"] > 0
    else:
        assert counts["all-gather"] == counts["reduce-scatter"] == 0
    assert counts["all-reduce"] > 0


@pytest.mark.parametrize("over,mesh_id", [
    ((("n_kv_heads", 1),), "tp"), ((("n_kv_heads", 1),), "fsdp")],
    ids=["kv1-tp", "kv1-fsdp"])
def test_kv_heads_that_do_not_divide_the_model_axis(over, mesh_id):
    """qwen3 (qk_norm) with one KV head over two 'model' devices: each
    device projects half the KV columns, the halves are all-gathered, and
    both devices' q heads attend with the one KV head."""
    case = _jax_case("qwen3-32b", over)
    _, tcfg, params, state, b = case[:5]
    tparams = params_from_reference(to_numpy_tree(params), device="cpu")
    tstate = opt_state_from_reference(to_numpy_tree(state), device="cpu")
    want = _want(case)
    shape, fsdp = MESHES[mesh_id]
    mesh = _mesh(shape)
    loss, got = _port(tcfg, tparams, tstate, torch_batch(b), mesh, fsdp)
    assert _rel(loss, want["loss_plain"]) <= PP.LM_LOSS_RTOL
    assert _worst_grad(want["grads"], got["grads"]) <= PP.LM_GRAD_L2
    err = PP.lm_step_errors(tparams, want, got, PO.AdamWConfig(**OCFG))
    assert not PP.lm_step_failures(err), err
    assert mesh.collectives.snapshot()["all-gather"] > 0


def test_eight_bit_state_under_fsdp():
    """8-bit AdamW state on FSDP (2, 2): the per-row statistics reduced
    over the split columns, so each block is quantized as its whole row;
    the padded vocab rows NaN on both sides (ROADMAP F9)."""
    case = _jax_case("llama3.2-1b", bits=8)
    _, tcfg, params, state, b = case[:5]
    tparams = params_from_reference(to_numpy_tree(params), device="cpu")
    want = _want(case, quant=True)
    _, got = _port(tcfg, tparams, None, torch_batch(b), _mesh((2, 2)),
                   True, bits=8)
    err = PP.lm_step_errors(tparams, want, got, PO.AdamWConfig(**OCFG))
    assert not PP.lm_step_failures(err, moment_l2=Q8_MOMENT_L2), err
    assert err["nan"] > 0


@pytest.mark.parametrize("mesh_id", [None, "dp"], ids=["plain", "dp"])
def test_bf16_accumulation_matches_jax(mesh_id):
    """On DP (2, 1) a microbatch is a contiguous slice of each device's
    rows: rows (0, 2) then (1, 3) of the 4, which JAX's microbatches are
    of the batch reordered (0, 2, 1, 3). Each microbatch's gradients are
    psummed before their bf16 cast, as GSPMD orders JAX's."""
    order = () if mesh_id is None else (0, 2, 1, 3)
    case = _jax_case("llama3.2-1b", accum=2, accum_dtype="bfloat16",
                     order=order)
    _, tcfg, params, state, b = case[:5]
    if order:  # the port's batch in its own order
        b = {k: v[np.argsort(order)] for k, v in b.items()}
    tparams = params_from_reference(to_numpy_tree(params), device="cpu")
    tstate = opt_state_from_reference(to_numpy_tree(state), device="cpu")
    want = _want(case)
    mesh = None if mesh_id is None else _mesh(MESHES[mesh_id][0])
    _, got = _port(tcfg, tparams, tstate, torch_batch(b), mesh,
                   accum=2, accum_dtype=torch.bfloat16)
    err = PP.lm_step_errors(tparams, want, got, PO.AdamWConfig(**OCFG))
    # the accumulated gradients are bf16 on both sides: a last-bit change
    # of a microbatch's f32 gradient can move their rounding by one bf16
    # ulp, so the moments (made of them) are held to the bf16 bound
    # (measured 2.0e-4 plain, 2.1e-4 on DP: just over LM_MOMENT_L2); the
    # rest to the f32 ones (grad norm measured 9.2e-7, sure params 3.1e-5)
    assert not PP.lm_step_failures(err, moment_l2=PP.LM_BF16_GRAD_L2), err


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_under_tp(arch):
    _, tcfg = configs(arch, "float32")
    params, logical = TM.init_params(tcfg, 0, device="cpu")
    rng = np.random.default_rng(7)
    prompt = torch.from_numpy(rng.integers(0, tcfg.vocab, (ROWS, 8)))
    steps = torch.from_numpy(rng.integers(0, tcfg.vocab, (2, ROWS, 1)))
    mesh = _mesh((1, 2))
    pp, batch = _place(mesh, False, params, logical, {"t": prompt})
    rows = batch["t"].sharding
    with torch.no_grad():
        want, cache = TM.prefill(params, tcfg, prompt, 12)
        got, pcache = TM.prefill(pp, tcfg, batch["t"], 12)
        outs = [(want, got)]
        for i, tok in enumerate(steps):
            want, cache = TM.decode_step(params, tcfg, tok, cache, 8 + i)
            got, pcache = TM.decode_step(pp, tcfg, S.place(tok, rows),
                                         pcache, 8 + i)
            outs.append((want, got))
    for want, got in outs:
        assert isinstance(got, S.Sharded)
        assert tuple(got.sharding.spec) == ("data", None, "model")
        np.testing.assert_allclose(got.gather().numpy(), want.numpy(),
                                   **F32_TOL)
    k = pcache["layers"]["k"]
    heads = "model" if tcfg.n_kv_heads % 2 == 0 else None
    assert tuple(k.sharding.spec) == (None, "data", None, heads, None)
    np.testing.assert_allclose(k.gather().numpy(),
                               cache["layers"]["k"].numpy(), **F32_TOL)


def test_collectives_backward_are_their_transposes():
    """all-gather's backward is a reduce-scatter, psum's the identity and
    enter's a psum: each checked against autograd of the same function
    written with plain tensors (a replicated output's cotangent counted
    once, as the partitioned loss is)."""
    mesh = _mesh((2, 2))
    rng = np.random.default_rng(0)
    xs = [torch.tensor(rng.standard_normal((2, 3)), requires_grad=True)
          for _ in range(4)]
    w = torch.tensor(rng.standard_normal((4, 3)))
    gathered = S.all_gather(xs, mesh, "data", 0)
    assert [tuple(t.shape) for t in gathered] == [(4, 3)] * 4
    loss = sum((t * w).sum() for t in gathered)
    loss.backward()
    groups = mesh.groups(("data",))
    for i, x in enumerate(xs):
        pos = groups[i].index(i)
        want = 2 * w[2 * pos:2 * pos + 2]  # both members' cotangents
        torch.testing.assert_close(x.grad, want)
    ys = [torch.tensor(rng.standard_normal(3), requires_grad=True)
          for _ in range(4)]
    summed = S.psum(ys, mesh, ("model",))
    torch.testing.assert_close(summed[0], ys[0] + ys[1])
    torch.testing.assert_close(summed[3], ys[2] + ys[3])
    one = [torch.full((3,), float(i + 1), dtype=torch.float64)
           for i in range(4)]
    for g, c in zip(torch.autograd.grad(summed, ys, one), one):
        torch.testing.assert_close(g, c)  # the identity
    zs = [torch.tensor(rng.standard_normal(3), requires_grad=True)
          for _ in range(4)]
    entered = S.enter(zs, mesh, ("model",))
    cot = [torch.full((3,), float(i + 1), dtype=torch.float64)
           for i in range(4)]
    got = torch.autograd.grad(entered, zs, cot)
    torch.testing.assert_close(got[0], cot[0] + cot[1])
    torch.testing.assert_close(got[2], cot[2] + cot[3])
    counts = mesh.collectives.snapshot()
    assert counts["all-gather"] == 2 * 3 * 8  # one device's operand
    assert counts["reduce-scatter"] == 4 * 3 * 8
    assert counts["all-reduce"] == 2 * 3 * 8


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b"])
@pytest.mark.parametrize("mesh_id", ["tp", "fsdp"])
def test_moe_partitions_on_a_mesh(arch, mesh_id):
    """The moe family partitions like every other: its bf16 loss on a mesh
    of several devices (capacity 1.0: pairs drop) within the bf16 bound
    of the mesh-less one (f32 against JAX: tests/test_torch_tp_moe.py)."""
    cfg = dataclasses.replace(reduced_config(arch), capacity_factor=1.0)
    params, logical = TM.init_params(cfg, 0, device="cpu")
    tokens = torch.from_numpy(_batch(cfg)["tokens"]).long()
    shape, fsdp = MESHES[mesh_id]
    pp, batch = _place(_mesh(shape), fsdp, params, logical,
                       {"tokens": tokens})
    with torch.no_grad():
        want = float(TM.loss_fn(params, cfg, {"tokens": tokens}))
        got = TM.loss_fn(pp, cfg, batch)
    assert isinstance(got, S.Sharded)
    assert _rel(float(got.parts[0]), want) <= PP.LM_BF16_LOSS_RTOL


@pytest.mark.parametrize("mesh_id", sorted(MESHES))
def test_placed_compression_equals_the_gathered_leaves(mesh_id):
    """int8 compression of the partitioned step's reduced gradients (a
    residual from an earlier step added): each leaf's codes, scale,
    dequantized gradient and new residual, compressed where they lie,
    equal bit for bit the port's and JAX's `compress_tree` of the
    gathered leaves, placed like the gradients; a placed `train_step`
    with `compress` runs, its residual that of the same gradients."""
    from repro.train import grad_compress as RGC
    from repro_torch.train import grad_compress as GC

    case = _jax_case("llama3.2-1b")
    _, tcfg, params, _, b = case[:5]
    tparams = params_from_reference(to_numpy_tree(params), device="cpu")
    _, logical = TM.init_params(tcfg, 0, device="meta")
    shape, fsdp = MESHES[mesh_id]
    mesh = _mesh(shape)
    pp, pb = _place(mesh, fsdp, tparams, logical, torch_batch(b))
    _, _, grads = PTL.value_and_grad(
        lambda p, bb: TM.loss_fn(p, tcfg, bb), pp, pb)
    grads = PTL._psum_data(grads, PTL.row_axes(pb))
    rng = np.random.default_rng(5)
    err_full = PT.tree_map(lambda g: torch.from_numpy(
        1e-4 * rng.standard_normal(tuple(g.shape))).float(), grads)
    err = PT.tree_map(lambda e, g: S.place(e, g.sharding), err_full, grads)
    deq, new_err = GC.compress_tree(grads, err)
    want = GC.compress_tree(_full(grads), err_full)
    jax_want = RGC.compress_tree(
        *(jax.tree.map(jnp.asarray, to_numpy_tree(t))
          for t in (_full(grads), err_full)))
    split = 0
    for g, e, got_d, got_e, w_d, w_e, j_d, j_e in zip(*(
            PT.leaves(t) for t in (grads, err, deq, new_err, *want)),
            *(jax.tree.leaves(t) for t in jax_want)):
        assert got_d.sharding == got_e.sharding == g.sharding
        split += bool(S.spec_axes(g.sharding.spec))
        for got, w, j in ((got_d, w_d, j_d), (got_e, w_e, j_e)):
            assert torch.equal(got.gather(), w)
            np.testing.assert_array_equal(w.numpy(), np.asarray(j))
        corrected = S.leafwise(torch.add, g, e)
        q, scale = GC.quantize(corrected)
        wq, ws = GC._q(corrected.gather())
        assert torch.equal(q.gather(), wq)
        assert all(torch.equal(s_, ws) for s_ in scale.parts)
    assert split > 0 or mesh_id == "dp"
    step = PTL.make_train_step(tcfg, PO.AdamWConfig(**OCFG), compress=True)
    err0 = GC.init_error(pp)
    *_, err1, metrics = step(pp, PO.init_state(pp), pb, err0)
    _, want1 = GC.compress_tree(_full(grads), PT.tree_map(
        lambda e: e.gather(), err0))
    for p, got, w in zip(PT.leaves(pp), PT.leaves(err1), PT.leaves(want1)):
        assert got.sharding == p.sharding
        assert torch.equal(got.gather(), w)
    assert np.isfinite(float(metrics["loss"]))


def test_batch_rows_must_split_over_the_data_axes():
    cfg = dataclasses.replace(reduced_config("llama3.2-1b"), dtype="float32")
    params, logical = TM.init_params(cfg, 0, device="cpu")
    mesh = _mesh((2, 1))
    pp, _ = _place(mesh, False, params, logical, {})
    whole = S.place(torch.zeros((2, 8), dtype=torch.long),
                    S.replicated(mesh))
    with pytest.raises(ValueError, match="rows must split"):
        TM.loss_fn(pp, cfg, {"tokens": whole})
    with pytest.raises(ValueError, match="place it"):
        TM.loss_fn(pp, cfg, {"tokens": torch.zeros((2, 8),
                                                   dtype=torch.long)})


CLI_SPANS = [(a, []) for a in ("llama3.2-1b", "phi-3-vision-4.2b",
                               "seamless-m4t-large-v2", "mamba2-1.3b",
                               "recurrentgemma-2b", "qwen2-moe-a2.7b")]
CLI_SPANS.append(("llama3.2-1b", ["--grad-compress"]))


@pytest.mark.parametrize("arch,extra", CLI_SPANS, ids=[
    a if not x else "grad-compress" for a, x in CLI_SPANS])
def test_train_cli_is_data_parallel_over_the_visible_devices(
        tmp_path, monkeypatch, arch, extra):
    """`launch/train.py` over two visible devices (the CPU named twice):
    a (2, 1) host mesh, each device its rows, for every family (moe's
    capacity and aux loss over the whole batch) and with
    `--grad-compress` (the psummed gradients compressed, the residual
    placed and checkpointed); the first loss within the bf16 bound of one
    device's (the reduced config is bf16), and a restart from a placed
    checkpoint continues the straight run bit for bit. The driver feeds
    tokens alone, as the reference's does, so the audio family (whose
    encoder needs its frames) fails alike on one device and on the mesh
    it spans."""
    from repro_torch.launch import train as CLI

    argv = ["--arch", arch, "--reduced", "--steps", "3", "--device", "cpu",
            "--log-every", "100"] + extra
    if arch == "seamless-m4t-large-v2":
        with pytest.raises(ValueError, match="enc_inputs"):
            CLI.main(argv)
    else:
        one = CLI.main(argv)
    monkeypatch.setattr(LM, "visible_devices",
                        lambda device=None: (torch.device("cpu"),) * 2)
    seen = []
    real = S.use_mesh

    def spy(mesh, fsdp=False):
        seen.append(dict(mesh.shape))
        return real(mesh, fsdp)

    monkeypatch.setattr(CLI, "use_mesh", spy)
    if arch == "seamless-m4t-large-v2":
        with pytest.raises(ValueError, match="enc_inputs"):
            CLI.main(argv)
        assert seen == [{"data": 2, "model": 1}]
        return
    two = CLI.main(argv)
    assert seen == [{"data": 2, "model": 1}]
    assert abs(two[0] - one[0]) / one[0] <= PP.LM_BF16_LOSS_RTOL
    # the loss goes the way one device's goes (down for llama; the
    # reduced mamba2 and recurrentgemma rise over three steps on both)
    assert (two[-1] < two[0]) == (one[-1] < one[0])
    assert arch != "llama3.2-1b" or two[-1] < two[0]
    ck = tmp_path / "ck"
    saved = CLI.main(argv + ["--ckpt-dir", str(ck), "--ckpt-every", "2"])
    assert saved == two
    shutil.rmtree(ck / "step_00000003")  # restart from step 2's
    (ck / "LATEST").write_text("step_00000002")
    resumed = CLI.main(argv + ["--ckpt-dir", str(ck), "--resume"])
    assert resumed == two[2:]


@pytest.mark.parametrize("arch,extra", [
    ("llama3.2-1b", ["--device", "cpu:0"]),
], ids=["indexed-device"])
def test_train_cli_keeps_one_device_where_the_step_is_not_partitioned(
        monkeypatch, arch, extra):
    """With two visible devices, a device named by index trains on the
    (1, 1) mesh of that one device, as with one visible device: the same
    losses, bit for bit."""
    from repro_torch.launch import train as CLI

    argv = ["--arch", arch, "--reduced", "--steps", "2", "--device", "cpu",
            "--log-every", "100"] + extra
    one = CLI.main(argv)
    monkeypatch.setattr(LM, "visible_devices",
                        lambda device=None: (torch.device("cpu"),) * 2)
    seen = []
    real = S.use_mesh

    def spy(mesh, fsdp=False):
        seen.append((dict(mesh.shape), mesh.device_list))
        return real(mesh, fsdp)

    monkeypatch.setattr(CLI, "use_mesh", spy)
    two = CLI.main(argv)
    want = torch.device(extra[-1] if "--device" in extra else "cpu")
    assert seen == [({"data": 1, "model": 1}, (want,))]
    assert two == one
