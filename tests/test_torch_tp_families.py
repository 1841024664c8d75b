"""Tensor parallelism, FSDP and data parallelism of the vlm, audio, ssm
and hybrid LMs: the port's partitioned program (`models/lm/{common,model,
mamba2,rglru}.py`, explicit SPMD over `dist/sharding.py`'s collectives) on
CPU meshes that name the CPU several times, against the mesh-less port
and the JAX package (its single-device program: GSPMD partitions without
changing the function).

On phi-3-vision (image embeds prepended), seamless (encoder, decoder and
cross-attention), mamba2 and recurrentgemma reduced (f32, JAX's weights
carried across, a numpy-seeded batch with its `embeds` / `enc_inputs`),
on the meshes TP (1, 2), DP (2, 1) and FSDP (2, 2):

  * the loss within `LM_LOSS_RTOL` and every gradient leaf within
    `LM_GRAD_L2` (relative L2) of the mesh-less port's and of JAX's;
  * one `make_train_step` step (AdamW from fresh state) against the
    mesh-less port's: `train/parity.py`'s `LM_*` bounds on the loss, the
    gradients and the moments, and the updated parameters within
    `F32_TOL` wherever the step's sign is sure;
  * prefill and decode steps under TP (1, 2): logits and caches within
    `F32_TOL` of the mesh-less port's, the caches placed as
    `cache_shardings` says.

Also: mamba2's `in_proj` columns and conv channels split off their
[z | x | B | C | dt] segments (148 of 296 columns a device), a batch of
one row replicated over the data axis (DP and FSDP: nothing summed over
the copies), q heads split mid-head (3 heads of 16 over two devices),
widths the placements leave whole beside split ones (a KV head's 6
columns, whole attention, MLP and RG-LRU blocks, mamba2's projection and
conv over four devices), and the new collectives' backward passes against
their transposes.
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from repro.models.lm import model as JM
from repro_torch.convert import params_from_reference
from repro_torch.dist import sharding as S
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as LM
from repro_torch.models.lm import model as TM
from repro_torch.train import optimizer as PO
from repro_torch.train import parity as PP
from repro_torch.train import train_loop as PTL
from repro_torch.train import tree as PT
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
)

FAMILIES = ("phi-3-vision-4.2b", "seamless-m4t-large-v2", "mamba2-1.3b",
            "recurrentgemma-2b")
MESHES = {"tp": ((1, 2), False), "dp": ((2, 1), False),
          "fsdp": ((2, 2), True)}
OCFG = dict(lr=1e-3, warmup_steps=0, total_steps=10)
ROWS, SEQ = 4, 16


def _mesh(shape):
    return LM.make_mesh(shape, ("data", "model"),
                        devices=["cpu"] * (shape[0] * shape[1]))


def _batch(cfg, rows=ROWS, seed=3):
    """numpy tokens [rows, SEQ] and the modality stub's inputs."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (rows, SEQ)).astype(np.int32)}
    name = {"vlm": "embeds", "audio": "enc_inputs"}.get(cfg.family)
    if name:
        b[name] = rng.standard_normal(
            (rows, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return b


def _torch(b):
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in b.items()}


def _place(mesh, fsdp, params, logical, batch):
    """Parameters as `tree_shardings` places them, the batch as the
    dry-run does (`batch_shardings`: rows over the data axes where they
    divide them)."""
    with S.use_mesh(mesh, fsdp=fsdp):
        sh = S.tree_shardings(logical, mesh, fsdp=fsdp, shapes=params)
        placed = PT.tree_map(S.place, params, sh)
        rows = D.batch_shardings(batch, mesh)
        return placed, {k: S.place(v, rows[k]) for k, v in batch.items()}


def _full(tree):
    return PT.tree_map(lambda x: x.gather() if isinstance(x, S.Sharded)
                       else x, tree)


@functools.lru_cache(maxsize=None)
def _jax_case(arch, rows=ROWS, over=()):
    """JAX's weights, batch, loss and gradients, in one compiled
    program."""
    jcfg, tcfg = configs(arch, "float32", **dict(over))
    params = jax_params(jcfg)
    b = _batch(jcfg, rows)
    _, (loss, grads) = jax_compiled(
        jax.value_and_grad(lambda p, bb: JM.loss_fn(p, jcfg, bb)), params,
        jax_batch(b), options=TRAIN_OPTIONS)
    return (tcfg, params_from_reference(to_numpy_tree(params), device="cpu"),
            b, float(loss),
            params_from_reference(to_numpy_tree(grads), device="cpu"))


def _port(tcfg, params, batch, mesh=None, fsdp=False):
    """The port's loss, gradients and one step (AdamW from fresh state),
    placed on `mesh` (or not), gathered whole, as `lm_step_errors` reads
    them."""
    _, logical = TM.init_params(tcfg, 0, device="meta")
    if mesh is not None:
        params, batch = _place(mesh, fsdp, params, logical, batch)
    loss, _, grads = PTL.value_and_grad(
        lambda p, b: TM.loss_fn(p, tcfg, b), params, batch)
    if mesh is not None:
        grads = PTL._psum_data(grads, PTL.row_axes(batch))
    step = PTL.make_train_step(tcfg, PO.AdamWConfig(**OCFG))
    new, state, metrics = step(params, PO.init_state(params), batch)
    return float(loss), dict(
        loss=metrics["loss"], grad_norm=metrics["grad_norm"],
        lr=metrics["lr"], grads=_full(grads), params=_full(new),
        m=_full(state.m), v=_full(state.v))


def _worst_grad(want, got):
    return max(PP._rel_l2(PP._as_tensor(a, "cpu"), PP._as_tensor(g, "cpu"))
               for a, g in zip(PT.leaves(want), PT.leaves(got)))


def _check_loss_grads_step(case, mesh, fsdp):
    """The partitioned loss and gradients against JAX's and the mesh-less
    port's; the step against the mesh-less port's: loss, grad norm,
    gradients, moments and lr within `train/parity.py`'s `LM_*` bounds,
    every parameter within LM_PARAM_LR lr, and within F32_TOL wherever
    the first Adam step's sign is sure on both sides (elsewhere, where
    |g| is near Adam's eps, g / (|g| + eps) moves by up to 2 lr either
    way). F32_TOL is relative: LM_PARAM_SURE's 1.5e-4 lr is one float32
    ulp only near 0.25, and recurrentgemma's `lam` sits near -5, where
    one ulp is 4.8e-4 lr."""
    tcfg, params, b, jax_loss, jax_grads = case
    plain_loss, plain = _port(tcfg, params, _torch(b))
    loss, got = _port(tcfg, params, _torch(b), mesh, fsdp)
    for ref_loss, ref_grads in ((jax_loss, jax_grads),
                                (plain_loss, plain["grads"])):
        assert abs(loss - ref_loss) / abs(ref_loss) <= PP.LM_LOSS_RTOL
        assert _worst_grad(ref_grads, got["grads"]) <= PP.LM_GRAD_L2
    ocfg = PO.AdamWConfig(**OCFG)
    err = PP.lm_step_errors(params, plain, got, ocfg)
    for key, lim in (("loss", PP.LM_LOSS_RTOL), ("grad_norm", PP.LM_LOSS_RTOL),
                     ("grads", PP.LM_GRAD_L2), ("moments", PP.LM_MOMENT_L2),
                     ("params", PP.LM_PARAM_LR)):
        assert err[key] <= lim, (key, err)
    assert err["lr"] == 0.0 and err["frozen_equal"], err
    assert err["sure_share"] > 0.5, err
    lim = PP.LM_SURE_EPS * ocfg.eps
    for p0, gw, gg, pw, pg in zip(*(PT.leaves(t) for t in (
            params, plain["grads"], got["grads"], plain["params"],
            got["params"]))):
        sure = (gw.abs() > lim) & (gg.abs() > lim) \
            & (torch.sign(gw) == torch.sign(gg))
        np.testing.assert_allclose(pg[sure].numpy(), pw[sure].numpy(),
                                   **F32_TOL)


@pytest.mark.parametrize("mesh_id", sorted(MESHES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_partitioned_loss_grads_and_step(arch, mesh_id):
    shape, fsdp = MESHES[mesh_id]
    mesh = _mesh(shape)
    _check_loss_grads_step(_jax_case(arch), mesh, fsdp)
    counts = mesh.collectives.snapshot()
    if mesh_id == "fsdp":
        assert counts["all-gather"] > 0 and counts["reduce-scatter"] > 0
    assert counts["all-reduce"] > 0


def _decode_case(tcfg, mesh, fsdp, rows=ROWS, steps=3, seed=7):
    """Prefill and `steps` decode steps, mesh-less and placed on `mesh`:
    [(want, got logits)], the mesh-less caches and the placed ones."""
    params, logical = TM.init_params(tcfg, 0, device="cpu")
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, tcfg.vocab, (rows, 8)).astype(np.int32)
    extra = {k: v for k, v in _torch(_batch(tcfg, rows, seed)).items()
             if k != "tokens"}
    toks = torch.from_numpy(rng.integers(0, tcfg.vocab, (steps, rows, 1)))
    pp, pb = _place(mesh, fsdp, params, logical,
                    {"tokens": torch.from_numpy(prompt).long(), **extra})
    pos = 8 + (tcfg.frontend_len if tcfg.family == "vlm" else 0)
    with torch.no_grad():
        want, cache = TM.prefill(params, tcfg, torch.from_numpy(prompt),
                                 pos + steps, **extra)
        got, pcache = TM.prefill(pp, tcfg, pb["tokens"], pos + steps,
                                 **{k: pb[k] for k in extra})
        outs = [(want, got)]
        for i, tok in enumerate(toks):
            want, cache = TM.decode_step(params, tcfg, tok, cache, pos + i)
            got, pcache = TM.decode_step(
                pp, tcfg, S.place(tok, pb["tokens"].sharding), pcache,
                pos + i)
            outs.append((want, got))
    return outs, cache, pcache


def _check_decode(outs, cache, pcache, mesh):
    for want, got in outs:
        assert isinstance(got, S.Sharded)
        np.testing.assert_allclose(got.gather().numpy(), want.numpy(),
                                   **F32_TOL)
    specs = TM.cache_shardings(PT.tree_map(
        lambda t: torch.empty(t.shape, device="meta"), cache), mesh)
    for c, p, sh in zip(PT.leaves(cache), PT.leaves(pcache),
                        PT.leaves(specs)):
        assert p.sharding.spec == sh.spec
        if c.is_floating_point():
            np.testing.assert_allclose(p.gather().numpy(), c.numpy(),
                                       **F32_TOL)
        else:
            assert torch.equal(p.gather(), c)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_under_tp(arch):
    _, tcfg = configs(arch, "float32")
    mesh = _mesh((1, 2))
    outs, cache, pcache = _decode_case(tcfg, mesh, False)
    _check_decode(outs, cache, pcache, mesh)
    heads = PT.leaves(pcache)[0].sharding.spec
    assert "model" in heads


def test_mamba2_splits_off_its_segments():
    """TP (1, 2) on the reduced mamba2: `in_proj`'s 296 columns [z 128 |
    x 128 | B 16 | C 16 | dt 8] split 148 a device and the conv's 160
    channels [x | B | C] 80, neither on a segment boundary, while the 8
    heads split 4 a device; the projection and the conv weights are
    all-gathered, and a decode step writes back each device's block of
    the conv cache."""
    tcfg, params, b, *_ = case = _jax_case("mamba2-1.3b")
    mesh = _mesh((1, 2))
    _, logical = TM.init_params(tcfg, 0, device="meta")
    pp, _ = _place(mesh, False, params, logical, {})
    mix = pp["layers"]["mix"]
    assert [tuple(t.shape) for t in mix["in_proj"]["w"].parts] == [
        (2, 64, 148)] * 2
    assert [tuple(t.shape) for t in mix["conv_w"].parts] == [(2, 4, 80)] * 2
    assert [tuple(t.shape) for t in mix["A_log"].parts] == [(2, 4)] * 2
    _check_loss_grads_step(case, mesh, False)
    assert mesh.collectives.snapshot()["all-gather"] > 0
    outs, cache, pcache = _decode_case(tcfg, mesh, False)
    _check_decode(outs, cache, pcache, mesh)
    assert [tuple(t.shape) for t in pcache["layers"]["conv"].parts] == [
        (2, ROWS, 3, 80)] * 2


@pytest.mark.parametrize("arch,mesh_id", [
    ("mamba2-1.3b", "dp"), ("recurrentgemma-2b", "fsdp")])
def test_a_batch_of_one_row_is_replicated_over_the_data_axis(arch, mesh_id):
    """One row on a 'data' axis of 2 (the long_500k cells' batch): the row
    stays whole on both data devices, each computes it, and neither the
    loss nor a gradient is summed over the copies (DP: no collective at
    all; FSDP: the weights' gathers keep each device's block of the whole
    cotangent); prefill and decode on the same mesh."""
    shape, fsdp = MESHES[mesh_id]
    mesh = _mesh(shape)
    case = _jax_case(arch, rows=1)
    _check_loss_grads_step(case, mesh, fsdp)
    if mesh_id == "dp":
        assert mesh.collectives.snapshot()["n_ops"] == 0
    outs, cache, pcache = _decode_case(case[0], mesh, fsdp, rows=1)
    _check_decode(outs, cache, pcache, mesh)
    assert PT.leaves(pcache)[0].sharding.spec[1] is None  # rows whole


@pytest.mark.parametrize("arch,over,shape", [
    ("recurrentgemma-2b", (("n_heads", 3),), (1, 2)),
    ("recurrentgemma-2b", (("head_dim", 6),), (1, 4)),
    ("recurrentgemma-2b", (("n_heads", 3), ("head_dim", 2), ("d_ff", 126),
                           ("lru_width", 66)), (1, 4)),
    ("mamba2-1.3b", (("ssm_state", 15),), (1, 4))],
    ids=["q-mid-head", "kv-columns-whole", "blocks-whole",
         "ssm-projection-whole"])
def test_widths_off_the_split_boundaries(arch, over, shape):
    """Splits the placements make off a block's natural boundaries, or
    not at all. recurrentgemma (one KV head) with 3 q heads of 16 over
    two devices: 24 columns a device, mid-head, so q is gathered, every
    device attends with every head and takes its own rows of the output
    into `wo` (the full widths' 10 heads of 256 over 16); with 6-wide
    heads over four devices, whose one KV head's 6 columns stay whole:
    every device projects it from the whole weight; with 3 heads of 2,
    d_ff 126 and an RG-LRU 66 wide over four, the attention's, the MLP's
    and the RG-LRU's widths all stay whole: every device runs those
    blocks whole. mamba2 with a
    state of 15 over four devices: `in_proj`'s 294 columns and the conv's
    158 channels stay whole while the 8 heads split."""
    mesh = _mesh(shape)
    case = _jax_case(arch, over=over)
    _check_loss_grads_step(case, mesh, False)
    outs, cache, pcache = _decode_case(case[0], mesh, False)
    _check_decode(outs, cache, pcache, mesh)


def test_new_collectives_backward_are_their_transposes():
    """reduce_scatter's backward is an all-gather; all_gather(whole=True)'s
    keeps each member's own block of its cotangent: each against the
    same function written with plain tensors."""
    mesh = _mesh((1, 2))
    rng = np.random.default_rng(0)
    xs = [torch.tensor(rng.standard_normal((2, 4)), requires_grad=True)
          for _ in range(2)]
    out = S.reduce_scatter(xs, mesh, "model", -1)
    total = xs[0] + xs[1]
    torch.testing.assert_close(out[0], total[:, :2])
    torch.testing.assert_close(out[1], total[:, 2:])
    cot = [torch.tensor(rng.standard_normal((2, 2))) for _ in range(2)]
    got = torch.autograd.grad(out, xs, cot)
    for g in got:  # each input reaches both blocks of the sum
        torch.testing.assert_close(g, torch.cat(cot, dim=-1))
    ys = [torch.tensor(rng.standard_normal((3,)), requires_grad=True)
          for _ in range(2)]
    gathered = S.all_gather(ys, mesh, "model", 0, whole=True)
    whole = torch.tensor(rng.standard_normal(6))
    got = torch.autograd.grad(gathered, ys, [whole, whole])
    torch.testing.assert_close(got[0], whole[:3])
    torch.testing.assert_close(got[1], whole[3:])
    counts = mesh.collectives.snapshot()
    assert counts["reduce-scatter"] == 2 * 4 * 8
    assert counts["all-gather"] == 2 * 2 * 8 + 3 * 8
