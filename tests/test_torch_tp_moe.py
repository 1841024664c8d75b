"""Tensor, expert and data parallelism of the moe LMs: the port's
partitioned MoE (`models/lm/moe.moe_spmd` in `models/lm/model.py`'s
partitioned program) on CPU meshes that name the CPU several times,
against the mesh-less port and the JAX package (its single-device
program: GSPMD partitions the global batch without changing the
function).

On qwen2-moe-a2.7b (shared experts) and arctic-480b (dense residual)
reduced (f32, JAX's weights carried across, a numpy-seeded batch) with
`capacity_factor` 1.0, so that (token, choice) pairs drop (the reduced
config's 8.0 drops none), on TP (1, 2), DP (2, 1) and FSDP (2, 2):

  * the loss within `LM_LOSS_RTOL` and every gradient leaf within
    `LM_GRAD_L2` of the mesh-less port's and of JAX's, and one AdamW step
    against the mesh-less port's (`tests/test_torch_tp_families.py`'s
    checks);
  * the routing identical to the mesh-less one: the same top-k experts
    and the same kept (token, choice) pairs, layer by layer; the
    mesh-less run drops pairs, and a capacity taken per row block (what
    each data group would keep on its own) keeps a different set;
  * prefill and decode steps under TP (1, 2) and FSDP (2, 2) (decode's
    capacity over the global slot batch) within `F32_TOL` of the
    mesh-less port's, the caches placed as `cache_shardings` says.

Also: experts that do not divide the 'model' axis (6 over four devices:
every device runs them all, whole), a batch of one row replicated over
the data axis, and the aux loss on DP equal to the mesh-less one where
the row blocks' own aux losses differ from it.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.dist import sharding as S
from repro_torch.models.lm import model as TM
from repro_torch.models.lm import moe as TMOE
from tests.test_torch_tp_families import (
    MESHES,
    _check_decode,
    _check_loss_grads_step,
    _decode_case,
    _jax_case,
    _mesh,
    _place,
    _torch,
)
from tests.torch_lm_parity import configs, one_torch_thread  # noqa: F401

ARCHS = ("qwen2-moe-a2.7b", "arctic-480b")
DROP = (("capacity_factor", 1.0),)


def _routes(tcfg, params, batch, mesh=None, fsdp=False):
    """Each MoE layer's routing (`moe.record_routes`) in one forward of
    the loss, mesh-less or placed on `mesh`."""
    if mesh is not None:
        _, logical = TM.init_params(tcfg, 0, device="meta")
        params, batch = _place(mesh, fsdp, params, logical, batch)
    with TMOE.record_routes() as rec, torch.no_grad():
        TM.loss_fn(params, tcfg, batch)
    return rec


def _per_block_keep(tcfg, idx, n_blk: int):
    """What each of `n_blk` row blocks would keep with a capacity of its
    own (its tokens alone, counted from 0)."""
    t, k = idx.shape
    keep = []
    for blk in idx.reshape(n_blk, t // n_blk, k):
        slot, _ = TMOE._slots(blk.reshape(-1), tcfg.n_experts)
        keep.append(slot < TMOE.capacity(tcfg, t // n_blk))
    return torch.cat(keep)


def _check_routes(case, mesh, fsdp):
    tcfg, params, b = case[:3]
    want = _routes(tcfg, params, _torch(b))
    got = _routes(tcfg, params, _torch(b), mesh, fsdp)
    assert len(got) == len(want) == tcfg.n_layers
    for w, g in zip(want, got):
        assert torch.equal(w["idx"], g["idx"])
        assert torch.equal(w["keep"], g["keep"])
    assert sum(int((~w["keep"]).sum()) for w in want) > 0
    return want


@pytest.mark.parametrize("mesh_id", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_partitioned_loss_grads_and_step(arch, mesh_id):
    shape, fsdp = MESHES[mesh_id]
    mesh = _mesh(shape)
    case = _jax_case(arch, over=DROP)
    _check_loss_grads_step(case, mesh, fsdp)
    counts = mesh.collectives.snapshot()
    if mesh_id == "fsdp":
        assert counts["all-gather"] > 0 and counts["reduce-scatter"] > 0
    assert counts["all-reduce"] > 0
    want = _check_routes(case, _mesh(shape), fsdp)
    if shape[0] > 1:  # two row blocks: a per-block capacity keeps others
        assert any(not torch.equal(_per_block_keep(case[0], w["idx"], 2),
                                   w["keep"]) for w in want)


@pytest.mark.parametrize("mesh_id", ["tp", "fsdp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode(arch, mesh_id):
    _, tcfg = configs(arch, "float32", **dict(DROP))
    shape, fsdp = MESHES[mesh_id]
    mesh = _mesh(shape)
    with TMOE.record_routes() as rec:
        outs, cache, pcache = _decode_case(tcfg, mesh, fsdp)
    _check_decode(outs, cache, pcache, mesh)
    # the last decode step's routing, mesh-less then placed: 4 slots,
    # capacity max(1, round(2 * 4 * 1.0 / 8)) = 1 over the whole batch
    n = tcfg.n_layers
    plain, placed = rec[-2 * n:-n], rec[-n:]
    for w, g in zip(plain, placed):
        assert w["idx"].shape == (4, tcfg.top_k)
        assert torch.equal(w["idx"], g["idx"])
        assert torch.equal(w["keep"], g["keep"])
    assert sum(int((~w["keep"]).sum()) for w in plain) > 0


def test_experts_that_do_not_divide_the_model_axis():
    """6 experts over a 'model' axis of 4: the placements leave them
    whole, and every device runs all of them for its rows (no psum of
    the experts' outputs), beside attention split over the axis; over 2
    they split, 3 a device."""
    case = _jax_case("qwen2-moe-a2.7b", over=DROP + (("n_experts", 6),))
    mesh = _mesh((1, 4))
    _check_loss_grads_step(case, mesh, False)
    _check_routes(case, _mesh((1, 4)), False)
    tcfg, params = case[:2]
    _, logical = TM.init_params(tcfg, 0, device="meta")
    for shape, parts in (((1, 4), (2, 6, 64, 64)),
                         ((1, 2), (2, 3, 64, 64))):
        pp, _ = _place(_mesh(shape), False, params, logical, {})
        wi = pp["layers"]["ffn"]["wi"]
        assert [tuple(t.shape) for t in wi.parts] == [parts] * len(wi.parts)
    mesh = _mesh((1, 4))
    outs, cache, pcache = _decode_case(tcfg, mesh, False)
    _check_decode(outs, cache, pcache, mesh)


@pytest.mark.parametrize("arch,mesh_id", [
    ("qwen2-moe-a2.7b", "dp"), ("arctic-480b", "fsdp")])
def test_a_batch_of_one_row_is_replicated_over_the_data_axis(arch, mesh_id):
    """One row on a 'data' axis of 2: each data device routes the whole
    batch, so there is no offset and no sum over the copies."""
    shape, fsdp = MESHES[mesh_id]
    case = _jax_case(arch, rows=1, over=DROP)
    mesh = _mesh(shape)
    _check_loss_grads_step(case, mesh, fsdp)
    if mesh_id == "dp":
        assert mesh.collectives.snapshot()["n_ops"] == 0
    _check_routes(case, _mesh(shape), fsdp)


def test_aux_loss_is_the_global_batchs_on_dp():
    """The aux loss on DP (2, 1) equals the mesh-less one (its mean
    probabilities and counts over all the tokens), where the two row
    blocks' own aux losses, and their mean, differ from it."""
    tcfg, params, b = _jax_case("arctic-480b", over=DROP)[:3]
    tok = _torch(b)["tokens"]
    _, logical = TM.init_params(tcfg, 0, device="meta")
    mesh = _mesh((2, 1))
    pp, pb = _place(mesh, False, params, logical, {"tokens": tok})
    with torch.no_grad():
        _, want = TM.forward_train(params, tcfg, tok)
        _, got = TM.forward_train(pp, tcfg, pb["tokens"])
        own = [float(TM.forward_train(params, tcfg, half)[1])
               for half in tok.chunk(2)]
    assert isinstance(got, S.Sharded)
    for part in got.parts:
        np.testing.assert_allclose(float(part), float(want), rtol=1e-6)
    assert min(abs(a - float(want)) for a in own + [np.mean(own)]) \
        > 1e3 * 1e-6 * float(want)
