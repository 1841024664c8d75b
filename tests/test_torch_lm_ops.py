"""The port's LM operator entry points (`kernels/ops.py`:
`quantize_weight_for_matmul`, `quantized_linear`, `decode_attend`), their
kernels' plain versions, `kv_quant`, int4 packing, the Llama-3.2-1B config
and `convert.lm_from_reference`, against the JAX package on the same
numpy-seeded inputs. The JAX Pallas kernels run in interpret mode, as the
JAX package's own tests run them.

Tolerances are the JAX tests': quantized matmul rtol 1e-5 / atol 1e-3 in
f32 and rtol 2e-2 / atol 2e-1 with bf16 inputs
(`test_kernels_quant_matmul.py`), decode attention rtol 1e-5 / atol 1e-5
(`test_kernels_decode_attention.py`): the sums run in another order.
Quantization, packing and `kv_quant` are exact.

The arithmetic of the card's tensor-core variant of the quantized matmul
(integer weights as bf16, x as one or three bf16 terms, per-group f32
partial sums times the scale) is emulated here and held to the same
tolerances, against the JAX kernel and the golden.

At full width, the port is held against the golden
`tests/golden_torch/llama32_1b_lm_ops.npz`, which stores only the JAX
entry points' outputs (inputs: `tests/torch_lm_cases.py`). Regenerate it:

    PYTHONPATH=src python -m tests.test_torch_lm_ops --regen
"""
from __future__ import annotations

import dataclasses
import inspect
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import llama32_1b as jax_llama
from repro.core import quant as RQ
from repro.kernels import ops as RK
from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.quant_matmul import quant_matmul as jax_qmm
from repro.models.lm import common as RC
from repro.models.lm.config import LMConfig as JaxLMConfig
from repro_torch.configs import llama32_1b
from repro_torch.convert import lm_from_reference
from repro_torch.core import quant as Q
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import ops as K
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.models.lm.common import kv_dequant, kv_quant
from tests import torch_lm_cases as C

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_torch",
                      "llama32_1b_lm_ops.npz")
F32_TOL = dict(rtol=1e-5, atol=1e-3)
BF16_TOL = dict(rtol=2e-2, atol=2e-1)
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _bf16_bits(a) -> np.ndarray:
    """The raw 16 bits of a bf16 array or tensor."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def test_llama32_1b_config_matches_reference():
    assert dataclasses.asdict(llama32_1b.get_config()) == \
        dataclasses.asdict(jax_llama.get_config())
    assert [f.name for f in dataclasses.fields(llama32_1b.get_config())] == \
        [f.name for f in dataclasses.fields(JaxLMConfig)]


@pytest.mark.parametrize("bits", [4, 8])
def test_symmetric_range_matches_reference(bits):
    cfg = RQ.QuantConfig(bits, symmetric=True)
    assert Q.symmetric_range(bits) == (cfg.qmin, cfg.qmax)


@pytest.mark.parametrize("signed", [False, True])
def test_int4_pack_unpack_bit_exact(signed):
    rng = np.random.default_rng(0)
    q = rng.integers(-8, 8, (6, 3, 10)).astype(np.int32)
    packed = Q.pack_int4(torch.from_numpy(q))
    want = np.asarray(RQ.pack_int4(jnp.asarray(q)))
    assert packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy(), want)
    np.testing.assert_array_equal(
        Q.unpack_int4(packed, signed=signed).numpy(),
        np.asarray(RQ.unpack_int4(jnp.asarray(want), signed=signed)))
    with pytest.raises(ValueError):
        Q.pack_int4(torch.zeros((2, 3), dtype=torch.int32))


@pytest.mark.parametrize("bits,gs", [(8, None), (4, None), (4, 128),
                                     (8, 64), (4, 16)])
def test_quantize_weight_for_matmul_bit_exact(bits, gs):
    """w_q and scales equal the JAX function's bit for bit, carried across
    by `lm_from_reference` as its tuple; a zero column takes scale 1."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(256, 96)).astype(np.float32)
    w[:, 5] = 0.0
    got = K.quantize_weight_for_matmul(torch.from_numpy(w), bits=bits,
                                       group_size=gs)
    want = lm_from_reference(
        RK.quantize_weight_for_matmul(jnp.asarray(w), bits=bits,
                                      group_size=gs), device="cpu")
    assert got[0].dtype == want[0].dtype == (
        torch.uint8 if bits == 4 else torch.int8)
    for g, x in zip(got, want):
        assert torch.equal(g, x)


def test_kv_quant_bit_exact():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 33, 4, 16)).astype(np.float32) * 3
    x[0, 1, 2] = 0.0  # scale floors at 1e-8
    q, s = kv_quant(torch.from_numpy(x))
    rq, rs = RC.kv_quant(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(_bf16_bits(s), _bf16_bits(rs))
    np.testing.assert_array_equal(
        kv_dequant(q, s, torch.float32).numpy(),
        np.asarray(RC.kv_dequant(rq, rs, jnp.float32)))


@pytest.mark.parametrize("m,k,n,bits,gs,bm,bn,bk", [
    (64, 256, 128, 8, None, 32, 64, 128),
    (64, 256, 128, 4, None, 32, 64, 128),
    (32, 512, 256, 4, 128, 32, 128, 128),
    (128, 384, 128, 8, 128, 64, 128, 128),
    (16, 128, 64, 8, 64, 16, 64, 64),
    (256, 1024, 512, 4, 256, 128, 128, 256),
])
def test_quantized_linear_matches_jax_kernel(m, k, n, bits, gs, bm, bn, bk):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    wq, sc = RK.quantize_weight_for_matmul(jnp.asarray(w), bits=bits,
                                           group_size=gs)
    want = jax_qmm(jnp.asarray(x), wq, sc, bits=bits, block_m=bm,
                   block_n=bn, block_k=bk, interpret=True)
    twq, tsc = K.quantize_weight_for_matmul(torch.from_numpy(w), bits=bits,
                                            group_size=gs)
    got = K.quantized_linear(torch.from_numpy(x), twq, tsc, bits=bits)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_linear_dtypes_match_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 128)).astype(np.float32)
    w = rng.normal(size=(128, 64)).astype(np.float32)
    wq, sc = RK.quantize_weight_for_matmul(jnp.asarray(w), bits=8)
    want = RK.quantized_linear(jnp.asarray(x, dtype), wq, sc, bits=8,
                               interpret=True)
    twq, tsc = lm_from_reference((wq, sc), device="cpu")
    got = K.quantized_linear(torch.from_numpy(x).to(getattr(torch, dtype)),
                             twq, tsc, bits=8)
    assert got.shape == (3, 5, 64) and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(
        _np(got), np.asarray(want, np.float32),
        **(F32_TOL if dtype == "float32" else BF16_TOL))


def test_quantized_linear_degenerate_groups_raise_cleanly():
    """4 scale groups for K = 2: refused like the JAX kernel refuses it."""
    x = torch.ones((4, 2))
    wq = torch.ones((2, 8), dtype=torch.int8)
    sc = torch.ones((4, 8))
    with pytest.raises(ValueError, match="not divisible"):
        K.quantized_linear(x, wq, sc, bits=8)
    with pytest.raises(ValueError):
        RK.quantized_linear(jnp.asarray(x.numpy()), jnp.asarray(wq.numpy()),
                            jnp.asarray(sc.numpy()), bits=8)


def _jax_cache(b, kv, dh, s, quant, seed=0, rep=1):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, kv, rep, dh)).astype(np.float32)
    kc = jnp.asarray(rng.normal(size=(b, s, kv, dh)), jnp.float32)
    vc = jnp.asarray(rng.normal(size=(b, s, kv, dh)), jnp.float32)
    if quant:
        (kc, ks), (vc, vs) = RC.kv_quant(kc), RC.kv_quant(vc)
        return q, {"k": kc, "v": vc, "k_scale": ks, "v_scale": vs}
    return q, {"k": kc, "v": vc}


@pytest.mark.parametrize("b,kv,rep,dh,s,bs,quant,vlen", [
    (2, 2, 4, 16, 64, 16, False, 64),
    (2, 2, 4, 16, 64, 16, False, 37),    # partially filled cache
    (1, 4, 1, 32, 128, 32, False, 100),  # MHA (rep=1)
    (2, 2, 4, 16, 100, 32, False, 70),   # ragged S vs block
    (2, 2, 4, 16, 64, 16, True, 50),     # int8 cache, bf16 scales
    (2, 1, 8, 32, 96, 32, True, 96),     # MQA + int8
    (1, 8, 8, 64, 256, 128, False, 256),  # qwen3-like geometry
])
def test_decode_attend_matches_jax_kernel(b, kv, rep, dh, s, bs, quant,
                                          vlen):
    """The JAX cache dict carried across by `lm_from_reference`, then the
    port's `decode_attend` against the JAX kernel at the JAX test's block."""
    q, cache = _jax_cache(b, kv, dh, s, quant, rep=rep)
    want = jax_decode(jnp.asarray(q), cache["k"], cache["v"],
                      jnp.int32(vlen), cache.get("k_scale"),
                      cache.get("v_scale"), block_s=bs, interpret=True)
    tcache = lm_from_reference({k: np.asarray(v) for k, v in cache.items()},
                               device="cpu")
    qm = torch.from_numpy(q).reshape(b, 1, kv * rep, dh)
    got = K.decode_attend(qm, tcache, vlen)
    assert got.shape == (b, 1, kv * rep, dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.reshape(b, kv, rep, dh).numpy(),
                               np.asarray(want), **ATTN_TOL)
    # a 0-dim int32 tensor kv_len gives the same answer
    torch.testing.assert_close(
        K.decode_attend(qm, tcache, torch.tensor(vlen, dtype=torch.int32)),
        got, rtol=0, atol=0)


@pytest.mark.parametrize("kv_len", [0, -3, torch.tensor(0, dtype=torch.int32)])
def test_decode_attention_refuses_empty_cache(kv_len):
    q, cache = _jax_cache(1, 2, 16, 32, False)
    tc = lm_from_reference({k: np.asarray(v) for k, v in cache.items()},
                           device="cpu")
    with pytest.raises(ValueError, match="no cache position"):
        decode_attention(torch.from_numpy(q), tc["k"], tc["v"], kv_len)


@pytest.mark.parametrize("bits", [8, 4])
def test_lm_from_reference_init_linear(bits):
    """An `init_linear` dict (bf16 scales, packed uint8 at 4 bits) carried
    across: the port's `quantized_linear` equals the JAX LM's `linear`."""
    cfg = jax_llama.get_config(quant_bits=bits)
    p, _ = RC.init_linear(jax.random.PRNGKey(7), 256, 96, "embed", "heads",
                          cfg)
    tp = lm_from_reference({k: np.asarray(v) for k, v in p.items()},
                           device="cpu")
    assert tp["scale"].dtype == torch.bfloat16
    assert tp["w_q"].dtype == (torch.uint8 if bits == 4 else torch.int8)
    np.testing.assert_array_equal(tp["w_q"].numpy(), np.asarray(p["w_q"]))
    np.testing.assert_array_equal(_bf16_bits(tp["scale"]),
                                  _bf16_bits(p["scale"]))
    x = np.random.default_rng(8).normal(size=(2, 3, 256)).astype(np.float32)
    want = RC.linear(jnp.asarray(x), p)
    got = K.quantized_linear(torch.from_numpy(x), tp["w_q"], tp["scale"],
                             bits=bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_lm_from_reference_bf16_cache_and_refusals():
    """A bf16 cache keeps its bits across; other inputs are refused."""
    rng = np.random.default_rng(9)
    k = jnp.asarray(rng.normal(size=(1, 8, 2, 16)), jnp.bfloat16)
    tc = lm_from_reference({"k": np.asarray(k), "v": np.asarray(k)},
                           device="cpu")
    assert tc["k"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16_bits(tc["k"]), _bf16_bits(k))
    for bad in ({"w": np.zeros(2)}, {"k": np.zeros(2)}, [np.zeros(2)]):
        with pytest.raises(ValueError):
            lm_from_reference(bad, device="cpu")


# ---------------------------------------------------------------------------
# the arithmetic of K5's `mma` variant, emulated in torch on the CPU
# ---------------------------------------------------------------------------


def _bf16_terms(x: torch.Tensor):
    """x as the bf16 terms the mma variant feeds the tensor cores: x itself
    when it is bf16, else hi, mid, lo (each the bf16 rounding of what the
    earlier ones left; every remainder is exact in f32)."""
    if x.dtype == torch.bfloat16:
        return [x]
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return [hi, mid, lo]


def mma_variant_emulation(x, w_q, w_scale, *, bits):
    """What the card's mma variant computes: integer weights as bf16 (exact),
    x as bf16 terms, an f32 sum of the exact products over each scale
    group, then that partial sum times the group's f32 scale, added up.
    The tensor cores sum in another order; f32 matmul stands in for it."""
    q = (Q.unpack_int4(w_q, signed=True) if bits == 4
         else w_q.to(torch.int32)).to(torch.float32)
    assert torch.equal(q.to(torch.bfloat16).float(), q)  # exact in bf16
    terms = _bf16_terms(x)
    k, g = q.shape[0], w_scale.shape[0]
    out = torch.zeros((x.shape[0], q.shape[1]), dtype=torch.float32)
    for i in range(g):
        rows = slice(i * (k // g), (i + 1) * (k // g))
        part = sum(t[:, rows].float() @ q[rows] for t in terms)
        out += part * w_scale[i].float()
    return out


def test_bf16_terms_sum_to_x():
    x = torch.from_numpy(np.random.default_rng(20).normal(
        size=(64, 256)).astype(np.float32)) * 3
    hi, mid, lo = _bf16_terms(x)
    assert torch.equal(hi.float() + mid.float() + lo.float(), x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,bits,gs,bm,bn,bk", [
    (64, 256, 128, 8, None, 32, 64, 128),
    (32, 512, 256, 4, 128, 32, 128, 128),
    (128, 384, 128, 8, 128, 64, 128, 128),
    (16, 128, 64, 8, 64, 16, 64, 64),
])
def test_mma_emulation_matches_jax_kernel(m, k, n, bits, gs, bm, bn, bk,
                                          dtype):
    """The mma variant's arithmetic against the JAX Pallas kernel
    (interpret mode), which rounds w * scale per weight first."""
    rng = np.random.default_rng(21)
    x = jnp.asarray(rng.normal(size=(m, k)).astype(np.float32), dtype)
    w = rng.normal(size=(k, n)).astype(np.float32)
    wq, sc = RK.quantize_weight_for_matmul(jnp.asarray(w), bits=bits,
                                           group_size=gs)
    want = jax_qmm(x, wq, sc, bits=bits, block_m=bm, block_n=bn,
                   block_k=bk, interpret=True)
    twq, tsc = lm_from_reference((wq, sc), device="cpu")
    tx = torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype))
    got = mma_variant_emulation(tx, twq, tsc, bits=bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(F32_TOL if dtype == "float32" else
                                  BF16_TOL))


# ---------------------------------------------------------------------------
# K6 on the card: its `plan`, and its split-and-merge arithmetic emulated in
# torch on the CPU
# ---------------------------------------------------------------------------


_LM = llama32_1b.get_config()


def _decode_plan_cases():
    """(b, kv, rep, dh, s, cache dtype) of the [lm] phase of chip_smoke.py
    and of every K6 case of tests/test_torch_cuda.py."""
    cases = {(C.DECODE_B, _LM.n_kv_heads, _LM.n_heads // _LM.n_kv_heads,
              _LM.head_dim, C.DECODE_S, dt)
             for dt in (torch.int8, torch.bfloat16)}
    for dt in (torch.int8, torch.bfloat16, torch.float32):
        for rep, dh in ((1, 32), (4, 64), (8, 128)):
            for s in (64, 100, 300):
                cases.add((2, 3, rep, dh, s, dt))
        cases.update({(2, 2, 4, 64, 200, dt), (1, 2, 4, 16, 40, dt),
                      (2, 2, 8, 16, 70, dt), (2, 4, 4, 32, 300, dt),
                      (1, 2, 4, 64, 1000, dt)})
    return sorted(cases, key=str)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("b,kv,rep,dh,s,dtype", _decode_plan_cases(),
                         ids=str)
def test_decode_attention_plan_is_legal(b, kv, rep, dh, s, dtype, aligned):
    """Every slice non-empty and S covered, whole tile steps, the card's
    shared memory, heads that divide KV, and no kv_len in the decision."""
    p = DA.plan(b, kv, rep, dh, s, dtype, aligned=aligned)
    lay = DA.layout(kv, rep, dh, dtype, aligned)
    assert p.splits * p.per_split >= s
    assert (p.variant == "split_s") == (p.splits > 1)
    if p.splits > 1:
        assert (p.splits - 1) * p.per_split < s  # none empty below S
        assert p.per_split >= DA.MIN_SPLIT
    assert p.tile % lay.tile_step(dh) == 0
    assert p.tile <= max(DA.TILE_MAX, lay.tile_step(dh))
    assert p.smem_bytes <= DA.SMEM_MAX
    assert kv % lay.heads == 0 and (lay.heads == 1 or lay.vec)
    assert lay.vec == (aligned and dh * dtype.itemsize % 16 == 0)
    assert p.workspace_numel(b, kv, rep, dh) == (
        p.splits * b * kv * rep * (dh + 2) if p.splits > 1 else 0)
    assert "kv_len" not in inspect.signature(DA.plan).parameters


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_decode_attention_plan_lm_shape(dtype):
    """At the [lm] shape S is split, into at least two blocks an SM, and
    int8 reads two kv heads (128 bytes) of a position at once."""
    b, kv, rep, dh = (C.DECODE_B, _LM.n_kv_heads,
                      _LM.n_heads // _LM.n_kv_heads, _LM.head_dim)
    p = DA.plan(b, kv, rep, dh, C.DECODE_S, dtype)
    lay = DA.layout(kv, rep, dh, dtype)
    blocks = p.splits * lay.grid(b, kv, rep)
    assert p.variant == "split_s" and blocks >= 2 * DA.SMS
    assert lay.heads * dh * dtype.itemsize >= DA.MIN_BYTES


def split_merge_emulation(q, k_cache, v_cache, kv_len, k_scale, v_scale, p):
    """What the card's split and merge kernels compute, in f32 torch,
    following `p` and `layout`: each split's warps walk their positions in
    tiles (scores with the folded k scale, the tile's max, one rescale,
    weights p * v_scale), the warps merge in order, then the splits in
    order (an empty split takes no part). Sums run in another order than
    on the card."""
    b, kv, rep, dh = q.shape
    end = min(k_cache.shape[1], kv_len)
    scale = dh ** -0.5
    quant = k_cache.dtype == torch.int8
    qf, kf, vf = q.float(), k_cache.float(), v_cache.float()
    if quant:
        kss = (k_scale.float() * scale).permute(0, 2, 1)[:, :, None, :]
        vss = v_scale.float().permute(0, 2, 1)[:, :, None, :]
    lay = DA.layout(kv, rep, dh, k_cache.dtype)
    pps = 32 // (DA._lanes(lay.values, dh) * lay.heads)
    pws = -(-(-(-p.per_split // DA.WARPS)) // pps) * pps
    twp = p.tile // DA.WARPS
    shape = (b, kv, rep)

    def merge(states):
        m = torch.stack([st[0] for st in states]).amax(0)
        mu = torch.where(m == -torch.inf, 0.0, m)
        f = [torch.exp(st[0] - mu) for st in states]
        return (m, sum(st[1] * fi for st, fi in zip(states, f)),
                sum(st[2] * fi[..., None] for st, fi in zip(states, f)))

    splits = []
    for sp in range(p.splits):
        s0, s1 = sp * p.per_split, min(end, (sp + 1) * p.per_split)
        if s0 >= s1:
            continue  # m = -inf, l = 0: selected away by the merge
        warps = []
        for w in range(DA.WARPS):
            m = torch.full(shape, -torch.inf)
            l, acc = torch.zeros(shape), torch.zeros(shape + (dh,))
            ws0, ws1 = s0 + w * pws, min(s1, s0 + (w + 1) * pws)
            for t0 in range(ws0, ws1, twp):
                t = slice(t0, min(ws1, t0 + twp))
                sc = torch.einsum("bgrd,bngd->bgrn", qf, kf[:, t]) * (
                    kss[..., t] if quant else scale)
                mn = torch.maximum(m, sc.amax(-1))
                c = torch.where(mn > m, torch.exp(m - mn), 1.0)
                acc, l, m = acc * c[..., None], l * c, mn
                pr = torch.exp(sc - m[..., None])
                l = l + pr.sum(-1)
                acc = acc + torch.einsum(
                    "bgrn,bngd->bgrd", pr * vss[..., t] if quant else pr,
                    vf[:, t])
            warps.append((m, l, acc))
        splits.append(merge(warps))
    _, l, acc = merge(splits)
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


_EMU_B, _EMU_KV, _EMU_REP, _EMU_DH, _EMU_S = 2, 2, 4, 32, 384
_emu_jax = {}


def _emu_inputs(quant):
    """numpy-seeded q and cache, as JAX arrays and carried to torch."""
    rng = np.random.default_rng(30)
    b, kv, rep, dh, s = _EMU_B, _EMU_KV, _EMU_REP, _EMU_DH, _EMU_S
    q = rng.normal(size=(b, kv, rep, dh)).astype(np.float32)
    k = jnp.asarray(rng.normal(size=(b, s, kv, dh)), jnp.float32)
    v = jnp.asarray(rng.normal(size=(b, s, kv, dh)), jnp.float32)
    if quant:
        (k, ks), (v, vs) = RC.kv_quant(k), RC.kv_quant(v)
        cache = {"k": k, "v": v, "k_scale": ks, "v_scale": vs}
    else:
        cache = {"k": k.astype(jnp.bfloat16), "v": v.astype(jnp.bfloat16)}
    return q, cache


def _emu_want(quant, kv_len):
    """The JAX kernel (interpret mode), once per cache and kv_len."""
    key = (quant, kv_len)
    if key not in _emu_jax:
        q, cache = _emu_inputs(quant)
        _emu_jax[key] = np.asarray(jax_decode(
            jnp.asarray(q), cache["k"], cache["v"], jnp.int32(kv_len),
            cache.get("k_scale"), cache.get("v_scale"), block_s=128,
            interpret=True))
    return _emu_jax[key]


@pytest.mark.parametrize("kv_len", [384, 1, 256, 200],
                         ids=["full", "one", "split_boundary",
                              "a_split_past_kv_len"])
@pytest.mark.parametrize("splits,per_split,tile", [
    (1, 384, 384), (1, 384, 128), (2, 256, 256), (3, 128, 128)],
    ids=["one", "one_in_3_tiles", "two", "three"])
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])
def test_split_merge_emulation_matches_jax_kernel(quant, splits, per_split,
                                                  tile, kv_len):
    """K6's split-and-merge arithmetic against the JAX Pallas kernel at the
    JAX tests' tolerance: one to three splits (kv_len 200 leaves the last
    split of three, and of two, wholly past it; 256 ends on a split
    boundary), and one split walked in three tiles."""
    q, cache = _emu_inputs(quant)
    tc = lm_from_reference({k: np.asarray(v) for k, v in cache.items()},
                           device="cpu")
    p = DA.plan(_EMU_B, _EMU_KV, _EMU_REP, _EMU_DH, _EMU_S, tc["k"].dtype)
    p = p._replace(variant="split_s" if splits > 1 else "single",
                   splits=splits, per_split=per_split, tile=tile)
    got = split_merge_emulation(torch.from_numpy(q), tc["k"], tc["v"],
                                kv_len, tc.get("k_scale"), tc.get("v_scale"),
                                p)
    np.testing.assert_allclose(got.numpy(), _emu_want(quant, kv_len),
                               **ATTN_TOL)


# ---------------------------------------------------------------------------
# full width, against the golden the JAX entry points wrote
# ---------------------------------------------------------------------------

CFG = llama32_1b.get_config()
LAYER = C.layer_linears(CFG)[:7]


@pytest.fixture(scope="module")
def golden():
    fix = np.load(GOLDEN)
    return {k: fix[k] for k in fix.files}


@pytest.mark.parametrize("scheme", C.GOLDEN_SCHEMES)
@pytest.mark.parametrize("name,k,n", LAYER, ids=[c[0] for c in LAYER])
def test_fullwidth_linear_matches_golden(golden, scheme, name, k, n):
    bits, gs = C.SCHEMES[scheme]
    wq, sc = K.quantize_weight_for_matmul(
        torch.from_numpy(C.weight(name, k, n)), bits=bits, group_size=gs)
    x = torch.from_numpy(C.activations(name, 8, k))
    got = K.quantized_linear(x, wq, sc, bits=bits)
    np.testing.assert_allclose(got.numpy(), golden[f"linear/{scheme}/{name}"],
                               **F32_TOL)


@pytest.mark.parametrize("scheme", C.GOLDEN_SCHEMES)
@pytest.mark.parametrize("name,k,n", LAYER, ids=[c[0] for c in LAYER])
def test_fullwidth_mma_emulation_matches_golden(golden, scheme, name, k, n):
    """The mma variant's arithmetic (x as three bf16 terms, per-group f32
    partial sums times the scale) on the golden's 8-row f32 inputs, `down`
    (K = 8192) included, at the JAX tests' f32 tolerance."""
    bits, gs = C.SCHEMES[scheme]
    wq, sc = K.quantize_weight_for_matmul(
        torch.from_numpy(C.weight(name, k, n)), bits=bits, group_size=gs)
    got = mma_variant_emulation(torch.from_numpy(C.activations(name, 8, k)),
                                wq, sc, bits=bits)
    np.testing.assert_allclose(got.numpy(), golden[f"linear/{scheme}/{name}"],
                               **F32_TOL)


@pytest.fixture(scope="module")
def decode_inputs():
    return C.decode_inputs(CFG)


@pytest.mark.parametrize("case,quant,kv_len", C.DECODE_CASES,
                         ids=[c[0] for c in C.DECODE_CASES])
def test_fullwidth_decode_matches_golden(golden, decode_inputs, case, quant,
                                         kv_len):
    q, k, v = (torch.from_numpy(a) for a in decode_inputs)
    if quant:
        (k, ks), (v, vs) = kv_quant(k), kv_quant(v)
        cache = {"k": k, "v": v, "k_scale": ks, "v_scale": vs}
    else:
        cache = {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
    got = K.decode_attend(q, cache, kv_len)
    np.testing.assert_allclose(got.numpy(), golden[f"decode/{case}"],
                               **ATTN_TOL)


def regen() -> None:
    """Write the golden with the JAX entry points (interpret mode)."""
    cfg = jax_llama.get_config()
    out = {}
    for scheme in C.GOLDEN_SCHEMES:
        bits, gs = C.SCHEMES[scheme]
        for name, k, n in C.layer_linears(cfg)[:7]:
            wq, sc = RK.quantize_weight_for_matmul(
                jnp.asarray(C.weight(name, k, n)), bits=bits, group_size=gs)
            y = RK.quantized_linear(jnp.asarray(C.activations(name, 8, k)),
                                    wq, sc, bits=bits, interpret=True)
            out[f"linear/{scheme}/{name}"] = np.asarray(y, np.float32)
    q, k, v = (jnp.asarray(a) for a in C.decode_inputs(cfg))
    for case, quant, kv_len in C.DECODE_CASES:
        if quant:
            (kq, ks), (vq, vs) = RC.kv_quant(k), RC.kv_quant(v)
            cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        else:
            cache = {"k": k.astype(jnp.bfloat16), "v": v.astype(jnp.bfloat16)}
        y = RK.decode_attend(q, cache, jnp.int32(kv_len), interpret=True)
        out[f"decode/{case}"] = np.asarray(y, np.float32)
    np.savez_compressed(GOLDEN, **out)
    print(f"[lm_ops] {len(out)} cases, "
          f"{os.path.getsize(GOLDEN) / 2**20:.2f} MiB -> {GOLDEN}")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--regen", action="store_true",
                    help="rewrite the golden with the JAX package")
    if ap.parse_args().regen:
        regen()
