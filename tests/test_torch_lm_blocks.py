"""The port's LM building blocks (`repro_torch.models.lm.{common,moe,mamba2,
rglru}`) against the JAX package's, block by block, on numpy-seeded inputs
and on JAX's own weight draws carried across by
`repro_torch.convert.params_from_reference` (whose leaf types are checked
here too). The JAX side of a block is compiled as one program
(`tests/torch_lm_parity.py`'s `jax_compiled`, without excess precision, so
bf16 is rounded op by op as eager JAX does), which costs a fraction of
compiling each eager op.

Tolerances (f32 unless named): rtol 1e-5, atol 5e-5, or exact where the
arithmetic is the same sequence of IEEE operations; bf16 elementwise
functions exact; the RG-LRU scan follows `jax.lax.associative_scan`'s tree
order (`rglru.associative_scan`), so only the gates' transcendental
functions part (measured below 1e-6)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm import common as JC
from repro.models.lm import mamba2 as JM2
from repro.models.lm import moe as JMOE
from repro.models.lm import rglru as JRG
from repro.models.lm.config import LMConfig as JaxLMConfig
from repro_torch.convert import params_from_reference
from repro_torch.models.lm import common as C
from repro_torch.models.lm import mamba2 as M2
from repro_torch.models.lm import moe as MOE
from repro_torch.models.lm import rglru as RG
from repro_torch.models.lm.config import LMConfig
from tests.torch_lm_parity import (F32_TOL, jax_compiled,  # noqa: F401
                                  one_torch_thread, to_numpy)

BASE = dict(name="blocks", family="dense", n_layers=1, d_model=64,
            n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
            dtype="float32")


def cfgs(**over):
    kw = {**BASE, **over}
    return JaxLMConfig(**kw), LMConfig(**kw)


def rand(shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def jrun(fn, *args):
    """`fn(*args)` on the JAX side, compiled as one program."""
    return jax_compiled(fn, *args)[1]


def carry(tree):
    """A JAX tree on the port's CPU tensors, through the converter."""
    return params_from_reference(jax.tree.map(np.asarray, tree),
                                 device="cpu")


def close(got, want, **tol):
    np.testing.assert_allclose(to_numpy(got), to_numpy(want),
                               **(tol or F32_TOL))


# ---------------------------------------------------------------------------
# the converter, linear, norm, rope, elementwise
# ---------------------------------------------------------------------------


def test_converter_keeps_every_lm_leaf_type():
    """int8 and packed-uint8 `w_q`, bf16 `scale` and `embed` (through f32,
    exact) and the f32 SSM leaves arrive with their values and types."""
    jc = dataclasses.replace(cfgs()[0], dtype="bfloat16")
    key = jax.random.PRNGKey(3)
    trees = jrun(lambda k: {
        "w8": JC.init_linear(k, 64, 32, None, None,
                             dataclasses.replace(jc, quant_bits=8))[0],
        "w4": JC.init_linear(k, 64, 32, None, None,
                             dataclasses.replace(jc, quant_bits=4))[0],
        "embed": (0.1 * jax.random.normal(k, (40, 64))).astype(
            jnp.bfloat16),
        "ssm": JM2.init_mamba2_block(k, dataclasses.replace(
            jc, ssm_state=16, ssm_head_dim=16))[0],
    }, key)
    ref = jax.tree.map(np.asarray, trees)
    got = carry(trees)
    want_types = {"w8": {"w_q": torch.int8, "scale": torch.bfloat16},
                  "w4": {"w_q": torch.uint8, "scale": torch.bfloat16}}
    for k, types in want_types.items():
        for leaf, t in types.items():
            assert got[k][leaf].dtype == t
    assert got["embed"].dtype == torch.bfloat16
    for leaf in ("A_log", "D", "dt_bias"):
        assert got["ssm"][leaf].dtype == torch.float32
    jax.tree.map(lambda w, g: np.testing.assert_array_equal(
        to_numpy(g), to_numpy(w)), ref, got)


@pytest.mark.parametrize("quant_bits", [None, 8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_matches_jax(quant_bits, dtype):
    jc, _ = cfgs(quant_bits=quant_bits, dtype=dtype)
    p = jrun(lambda k: JC.init_linear(k, 64, 48, None, None, jc)[0],
             jax.random.PRNGKey(1))
    x = rand((2, 5, 64), 1)
    xj = jnp.asarray(x).astype(jc.dtype)
    want = jrun(JC.linear, xj, p)
    got = C.linear(torch.from_numpy(x).to(C.dt(cfgs(dtype=dtype)[1])),
                   carry(p))
    close(got, want)  # the same bf16 products, rounded once


def test_port_init_linear_quantizes_like_jax():
    """The port's own W8/W4 draws: dequantized, each within half a step of
    the f32 weight, the packed nibbles JAX's layout (low = even column)."""
    for bits in (8, 4):
        _, tc = cfgs(quant_bits=bits)
        gen = torch.Generator().manual_seed(0)
        p, lg = C.init_linear(gen, 64, 48, "embed", "ffn", tc)
        w = C.normal(torch.Generator().manual_seed(0), (64, 48), 64**-0.5)
        deq = C.linear(torch.eye(64), p)
        assert lg == {"w_q": ("embed", "ffn"), "scale": (None, "ffn")}
        assert float((deq - w).abs().max()) <= float(
            p["scale"].max()) / 2 + 1e-6
        q = jnp.asarray(torch.round(w / p["scale"]).to(torch.int8).numpy())
        if bits == 4:
            u = jnp.where(q < 0, q + 16, q).astype(jnp.uint8)
            packed = (u[:, 0::2] & 0xF) | ((u[:, 1::2] & 0xF) << 4)
            np.testing.assert_array_equal(p["w_q"].numpy(),
                                          np.asarray(packed))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_match_jax(dtype):
    x = rand((2, 7, 4, 16), 2, 3.0)
    scale = 1 + rand((16,), 3, 0.1)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = JC.rms_norm(jx, {"scale": jnp.asarray(scale).astype(dtype)}, 1e-5)
    got = C.rms_norm(tx, {"scale": torch.from_numpy(scale).to(tx.dtype)},
                     1e-5)
    close(got, want, rtol=1e-6, atol=1e-6)
    pos = np.array([[3, 4, 5, 6, 7, 8, 9], [0, 1, 2, 30, 31, 32, 99]])
    for theta, positions in ((10000.0, pos[0]), (500000.0, pos)):
        want = JC.rope(jx, jnp.asarray(positions), theta)
        got = C.rope(tx, torch.from_numpy(positions), theta)
        # f32: cos/sin/pow of XLA and PyTorch part in the last bit
        close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_elementwise_functions_match_jax_nn(dtype):
    x = rand((4096,), 4, 4.0)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    # bf16: every op rounded where XLA rounds it, so bit for bit; f32:
    # XLA's exp/tanh/log1p against PyTorch's, a few ulps apart
    tol = dict(rtol=0, atol=0) if dtype == "bfloat16" else dict(
        rtol=1e-6, atol=1e-6)
    close(C.silu(tx), jax.nn.silu(jx), **tol)
    close(C.gelu(tx), jax.nn.gelu(jx), **tol)
    close(C.sigmoid(tx), jax.nn.sigmoid(jx), **tol)
    close(C.softplus(tx.float()), jax.nn.softplus(jx.astype(jnp.float32)),
          rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def qkv(b=2, sq=9, sk=9, h=4, kv=2, dh=16, seed=5):
    return rand((b, sq, h, dh), seed), rand((b, sk, kv, dh), seed + 1), \
        rand((b, sk, kv, dh), seed + 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv", [4, 2, 1])  # MHA, GQA, MQA
def test_full_attention_matches_jax(kv, dtype):
    q, k, v = qkv(kv=kv, sk=12)
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(
        rtol=0, atol=0)  # f32 sums of exact products, rounded once to bf16
    kv_len = np.array([5, 12], np.int32)
    kws = (dict(causal=True), dict(causal=True, window=4),
           dict(causal=False), dict(causal=False, kv_offset=3))
    want = jrun(lambda q, k, v, n: [JC.full_attention(q, k, v, **kw)
                                    for kw in kws]
                + [JC.full_attention(q[:, :1], k, v, causal=False,
                                     kv_offset=4, kv_len=n)],
                jq, jk, jv, jnp.asarray(kv_len))
    got = [C.full_attention(tq, tk, tv, **kw) for kw in kws] + [
        C.full_attention(tq[:, :1], tk, tv, causal=False, kv_offset=4,
                         kv_len=torch.from_numpy(kv_len))]
    for g, w in zip(got, want):
        close(g, w, **tol)


def test_pos_attention_matches_jax():
    q, k, v = qkv(sq=1, sk=8)
    kpos = np.array([8, 9, 10, -1, 4, 5, 6, 7], np.int32)
    for window in (0, 5):
        close(C.pos_attention(*map(torch.from_numpy, (q, k, v, kpos)), 10,
                              window),
              jrun(lambda *a: JC.pos_attention(*a, 10, window),
                   *map(jnp.asarray, (q, k, v, kpos))))


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=5)],
                         ids=["causal", "full", "window"])
def test_blockwise_attention_matches_jax(kw):
    """block_k 4 over 11 keys: three blocks, a ragged tail of one."""
    q, k, v = qkv(sq=11, sk=11)
    want = jrun(lambda *a: JC.blockwise_attention(*a, block_k=4, **kw),
                *map(jnp.asarray, (q, k, v)))
    got = C.blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                block_k=4, **kw)
    close(got, want)
    # and the direct form it stands in for
    close(got, C.full_attention(*map(torch.from_numpy, (q, k, v)), **kw),
          rtol=1e-5, atol=1e-5)


def attn_params(**over):
    jc, tc = cfgs(**over)
    p = jrun(lambda k: JC.init_attention(k, jc)[0], jax.random.PRNGKey(7))
    return jc, tc, p, carry(p)


def _jax_cache(jc, b, size, ring=False):
    dtype = jnp.int8 if jc.kv_bits == 8 else jnp.dtype(jc.dtype)
    c = {"k": jnp.zeros((b, size, jc.n_kv_heads, jc.head_dim), dtype),
         "v": jnp.zeros((b, size, jc.n_kv_heads, jc.head_dim), dtype)}
    if ring:
        c["pos"] = jnp.full((size,), -1, jnp.int32)
    if jc.kv_bits == 8:
        c["k_scale"] = jnp.zeros((b, size, jc.n_kv_heads), jnp.bfloat16)
        c["v_scale"] = jnp.zeros((b, size, jc.n_kv_heads), jnp.bfloat16)
    return c


@pytest.mark.parametrize("case", ["bf16", "f32", "int8", "ring", "ring_wrap",
                                  "ring_int8", "clamped"])
def test_attention_block_cache_matches_jax(case):
    """Prefill then decode steps through `attention_block` with each kind
    of cache: the insert at `cache_pos`, the ring of local attention
    (window 6; with a 4-slot ring that the 8-token prefill overfills, as
    the reference's `size | s` case), the int8 cache, and a decode past
    the end of a global cache (the reference clamps the write index)."""
    dtype = "bfloat16" if case == "bf16" else "float32"
    over = dict(dtype=dtype, qk_norm=case == "f32")
    if "int8" in case:
        over["kv_bits"] = 8
    jc, tc, jp, tp = attn_params(**over)
    ring = case.startswith("ring")
    size = 4 if case == "ring_wrap" else 8 if case == "clamped" else 12
    window = 6 if ring else 0
    x = rand((2, 11, 64), 8)
    jx, tx = jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        C.dt(tc))
    jcache = _jax_cache(jc, 2, size, ring)
    tcache = carry(jcache)
    s0 = 8
    pos = np.arange(s0)
    jo, jcache = jrun(lambda p, x, c: JC.attention_block(
        p, x, jc, jnp.asarray(pos), window=window, kv_cache=c),
        jp, jx[:, :s0], jcache)
    to, tcache = C.attention_block(tp, tx[:, :s0], tc, torch.from_numpy(pos),
                                   window=window, kv_cache=tcache)
    tol = F32_TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    int8_tol = dict(rtol=1e-5, atol=2e-3)  # a code at a .5 boundary
    close(to, jo, **tol)
    step = None
    for t in range(s0, 11):
        args = (jp, jx[:, t:t + 1], jnp.asarray([t]), jcache, jnp.int32(t))
        if step is None:  # one program for every step
            step = jax_compiled(lambda p, x, pos, c, cp: JC.attention_block(
                p, x, jc, pos, window=window, kv_cache=c, cache_pos=cp),
                *args)[0]
        jo, jcache = step(*args)
        to, tcache = C.attention_block(
            tp, tx[:, t:t + 1], tc, torch.tensor([t]), window=window,
            kv_cache=tcache, cache_pos=t)
        close(to, jo, **(int8_tol if "int8" in case else tol))
    want, got = to_numpy(jcache), to_numpy(tcache)
    assert set(got) == set(want)
    for key in want:
        if want[key].dtype == np.int8:
            assert np.abs(got[key].astype(int) - want[key]).max() <= 1
        elif key == "pos":
            np.testing.assert_array_equal(got[key], want[key])
        else:
            np.testing.assert_allclose(got[key], want[key], **tol)


@pytest.mark.parametrize("case", ["f32", "int8", "ring"])
def test_attention_block_writes_the_cache_in_place(case):
    """Prefill and a decode step through `attention_block` return the cache
    tensors they were given (no copy of the cache), the decode step
    writing only its own position of each."""
    jc, tc, _, tp = attn_params(dtype="float32",
                                kv_bits=8 if case == "int8" else 0)
    window = 6 if case == "ring" else 0
    cache = carry(_jax_cache(jc, 2, 12, ring=case == "ring"))
    given = dict(cache)
    x = torch.from_numpy(rand((2, 9, 64), 13))
    _, cache = C.attention_block(tp, x[:, :8], tc, torch.arange(8),
                                 window=window, kv_cache=cache)
    assert cache.keys() == given.keys()
    assert all(cache[k] is given[k] for k in given)
    before = {k: t.clone() for k, t in cache.items()}
    _, cache = C.attention_block(tp, x[:, 8:], tc, torch.tensor([8]),
                                 window=window, kv_cache=cache, cache_pos=8)
    for k, t in cache.items():
        assert t is given[k], k
        axis = 0 if k == "pos" else 1  # the sequence axis
        rows = (t != before[k]).movedim(axis, 0).reshape(12, -1).any(1)
        assert rows.nonzero().flatten().tolist() == [8], k


def test_attention_block_cross_and_no_cache_match_jax():
    jc, tc, jp, tp = attn_params()
    x, mem = rand((2, 5, 64), 9), rand((2, 7, 64), 10)
    pos = np.arange(5)
    close(C.attention_block(tp, torch.from_numpy(x), tc,
                            torch.from_numpy(pos), xk=torch.from_numpy(mem))[0],
          jrun(lambda p, x, m: JC.attention_block(
              p, x, jc, jnp.asarray(pos), xk=m)[0], jp, jnp.asarray(x),
              jnp.asarray(mem)))
    for causal in (True, False):
        close(C.attention_block(tp, torch.from_numpy(x), tc,
                                torch.from_numpy(pos), causal=causal)[0],
              jrun(lambda p, x: JC.attention_block(
                  p, x, jc, jnp.asarray(pos), causal=causal)[0], jp,
                  jnp.asarray(x)))


def test_dense_block_matches_jax():
    jc, tc = cfgs()
    p = jrun(lambda k: JC.init_dense_block(k, jc)[0], jax.random.PRNGKey(11))
    x = rand((2, 6, 64), 12)
    pos = np.arange(6)
    close(C.dense_block(carry(p), torch.from_numpy(x), tc,
                        torch.from_numpy(pos))[0],
          jrun(lambda p, x: JC.dense_block(p, x, jc, jnp.asarray(pos))[0],
               p, jnp.asarray(x)))


# ---------------------------------------------------------------------------
# MoE, Mamba-2, RG-LRU
# ---------------------------------------------------------------------------


def moe_cfgs(**over):
    return cfgs(family="moe", n_experts=8, top_k=2, moe_d_ff=32, **over)


@pytest.mark.parametrize("over", [
    dict(capacity_factor=8.0),  # lossless: cap == T
    dict(capacity_factor=0.5),  # drops choices past each expert's capacity
    dict(capacity_factor=1.25, n_shared_experts=1, shared_d_ff=48),
    dict(capacity_factor=1.0, dense_residual=True),
], ids=["lossless", "dropping", "shared", "dense_residual"])
def test_moe_ffn_matches_jax(over):
    jc, tc = moe_cfgs(**over)
    p = jrun(lambda k: JMOE.init_moe(k, jc)[0], jax.random.PRNGKey(13))
    x = rand((2, 9, 64), 14)
    want_y, want_aux = jrun(lambda p, x: JMOE.moe_ffn(p, x, jc), p,
                            jnp.asarray(x))
    got_y, got_aux = MOE.moe_ffn(carry(p), torch.from_numpy(x), tc)
    close(got_y, want_y)
    close(got_aux, want_aux, rtol=1e-6, atol=1e-7)


def test_moe_router_ties_take_the_lower_expert():
    """Experts 2, 5 and 6 have the same router column, so every token's
    probabilities tie among them: `jax.lax.top_k` takes the lower index
    first, and so must the port (a dropping capacity makes the order
    matter for which choices are kept)."""
    jc, tc = moe_cfgs(capacity_factor=0.75)
    p = jrun(lambda k: JMOE.init_moe(k, jc)[0], jax.random.PRNGKey(15))
    w = np.asarray(p["router"]["w"]).copy()
    w[:, 5] = w[:, 2]
    w[:, 6] = w[:, 2]
    w[:, 2] += 3.0  # make the tied experts the likeliest
    w[:, 5] += 3.0
    w[:, 6] += 3.0
    p["router"]["w"] = jnp.asarray(w)
    x = np.abs(rand((2, 8, 64), 16))
    probs = jax.nn.softmax(jnp.asarray(x).reshape(16, 64) @ p["router"]["w"])
    _, jidx = jax.lax.top_k(probs, 2)
    _, tidx = MOE.top_k(torch.from_numpy(np.array(probs)), 2)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert set(np.unique(np.asarray(jidx))) == {2, 5}  # 6 loses every tie
    want_y, _ = jrun(lambda p, x: JMOE.moe_ffn(p, x, jc), p, jnp.asarray(x))
    got_y, _ = MOE.moe_ffn(carry(p), torch.from_numpy(x), tc)
    close(got_y, want_y)


def ssm_cfgs(**over):
    return cfgs(family="ssm", d_ff=0, ssm_state=16, ssm_head_dim=16,
                ssm_chunk=4, **over)


@pytest.mark.parametrize("s", [8, 11])  # whole chunks; a ragged tail
def test_ssd_chunked_and_step_match_jax(s):
    b, h, p, n = 2, 3, 16, 8
    rng = np.random.default_rng(17)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dtv = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    Cm = rng.standard_normal((b, s, n)).astype(np.float32)
    want_y, want_st = jrun(lambda *a: JM2.ssd_chunked(*a, chunk=4),
                           *map(jnp.asarray, (x, dtv, A, B, Cm)))
    got_y, got_st = M2.ssd_chunked(*map(torch.from_numpy, (x, dtv, A, B, Cm)),
                                   chunk=4)
    close(got_y, want_y)
    close(got_st, want_st)
    # one more token against the carried state
    x1, d1, B1, C1 = (a[:, :1] for a in (x, dtv, B, Cm))
    want = jrun(JM2.ssd_step, *map(jnp.asarray, (x1, d1, A, B1, C1)),
                want_st)
    got = M2.ssd_step(*map(torch.from_numpy, (x1, d1, A, B1, C1)), got_st)
    close(got[0], want[0])
    close(got[1], want[1])


def test_mamba2_block_prefill_then_step_matches_jax():
    jc, tc = ssm_cfgs()
    p = jrun(lambda k: JM2.init_mamba2_block(k, jc)[0],
             jax.random.PRNGKey(18))
    tp = carry(p)
    x = rand((2, 10, 64), 19)
    want, wst = jrun(lambda p, x: JM2.mamba2_block(p, x, jc, state={}), p,
                     jnp.asarray(x[:, :9]))
    got, gst = M2.mamba2_block(tp, torch.from_numpy(x[:, :9]), tc, state={})
    close(got, want)
    want, wst = jrun(lambda p, x, st: JM2.mamba2_block(p, x, jc, state=st),
                     p, jnp.asarray(x[:, 9:]), wst)
    got, gst = M2.mamba2_block(tp, torch.from_numpy(x[:, 9:]), tc, state=gst)
    close(got, want)
    for key in ("conv", "ssd"):
        close(gst[key], wst[key])


def rec_cfgs(**over):
    return cfgs(family="hybrid", lru_width=32, block_pattern=("rec",),
                **over)


@pytest.mark.parametrize("chunk", [0, 4, 5])  # whole sequence; 3 chunks;
def test_rglru_scan_and_step_match_jax(chunk):  # 3 chunks with a pad of 3
    jc, tc = rec_cfgs(rglru_chunk=chunk)
    p = jrun(lambda k: JRG.init_rglru_block(k, jc)[0],
             jax.random.PRNGKey(20))
    tp = carry(p)
    xc = rand((2, 12, 32), 21)
    want_h, want_last = jrun(lambda p, x: JRG.rglru_scan(p, x, chunk), p,
                             jnp.asarray(xc))
    got_h, got_last = RG.rglru_scan(tp, torch.from_numpy(xc), chunk)
    close(got_h, want_h, rtol=1e-6, atol=1e-6)
    close(got_last, want_last, rtol=1e-6, atol=1e-6)
    want = jrun(JRG.rglru_step, p, jnp.asarray(xc[:, :1]), want_last)
    got = RG.rglru_step(tp, torch.from_numpy(xc[:, :1]), got_last)
    close(got[0], want[0], rtol=1e-6, atol=1e-6)
    close(got[1], want[1], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 7, 8, 13])
def test_associative_scan_takes_jax_order(n):
    """Bit for bit `jax.lax.associative_scan` on a non-associative-in-f32
    combine (the RG-LRU's), odd and even lengths."""
    a = np.exp(-np.abs(rand((3, n, 5), 22)))
    b = rand((3, n, 5), 23)
    want = jax.lax.associative_scan(JRG._comb, (jnp.asarray(a),
                                                jnp.asarray(b)), axis=1)
    got = RG.associative_scan(RG._comb, (torch.from_numpy(a),
                                         torch.from_numpy(b)), dim=1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("diagonal", [False, True])
def test_rglru_block_prefill_then_step_matches_jax(diagonal):
    jc, tc = rec_cfgs(rglru_diagonal_gates=diagonal)
    p = jrun(lambda k: JRG.init_rglru_block(k, jc)[0],
             jax.random.PRNGKey(24))
    tp = carry(p)
    x = rand((2, 7, 64), 25)
    want, wst = jrun(lambda p, x: JRG.rglru_block(p, x, jc, state={}), p,
                     jnp.asarray(x[:, :6]))
    got, gst = RG.rglru_block(tp, torch.from_numpy(x[:, :6]), tc, state={})
    close(got, want)
    want, wst = jrun(lambda p, x, st: JRG.rglru_block(p, x, jc, state=st),
                     p, jnp.asarray(x[:, 6:]), wst)
    got, gst = RG.rglru_block(tp, torch.from_numpy(x[:, 6:]), tc, state=gst)
    close(got, want)
    for key in ("conv", "h"):
        close(gst[key], wst[key])
