"""Shared parts of the port's LM parity tests (`tests/test_torch_lm_*.py`):
each architecture's reduced config run through the JAX package and through
the port on the same weights (JAX's own `init_params` draws, carried across
by `repro_torch.convert.params_from_reference`) and the same numpy-seeded
inputs.

The JAX side is compiled once per function (`jax_compiled`) with XLA's
`xla_allow_excess_precision` off. The JAX package's own eager calls run
`lax.scan` bodies as compiled programs, where XLA by default drops the
bf16 rounding between fused elementwise ops; the port, like eager JAX op
by op, rounds after every op. With the option off, the bf16 outputs of
seven archs are bit for bit JAX's; llama3.2-1b, recurrentgemma-2b and
qwen3-32b part by one or two bf16 ulps in a few per cent of the logits
(measured at most 0.0195, 0.0156 and 0.03125 at magnitudes 2 to 4: the
compiled program sums its reductions in another order). Against the
default compilation the two packages part by 0.031 to 0.094 for the dense,
SSM, hybrid and enc-dec archs, and by up to 1.36 for qwen2-moe, whose
router then picks another expert for some tokens. f32 is unaffected by
the option.

Tolerances: f32 configs rtol 1e-5, atol 5e-5 (measured: at most 4.1e-6
on logits of magnitude up to 4; the transcendental functions of XLA and
PyTorch differ in the last bit, the RG-LRU scan takes JAX's tree order).
bf16 configs: the JAX tests' own 2e-2 (tests/test_lm_archs.py), taken as
atol 2e-2 and rtol 2e-2: qwen3-32b's two-ulp 0.03125 exceeds the absolute
bound alone. With the int8 KV cache (f32): atol 2e-3 on logits, since a
key or value that differs in its last bit can round to the neighbouring
int8 code, which moves the attention output by that code's share (one
code of 4096 in the kv8 case, 7.7e-4 on the decode logits).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models.lm import model as JM
from repro_torch.configs import reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.models.lm import model as TM

F32_TOL = dict(rtol=1e-5, atol=5e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
KV8_TOL = dict(rtol=1e-5, atol=2e-3)
COMPILER_OPTIONS = {"xla_allow_excess_precision": False}
BATCH, SEQ, PROMPT, DECODE_STEPS = 2, 16, 8, 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one intra-op thread: the default (every core, in
    each of the test workers) oversubscribes the machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_compiled(fn, *args, options=COMPILER_OPTIONS):
    """`fn(*args)` (arrays, trees of arrays) compiled without excess
    precision (or with the compiler `options` given); returns (the
    compiled program, its outputs)."""
    prog = jax.jit(fn).lower(*args).compile(compiler_options=options)
    return prog, prog(*args)


def to_numpy(tree):
    """A JAX or torch tree as numpy, bf16 leaves as float32 (exact)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(tree)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def assert_trees_close(got, want, tol, where=""):
    """Same keys, shapes and dtypes (bf16 read as f32); float leaves within
    `tol`, int8 KV-cache codes within one code (f32 keys and values that
    agree to the last bit or two round to a neighbouring code at a .5
    boundary: measured 1 of 4096 in the kv8 case), other integer leaves
    (ring positions) exactly equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (
            f"{where}: keys {sorted(got)} != {sorted(want)}")
        for k in want:
            assert_trees_close(got[k], want[k], tol, f"{where}/{k}")
        return
    assert got.shape == want.shape and got.dtype == want.dtype, (
        f"{where}: {got.shape} {got.dtype} != {want.shape} {want.dtype}")
    if want.dtype == np.int8:
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1, f"{where}: codes differ by {diff.max()}"
    elif np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        np.testing.assert_allclose(got, want, err_msg=where, **tol)


def configs(arch: str, dtype: str, **over):
    """(JAX config, port config) of `arch` reduced, in `dtype`."""
    return (dataclasses.replace(jax_reduced_config(arch), dtype=dtype, **over),
            dataclasses.replace(reduced_config(arch), dtype=dtype, **over))


def inputs(cfg, seed: int = 0):
    """numpy tokens [B, S] and the modality stub's inputs, if any."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["embeds"] = rng.standard_normal(
            (BATCH, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    if cfg.family in ("encdec", "audio"):
        extra["enc_inputs"] = rng.standard_normal(
            (BATCH, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return tokens, extra


def run_jax(jcfg, seed: int = 0):
    """The JAX package's outputs of one arch: its params (numpy), the
    inputs, forward logits, prefill logits and cache, and a greedy loop of
    DECODE_STEPS decode steps (logits, tokens, last cache)."""
    params, logical = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tokens, extra = inputs(jcfg, seed)
    jextra = {k: jnp.asarray(v) for k, v in extra.items()}
    offset = jcfg.frontend_len if jcfg.family == "vlm" else 0
    max_len = offset + SEQ
    _, (fwd, aux) = jax_compiled(
        lambda p, t, e: JM.forward_train(p, jcfg, t, **e), params,
        jnp.asarray(tokens), jextra)
    _, (logits, cache) = jax_compiled(
        lambda p, t, e: JM.prefill(p, jcfg, t, max_len=max_len, **e),
        params, jnp.asarray(tokens[:, :PROMPT]), jextra)
    out = {"params": jax.tree.map(np.asarray, params), "logical": logical,
           "tokens": tokens, "extra": extra,
           "forward": to_numpy(fwd), "aux": float(aux),
           "prefill": to_numpy(logits), "prefill_cache": to_numpy(cache),
           "cache_logical": jax.tree.map(JM.cache_logical(jcfg), cache),
           "offset": offset, "max_len": max_len}
    step = None
    steps, greedy = [], [np.asarray(jnp.argmax(logits[:, 0], -1))]
    for t in range(DECODE_STEPS):
        args = (params, jnp.asarray(greedy[-1][:, None]), cache,
                jnp.int32(offset + PROMPT + t))
        if step is None:
            step, _ = jax_compiled(
                lambda p, tok, c, pos: JM.decode_step(p, jcfg, tok, c, pos),
                *args)
        logits, cache = step(*args)
        steps.append(to_numpy(logits))
        greedy.append(np.asarray(jnp.argmax(logits[:, 0], -1)))
    out.update(steps=steps, greedy=np.stack(greedy, 1),
               decode_cache=to_numpy(cache))
    return out


def check_port(tcfg, ref, tol, *, follow_own_tokens: bool):
    """Run the port on `ref`'s weights and inputs and hold every output to
    it. With `follow_own_tokens` the decode loop feeds the port's own
    argmax, which must equal JAX's at every step; otherwise it feeds JAX's
    tokens (bf16: two logits within an ulp may order either way)."""
    params = params_from_reference(ref["params"], device="cpu")
    tokens = torch.from_numpy(ref["tokens"]).long()
    extra = {k: torch.from_numpy(v) for k, v in ref["extra"].items()}
    with torch.inference_mode():
        fwd, aux = TM.forward_train(params, tcfg, tokens, **extra)
        np.testing.assert_allclose(to_numpy(fwd), ref["forward"],
                                   err_msg="forward", **tol)
        np.testing.assert_allclose(float(aux), ref["aux"], rtol=1e-5,
                                   atol=1e-6)
        logits, cache = TM.prefill(params, tcfg, tokens[:, :PROMPT],
                                   max_len=ref["max_len"], **extra)
        np.testing.assert_allclose(to_numpy(logits), ref["prefill"],
                                   err_msg="prefill", **tol)
        assert_trees_close(to_numpy(cache), ref["prefill_cache"], tol,
                           "prefill cache")
        assert TM.tree_map(TM.cache_logical(tcfg), cache) == \
            ref["cache_logical"]
        cur = torch.argmax(logits[:, 0], -1)
        greedy = [cur.numpy()]
        for t in range(DECODE_STEPS):
            if not follow_own_tokens:
                cur = torch.from_numpy(ref["greedy"][:, t]).long()
            logits, cache = TM.decode_step(
                params, tcfg, cur[:, None], cache,
                ref["offset"] + PROMPT + t)
            np.testing.assert_allclose(to_numpy(logits), ref["steps"][t],
                                       err_msg=f"decode step {t}", **tol)
            cur = torch.argmax(logits[:, 0], -1)
            greedy.append(cur.numpy())
        assert_trees_close(to_numpy(cache), ref["decode_cache"], tol,
                           "decode cache")
    if follow_own_tokens:
        np.testing.assert_array_equal(np.stack(greedy, 1), ref["greedy"])


def check_init_structure(tcfg, ref):
    """The port's `init_params` gives JAX's tree: keys, shapes, dtypes and
    logical axes (its own draws, not JAX's)."""
    got, got_lg = TM.init_params(tcfg, 0, device="cpu")

    def spec(tree):
        if isinstance(tree, dict):
            return {k: spec(v) for k, v in tree.items()}
        if isinstance(tree, torch.Tensor):
            return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))
        return (tuple(tree.shape), tree.dtype.name)

    assert spec(got) == spec(ref["params"])
    assert got_lg == ref["logical"]


def arch_checks(arch: str, dtype: str, **over):
    """The whole per-arch check: init structure, then forward, prefill,
    decode, caches and (f32) greedy tokens against JAX."""
    jcfg, tcfg = configs(arch, dtype, **over)
    ref = run_jax(jcfg)
    check_init_structure(tcfg, ref)
    f32 = dtype == "float32"
    tol = (BF16_TOL if not f32 else KV8_TOL if tcfg.kv_bits == 8
           else F32_TOL)
    check_port(tcfg, ref, tol, follow_own_tokens=f32)
