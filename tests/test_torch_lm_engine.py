"""The port's registry, LM `Engine` and full-width golden on the CPU.

* Registry: `get_config` and `reduced_config` of every arch equal the JAX
  package's field for field; the NetSpec archs build the same nets.
* Engine: the three properties of `tests/test_serve_engine.py` (greedy
  output equals a manual prefill-and-decode loop; more requests than slots
  are all served; a prompt gives the same tokens whatever shares its
  batch), and greedy tokens equal to the JAX `Engine`'s on the same
  weights and prompts (f32: in bf16 two logits within an ulp may order
  either way, see `tests/torch_lm_parity.py`).
* Golden: Llama-3.2-1B at its published widths, depth cut to 2 layers, in
  f32, on numpy-seeded weights (`tests/torch_lm_cases.py`): the port's
  prefill and greedy decode against the JAX outputs frozen in
  `tests/golden_torch/llama32_1b_serve.npz` (logits at 256 seeded vocab
  ids and at the argmax, rtol 1e-4 / atol 1e-4: 2048-long f32 sums in
  another order; tokens exact), and the port's `Engine` on the same
  prompts. Regenerate with the JAX package:

    PYTHONPATH=src python -m tests.test_torch_lm_engine --regen
"""
from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models.lm import model as JM
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import llama32_1b
from repro_torch.configs import registry as R
from repro_torch.convert import netspec_from_reference, params_from_reference
from repro_torch.models.lm import model as M
from repro_torch.serve.engine import Engine, Request
from tests import torch_lm_cases as CASES
from tests.torch_lm_parity import one_torch_thread, to_numpy  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_torch",
                      "llama32_1b_serve.npz")
GOLDEN_TOL = dict(rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def test_registry_lists_the_same_archs():
    assert set(R.ARCHS) == set(JR.ARCHS)
    assert R.CNN_ARCHS == JR.CNN_ARCHS and R.DSCNN_ARCHS == JR.DSCNN_ARCHS
    with pytest.raises(KeyError, match="unknown arch"):
        R.get_config("gpt-5")


@pytest.mark.parametrize("arch", sorted(JR.ARCHS))
def test_configs_match_jax_field_for_field(arch):
    assert dataclasses.asdict(R.get_config(arch)) == dataclasses.asdict(
        JR.get_config(arch))
    assert dataclasses.asdict(R.reduced_config(arch)) == dataclasses.asdict(
        JR.reduced_config(arch))
    over = dict(quant_bits=8, kv_bits=8, dtype="float32")
    assert dataclasses.asdict(R.reduced_config(arch, **over)) == \
        dataclasses.asdict(JR.reduced_config(arch, **over))


@pytest.mark.parametrize("arch", sorted(JR.DSCNN_ARCHS))
def test_netspec_archs_build_the_same_nets(arch):
    assert R.netspec_build_record(arch, bits=4) == JR.netspec_build_record(
        arch, bits=4)
    assert R.get_netspec(arch) == netspec_from_reference(
        JR.get_netspec(arch))
    with pytest.raises(KeyError, match="unknown netspec arch"):
        R.netspec_build_record("mobilenet-v2")


# ---------------------------------------------------------------------------
# the Engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def llama():
    cfg = R.reduced_config("llama3.2-1b")
    return cfg, M.init_params(cfg, 0, device="cpu")[0]


def manual_greedy(params, cfg, prompt, max_new, max_len):
    with torch.inference_mode():
        tokens = torch.from_numpy(prompt).long()[None, :]
        logits, cache = M.prefill(params, cfg, tokens, max_len=max_len)
        out = [int(torch.argmax(logits[0, 0]))]
        pos = tokens.shape[1]
        for _ in range(max_new - 1):
            logits, cache = M.decode_step(
                params, cfg, torch.tensor([[out[-1]]]), cache, pos)
            pos += 1
            out.append(int(torch.argmax(logits[0, 0])))
    return out


def test_engine_matches_manual_greedy(llama):
    cfg, params = llama
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, 6).astype(
        np.int32)
    eng = Engine(cfg, params, batch_slots=1, max_len=32, device="cpu")
    eng.submit(Request(rid=0, prompt=prompt, max_new=5, temperature=0.0))
    assert eng.run()[0] == manual_greedy(params, cfg, prompt, 5, 32)


def test_engine_batches_multiple_requests(llama):
    cfg, params = llama
    rng = np.random.default_rng(1)
    eng = Engine(cfg, params, batch_slots=4, max_len=32, device="cpu")
    for i in range(6):  # > slots: two batches
        eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, 4).astype(
            np.int32), max_new=4))
    done = eng.run()
    assert sorted(done) == list(range(6))
    assert all(len(v) == 4 for v in done.values())


def test_engine_same_prompt_same_output_across_batches(llama):
    """Batched decoding must not cross-contaminate slots."""
    cfg, params = llama
    rng = np.random.default_rng(2)
    p = rng.integers(0, cfg.vocab, 5).astype(np.int32)
    other = rng.integers(0, cfg.vocab, 5).astype(np.int32)
    eng = Engine(cfg, params, batch_slots=2, max_len=32, device="cpu")
    eng.submit(Request(rid=0, prompt=p, max_new=6))
    eng.submit(Request(rid=1, prompt=other, max_new=6))
    done_a = eng.run()
    eng.submit(Request(rid=2, prompt=p, max_new=6))
    eng.submit(Request(rid=3, prompt=np.flip(other).copy(), max_new=6))
    done_b = eng.run()
    assert done_a[0] == done_b[2]


def test_engine_samples_with_its_own_generator(llama):
    """Temperature requests draw from the engine's seeded generator: the
    same seed gives the same tokens, in range; greedy slots stay greedy."""
    cfg, params = llama
    prompt = np.random.default_rng(3).integers(0, cfg.vocab, 5).astype(
        np.int32)
    runs = []
    for _ in range(2):
        eng = Engine(cfg, params, batch_slots=2, max_len=32, seed=7,
                     device="cpu")
        eng.submit(Request(rid=0, prompt=prompt, max_new=6))
        eng.submit(Request(rid=1, prompt=prompt, max_new=6, temperature=0.8))
        runs.append(eng.run())
    assert runs[0] == runs[1]
    assert runs[0][0] == manual_greedy(params, cfg, prompt, 6, 32)
    assert all(0 <= t < cfg.vocab for t in runs[0][1])


def test_engine_greedy_tokens_equal_jax_engine():
    """Both engines on JAX's weights (reduced llama3.2-1b in f32; the other
    archs' prefill and decode are held to JAX's in
    `tests/test_torch_lm_archs_*.py`), 5 requests over 2 slots with
    prompts of 3 to 7 tokens (left-padded within a batch) and mixed
    temperatures: every greedy request's tokens are equal."""
    arch = "llama3.2-1b"
    jcfg = dataclasses.replace(JR.reduced_config(arch), dtype="float32")
    tcfg = dataclasses.replace(R.reduced_config(arch), dtype="float32")
    jparams, _ = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, jcfg.vocab, n).astype(np.int32)
               for n in (3, 7, 5, 5, 4)]
    jeng = JaxEngine(jcfg, jparams, batch_slots=2, max_len=24)
    teng = Engine(tcfg, tparams, batch_slots=2, max_len=24, device="cpu")
    for i, p in enumerate(prompts):
        temp = 0.0 if i != 3 else 0.8
        jeng.submit(JaxRequest(rid=i, prompt=p, max_new=6, temperature=temp))
        teng.submit(Request(rid=i, prompt=p, max_new=6, temperature=temp))
    want, got = jeng.run(), teng.run()
    assert sorted(got) == sorted(want)
    for rid in (0, 1, 2, 4):
        assert got[rid] == [int(t) for t in want[rid]], rid


KV_LEAVES = {"k": 3, "v": 3, "k_scale": 2, "v_scale": 2, "pos": 1}


def _leaf_items(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_items(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("arch", sorted(JR.ARCHS))
def test_decode_step_writes_the_caches_in_place(arch):
    """A decode step returns the caches it was given, every leaf the
    tensor passed in, and writes at most one position of each KV-cache
    leaf (the key, value, scale and ring-position tensors; their sequence
    axis counted from the end): no copy of the cache per step. Recurrent
    and SSM states are replaced whole, in their slots."""
    cfg = R.reduced_config(arch, kv_bits=8 if arch == "llama3.2-1b" else 0)
    params = M.init_params(cfg, 0, device="cpu")[0]
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 5)))
    extra, off = {}, 0
    if cfg.family == "vlm":
        extra["embeds"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.frontend_len, cfg.d_model)).astype(np.float32))
        off = cfg.frontend_len
    if cfg.family in ("encdec", "audio"):
        extra["enc_inputs"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.frontend_len, cfg.d_model)).astype(np.float32))
    with torch.inference_mode():
        _, cache = M.prefill(params, cfg, tokens[:, :4], max_len=off + 8,
                             **extra)
        before = {p: (t, t.clone()) for p, t in _leaf_items(cache)}
        _, after = M.decode_step(params, cfg, tokens[:, 4:], cache, off + 4)
    assert after is cache
    written = 0
    for path, t in _leaf_items(after):
        leaf, old = before[path]
        assert t is leaf, path
        if path[-1] in KV_LEAVES:
            axis = t.ndim - KV_LEAVES[path[-1]]
            rows = (t != old).movedim(axis, 0).reshape(t.shape[axis], -1)
            n = int(rows.any(1).sum())
            assert n <= 1, f"{path}: {n} positions written"
            written += n
    assert written > 0 or cfg.family == "ssm"


# ---------------------------------------------------------------------------
# the full-width golden
# ---------------------------------------------------------------------------


def serve_config():
    return dataclasses.replace(llama32_1b.get_config(),
                               n_layers=CASES.SERVE_LAYERS, dtype="float32")


def greedy_run(prefill, decode, argmax, to_np, prompts):
    """Prefill then SERVE_NEW greedy steps, batched: (tokens [B, 1 + NEW],
    logits [1 + NEW, B, V])."""
    logits, cache = prefill(prompts)
    steps, toks = [to_np(logits[:, 0])], [argmax(logits[:, 0])]
    for t in range(CASES.SERVE_NEW):
        logits, cache = decode(toks[-1], cache, CASES.SERVE_PROMPT + t)
        steps.append(to_np(logits[:, 0]))
        toks.append(argmax(logits[:, 0]))
    return np.stack([to_np(t) for t in toks], 1), np.stack(steps)


def golden_of(tokens, logits, ids):
    """What the golden keeps of a run: tokens, the logits at `ids`, and
    the logit at each greedy token."""
    top = np.take_along_axis(logits, tokens.T[:, :, None], axis=2)[..., 0]
    return {"tokens": tokens, "logits_at_ids": logits[:, :, ids],
            "top_logit": top}


@pytest.fixture(scope="module")
def served():
    """The port's run on the CPU and the stored JAX run."""
    cfg = serve_config()
    params = M.tree_map(torch.from_numpy, CASES.serve_params(cfg))
    prompts = CASES.serve_prompts(cfg)
    with torch.inference_mode():
        tokens, logits = greedy_run(
            lambda p: M.prefill(params, cfg, torch.from_numpy(p).long(),
                                max_len=CASES.SERVE_MAX_LEN),
            lambda tok, c, pos: M.decode_step(params, cfg, tok[:, None], c,
                                              pos),
            lambda lg: torch.argmax(lg, -1), to_numpy, prompts)
    ids = CASES.serve_vocab_ids(cfg)
    fix = np.load(GOLDEN)
    return (cfg, params, prompts, golden_of(tokens, logits, ids),
            {k: fix[k] for k in fix.files}, ids)


def test_golden_holds_only_jax_outputs_and_is_small(served):
    *_, want, ids = served
    assert os.path.getsize(GOLDEN) <= 2 * 2**20
    assert set(want) == {"tokens", "logits_at_ids", "top_logit", "ids"}
    np.testing.assert_array_equal(want["ids"], ids)


def test_fullwidth_prefill_and_decode_match_golden(served):
    _, _, _, got, want, _ = served
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["logits_at_ids"], want["logits_at_ids"],
                               **GOLDEN_TOL)
    np.testing.assert_allclose(got["top_logit"], want["top_logit"],
                               **GOLDEN_TOL)


def test_fullwidth_engine_matches_golden(served):
    cfg, params, prompts, _, want, _ = served
    eng = Engine(cfg, params, batch_slots=CASES.SERVE_BATCH,
                 max_len=CASES.SERVE_MAX_LEN, device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=1 + CASES.SERVE_NEW))
    done = eng.run()
    np.testing.assert_array_equal(
        np.array([done[i] for i in range(len(prompts))]), want["tokens"])


def regen() -> None:
    """Write the golden with the JAX package (f32, eager calls)."""
    from repro.configs import llama32_1b as jax_llama

    cfg = dataclasses.replace(jax_llama.get_config(),
                              n_layers=CASES.SERVE_LAYERS, dtype="float32")
    params = jax.tree.map(jnp.asarray, CASES.serve_params(cfg))
    prompts = CASES.serve_prompts(cfg)
    tokens, logits = greedy_run(
        lambda p: JM.prefill(params, cfg, jnp.asarray(p),
                             max_len=CASES.SERVE_MAX_LEN),
        lambda tok, c, pos: JM.decode_step(params, cfg, tok[:, None], c,
                                           jnp.int32(pos)),
        lambda lg: jnp.argmax(lg, -1), lambda a: np.asarray(a), prompts)
    ids = CASES.serve_vocab_ids(cfg)
    out = golden_of(tokens.astype(np.int64), logits.astype(np.float32), ids)
    np.savez_compressed(GOLDEN, ids=ids, **out)
    print(f"[lm_serve] tokens {tokens.tolist()}, "
          f"{os.path.getsize(GOLDEN) / 2**10:.1f} KiB -> {GOLDEN}")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--regen", action="store_true",
                    help="rewrite the golden with the JAX package")
    if ap.parse_args().regen:
        regen()
