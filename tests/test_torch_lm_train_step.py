"""The port's LM training (`train/{train_loop,grad_compress,straggler,
checkpoint}.py`, `data/pipeline.py`'s LM stream, `launch/train.py`)
against the JAX package's, on Llama-3.2-1B's reduced config in f32 with
JAX's weights carried across:

  * one `make_train_step` step (grad_accum 1 and 2, 8-bit state, and a W8
    config whose int8 codes stay frozen) under `train/parity.py`'s `LM_*`
    bounds, grad_accum 2 also against the port's grad_accum 1;
  * `compress_tree` / `init_error` bit for bit over three steps of error
    feedback, and compressed training that still lowers the loss;
  * `StepWatchdog`, `lm_batch` and `lm_stream` equal;
  * a restart from a checkpoint bitwise equal to the straight run, through
    the API and through the CLI (stopped by a SIGTERM, then `--resume`).

Tolerances and the JAX compilation: `tests/torch_lm_train_cases.py`.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.data import pipeline as RD
from repro.models.lm import model as JM
from repro.train import grad_compress as RGC
from repro.train import optimizer as RO
from repro.train import straggler as RS
from repro.train import train_loop as RTL
from repro_torch.configs import reduced_config
from repro_torch.convert import opt_state_from_reference, params_from_reference
from repro_torch.data import pipeline as PD
from repro_torch.launch import train as CLI
from repro_torch.models.lm import model as TM
from repro_torch.train import checkpoint as PCK
from repro_torch.train import grad_compress as PGC
from repro_torch.train import optimizer as PO
from repro_torch.train import parity as PP
from repro_torch.train import straggler as PS
from repro_torch.train import train_loop as PTL
from repro_torch.train import tree as PT
from tests.torch_lm_parity import jax_compiled, one_torch_thread  # noqa: F401
from tests.torch_lm_train_cases import (
    TRAIN_OPTIONS,
    batch_np,
    jax_batch,
    jax_params,
    to_numpy_tree,
    torch_batch,
)

ARCH = "llama3.2-1b"
OCFG = dict(lr=1e-3, warmup_steps=0, total_steps=10)
Q8_MOMENT_L2 = 0.1  # measured 0.041 (v of layers/ffn/wi/w)
Q8_CODE_SHARE = 1e-4  # measured: 8 codes apart, all in layers/mix/wk/w


def _cfgs(**over):
    return (dataclasses.replace(jax_reduced_config(ARCH), dtype="float32",
                                **over),
            dataclasses.replace(reduced_config(ARCH), dtype="float32",
                                **over))


def _dq_state(params, state, quant: bool):
    """m and v as float trees (8-bit leaves dequantized)."""
    if not quant:
        return state.m, state.v
    return (PT.tree_map(lambda p, m: PO._dq8(m), params, state.m),
            PT.tree_map(lambda p, v: PO._dq8_v(v), params, state.v))


def _jax_grads(jcfg, params, batch, accum: int):
    """The gradients the JAX step takes: the mean over its microbatches,
    in its scan's order (zeros + g1 + g2, times 1/n)."""
    def g(p, b):
        return jax.grad(lambda q: JM.loss_fn(q, jcfg, b))(p)
    if accum == 1:
        return g(params, batch)
    micro = RTL._split_microbatches(batch, accum)
    acc = jax.tree.map(jnp.zeros_like, params)
    for i in range(accum):
        gi = g(params, jax.tree.map(lambda m: m[i], micro))
        acc = jax.tree.map(lambda a, x: a + x, acc, gi)
    return jax.tree.map(lambda a: a * (1.0 / accum), acc)


def _port_grads(tcfg, params, batch, accum: int):
    def loss(p, b):
        return TM.loss_fn(p, tcfg, b)
    if accum == 1:
        return PTL.value_and_grad(loss, params, batch)[2]
    acc = PT.tree_map(torch.zeros_like, params)
    for mb in PTL._split_microbatches(batch, accum):
        acc = PT.tree_map(lambda a, x: a + x, acc,
                          PTL.value_and_grad(loss, params, mb)[2])
    return PT.tree_map(lambda a: a * (1.0 / accum), acc)


def _side(params, grads, out, quant: bool):
    new_p, state, metrics = out
    m, v = _dq_state(params, state, quant)
    return dict(loss=metrics["loss"], grad_norm=metrics["grad_norm"],
                lr=metrics["lr"], grads=grads, params=new_p, m=m, v=v)


@functools.lru_cache(maxsize=None)
def _jax_steps(accum: int):
    """The JAX side: its gradients and `make_train_step`'s step, from fresh
    AdamW state, in one program; with accum 1 also the 8-bit state's step
    (sharing the program's forward and backward)."""
    jcfg, _ = _cfgs()
    params = jax_params(jcfg)
    b = batch_np(jcfg)
    states = [RO.init_state(params)]
    steps = [RTL.make_train_step(jcfg, RO.AdamWConfig(**OCFG),
                                 grad_accum=accum)]
    if accum == 1:
        states.append(RO.init_state(params, state_bits=8))
        steps.append(RTL.make_train_step(
            jcfg, RO.AdamWConfig(**OCFG, state_bits=8)))
    _, (grads, outs) = jax_compiled(
        lambda p, os, bb: (_jax_grads(jcfg, p, bb, accum),
                           [f(p, o, bb) for f, o in zip(steps, os)]),
        params, states, jax_batch(b), options=TRAIN_OPTIONS)
    return params, b, states, grads, outs


@pytest.mark.parametrize("case", ["accum1", "accum2", "state8"])
def test_train_step_matches_jax(case):
    accum = 2 if case == "accum2" else 1
    bits = 8 if case == "state8" else None
    _, tcfg = _cfgs()
    ocfg_t = PO.AdamWConfig(**OCFG, state_bits=bits)
    params, b, states, grads, outs = _jax_steps(accum)
    state, out = (states[1], outs[1]) if bits else (states[0], outs[0])
    want = _side(params, grads, (to_numpy_tree(out[0]),
                                 opt_state_from_reference(
                                     to_numpy_tree(out[1]), device="cpu"),
                                 out[2]), bits == 8)

    tparams = params_from_reference(to_numpy_tree(params), device="cpu")
    tstate = opt_state_from_reference(to_numpy_tree(state), device="cpu")
    tb = torch_batch(b)
    step_t = PTL.make_train_step(tcfg, ocfg_t, grad_accum=accum)
    out_t = step_t(tparams, tstate, tb)
    got = _side(tparams, _port_grads(tcfg, tparams, tb, accum), out_t,
                bits == 8)
    err = PP.lm_step_errors(tparams, want, got, ocfg_t)
    # 8-bit state: v is stored in log space per row, from the row's
    # smallest entry; where that entry is a gradient of 1e-9 or so, its
    # last bits move the row's offset and every code of the row with it
    # (measured: up to 5 codes in one row of layers/ffn/wi/w). So the
    # dequantized moments are held to Q8_MOMENT_L2, and m's codes (linear,
    # symmetric) to at most one apart on at most Q8_CODE_SHARE of them
    assert not PP.lm_step_failures(
        err, moment_l2=Q8_MOMENT_L2 if bits else PP.LM_MOMENT_L2), err
    assert err["sure_share"] > 0.5, err
    # the padded vocab rows (gradient exactly 0) turn NaN on both sides
    # under 8-bit state, as they do in the JAX package alone (ROADMAP F9)
    assert (err["nan"] > 0) == (bits == 8), err
    if bits == 8:
        treedef = PT.flatten(tparams)[1]
        apart = total = 0
        for a, c in zip(PT.flatten_up_to(treedef, to_numpy_tree(out[1].m)),
                        PT.flatten_up_to(treedef, out_t[1].m)):
            d = np.abs(a["q"].astype(np.int64)
                       - c["q"].numpy().astype(np.int64))
            assert d.max() <= 1
            apart += int((d > 0).sum())
            total += d.size
        assert apart <= Q8_CODE_SHARE * total, (apart, total)
    if accum == 2:  # the port's accumulation against its own single batch
        one = PTL.make_train_step(tcfg, ocfg_t)
        single = _side(tparams, _port_grads(tcfg, tparams, tb, 1),
                       one(tparams, tstate, tb), False)
        err1 = PP.lm_step_errors(tparams, single, got, ocfg_t)
        assert not PP.lm_step_failures(err1), err1


def test_quantized_config_trains_its_float_leaves_only():
    """W8: the int8 codes get zero gradients and stay as they are; the
    scales and every other float leaf train as JAX's optimizer trains
    them on the float leaves' gradients (JAX's own `make_train_step`
    refuses the tree: `jax.grad` takes no int8 input)."""
    jcfg, tcfg = _cfgs(quant_bits=8)
    ocfg_j, ocfg_t = RO.AdamWConfig(**OCFG), PO.AdamWConfig(**OCFG)
    params = jax_params(jcfg)
    b = batch_np(jcfg)

    def ref(p, o, bb):
        def loss(fp):
            merged = jax.tree.map(lambda f, x: x if f is None else f, fp, p,
                                  is_leaf=lambda x: x is None)
            return JM.loss_fn(merged, jcfg, bb)
        loss_v, fg = jax.value_and_grad(loss)(
            jax.tree.map(lambda x: x if jnp.issubdtype(
                x.dtype, jnp.floating) else None, p))
        g = jax.tree.map(lambda f, x: jnp.zeros_like(x) if f is None else f,
                         fg, p, is_leaf=lambda x: x is None)
        new_p, new_o, m = RO.apply_updates(p, g, o, ocfg_j)
        return g, (new_p, new_o, dict(m, loss=loss_v))

    _, (grads, out) = jax_compiled(ref, params, RO.init_state(params),
                                   jax_batch(b), options=TRAIN_OPTIONS)
    want = _side(params, grads, (to_numpy_tree(out[0]),
                                 opt_state_from_reference(
                                     to_numpy_tree(out[1]), device="cpu"),
                                 out[2]), False)
    tparams = params_from_reference(to_numpy_tree(params), device="cpu")
    tb = torch_batch(b)
    got = _side(tparams, _port_grads(tcfg, tparams, tb, 1),
                PTL.make_train_step(tcfg, ocfg_t)(
                    tparams, PO.init_state(tparams), tb), False)
    err = PP.lm_step_errors(tparams, want, got, ocfg_t)
    assert not PP.lm_step_failures(err), err
    assert any(x.dtype == torch.int8 for x in PT.leaves(got["params"]))
    assert err["frozen_equal"]


def _grad_tree(rng, zero: bool):
    tree = {"a": rng.standard_normal((4, 8)).astype(np.float32),
            "b": {"c": (1e-3 * rng.standard_normal(17)).astype(np.float32),
                  "d": (50 * rng.standard_normal((3, 5))).astype(np.float32)},
            "z": np.zeros(6, np.float32)}
    if not zero:
        tree["z"] = rng.standard_normal(6).astype(np.float32)
    return tree


def test_compress_tree_bitwise_with_error_feedback():
    """Three steps of error feedback from `init_error`, bit for bit with
    the reference's own (eager) semantics, a zero tensor included (amax 0:
    scale 1) and values on rounding ties (k + 0.5 codes). XLA's compiled
    `compress_tree` takes the residual `corrected - q * scale` as one
    fused multiply-add, 1 ulp of `corrected` away on most elements."""
    rng = np.random.default_rng(5)
    steps = [_grad_tree(rng, zero=i < 2) for i in range(3)]
    steps[1]["a"][0, :4] = np.float32(np.abs(steps[1]["a"]).max()) \
        * np.array([0.5, 1.5, -2.5, 126.5], np.float32) / 127
    err_j = RGC.init_error(steps[0])
    err_t = PGC.init_error(params_from_reference(steps[0], device="cpu"))
    for e in PT.leaves(err_t):
        assert e.dtype == torch.float32 and not e.any()
    for g in steps:
        deq_j, err_j = RGC.compress_tree(jax.tree.map(jnp.asarray, g), err_j)
        deq_t, err_t = PGC.compress_tree(
            params_from_reference(g, device="cpu"), err_t)
        for want, got in zip(jax.tree.leaves((deq_j, err_j)),
                             PT.leaves((deq_t, err_t))):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_compressed_step_is_compress_tree_between_grads_and_adamw():
    _, tcfg = _cfgs()
    ocfg = PO.AdamWConfig(**OCFG)
    params, _ = TM.init_params(tcfg, 0, device="cpu")
    b = torch_batch(batch_np(tcfg))
    err = PGC.init_error(params)
    step = PTL.make_train_step(tcfg, ocfg, compress=True)
    new_p, new_s, new_e, metrics = step(params, PO.init_state(params), b,
                                        err)
    loss, _, grads = PTL.value_and_grad(
        lambda p, bb: TM.loss_fn(p, tcfg, bb), params, b)
    deq, want_e = PGC.compress_tree(grads, err)
    want_p, want_s, _ = PO.apply_updates(params, deq, PO.init_state(params),
                                         ocfg)
    assert torch.equal(metrics["loss"], loss)
    for a, c in zip(PT.leaves((want_p, want_s, want_e)),
                    PT.leaves((new_p, new_s, new_e))):
        assert torch.equal(a, c)
    ev = PTL.make_eval_step(tcfg)(params, b)
    assert torch.equal(ev, loss)


def test_compressed_training_still_converges():
    """`tests/test_train_runtime.py`'s convergence check, on the port."""
    cfg = reduced_config(ARCH)
    data = PD.DataConfig(seed=7, vocab=cfg.vocab, seq_len=32, global_batch=8)
    params, _ = TM.init_params(cfg, 0, device="cpu")
    ocfg = PO.AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=60)
    step = PTL.make_train_step(cfg, ocfg, compress=True)
    opt, err = PO.init_state(params), PGC.init_error(params)
    losses = []
    for s, batch in zip(range(60), PD.lm_stream(data)):
        params, opt, err, m = step(params, opt, torch_batch(batch), err)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.7, losses[::10]


WATCHDOG_SEQS = [
    [1.0] * 12,
    [1.0] * 6 + [5.0] * 3 + [1.0] * 3,  # a persistent straggler
    [1.0] * 6 + [5.0, 1.0, 5.0, 5.0, 5.0, 5.0, 5.0, 5.0, 1.0],
    [0.5, 3.0, 0.2, 0.4, 0.3, 9.0, 0.3, 2.0, 2.0, 0.9, 8.0, 8.0, 8.0],
]


@pytest.mark.parametrize("seq", WATCHDOG_SEQS)
@pytest.mark.parametrize("kw", [{}, dict(threshold=1.5, patience=2,
                                         warmup=2, ema_beta=0.5)])
def test_step_watchdog_equal(seq, kw):
    calls = {"j": [], "t": []}
    wj = RS.StepWatchdog(**kw, on_straggler=lambda *a: calls["j"].append(a))
    wt = PS.StepWatchdog(**kw, on_straggler=lambda *a: calls["t"].append(a))
    fired = [(wj.observe(dt), wt.observe(dt)) for dt in seq]
    assert all(a == b for a, b in fired)
    assert wt.flagged == wj.flagged and wt.ema == wj.ema
    assert calls["t"] == calls["j"]


@pytest.mark.parametrize("seed,step,n_hosts,host_id",
                         [(0, 0, 1, 0), (3, 5, 2, 1), (1234, 17, 4, 3),
                          (11, 2, 4, 0)])
def test_lm_batch_and_stream_equal(seed, step, n_hosts, host_id):
    kw = dict(seed=seed, vocab=300, seq_len=24, global_batch=8,
              n_hosts=n_hosts, host_id=host_id)
    rc, pc = RD.DataConfig(**kw), PD.DataConfig(**kw)
    want, got = RD.lm_batch(rc, step), PD.lm_batch(pc, step)
    assert got["tokens"].dtype == want["tokens"].dtype == np.int32
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    for w, g, _ in zip(RD.lm_stream(rc, step), PD.lm_stream(pc, step),
                       range(3)):
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
    with pytest.raises(ValueError):
        PD.lm_batch(dataclasses.replace(pc, global_batch=7, n_hosts=2), 0)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same dtype and the same bits (NaN payloads included)."""
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    if a.dtype != b.dtype:
        return False
    if a.dtype in view:
        a, b = a.view(view[a.dtype]), b.view(view[b.dtype])
    return torch.equal(a, b)


def _run(cfg, ocfg, data, params, opt, s0, s1):
    step = PTL.make_train_step(cfg, ocfg)
    for s in range(s0, s1):
        params, opt, _ = step(params, opt,
                              torch_batch(PD.lm_batch(data, s)))
    return params, opt


@pytest.mark.parametrize("bits", [None, 8])
def test_bitwise_restart_continuation(tmp_path, bits):
    """`tests/test_fault_tolerance.py`'s restart check on the port (bf16
    leaves; with 8-bit AdamW state too): 6 steps straight against 3 +
    checkpoint + restore + 3, params and state bitwise equal. With 8-bit
    state the padded vocab rows, whose gradient is exactly 0, turn NaN at
    the first step, as in the JAX package (ROADMAP F9): bit for bit all
    the same."""
    cfg = reduced_config(ARCH)
    data = PD.DataConfig(seed=11, vocab=cfg.vocab, seq_len=16, global_batch=4)
    ocfg = PO.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=6)
    p0, _ = TM.init_params(cfg, 0, device="cpu")
    o0 = PO.init_state(p0, state_bits=bits)
    p_a, o_a = _run(cfg, ocfg, data, p0, o0, 0, 6)
    p_b, o_b = _run(cfg, ocfg, data, p0, o0, 0, 3)
    PCK.save(str(tmp_path), 3, (p_b, o_b))
    (p_c, o_c), start = PCK.restore(str(tmp_path), (p_b, o_b))
    assert start == 3
    for a, c in zip(PT.leaves((p_b, o_b)), PT.leaves((p_c, o_c))):
        assert _bits_equal(a, c)
    assert any(x.dtype == torch.bfloat16 for x in PT.leaves(p_c))
    p_d, o_d = _run(cfg, ocfg, data, p_c, o_c, start, 6)
    for a, d in zip(PT.leaves((p_a, o_a)), PT.leaves((p_d, o_d))):
        assert _bits_equal(a, d)
    assert torch.isnan(p_a["embed"]).any() == (bits == 8)


def _final_state(ckpt_dir):
    """The leaves of the newest checkpoint in `ckpt_dir`, as written."""
    step = PCK.latest_step(ckpt_dir)
    with np.load(os.path.join(ckpt_dir, f"step_{step:08d}",
                              "arrays.npz")) as z:
        return step, [z[f"a{i}"] for i in range(len(z.files))]


def _sigterm_at(monkeypatch, step_no: int):
    """Make the CLI's data stream send the process a SIGTERM as it hands
    out batch `step_no` (counting from 0): the drain then checkpoints
    after that step and stops, as on a preemption."""
    real = CLI.lm_stream

    def stream(cfg, start_step=0):
        for i, b in enumerate(real(cfg, start_step), start_step):
            if i == step_no:
                os.kill(os.getpid(), signal.SIGTERM)
            yield b

    monkeypatch.setattr(CLI, "lm_stream", stream)


@pytest.mark.parametrize("extra", [[], ["--grad-compress"]],
                         ids=["plain", "grad-compress"])
def test_cli_runs_resumes_bitwise_and_drains_on_sigterm(tmp_path,
                                                        monkeypatch, capsys,
                                                        extra):
    """With `--grad-compress` the checkpoint holds the error-feedback
    residual, so the resumed run compresses the straight run's gradients."""
    common = ["--device", "cpu", "--reduced", "--steps", "6", "--batch", "4",
              "--seq", "32", "--log-every", "2"] + extra
    handler = signal.getsignal(signal.SIGTERM)
    straight = CLI.main(common + ["--ckpt-dir", str(tmp_path / "a")])
    assert len(straight) == 6 and all(np.isfinite(straight))
    with monkeypatch.context() as m:
        _sigterm_at(m, 2)
        first = CLI.main(common + ["--ckpt-dir", str(tmp_path / "b")])
    assert signal.getsignal(signal.SIGTERM) is handler  # restored
    assert first == straight[:3]
    assert PCK.latest_step(str(tmp_path / "b")) == 3
    rest = CLI.main(common + ["--ckpt-dir", str(tmp_path / "b"), "--resume"])
    assert rest == straight[3:]
    (sa, a), (sb, b) = (_final_state(str(tmp_path / d)) for d in "ab")
    assert sa == sb == 6 and len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    out = capsys.readouterr().out
    assert "SIGTERM: checkpoint + exit" in out
    assert "resumed from step 3" in out


def test_cli_loss_falls_and_options_run():
    base = ["--device", "cpu", "--reduced", "--batch", "8", "--seq", "64",
            "--log-every", "100"]
    losses = CLI.main(base + ["--steps", "30", "--lr", "1e-2"])
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses[::5]
    for extra in (["--grad-compress"], ["--grad-accum", "2"]):
        got = CLI.main(base + ["--steps", "3"] + extra)
        assert len(got) == 3 and all(np.isfinite(got))


def test_remat_checkpoints_activations():
    """`_remat` keeps fewer activations for the backward pass and
    recomputes the rest there: "full" its whole body (more matmuls in the
    backward pass), "dots" all but the matmuls (no more matmuls than
    without remat). The numbers stay bitwise the same
    (`tests/torch_lm_train_cases.py`)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.mm += func in (torch.ops.aten.mm.default,
                                torch.ops.aten.addmm.default)
            return func(*args, **(kwargs or {}))

    _, tcfg = _cfgs()
    params, _ = TM.init_params(tcfg, 0, device="cpu")
    b = torch_batch(batch_np(tcfg))
    saved, mms = {}, {}
    for mode in ("none", "dots", "full"):
        cfg = dataclasses.replace(tcfg, remat=mode)
        n = [0]

        def pack(t, n=n):
            n[0] += t.numel()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            PTL.value_and_grad(lambda p, bb: TM.loss_fn(p, cfg, bb),
                               params, b)
        saved[mode] = n[0]
        with CountMM() as count:
            PTL.value_and_grad(lambda p, bb: TM.loss_fn(p, cfg, bb),
                               params, b)
        mms[mode] = count.mm
    assert saved["full"] < saved["none"] and saved["dots"] < saved["none"]
    assert mms["dots"] == mms["none"] < mms["full"], mms
