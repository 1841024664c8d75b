"""The port's serving CLI (`python -m repro_torch.launch.serve`) on the
CPU. Vision (`--vision`): every request served, its logits equal to the
port's `cu.run_qnet` for the same nets (the CLI's nets come from the
port's own `make_calibrated_qnet` draws, so they are not the JAX CLI's),
a tuned cache written by `--tune` and served by a second run, the trace
and metrics files. LM (the default): every request served, the greedy
requests' tokens equal to the JAX CLI's on JAX's weights, `--quant-bits`
serving integer weights. And the refusals of `--replicas` > 1: by the LM
path, which serves on one device, and by the vision mesh on one visible
device (served over two in `tests/test_torch_replicas.py`)."""
from __future__ import annotations

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.launch import serve as JAX_CLI
from repro.models.lm import model as JM
from repro_torch import configs as port_configs
from repro_torch.convert import params_from_reference
from repro_torch.core import cu
from repro_torch.launch import serve as CLI
from repro_torch.models.lm import model as M
from repro_torch.obs import validate_chrome_trace
from repro_torch.tune import load_tuned

BASE = ["--vision", "--models", "mobilenet_v2,efficientnet_compact", "--hw",
        "32", "--batch", "4", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side on one intra-op thread, as the other port test files
    under several workers: the default (every core, in each worker)
    oversubscribes the machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _check_served(out, n):
    results = out["results"]
    assert len(results) == n and len(out["requests"]) == n
    assert all(r.status == "ok" for r in results.values())
    for handle, img in out["requests"]:
        want = cu.run_qnet(out["qnets"][handle[0]], img[None],
                           device="cpu").numpy()[0]
        np.testing.assert_array_equal(results[handle].logits, want)


def test_serves_every_request_bit_exact(capsys):
    out = CLI.main(BASE + ["--requests", "6"])
    _check_served(out, 6)
    assert out["coverage"] == {}
    assert {m: st.n_ok for m, st in out["stats"].items()} == {
        "mobilenet_v2": 3, "efficientnet_compact": 3}
    text = capsys.readouterr().out
    assert "[serve-vision] 6/6 ok over 2 model(s) on cpu" in text


def test_tune_writes_a_cache_a_second_run_serves(tmp_path, capsys):
    cache = str(tmp_path / "serve_cpu.json")
    trace, metrics = str(tmp_path / "t.json"), str(tmp_path / "m.prom")
    out = CLI.main(BASE + ["--requests", "4", "--tune", "--tuned-cache",
                           cache, "--trace-out", trace, "--metrics-out",
                           metrics])
    _check_served(out, 4)
    assert out["coverage"] == {"mobilenet_v2": 1.0,
                               "efficientnet_compact": 1.0}
    plan = load_tuned(cache)
    assert plan.backend == "cpu" and set(plan.nets) == {
        out["qnets"][m].spec.name for m in out["qnets"]}
    with open(trace) as f:
        doc = json.load(f)
    assert validate_chrome_trace(doc) == []
    assert sum(e.get("name") == "request" and e["ph"] == "e"
               for e in doc["traceEvents"]) == 4
    prom = open(metrics).read()
    assert 'serve_requests_completed_total{model="mobilenet_v2"} 2' in prom
    text = capsys.readouterr().out
    assert "tuned route coverage 100% (cpu)" in text
    again = CLI.main(BASE + ["--requests", "4", "--tuned-cache", cache])
    _check_served(again, 4)
    assert again["coverage"] == out["coverage"]
    assert "loaded tuning cache" in capsys.readouterr().out
    for st in again["stats"].values():
        assert st.energy_tuned_fraction > 0.5  # the cache priced its ops


def test_metrics_json_snapshot(tmp_path):
    path = str(tmp_path / "m.json")
    CLI.main(BASE + ["--models", "mobilenet_v2", "--requests", "2",
                     "--metrics-out", path])
    snap = json.load(open(path))
    assert snap["counters"][
        'serve_requests_completed_total{model="mobilenet_v2"}'] == 2.0


@pytest.mark.parametrize("argv,item", [
    (["--requests", "2", "--replicas", "2", "--device", "cpu"],
     "serves on one device"),
    (BASE + ["--replicas", "2"], "replicas=2 with 1 visible devices"),
])
def test_refuses_what_is_not_ported(argv, item):
    """The LM engine serves on one device, so its path refuses replicas;
    the vision path builds a mesh, which the CPU's one visible device
    cannot hold two replicas of (the JAX CLI's `data_mesh` error)."""
    if "--vision" in argv:
        with pytest.raises(ValueError, match=item):
            CLI.main(argv)
        return
    with pytest.raises(SystemExit, match=item) as e:
        CLI.main(argv)
    assert e.value.code not in (0, None)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLI.main(["--vision", "--hw", "32", "--requests", "1"])


LM = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu"]


def test_lm_serves_every_request(capsys):
    out = CLI.main(LM)
    done, cfg = out["done"], out["cfg"]
    assert sorted(done) == list(range(8))
    assert all(len(t) == 16 and all(0 <= x < cfg.vocab for x in t)
               for t in done.values())
    assert cfg == port_configs.reduced_config("llama3.2-1b")
    assert out["tok_per_s"] > 0
    text = capsys.readouterr().out
    assert "[serve] 8 requests, 128 tokens in" in text and "on cpu" in text


def test_lm_greedy_requests_equal_jax_cli(monkeypatch):
    """Both CLIs at their defaults on the reduced llama3.2-1b in f32 (in
    bf16 two logits within an ulp may order either way), the port serving
    JAX's weights: the same prompts (numpy, seeded alike), and every greedy
    (even) request's tokens equal."""
    def f32(module):
        reduced = module.reduced_config
        return lambda arch: dataclasses.replace(reduced(arch),
                                                dtype="float32")

    monkeypatch.setattr(JAX_CLI, "reduced_config", f32(jax_configs))
    monkeypatch.setattr(port_configs, "reduced_config", f32(port_configs))
    argv = ["--arch", "llama3.2-1b", "--reduced"]
    want = JAX_CLI.main(argv)
    jparams, _ = JM.init_params(JAX_CLI.reduced_config("llama3.2-1b"),
                                jax.random.PRNGKey(0))
    monkeypatch.setattr(M, "init_params", lambda cfg, seed, device: (
        params_from_reference(jax.tree.map(np.asarray, jparams), device),
        None))
    got = CLI.main(argv + ["--device", "cpu"])["done"]
    assert sorted(got) == sorted(want)
    for rid in range(0, 8, 2):
        assert got[rid] == [int(t) for t in want[rid]], rid


@pytest.mark.parametrize("bits,dtype", [(8, torch.int8), (4, torch.uint8)])
def test_lm_quant_bits_serves_integer_weights(bits, dtype):
    out = CLI.main(LM + ["--quant-bits", str(bits), "--requests", "2",
                         "--max-new", "4"])
    assert out["cfg"].quant_bits == bits
    leaves = []
    M.tree_map(leaves.append, out["params"])
    quantized = [t for t in leaves if t.dtype == dtype]
    # q, k, v, o, gate, up, down, each stacked over the layers
    assert [tuple(t.shape[:1]) for t in quantized] == [(2,)] * 7
    assert all(len(t) == 4 for t in out["done"].values())


def test_lm_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLI.main(["--arch", "llama3.2-1b", "--reduced", "--requests", "1"])
