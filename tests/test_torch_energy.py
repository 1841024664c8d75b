"""The port's energy model (`repro_torch.energy`) and tuning-cache format
(`repro_torch.tune.cache`) against the JAX package's, on the same inputs.

  * RAPL: both packages' readers, over the same fixture powercap trees
    under `tmp_path` (the real `/sys/class/powercap` is never touched),
    read equal joules, wrap equally, calibrate equal `PowerModel`s and
    refuse the same trees;
  * `estimate_energy` with an explicit `PowerModel` and backend: equal op
    for op (name, CU, kind, key, µs, source, MACs, bytes, both joule
    terms) and in every report property, on every `tests/golden` net and
    both full-size fixtures, and with the committed tuning cache
    `experiments/tuned/mobilenet_v2_act8_cpu.json` (pure Python: the
    tolerance is 0);
  * `PowerGovernor`: equal decisions on seeded random record /
    `would_exceed` sequences;
  * the cache keys and the `TunedPlan` JSON form;
  * `BACKEND_WATTS`: the port keeps the CPU and ZCU102 rows and carries
    the H100's measured row in place of the reference's TPU and GPU
    ballparks.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest

import repro.energy as R
from repro.core import compiler as R_CC, qnet as R_Q
from repro.tune import cache as R_TC
import repro_torch.energy as P
from repro_torch.core import compiler as P_CC, qnet as P_Q
from repro_torch.tune import cache as P_TC
from tests.regen_golden import CASES, fixture_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL = {name: os.path.join(ROOT, "tests", "golden_torch", name + ".qnet")
        for name in ("mobilenet_v2_alpha1_224_act8",
                     "efficientnet_compact_h128_act8")}
NETS = {f"{m}_act{b}": fixture_paths(m, b)[0] for m, b in CASES}
NETS.update(FULL)
TUNED = os.path.join(ROOT, "experiments", "tuned", "mobilenet_v2_act8_cpu.json")


class Ticker:
    def __init__(self, step: float = 1.0):
        self.t = 0.0
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


@pytest.fixture(autouse=True)
def _fresh_memo():
    R.reset_default_power_model()
    P.reset_default_power_model()
    yield
    R.reset_default_power_model()
    P.reset_default_power_model()


def _write_domain(root, name, uj, range_uj=2 ** 32 - 1):
    d = root / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "energy_uj").write_text(f"{uj}\n")
    if range_uj is not None:
        (d / "max_energy_range_uj").write_text(f"{range_uj}\n")
    return d


# ---------------------------------------------------------------------------
# RAPL
# ---------------------------------------------------------------------------


def _tree(tmp_path, case):
    root = tmp_path / case
    root.mkdir(parents=True)
    if case == "packages":
        _write_domain(root, "intel-rapl:0", 1_000_000)
        _write_domain(root, "intel-rapl:1", 2_000_000, range_uj=None)
        _write_domain(root, "intel-rapl:0:0", 5)  # core: inside the package
    elif case == "wrap":
        _write_domain(root, "intel-rapl:0", 990, range_uj=1000)
    elif case == "no_counters":
        (root / "intel-rapl:0").mkdir()
    return root


def _rapl(pkg, root, bumps):
    """Readings after each bump of every package counter, or the refusal."""
    mod = {"jax": R, "torch": P}[pkg]
    try:
        reader = mod.RaplEnergyReader(str(root))
    except mod.RaplUnavailable as e:
        return ("unavailable", str(e).replace(str(root), "<root>"))
    out = [reader.n_domains]
    for bump in bumps:
        for d in sorted(root.iterdir()):
            f = d / "energy_uj"
            if d.name.count(":") < 2 and f.exists():
                rng_f = d / "max_energy_range_uj"
                rng = int(rng_f.read_text()) if rng_f.exists() else 2 ** 32 - 1
                f.write_text(f"{(int(f.read_text()) + bump) % (rng + 1)}\n")
        out.append(reader.read_j())
    return out


@pytest.mark.parametrize("case", ["packages", "wrap", "no_counters",
                                  "missing"])
def test_rapl_readers_read_equal_values(tmp_path, case):
    bumps = [0, 250, 40, 1_000, 7]
    got = {}
    for pkg in ("jax", "torch"):
        root = (_tree(tmp_path / pkg, case) if case != "missing"
                else tmp_path / pkg / "absent")
        got[pkg] = _rapl(pkg, root, bumps)
    assert got["torch"] == got["jax"]


def _calibrate(pkg, root, idle_uj, busy_uj):
    mod = {"jax": R, "torch": P}[pkg]
    energy = root / "intel-rapl:0" / "energy_uj"

    def spend(uj):
        def fn():
            energy.write_text(f"{int(energy.read_text()) + uj}\n")
        return fn

    m = mod.calibrate_power(root=str(root), clock=Ticker(0.5),
                            idle_fn=spend(idle_uj), busy_fn=spend(busy_uj))
    return (m.busy_w, m.idle_w, m.source.replace(str(root), "<root>"))


@pytest.mark.parametrize("idle_uj,busy_uj", [(2_000_000, 9_000_000),
                                             (5_000_000, 1_000_000)])
def test_calibrate_power_equal_reference(tmp_path, idle_uj, busy_uj):
    got = {}
    for pkg in ("jax", "torch"):
        root = tmp_path / pkg
        _write_domain(root, "intel-rapl:0", 0)
        got[pkg] = _calibrate(pkg, root, idle_uj, busy_uj)
    assert got["torch"] == got["jax"]


def test_default_power_model_equal_reference(tmp_path):
    absent = str(tmp_path / "absent")
    for backend in ("cpu", "zcu102", "unknown"):
        p = P.default_power_model(backend, root=absent)
        r = R.default_power_model(backend, root=absent)
        assert p == P.PowerModel(busy_w=r.busy_w, idle_w=r.idle_w,
                                 source=r.source)
    assert P.BACKEND_WATTS["cpu"] == R.BACKEND_WATTS["cpu"]
    assert P.BACKEND_WATTS["zcu102"] == R.BACKEND_WATTS["zcu102"]
    # the H100's row is measured on the card; the reference's TPU and GPU
    # ballparks are no number of it
    assert set(P.BACKEND_WATTS) == {"cpu", "cuda", "zcu102"}
    busy, idle = P.BACKEND_WATTS["cuda"]
    assert busy > idle > 0
    m = P.default_power_model("cuda")
    assert (m.busy_w, m.idle_w, m.source) == (busy, idle, "constant:cuda")


def test_default_power_model_needs_cuda_without_a_backend(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.default_power_model()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.estimate_energy(P_Q.load_qnet(NETS["mobilenet_v2_act8"]))


def test_power_model_refusals_equal_reference():
    for kw in (dict(busy_w=0.0), dict(busy_w=5.0, idle_w=-1.0),
               dict(busy_w=5.0, idle_w=6.0)):
        msgs = []
        for mod in (R, P):
            with pytest.raises(ValueError) as e:
                mod.PowerModel(**kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# estimate_energy, op for op
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def specs():
    """Each net's spec from both packages (read from the same artifact)."""
    return {name: (R_Q.load_qnet(path).spec, P_Q.load_qnet(path).spec)
            for name, path in NETS.items()}


def _report(rep):
    return {"ops": [dataclasses.asdict(o) for o in rep.ops],
            "j": [o.j for o in rep.ops],
            "as_dict": rep.as_dict(), "net": rep.net,
            "backend": rep.backend,
            "j_per_image": rep.j_per_image,
            "us_per_image": rep.us_per_image,
            "tuned_fraction": rep.tuned_fraction,
            "watts": [rep.watts(f) for f in (0.0, 1.0, 47.4, 2500.0)],
            "fps_per_watt": [rep.fps_per_watt(f) for f in (1.0, 2500.0)]}


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
@pytest.mark.parametrize("net", sorted(NETS))
def test_estimate_energy_equal_reference_op_for_op(specs, net, backend):
    r_spec, p_spec = specs[net]
    r = R.estimate_energy(r_spec, R_CC.compile_net(r_spec),
                          power=R.PowerModel(250.0, 60.0, "test"),
                          backend=backend)
    p = P.estimate_energy(p_spec, P_CC.compile_net(p_spec),
                          power=P.PowerModel(250.0, 60.0, "test"),
                          backend=backend)
    got, want = _report(p), _report(r)
    assert got == want
    assert len(got["ops"]) >= len(p_spec.blocks)
    assert all(o["source"] == "analytic" for o in got["ops"])


@pytest.mark.parametrize("net", ["mobilenet_v2_act8",
                                 "mobilenet_v2_alpha1_224_act8"])
def test_estimate_energy_with_tuned_cache_equal_reference(specs, net):
    r_spec, p_spec = specs[net]
    r = R.estimate_energy(r_spec, tuned=R_TC.load_tuned(TUNED),
                          power=R.PowerModel(18.0, 4.0, "test"))
    p = P.estimate_energy(p_spec, tuned=P_TC.load_tuned(TUNED),
                          power=P.PowerModel(18.0, 4.0, "test"))
    assert _report(p) == _report(r)
    if net == "mobilenet_v2_act8":  # the cache was measured on this net
        assert p.tuned_fraction > 0.5


@pytest.mark.parametrize("net", sorted(NETS))
def test_analytic_terms_equal_reference(specs, net):
    r_spec, p_spec = specs[net]
    assert P.analytic_energy_j(p_spec) == R.analytic_energy_j(r_spec)
    rank = p_spec.spatial_rank
    r_desc = R_CC.compile_net(r_spec).op_descriptors()
    p_desc = P_CC.compile_net(p_spec).op_descriptors()
    for (_, rb, rop, hw), (_, pb, pop, hw2) in zip(r_desc, p_desc):
        assert hw == hw2 and rop.name == pop.name
        assert P.op_macs(pop, hw, rank) == R.op_macs(rop, hw, rank)
        for bits in (None, 4, 8):
            assert (P.op_bytes_moved(pop, hw, rank, in_bits=bits)
                    == R.op_bytes_moved(rop, hw, rank, in_bits=bits))
        assert P.op_pj_per_mac(pop) == R.op_pj_per_mac(rop)
        assert (P_TC.op_key(pop, hw, "cuda", rank)
                == R_TC.op_key(rop, hw, "cuda", rank))
        if len(pb.ops) == 3:
            assert P_TC.irb_key(pb, hw, "cpu") == R_TC.irb_key(rb, hw, "cpu")


def test_edp_score_equal_reference():
    rng = np.random.default_rng(0)
    for _ in range(50):
        t = float(rng.choice([0.0, -1.0, float("inf"),
                              float(rng.lognormal(-8, 2))]))
        b = int(rng.integers(0, 10 ** 7))
        assert P.edp_score(t, b, P.PowerModel(20.0, 2.0)) == R.edp_score(
            t, b, R.PowerModel(20.0, 2.0))


def test_tuned_plan_json_round_trip_equal_reference(tmp_path):
    p, r = P_TC.load_tuned(TUNED), R_TC.load_tuned(TUNED)
    assert p.to_json() == r.to_json()
    P_TC.save_tuned(p, str(tmp_path / "p.json"))
    R_TC.save_tuned(r, str(tmp_path / "r.json"))
    assert (tmp_path / "p.json").read_text() == (
        tmp_path / "r.json").read_text()
    for name in os.listdir(os.path.dirname(TUNED)):
        path = os.path.join(os.path.dirname(TUNED), name)
        assert P_TC.load_tuned(path).to_json() == \
            R_TC.load_tuned(path).to_json(), name
    bad = dict(p.to_json(), version=1)
    msgs = []
    for mod in (P_TC, R_TC):
        with pytest.raises(ValueError) as e:
            mod.TunedPlan.from_json(bad)
        msgs.append(str(e.value).split(" — ")[0])
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# PowerGovernor
# ---------------------------------------------------------------------------


def _governor_run(mod, seed):
    rng = np.random.default_rng(seed)
    gov = mod.PowerGovernor(float(rng.uniform(5, 50)),
                            window_s=float(rng.uniform(0.1, 2.0)),
                            idle_w=float(rng.uniform(0, 4)))
    now, out = 0.0, []
    for _ in range(300):
        now += float(rng.exponential(0.05))
        j = float(rng.exponential(1.0))
        if gov.would_exceed(j, now):
            out.append(("defer", now, gov.headroom_j(now)))
        else:
            gov.record(j, now)
            out.append(("go", now, gov.watts(now)))
            assert gov.watts(now) <= gov.budget_w * (1 + 1e-9)
    return out, gov.total_j, gov.window_j(now)


@pytest.mark.parametrize("seed", range(6))
def test_governor_decisions_equal_reference(seed):
    assert _governor_run(P, seed) == _governor_run(R, seed)


def test_governor_refusals_equal_reference():
    for args, kw in (((4.0,), dict(idle_w=5.0)), ((4.0,), dict(window_s=0)),
                     ((10.0,), {})):
        msgs = []
        for mod in (R, P):
            try:
                g = mod.PowerGovernor(*args, **kw)
                g.record(-1.0, 0.0)
            except ValueError as e:
                msgs.append(str(e))
        assert len(msgs) == 2 and msgs[0] == msgs[1]
