"""Device power curves: RAPL-measured on Linux CPUs, constants elsewhere.

Counterpart of `repro/energy/power.py`. The energy model
(`repro_torch.energy.model`) converts per-op route *times* into
joules through a `PowerModel` — two numbers and a provenance string:

  * `busy_w`  — average package power while the integer datapath is
    executing (compute + cache dynamic power; DRAM traffic is priced
    separately, per byte, by the model),
  * `idle_w`  — static draw the device pays whether or not it is serving
    (what makes FPS/Watt rate-dependent, exactly as on real silicon).

On Linux CPUs the kernel exposes RAPL package energy counters under
`/sys/class/powercap/intel-rapl:<pkg>/energy_uj` — microjoule counters
that wrap at `max_energy_range_uj`. `RaplEnergyReader` turns them into a
monotone cumulative joule count (wraparound handled per domain), and
`calibrate_power` derives a measured `PowerModel` from two sampling
windows (idle, then under a busy spin). Everywhere RAPL is absent,
unreadable (non-root), or not a CPU, `default_power_model` falls back to
per-backend constants — the H100's, measured on the card, and the
paper's ZCU102 board power, the basis of its 47.4 / 233.3 FPS/Watt
headline. The backend is the caller's device type (`"cuda"`, `"cpu"`);
with none given it is CUDA, and without a card that raises.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

DEFAULT_RAPL_ROOT = "/sys/class/powercap"

# Per-backend (busy_w, idle_w) constant fallbacks: a ballpark laptop or
# desktop CPU package under vectorized integer load; the H100 as
# `nvidia-smi --query-gpu=power.draw` reads it (the median of 100 ms samples
# over 6 s: busy under a dense int8 matmul loop, idle at rest with a CUDA
# context open; NVIDIA H100 80GB HBM3 at a 700 W power limit, measured by
# `chip_smoke.power_constants`, which the [fleet] phase reruns); and the
# paper's ZCU102 (Table 6 reports ~7.2 W board power for the MobileNetV2
# design point, the FPS/Watt denominator).
BACKEND_WATTS: Dict[str, Tuple[float, float]] = {
    "cpu": (18.0, 4.0),
    "cuda": (398.35, 119.86),
    "zcu102": (7.2, 0.7),
}
_FALLBACK_WATTS = (18.0, 4.0)


class RaplUnavailable(RuntimeError):
    """No readable RAPL domain (missing tree, no permission, non-Linux)."""


@dataclasses.dataclass(frozen=True)
class PowerModel:
    """Device power curve: busy/idle watts plus where they came from."""

    busy_w: float
    idle_w: float = 0.0
    source: str = "constant"

    def __post_init__(self):
        if self.busy_w <= 0:
            raise ValueError(f"busy_w must be positive, got {self.busy_w}")
        if self.idle_w < 0 or self.idle_w > self.busy_w:
            raise ValueError(
                f"idle_w {self.idle_w} outside [0, busy_w={self.busy_w}]")

    def as_dict(self) -> Dict[str, object]:
        return {"busy_w": self.busy_w, "idle_w": self.idle_w,
                "source": self.source}


def _read_uj(path: str) -> int:
    """One sysfs microjoule counter read (split out so tests can fault it
    with PermissionError/OSError without touching real sysfs)."""
    with open(path) as f:
        return int(f.read().strip())


@dataclasses.dataclass
class _RaplDomain:
    path: str  # .../energy_uj
    range_uj: int
    last_uj: int
    acc_uj: int = 0


class RaplEnergyReader:
    """Cumulative joules since construction from a RAPL powercap tree.

    Scans `root` for package-level domains (directories holding an
    `energy_uj` counter whose name is not a `:N:M` subdomain — core/dram
    subdomains are *included* in the package counter and would double
    count). Each `read_j()` advances a per-domain accumulator; a raw
    counter that moved backwards is a wraparound and contributes
    `range - last + raw` (the `max_energy_range_uj` the kernel
    advertises, defaulting to the 32-bit microjoule range when the file
    is absent). Raises `RaplUnavailable` when no domain is readable —
    the signal `default_power_model` uses to fall back to constants."""

    def __init__(self, root: str = DEFAULT_RAPL_ROOT):
        self.root = root
        self._domains: List[_RaplDomain] = []
        if not os.path.isdir(root):
            raise RaplUnavailable(f"no powercap tree at {root}")
        for entry in sorted(os.listdir(root)):
            if entry.count(":") >= 2:
                continue  # :N:M subdomain — already inside the package
            energy = os.path.join(root, entry, "energy_uj")
            if not os.path.isfile(energy):
                continue
            try:
                last = _read_uj(energy)
                rng_path = os.path.join(root, entry, "max_energy_range_uj")
                rng = (_read_uj(rng_path) if os.path.isfile(rng_path)
                       else 2 ** 32 - 1)
            except OSError:
                continue  # unreadable domain (permissions): skip it
            self._domains.append(_RaplDomain(energy, rng, last))
        if not self._domains:
            raise RaplUnavailable(
                f"no readable RAPL energy_uj counters under {root}")

    @property
    def n_domains(self) -> int:
        return len(self._domains)

    def read_j(self) -> float:
        """Total joules consumed across all domains since construction."""
        for d in self._domains:
            try:
                raw = _read_uj(d.path)
            except OSError as e:
                raise RaplUnavailable(f"RAPL counter vanished: {e}") from e
            if raw >= d.last_uj:
                d.acc_uj += raw - d.last_uj
            else:  # counter wrapped at max_energy_range_uj
                d.acc_uj += d.range_uj - d.last_uj + raw
            d.last_uj = raw
        return sum(d.acc_uj for d in self._domains) * 1e-6


def measure_power(fn: Callable[[], None], reader: RaplEnergyReader,
                  clock: Callable[[], float] = time.perf_counter) -> float:
    """Average package watts while `fn` runs: RAPL energy delta / wall."""
    e0 = reader.read_j()
    t0 = clock()
    fn()
    dt = clock() - t0
    de = reader.read_j() - e0
    if dt <= 0:
        raise ValueError("zero-duration measurement window")
    return de / dt


def _busy_spin(duration_s: float, clock: Callable[[], float]) -> None:
    """Compute-bound calibration load (integer matmul spin)."""
    import numpy as np

    a = np.random.default_rng(0).integers(
        0, 127, (256, 256), dtype=np.int32)
    t_end = clock() + duration_s
    while clock() < t_end:
        a = (a @ a) & 0x7F


def calibrate_power(
    *,
    reader: Optional[RaplEnergyReader] = None,
    root: str = DEFAULT_RAPL_ROOT,
    clock: Callable[[], float] = time.perf_counter,
    duration_s: float = 0.2,
    idle_fn: Optional[Callable[[], None]] = None,
    busy_fn: Optional[Callable[[], None]] = None,
) -> PowerModel:
    """Measure a `PowerModel` off the live RAPL counters.

    Two sampling windows: `idle_fn` (default: sleep `duration_s`) pins the
    static package floor, `busy_fn` (default: an integer matmul spin for
    `duration_s`) the loaded draw. Both are injectable so tests drive the
    whole path against a fixture tree and a fake clock. Raises
    `RaplUnavailable` when no counters are readable."""
    reader = reader if reader is not None else RaplEnergyReader(root)
    idle_fn = idle_fn or (lambda: time.sleep(duration_s))
    busy_fn = busy_fn or (lambda: _busy_spin(duration_s, clock))
    idle_w = measure_power(idle_fn, reader, clock)
    busy_w = measure_power(busy_fn, reader, clock)
    # a busy window slower than idle is measurement noise on a loaded box;
    # clamp so the model stays valid (busy >= idle > 0)
    idle_w = max(idle_w, 0.0)
    busy_w = max(busy_w, idle_w, 1e-3)
    return PowerModel(busy_w=busy_w, idle_w=idle_w,
                      source=f"rapl:{reader.root}")


_DEFAULT_MEMO: Dict[Tuple[str, str], PowerModel] = {}


def default_backend() -> str:
    """The backend of an entry point called without one: CUDA, which must be
    there (no silent fall back to the CPU's power curve)."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass backend='cpu' to price the "
            "CPU")
    return "cuda"


def default_power_model(backend: Optional[str] = None,
                        root: str = DEFAULT_RAPL_ROOT,
                        calibrate_s: float = 0.04) -> PowerModel:
    """The power curve the engines use when none is injected.

    `backend` is the serving device's type; None means CUDA. CPU backend
    with a readable RAPL tree: a short (`2 * calibrate_s`) live
    calibration, memoized per (backend, root) so a process pays it once.
    Everything else — RAPL absent/unreadable, accelerator backends — falls
    back to the `BACKEND_WATTS` constants. Deterministic tests inject an
    explicit `PowerModel` instead and never touch this path."""
    if backend is None:
        backend = default_backend()
    key = (backend, root)
    memo = _DEFAULT_MEMO.get(key)
    if memo is not None:
        return memo
    model: Optional[PowerModel] = None
    if backend == "cpu" and calibrate_s > 0:
        try:
            model = calibrate_power(root=root, duration_s=calibrate_s)
        except (RaplUnavailable, ValueError):
            model = None
    if model is None:
        busy, idle = BACKEND_WATTS.get(backend, _FALLBACK_WATTS)
        model = PowerModel(busy_w=busy, idle_w=idle,
                           source=f"constant:{backend}")
    _DEFAULT_MEMO[key] = model
    return model


def reset_default_power_model() -> None:
    """Drop the process memo (tests that re-point `root` call this)."""
    _DEFAULT_MEMO.clear()


__all__ = [
    "BACKEND_WATTS",
    "DEFAULT_RAPL_ROOT",
    "PowerModel",
    "RaplEnergyReader",
    "RaplUnavailable",
    "calibrate_power",
    "default_backend",
    "default_power_model",
    "measure_power",
    "reset_default_power_model",
]
