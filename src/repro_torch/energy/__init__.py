"""Energy modeling: power curves, per-op energy, power-capped dispatch.

Counterpart of `repro/energy/`. The package behind the paper's FPS/Watt
headline (Sec. 6, Table 6):

  * `power`    — `PowerModel` device curves; RAPL-calibrated on Linux
                 CPUs where `/sys/class/powercap` is readable, per-
                 backend constants otherwise (`"cuda"`: the H100's,
                 measured with `nvidia-smi`).
  * `model`    — `estimate_energy`: autotuner route timings × analytic
                 bytes-moved × the power curve → modeled J/image, plus
                 `edp_score`.
  * `governor` — `PowerGovernor`: the deterministic rolling-window watt
                 estimate behind `VisionEngine(power_budget_w=...)`.
"""
from repro_torch.energy.governor import PowerGovernor
from repro_torch.energy.model import (
    PJ_PER_BYTE,
    PJ_PER_MAC,
    PJ_PER_MAC_DEFAULT,
    EnergyReport,
    OpEnergy,
    analytic_energy_j,
    edp_score,
    estimate_energy,
    op_bytes_moved,
    op_macs,
    op_pj_per_mac,
)
from repro_torch.energy.power import (
    BACKEND_WATTS,
    DEFAULT_RAPL_ROOT,
    PowerModel,
    RaplEnergyReader,
    RaplUnavailable,
    calibrate_power,
    default_backend,
    default_power_model,
    measure_power,
    reset_default_power_model,
)

__all__ = [
    "BACKEND_WATTS",
    "DEFAULT_RAPL_ROOT",
    "PJ_PER_BYTE",
    "PJ_PER_MAC",
    "PJ_PER_MAC_DEFAULT",
    "EnergyReport",
    "OpEnergy",
    "PowerGovernor",
    "PowerModel",
    "RaplEnergyReader",
    "RaplUnavailable",
    "analytic_energy_j",
    "calibrate_power",
    "default_backend",
    "default_power_model",
    "edp_score",
    "estimate_energy",
    "measure_power",
    "op_bytes_moved",
    "op_macs",
    "op_pj_per_mac",
    "reset_default_power_model",
]
