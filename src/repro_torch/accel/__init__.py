from repro_torch.accel.sim import AccelConfig, simulate, SimResult
from repro_torch.accel.energy import energy_report

__all__ = ["AccelConfig", "simulate", "SimResult", "energy_report"]
