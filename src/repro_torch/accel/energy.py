"""Energy model (Fig. 11 analog): on-chip vs external-memory-access energy.

Constants follow the paper's sources: HBM2 ≈ 3.9 pJ/bit [22]; 28nm SRAM
read/write ≈ 0.08 pJ/bit (TSMC N28 compiler class); Half-Gate unit energy
derived from 4 cipher evaluations ≈ 60 pJ; FreeXOR ≈ 1 pJ.

A copy of the JAX package's ``accel/energy.py`` (numpy only) with
its imports rewritten: orders, programs and reports of a netlist are
the reference's.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.accel.sim import SimResult

HBM_PJ_PER_BIT = 3.9
SRAM_PJ_PER_BIT = 0.08
HALFGATE_PJ = 60.0
FREEXOR_PJ = 1.0
LABEL_BITS = 128


def energy_report(res: SimResult, and_gates: int, other_gates: int) -> Dict:
    ema_pj = res.dram_bytes * 8 * HBM_PJ_PER_BIT
    sram_pj = res.compute_cycles * 3 * LABEL_BITS * SRAM_PJ_PER_BIT
    core_pj = and_gates * HALFGATE_PJ + other_gates * FREEXOR_PJ
    total = ema_pj + sram_pj + core_pj
    return {
        "ema_uj": ema_pj / 1e6,
        "onchip_uj": (sram_pj + core_pj) / 1e6,
        "total_uj": total / 1e6,
        "ema_fraction": ema_pj / total if total else 0.0,
    }
