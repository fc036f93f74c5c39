"""Fault tolerance for long-running jobs.

The port of ``src/repro/train/fault.py``:

  * PreemptionGuard — SIGTERM/SIGINT set a flag; the train loop checkpoints
    and exits cleanly at the next step boundary.
  * StragglerWatchdog — per-step wall-time EWMA + k·sigma flagging; on a
    real fleet the hook triggers backup-worker re-dispatch; here it logs
    and counts.
  * elastic_info — the mesh a restarted job can support from the visible
    device count (checkpoints are restored onto whatever it is).
"""

from __future__ import annotations

import math
import signal
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch

from repro_torch.utils import get_logger

log = get_logger("repro_torch.fault")


class PreemptionGuard:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:  # not the main thread
                pass

    def _handler(self, signum, frame):
        log.warning("preemption signal %s received; will checkpoint and exit",
                    signum)
        self.requested = True

    def restore(self):
        for s, h in self._prev.items():
            signal.signal(s, h)


@dataclass
class StragglerWatchdog:
    """Flags steps slower than mean + k·sigma (EWMA estimates)."""

    k: float = 4.0
    alpha: float = 0.05
    warmup: int = 5
    on_straggler: Optional[Callable[[int, float, float], None]] = None
    _mean: float = 0.0
    _var: float = 0.0
    _n: int = 0
    flagged: List[int] = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self._n += 1
        if self._n <= self.warmup:
            # prime estimates
            self._mean = (self._mean * (self._n - 1) + dt) / self._n
            self._var = max(self._var, (dt - self._mean) ** 2)
            return False
        sigma = math.sqrt(max(self._var, 1e-12))
        is_straggler = dt > self._mean + self.k * sigma + 1e-9
        if is_straggler:
            self.flagged.append(step)
            log.warning(
                "straggler: step %d took %.4fs (mean %.4fs, sigma %.4fs)",
                step, dt, self._mean, sigma,
            )
            if self.on_straggler:
                self.on_straggler(step, dt, self._mean)
        else:  # don't pollute stats with straggler samples
            d = dt - self._mean
            self._mean += self.alpha * d
            self._var = (1 - self.alpha) * (self._var + self.alpha * d * d)
        return is_straggler


def elastic_info(device="cuda") -> dict:
    """Devices visible to this process (the CUDA cards, or 1 for the CPU)
    and the (data, model) mesh they support."""
    n = torch.cuda.device_count() if torch.device(device).type == "cuda" \
        else 1
    model = 16 if n % 16 == 0 and n >= 16 else 1
    return {
        "devices": n,
        "mesh": (n // model, model),
        "axes": ("data", "model"),
    }
