"""Training loop: checkpoint/resume, preemption handling, straggler
watchdog.

The port of ``src/repro/train/trainer.py``. Deterministic end to end on
one device: the synthetic data is a counter hash, the initial parameters
come from a ``torch.Generator`` seeded with ``tc.seed`` (the reference's
distributions, not its bits), and a run resumed from a checkpoint
reproduces the uninterrupted run bit for bit on the CPU (on a card, with
``torch.use_deterministic_algorithms(True)``).

With ``mesh=`` (a ``DeviceMesh`` of the running job, ``launch/mesh.py``)
and ``shape=``, every rank builds the same initial state from the seed on
``device`` (its own card), keeps its blocks of it as DTensors laid out by
``state_shardings``, restores a checkpoint leaf by leaf onto that layout,
and steps through the sharded ``build_train_step``; checkpoints are
written whole by rank 0.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.data import SyntheticLMData
from repro_torch.launch.steps import build_train_step, lay_out
from repro_torch.models.transformer import init_params
from repro_torch.train import checkpoint as CK
from repro_torch.train.fault import PreemptionGuard, StragglerWatchdog
from repro_torch.train.optimizer import init_opt_state
from repro_torch.utils import get_logger

log = get_logger("repro_torch.trainer")


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        tc: TrainConfig,
        *,
        global_batch: int = 8,
        seq_len: int = 128,
        mesh=None,
        shape: Optional[ShapeConfig] = None,
        device="cuda",
    ):
        self.cfg, self.tc = cfg, tc
        self.device = torch.device(device)
        self.data = SyntheticLMData(cfg, global_batch, seq_len, seed=tc.seed)
        self.mesh = mesh
        self.step_fn, in_sh, _, _ = build_train_step(cfg, tc, mesh, shape)
        self.state_sh = in_sh[0] if in_sh is not None else None
        self.ckpt = CK.AsyncCheckpointer(tc.checkpoint_dir)
        self.watchdog = StragglerWatchdog()
        self.state = None
        self.step = 0

    def init_or_resume(self, resume: bool = True):
        latest = CK.latest_step(self.tc.checkpoint_dir) if resume else None
        if latest is not None:
            self.step, self.state = CK.restore(
                self.tc.checkpoint_dir, latest, shardings=self.state_sh,
                device=self.device)
            log.info("resumed from step %d", self.step)
        else:
            gen = torch.Generator(self.device).manual_seed(self.tc.seed)
            params = init_params(self.cfg, gen)
            if self.mesh is not None:  # each rank keeps its blocks
                params = lay_out(params, self.state_sh["params"], self.mesh)
            self.state = {
                "params": params,
                "opt": init_opt_state(params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=self.device),
            }
            if self.mesh is not None:
                self.state = lay_out(self.state, self.state_sh, self.mesh)
        return self.step

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """The global batch of ``step`` on the trainer's device."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in self.data.batch_at(step).items()}

    def run(self, num_steps: int, *, with_guard: bool = True) -> Dict:
        guard = PreemptionGuard() if with_guard else None
        metrics_hist = []
        end = self.step + num_steps
        try:
            while self.step < end:
                batch = self.batch_at(self.step)
                t0 = time.time()
                self.state, metrics = self.step_fn(self.state, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t0
                self.watchdog.observe(self.step, dt)
                metrics_hist.append(metrics)
                self.step += 1
                if self.step % max(self.tc.checkpoint_every, 1) == 0:
                    self.ckpt.save(self.step, self.state,
                                   meta={"cfg": self.cfg.name})
                if guard is not None and guard.requested:
                    log.warning("preempted: checkpointing at step %d",
                                self.step)
                    self.ckpt.save(self.step, self.state)
                    break
            self.ckpt.wait()
        finally:
            if guard is not None:
                guard.restore()
        return {
            "final_step": self.step,
            "losses": [m["loss"] for m in metrics_hist],
            "metrics": metrics_hist,
        }
