"""The training loop: checkpoint and resume, preemption, straggler
watch, the JAX package's ``train/trainer.py`` on one card.

Each step feeds ``SyntheticTokens``' batch for that step (a function of
the seed and the step, so a resumed run sees the stream an unbroken one
sees) through the train step, saves every ``ckpt_every`` steps, and
saves and stops when the preemption handler asks.  Params are drawn on
the device from a generator seeded with ``tcfg.seed``.
"""
from __future__ import annotations

import time
from typing import Any

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.config import ModelConfig, ShardingConfig, TrainConfig
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.ft import PreemptionHandler, StragglerDetector
from repro_torch.models import lm
from repro_torch.train import step as step_mod


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 scfg: ShardingConfig = ShardingConfig(),
                 batch: int = 8, seq: int = 64,
                 preemption: PreemptionHandler | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tcfg = tcfg
        self.scfg = scfg
        self.batch = batch
        self.seq = seq
        self.data = SyntheticTokens(cfg, batch, seq, seed=tcfg.seed)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.ckpt_keep)
        self.preemption = preemption or PreemptionHandler(install=False)
        self.straggler = StragglerDetector(n_hosts=1)
        self.train_step = step_mod.make_train_step(cfg, tcfg, scfg)
        self.history: list = []

    def init_or_restore(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = lm.init_params(self.cfg, gen, self.device)
        opt_state = step_mod.init_opt_state(params, self.tcfg, self.scfg)
        start = 0
        restored = self.ckpt.restore({"params": params,
                                      "opt_state": opt_state},
                                     device=self.device)
        if restored is not None:
            tree, start = restored
            params, opt_state = tree["params"], tree["opt_state"]
        return params, opt_state, start

    def run(self, steps: int | None = None) -> dict[str, Any]:
        params, opt_state, start = self.init_or_restore()
        steps = steps if steps is not None else self.tcfg.steps
        step = start
        stopped_early = False
        for step in range(start, steps):
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.data.batch(step).items()}
            params, opt_state, metrics = self.train_step(params, opt_state,
                                                         batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            self.straggler.report(0, dt)
            metrics["step_time_s"] = dt
            metrics["step"] = step
            self.history.append(metrics)
            if (step + 1) % self.tcfg.ckpt_every == 0:
                self.ckpt.save(step + 1, {"params": params,
                                          "opt_state": opt_state})
            if self.preemption.should_stop:
                self.ckpt.save(step + 1, {"params": params,
                                          "opt_state": opt_state})
                stopped_early = True
                break
        return {"params": params, "opt_state": opt_state,
                "last_step": step + 1, "history": self.history,
                "stopped_early": stopped_early,
                "stragglers": self.straggler.stragglers()}
