"""LR schedules: cosine, constant, and WSD (warmup-stable-decay, the
minicpm-2b training feature, arXiv:2404.06395), the JAX package's
``optim/schedules.py``: each takes the step as an int32 tensor and gives
the rate as an f32 tensor on its device."""
from __future__ import annotations

import math

import torch

from repro_torch.config import TrainConfig


def make_schedule(cfg: TrainConfig):
    base = cfg.learning_rate
    warm = max(cfg.warmup_steps, 1)
    total = max(cfg.steps, warm + 1)

    def warmup(step):
        return base * step / warm

    def cosine(step):
        step = torch.as_tensor(step, dtype=torch.int32)
        frac = torch.clamp((step - warm) / max(total - warm, 1), 0, 1)
        cos_lr = base * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warm, warmup(step), cos_lr)

    def constant(step):
        step = torch.as_tensor(step, dtype=torch.int32)
        return torch.where(step < warm, warmup(step),
                           torch.full((), base, dtype=torch.float32,
                                      device=step.device))

    def wsd(step):
        """Warmup -> stable plateau -> sharp decay in the final
        ``wsd_decay_frac`` of training (exponential-style to 10%)."""
        step = torch.as_tensor(step, dtype=torch.int32)
        decay_steps = max(int(total * cfg.wsd_decay_frac), 1)
        decay_start = total - decay_steps
        frac = torch.clamp((step - decay_start) / decay_steps, 0, 1)
        decay_lr = base * torch.pow(
            torch.full((), 0.1, dtype=torch.float32, device=step.device),
            frac)
        return torch.where(step < warm, warmup(step),
                           torch.where(step < decay_start,
                                       torch.full_like(decay_lr, base),
                                       decay_lr))

    return {"cosine": cosine, "constant": constant, "wsd": wsd}[cfg.schedule]
