"""Learning-rate schedules (counterpart of ``uvc_tpu/utils/schedules.py``).

Each builder returns ``fn(step) -> lr`` as a 0-d f32 tensor, computed in
f32 as the JAX package computes it, so that trajectories can be compared.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def warmup_cosine_schedule(base_lr: float, warmup_steps: int, t_total: int,
                           cycles: float = 0.5):
    """Linear warmup to ``base_lr``, then a cosine decay to 0 at
    ``t_total``."""

    def fn(step):
        step = _f32(step)
        warm = step / max(1.0, warmup_steps)
        progress = (step - warmup_steps) / max(1.0, t_total - warmup_steps)
        cos = torch.clamp(
            0.5 * (1.0 + torch.cos(math.pi * cycles * 2.0 * progress)),
            min=0.0)
        return base_lr * torch.where(step < warmup_steps, warm, cos)

    return fn


def warmup_linear_schedule(base_lr: float, warmup_steps: int, t_total: int):
    """Linear warmup to ``base_lr``, then a linear decay to 0 at
    ``t_total``."""

    def fn(step):
        step = _f32(step)
        warm = step / max(1.0, warmup_steps)
        lin = torch.clamp((t_total - step) / max(1.0, t_total - warmup_steps),
                          min=0.0)
        return base_lr * torch.where(step < warmup_steps, warm, lin)

    return fn


def warmup_constant_schedule(base_lr: float, warmup_steps: int):
    """Linear warmup to ``base_lr``, then constant."""

    def fn(step):
        step = _f32(step)
        warm = step / max(1.0, warmup_steps)
        return base_lr * torch.where(step < warmup_steps, warm,
                                     torch.ones_like(warm))

    return fn


def timm_epoch_schedule(sched: str, base_lr: float, *, epochs: int,
                        steps_per_epoch: int, min_lr: float = 1e-5,
                        warmup_lr: float = 1e-6, warmup_epochs: int = 5,
                        decay_epochs: float = 30.0,
                        decay_rate: float = 0.1):
    """timm's per-epoch cosine or step schedule with a linear warmup leg,
    constant within an epoch (``epoch = floor(step / steps_per_epoch)``):

      cosine: t < warmup -> warmup_lr + t * (base - warmup_lr) / warmup
              t < epochs -> min_lr + (base - min_lr) / 2 * (1 + cos(pi t /
                            epochs))
              else       -> min_lr
      step:   t < warmup -> the same warmup leg
              else       -> base * decay_rate ** floor(t / decay_epochs)
    """
    if sched not in ("cosine", "step"):
        raise ValueError(f"unsupported --sched {sched!r} (cosine|step)")

    def fn(step):
        t = torch.floor(_f32(step) / max(1, steps_per_epoch))
        warm = warmup_lr + t * (base_lr - warmup_lr) / max(1, warmup_epochs)
        if sched == "cosine":
            cos = min_lr + 0.5 * (base_lr - min_lr) * (
                1.0 + torch.cos(math.pi * t / max(1, epochs)))
            main = torch.where(t >= epochs, torch.full_like(cos, min_lr), cos)
        else:
            main = base_lr * decay_rate ** torch.floor(t / decay_epochs)
        return torch.where(t < warmup_epochs, warm, main)

    return fn


def get_tau(tau_max: float, tau_min: float, step, total_steps: int
            ) -> float:
    """The token-selection Gumbel temperature ramp
    ``tau_min + (tau_max - tau_min) * clip(step / total_steps, 0, 1)``,
    computed in f32 (the stage-1 driver calls it with (10, 0.1), so tau
    rises from 0.1 to 10 over training); a host float, so the step gets it
    without a copy to the device."""
    frac = np.clip(np.float32(step) / np.float32(max(1, total_steps)),
                   np.float32(0.0), np.float32(1.0))
    return float(np.float32(tau_min)
                 + np.float32(tau_max - tau_min) * frac)
