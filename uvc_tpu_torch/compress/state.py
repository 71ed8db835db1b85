"""Compression (minimax) hyperparameters and state (counterpart of
``uvc_tpu/compress/state.py``).

``MinimaxHParams`` has every field of the JAX package's, with its
defaults.  ``CompressionState`` holds the dynamic minimax variables (the
primal s / r, the duals y / p / z, the gating-window accumulator and the
tiny optimizers' state) as a dataclass of tensors, replaced wholesale by
each architecture update (``dataclasses.replace``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MinimaxHParams:
    """Static hyperparameters of the minimax engine."""

    budget: float = 0.5
    slr: float = 0.02
    rlr: float = 0.02
    glr: float = 1e-3
    ylr: float = 1e-4
    plr: float = 1e-4
    zlr_schedule: tuple = (10, 20, 30, 40, 50)
    sl2wd: float = 0.0
    z_grad_clip: float = 0.5
    gating_weight: float = 5.0
    gating_interval: int = 100
    soptim: str = "sgd"      # sgd | adam | rmsprop
    roptim: str = "sgd"
    # True: the MACs-table cost (calc_flops); False: the W1/W3 linear-layer
    # cost (flops2)
    flops_with_mhsa: bool = True
    use_gumbel: bool = True
    eps: float = 0.1
    eps_decay: float = 0.92
    enable_block_gating: bool = True
    enable_part_gating: bool = False
    enable_patch_gating: int = 2   # 0=off, 1=sigmoid gate, 2=token top-k
    enable_jumping: bool = False
    enable_pruning: bool = True
    patch_ratio: float = 0.9
    z_init: float = 1e-3
    y_init: float = 1e-3
    p_init: float = 1e-3

    def zlr_for_epoch(self, epoch: int, num_epochs: int) -> float:
        """Staircase dual-z step size: the largest schedule entry whose
        start epoch ``i * (num_epochs // len(schedule))`` is <= epoch."""
        sched = self.zlr_schedule
        gap = max(1, num_epochs // max(1, len(sched)))
        zlr = float(sched[0])
        for i, v in enumerate(sched):
            if epoch >= i * gap:
                zlr = float(v)
        return zlr


@dataclasses.dataclass
class OptState:
    """State of one tiny torch-semantics optimizer (compress/optim.py)."""

    m: Optional[torch.Tensor] = None      # momentum / first moment
    v: Optional[torch.Tensor] = None      # second moment (adam / rmsprop)
    count: int = 0


@dataclasses.dataclass
class CompressionState:
    """All dynamic minimax variables."""

    s: torch.Tensor           # [L, 2]  heads removed, MLP units removed
    r: torch.Tensor           # [L, H]  per-head dims removed
    y: torch.Tensor           # [L, 2]  dual for s
    p: torch.Tensor           # [L, H]  dual for r
    z: torch.Tensor           # []      dual for the FLOPs budget
    eps: torch.Tensor         # []      softl0 epsilon (decayed per epoch)
    zlr: torch.Tensor         # []      current staircase z step size
    gating_accum: torch.Tensor  # [L, 2] accumulated gating grads
    s_opt: OptState
    r_opt: OptState
    gating_opt: OptState      # SGD-momentum trace of the interval update

    def replace(self, **changes) -> "CompressionState":
        return dataclasses.replace(self, **changes)
