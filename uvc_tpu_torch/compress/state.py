"""Compression hyperparameters (counterpart of
``uvc_tpu/compress/state.py``): the fields of ``MinimaxHParams`` that the
eval forward reads, with the JAX package's defaults.  The minimax state
itself belongs to training and comes with it."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MinimaxHParams:
    enable_block_gating: bool = True
    enable_patch_gating: int = 2   # 0=off, 1=sigmoid gate, 2=token top-k
    patch_ratio: float = 0.9
