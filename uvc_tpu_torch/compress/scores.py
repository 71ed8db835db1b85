"""Structured-group importance scores (counterpart of
``uvc_tpu/compress/scores.py``): squared l2 norms of the attention
projection's input columns (per head dim and per head) and of MLP fc2's
input columns (per hidden unit), from detached weights."""

from __future__ import annotations

from typing import Tuple

import torch


def group_scores(blocks: dict, num_heads: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(scores1 ``[L, H, head_size]``, scores2 ``[L, H]``, scores3
    ``[L, d_ff]``) from ``proj.kernel [L, D, D]`` and ``fc2.kernel
    [L, d_ff, D]`` stored (in, out)."""
    pk = blocks["proj"]["kernel"].detach().float()
    l, d, _ = pk.shape
    col_sq = (pk * pk).sum(dim=-1)                  # [L, D]
    scores1 = col_sq.reshape(l, num_heads, d // num_heads)
    scores2 = scores1.sum(dim=-1)
    f2 = blocks["fc2"]["kernel"].detach().float()
    scores3 = (f2 * f2).sum(dim=-1)                 # [L, d_ff]
    return scores1, scores2, scores3
