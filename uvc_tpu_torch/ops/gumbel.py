"""Deterministic token selection for serving and eval (counterpart of
``uvc_tpu/ops/gumbel.py``).

The noise-free top-k mask, the token scorer, and the physical top-k
gather.  The Gumbel samplers belong to training and come with it.
"""

from __future__ import annotations

import torch


def topk_token_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep exactly the ``k`` highest-scoring tokens, token 0 force-included
    by boosting its score to +inf (inside the k budget)."""
    boosted = logits.clone()
    boosted[..., 0] = float("inf")
    kth = torch.topk(boosted, k, dim=-1).values[..., -1:]
    return (boosted >= kth).to(logits.dtype)


def token_scores(t: torch.Tensor, scorer: dict) -> torch.Tensor:
    """``[B, N]`` f32 selection scores from the linear token scorer."""
    return (t.float() @ scorer["kernel"].float()
            + scorer["bias"].float()).squeeze(-1)


def physical_topk_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """``[B, k]`` kept-token indices: the decision rule of
    ``topk_token_mask``, sorted ascending so kept tokens keep their order."""
    boosted = scores.clone()
    boosted[..., 0] = float("inf")
    idx = torch.topk(boosted, k, dim=-1).indices
    return torch.sort(idx, dim=-1).values


def gather_tokens_with_pos(t: torch.Tensor, idx: torch.Tensor, tokens,
                           pos: torch.Tensor, dtype) -> torch.Tensor:
    """Gather the kept patch tokens and their positional rows, then prepend
    the prefix tokens (cls / dist) with theirs.

    t: ``[B, N, D]`` patch tokens before the position add; idx ``[B, k]``;
    tokens: list of ``[B, 1, D]`` prefix tokens (already ``dtype``); pos
    ``[1, prefix + N, D]``.  Returns ``[B, prefix + k, D]``."""
    b, n, d = t.shape
    prefix = len(tokens)
    pos = pos.to(dtype)
    gidx = idx[..., None].expand(b, idx.shape[1], d)
    kept = torch.gather(t, 1, gidx)
    pos_patch = torch.gather(pos[:, prefix:].expand(b, n, d), 1, gidx)
    return torch.cat([torch.cat(tokens, dim=1) + pos[:, :prefix],
                      kept + pos_patch], dim=1)
