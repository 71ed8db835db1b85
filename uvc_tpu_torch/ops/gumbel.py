"""Gumbel samplers, the soft-L0 gate and token selection (counterpart of
``uvc_tpu/ops/gumbel.py``).

The training samplers (``gumbel_softmax``, ``gumbel_topk_mask``,
``block_gating_distrib``) take their Gumbel noise as a tensor instead of a
PRNG key, so that a caller draws every random number of a step up front
(``train/step.py::draw_stage1_noise``) and a test can feed in
``jax.random.gumbel``'s draws.  Serving and eval use the noise-free top-k
mask, the token scorer and the physical top-k gather.
"""

from __future__ import annotations

from typing import Optional

import torch


def gumbel_noise(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel draws ``-log(-log(u))`` of ``shape`` (f32, on the
    generator's device), ``u`` uniform in the open interval (0, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator,
                   device=generator.device).clamp(tiny, 1.0)
    return -torch.log(-torch.log(u))


def gumbel_softmax(noise: torch.Tensor, logits: torch.Tensor,
                   tau: float = 1.0, hard: bool = False,
                   dim: int = -1) -> torch.Tensor:
    """``softmax((logits + noise) / tau)``; with ``hard`` the one-hot argmax
    with the soft sample's straight-through gradient (the semantics of
    ``torch.nn.functional.gumbel_softmax``, with the noise given)."""
    y_soft = torch.softmax((logits + noise) / tau, dim=dim)
    if not hard:
        return y_soft
    index = y_soft.argmax(dim=dim, keepdim=True)
    y_hard = torch.zeros_like(y_soft).scatter_(dim, index, 1.0)
    return y_hard + y_soft - y_soft.detach()


def gumbel_topk_mask(noise: torch.Tensor, logits: torch.Tensor, k: int,
                     tau) -> torch.Tensor:
    """Hard straight-through top-k token mask: ``log_softmax(logits)``
    perturbed by the ``[B, N]`` Gumbel ``noise``, the top-k of the
    tempered softmax kept as 0/1 with the soft distribution's gradient,
    then token 0 forced on."""
    log_probs = torch.log_softmax(logits, dim=-1)
    y_soft = torch.softmax((log_probs + noise) / tau, dim=-1)
    kth = torch.topk(y_soft, k, dim=-1).values[..., -1:]
    y_hard = (y_soft >= kth).to(y_soft.dtype)
    mask = y_hard + y_soft - y_soft.detach()
    first = torch.zeros_like(mask)
    first[..., 0] = 1.0
    return torch.where(first.bool(), torch.ones_like(mask), mask)


def softl0(g: torch.Tensor, eps) -> torch.Tensor:
    """Soft-L0 gate ``g^2 / (g^2 + eps)``."""
    g2 = g * g
    return g2 / (g2 + eps)


def block_gating_distrib(noise: Optional[torch.Tensor],
                         gating: torch.Tensor, *, use_gumbel: bool,
                         gumbel_hard: bool, eps, warmup: bool
                         ) -> torch.Tensor:
    """``[L, 2]`` per-layer (skip, keep) distribution from the ``[L, 2]``
    gating logits: (0.5, 0.5) in warmup; a tau=0.5 Gumbel-softmax of the
    ``[L, 2]`` ``noise`` with ``use_gumbel``; else the soft-L0 relaxation
    of the keep logit."""
    if warmup:
        return torch.full_like(gating, 0.5)
    if use_gumbel:
        return gumbel_softmax(noise, gating, tau=0.5, hard=gumbel_hard)
    keep = softl0(gating[:, 1], eps)
    return torch.stack([1.0 - keep, keep], dim=-1)


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
