"""Straight-through estimators and the bottom-k group-norm reduction
(counterpart of ``uvc_tpu/ops/stes.py``).

* ``ste_ceil`` / ``ste_floor``: rounding with the identity gradient.
* ``least_k_sum``: the sum of the smallest ``ceil(s)`` scores, whose
  gradient with respect to ``s`` is the ``(k+1)``-th smallest score.
* ``torch_clamp``: ``clamp`` with the full gradient on the boundary (the
  JAX package writes it out because ``jnp.clip`` splits it; PyTorch's own
  ``clamp`` already passes it, and the Function states the rule).
* ``bottom_k_mask``: rank-based bottom-k selection with traced ``k``.

Each is a ``torch.autograd.Function`` with the JAX custom VJP's gradient.
"""

from __future__ import annotations

import torch


class _SteCeil(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a):
        return torch.ceil(a)

    @staticmethod
    def backward(ctx, g):
        return g


class _SteFloor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a):
        return torch.floor(a)

    @staticmethod
    def backward(ctx, g):
        return g


def ste_ceil(a: torch.Tensor) -> torch.Tensor:
    return _SteCeil.apply(a)


def ste_floor(a: torch.Tensor) -> torch.Tensor:
    return _SteFloor.apply(a)


class _LeastKSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s, scores):
        n = scores.shape[-1]
        srt = torch.sort(scores, dim=-1).values
        k = torch.clamp(torch.ceil(s), 0, n).long()
        idx = torch.arange(n, device=scores.device)
        val = torch.where(idx < k[..., None], srt,
                          torch.zeros_like(srt)).sum(dim=-1)
        # the gradient seed: the (k+1)-th smallest, clamped to the largest
        ctx.save_for_backward(torch.gather(
            srt, -1, torch.clamp(k, max=n - 1)[..., None])[..., 0])
        return val

    @staticmethod
    def backward(ctx, g):
        (seed,) = ctx.saved_tensors
        return g * seed, None


def least_k_sum(s: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """Sum of the smallest ``ceil(s)`` entries of ``scores`` along the last
    axis (all of them when ``ceil(s) >= n``), batched over the leading
    axes.  The gradient with respect to ``s`` is the ``(k+1)``-th smallest
    entry (the largest when ``k + 1 > n``); ``scores`` gets none."""
    return _LeastKSum.apply(s, scores)


class _TorchClamp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward((x >= lo) & (x <= hi))
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (inside,) = ctx.saved_tensors
        return torch.where(inside, g, torch.zeros_like(g)), None, None


def torch_clamp(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``clamp`` whose gradient passes wherever ``lo <= x <= hi``, the
    boundary included (the resource ratios start on the 1.0 boundary and
    must feel the full budget pressure there)."""
    return _TorchClamp.apply(x, lo, hi)


def bottom_k_mask(scores: torch.Tensor, k) -> torch.Tensor:
    """Boolean mask selecting the ``k`` smallest entries along the last
    axis.  ``k`` is an int or a tensor broadcast against the leading axes.
    Ties are broken by index order (stable sort), as in the JAX package."""
    order = torch.argsort(scores, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    k = torch.as_tensor(k, device=scores.device)
    return ranks < k[..., None]
