"""Bottom-k selection (counterpart of ``uvc_tpu/ops/stes.py``).

Only the forward selection that mask building and serving need is here;
the straight-through estimators belong to training and come with it.
"""

from __future__ import annotations

import torch


def bottom_k_mask(scores: torch.Tensor, k) -> torch.Tensor:
    """Boolean mask selecting the ``k`` smallest entries along the last
    axis.  ``k`` is an int or a tensor broadcast against the leading axes.
    Ties are broken by index order (stable sort), as in the JAX package."""
    order = torch.argsort(scores, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    k = torch.as_tensor(k, device=scores.device)
    return ranks < k[..., None]
