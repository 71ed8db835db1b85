"""Tiny functional optimizers with torch's update rules (counterpart of
``uvc_tpu/compress/optim.py``): the minimax engine steps s / r / gating
with SGD, Adam or RMSprop.  Each step returns a new parameter and a new
``OptState``; nothing is updated in place."""

from __future__ import annotations

import numpy as np
import torch

from uvc_tpu_torch.compress.state import OptState


def init_opt_state(kind: str, param: torch.Tensor) -> OptState:
    z = torch.zeros_like(param)
    if kind == "sgd":
        return OptState(m=z, v=None, count=0)
    if kind in ("adam", "rmsprop"):
        return OptState(m=z, v=z.clone(), count=0)
    raise ValueError(f"unknown optimizer {kind!r}")


def opt_step(kind: str, param: torch.Tensor, grad: torch.Tensor,
             state: OptState, lr, *, momentum: float = 0.0,
             weight_decay: float = 0.0, betas=(0.0, 0.999),
             eps: float = 1e-8, alpha: float = 0.99):
    """One optimizer step; returns (new_param, new_state).  SGD:
    ``buf = mu * buf + g`` (dampening 0), the update is ``buf``; Adam with
    bias correction and eps outside the sqrt; RMSprop's square average
    with ``alpha``.  Weight decay is added to the gradient (coupled)."""
    if weight_decay:
        grad = grad + weight_decay * param
    count = state.count + 1
    if kind == "sgd":
        if momentum:
            buf = momentum * state.m + grad
            upd = buf
        else:
            buf = state.m
            upd = grad
        return param - lr * upd, OptState(m=buf, v=None, count=count)
    if kind == "adam":
        b1, b2 = betas
        m = b1 * state.m + (1 - b1) * grad
        v = b2 * state.v + (1 - b2) * grad * grad
        t, one = np.float32(count), np.float32(1.0)
        mhat = m / float(one - np.float32(b1) ** t)
        vhat = v / float(one - np.float32(b2) ** t)
        return (param - lr * mhat / (torch.sqrt(vhat) + eps),
                OptState(m=m, v=v, count=count))
    if kind == "rmsprop":
        v = alpha * state.v + (1 - alpha) * grad * grad
        return (param - lr * grad / (torch.sqrt(v) + eps),
                OptState(m=state.m, v=v, count=count))
    raise ValueError(f"unknown optimizer {kind!r}")
