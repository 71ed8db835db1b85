"""Train state, training hyperparameters and the weight optimizer
(counterpart of ``uvc_tpu/train/state.py``).

``make_weight_optimizer`` is AdamW written out with optax's update rule
(``optax.adamw``: bias-corrected moments, eps outside the sqrt, decoupled
weight decay on every leaf, the learning rate taken from the schedule at
the optimizer's own count), or stage 2's heavy-ball SGD (``optax.chain(
add_decayed_weights, sgd)``), working on the carried state so that a
trajectory can be held against the JAX package's step by step.  The
``*_state_dict`` functions give the optimizer state and the minimax state
the layout that ``flax.serialization.to_state_dict`` gives the JAX
package's (optax's chain states, the ``CompressionState`` fields), so that
the two packages' checkpoints cross-load.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from uvc_tpu_torch.compress.state import CompressionState, OptState
from uvc_tpu_torch.parallel.mesh import gather_params, shard_params
from uvc_tpu_torch.utils.schedules import (timm_epoch_schedule,
                                           warmup_cosine_schedule,
                                           warmup_linear_schedule)
from uvc_tpu_torch.utils.tree import (tree_leaves, tree_leaves_with_path,
                                      tree_map, tree_unflatten)


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    """Weight-training hyperparameters, with the JAX package's fields and
    defaults (``compute_dtype`` a torch dtype)."""

    learning_rate: float = 1e-4
    weight_decay: float = 0.05
    max_grad_norm: float = 1.0
    warmup_steps: int = 500
    t_total: int = 10000
    decay_type: str = "cosine"          # cosine | linear
    num_epochs: int = 20
    warmup_epochs: int = 5              # UVC gating warmup (epochs)
    warmup_lr: float = 1e-4
    # mixup family
    mixup: float = 0.8
    cutmix: float = 1.0
    mixup_prob: float = 0.8
    mixup_switch_prob: float = 0.5
    mixup_mode: str = "batch"            # batch | elem | pair
    cutmix_minmax: object = None         # optional (min, max) box fractions
    smoothing: float = 0.1
    num_classes: int = 1000
    # distillation
    distillation_type: Optional[str] = "soft"   # none | soft | hard
    distillation_alpha: float = 0.5
    distillation_tau: float = 1.0
    # gradient accumulation: micro-steps accumulate loss/N grads, every
    # N-th step applies clip + AdamW + the arch update
    accum_steps: int = 1
    # stage-2 timm scheduler surface
    sched: Optional[str] = None
    min_lr: float = 1e-5
    sched_warmup_lr: float = 1e-6
    decay_epochs: float = 30.0
    decay_rate: float = 0.1
    steps_per_epoch: int = 0
    # stage-2 timm optimizer surface
    opt: str = "adamw"                   # adamw | sgd | momentum
    opt_eps: float = 1e-8
    opt_betas: object = None             # optional (b1, b2)
    momentum: float = 0.9
    # numerics
    compute_dtype: Any = torch.bfloat16

    def lr_schedule(self) -> Callable:
        if self.sched:
            return timm_epoch_schedule(
                self.sched, self.learning_rate, epochs=self.num_epochs,
                steps_per_epoch=self.steps_per_epoch, min_lr=self.min_lr,
                warmup_lr=self.sched_warmup_lr,
                warmup_epochs=self.warmup_epochs,
                decay_epochs=self.decay_epochs, decay_rate=self.decay_rate)
        if self.decay_type == "cosine":
            return warmup_cosine_schedule(self.learning_rate,
                                          self.warmup_steps, self.t_total)
        return warmup_linear_schedule(self.learning_rate, self.warmup_steps,
                                      self.t_total)


@dataclasses.dataclass
class AdamWState:
    count: int      # updates taken (bias correction and the schedule)
    mu: Any         # first moments, a tree like the parameters
    nu: Any         # second moments


@dataclasses.dataclass
class TrainState:
    step: int
    params: Any
    opt_state: Any
    cstate: Optional[CompressionState] = None
    # gradient-accumulation buffer (params-shaped; None when accum_steps==1)
    grad_accum: Any = None

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


class AdamW:
    """``optax.adamw(lr_fn, b1, b2, eps, weight_decay)``:
    ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g^2``,
    ``update = -lr(count) * (mu_hat / (sqrt(nu_hat) + eps) + wd * p)``
    with ``mu_hat = mu / (1 - b1^(count + 1))`` (likewise nu) and the
    schedule read at the count before the update."""

    def __init__(self, lr_fn: Callable, b1: float, b2: float, eps: float,
                 weight_decay: float):
        self.lr_fn, self.b1, self.b2 = lr_fn, b1, b2
        self.eps, self.weight_decay = eps, weight_decay

    def init(self, params) -> AdamWState:
        return AdamWState(count=0, mu=tree_map(torch.zeros_like, params),
                          nu=tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """(updates, new state); ``params + updates`` is the step."""
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads,
                      state.nu)
        count = state.count + 1
        # host scalars, computed in f32 as optax computes them: no copy to
        # the device, so the update never waits for the card
        lr = float(self.lr_fn(state.count))
        c, one = np.float32(count), np.float32(1.0)
        bc1 = float(one - np.float32(b1) ** c)
        bc2 = float(one - np.float32(b2) ** c)

        def upd(m, v, p):
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            return -lr * (u + self.weight_decay * p)

        return tree_map(upd, mu, nu, params), AdamWState(count, mu, nu)


@dataclasses.dataclass
class SGDState:
    count: int      # updates taken (the schedule)
    trace: Any      # momentum buffers, a tree like the parameters


class SGD:
    """``optax.chain(add_decayed_weights(wd), sgd(lr_fn, momentum,
    nesterov))``: ``g += wd * p`` (coupled decay, after the step's clip),
    ``t = g + momentum * t``, the update ``g + momentum * t`` with Nesterov
    or ``t`` without, times ``-lr(count)`` with the schedule read at the
    count before the update."""

    def __init__(self, lr_fn: Callable, momentum: float, nesterov: bool,
                 weight_decay: float):
        self.lr_fn, self.momentum = lr_fn, momentum
        self.nesterov, self.weight_decay = nesterov, weight_decay

    def init(self, params) -> SGDState:
        return SGDState(count=0, trace=tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, grads, state: SGDState, params):
        """(updates, new state); ``params + updates`` is the step."""
        mom, wd = self.momentum, self.weight_decay
        grads = tree_map(lambda g, p: g + wd * p, grads, params)
        trace = tree_map(lambda g, t: g + mom * t, grads, state.trace)
        lr = float(self.lr_fn(state.count))
        if self.nesterov:
            updates = tree_map(lambda g, t: -lr * (g + mom * t), grads,
                               trace)
        else:
            updates = tree_map(lambda t: -lr * t, trace)
        return updates, SGDState(state.count + 1, trace)


def make_weight_optimizer(thp: TrainHParams,
                          lr_fn: Optional[Callable] = None):
    """AdamW over every parameter (decoupled decay on norms, biases and
    tokens too), with the warmup-cosine / linear schedule or ``lr_fn``
    (the constant ``warmup_lr`` of the gating warmup).  ``thp.opt`` "sgd"
    (timm's Nesterov SGD) or "momentum" (heavy ball without Nesterov)
    selects stage 2's ``SGD`` with coupled decay instead; ``opt_eps`` and
    ``opt_betas`` then go unused.  Global-norm clipping happens in the
    step, before this update."""
    lr_fn = lr_fn or thp.lr_schedule()
    if thp.opt in ("sgd", "momentum"):
        return SGD(lr_fn, thp.momentum, thp.opt == "sgd", thp.weight_decay)
    b1, b2 = thp.opt_betas or (0.9, 0.999)
    return AdamW(lr_fn, b1, b2, thp.opt_eps, thp.weight_decay)


def zero_frozen_updates(updates):
    """Zero the updates of non-trainable leaves (the performer's ``prm_w``
    random features), which decoupled weight decay would still move."""
    leaves = [torch.zeros_like(u) if any("prm_w" in k for k in path) else u
              for path, u in tree_leaves_with_path(updates)]
    return tree_unflatten(updates, leaves)


def clip_global_norm(grads, max_norm: float):
    """torch ``clip_grad_norm_``: scale every gradient by
    ``min(1, max_norm / (total + 1e-6))``; returns (grads, total)."""
    leaves = tree_leaves(grads)
    total = torch.sqrt(sum((g.float() * g.float()).sum() for g in leaves))
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    return tree_map(lambda g: g * scale, grads), total


def create_train_state(params, thp: TrainHParams,
                       cstate: Optional[CompressionState] = None
                       ) -> TrainState:
    grad_accum = None
    if thp.accum_steps > 1:
        grad_accum = tree_map(torch.zeros_like, params)
    return TrainState(step=0, params=params,
                      opt_state=make_weight_optimizer(thp).init(params),
                      cstate=cstate, grad_accum=grad_accum)


def map_param_trees(fn: Callable, state):
    """``state`` (a ``TrainState``, or the baseline fine-tune's state) with
    ``fn`` applied to each of its parameter-shaped trees: the params, the
    optimizer's moments (AdamW's ``mu`` / ``nu``, SGD's ``trace``), the
    gradient-accumulation buffer and the EMA params, where present.  The
    tensor-parallel drivers shard and gather a state with it."""
    opt = state.opt_state
    changes = {"params": fn(state.params),
               "opt_state": (AdamWState(opt.count, fn(opt.mu), fn(opt.nu))
                             if isinstance(opt, AdamWState)
                             else SGDState(opt.count, fn(opt.trace)))}
    for name in ("grad_accum", "ema_params"):
        if getattr(state, name, None) is not None:
            changes[name] = fn(getattr(state, name))
    return dataclasses.replace(state, **changes)


def shard_state(state, mesh, mp: int):
    """This rank's shard of every parameter-shaped tree of ``state``
    (``parallel/mesh.py::shard_params``)."""
    return map_param_trees(lambda t: shard_params(t, mesh, mp), state)


def gather_state(state, mesh):
    """``shard_state``'s inverse: the whole trees gathered over the model
    group (``parallel/mesh.py::gather_params``)."""
    return map_param_trees(lambda t: gather_params(t, mesh), state)


# ---------------------------------------------------------------------------
# the checkpoint layout: the JAX package's state dicts
# ---------------------------------------------------------------------------


def _count(n: int) -> np.ndarray:
    """A step count as the JAX package stores it (a 0-d int32 array)."""
    return np.asarray(int(n), np.int32)


def opt_state_to_state_dict(opt_state) -> dict:
    """The weight optimizer's state in the layout of
    ``flax.serialization.to_state_dict`` of the optax state: AdamW's
    ``(ScaleByAdamState, EmptyState, ScaleByScheduleState)``, SGD's
    ``(EmptyState, (TraceState, ScaleByScheduleState))``."""
    if isinstance(opt_state, AdamWState):
        return {"0": {"count": _count(opt_state.count), "mu": opt_state.mu,
                      "nu": opt_state.nu},
                "1": {}, "2": {"count": _count(opt_state.count)}}
    return {"0": {}, "1": {"0": {"trace": opt_state.trace},
                           "1": {"count": _count(opt_state.count)}}}


def opt_state_from_state_dict(state: dict, like):
    """``opt_state_to_state_dict``'s inverse: the optimizer state of
    ``like``'s kind and tree structure (its tensors' devices) holding
    ``state``'s values."""
    from uvc_tpu_torch.utils.checkpoint import restore_like
    if isinstance(like, AdamWState):
        adam = state["0"]
        return AdamWState(count=int(adam["count"]),
                          mu=restore_like(like.mu, adam["mu"]),
                          nu=restore_like(like.nu, adam["nu"]))
    return SGDState(count=int(state["1"]["1"]["count"]),
                    trace=restore_like(like.trace,
                                       state["1"]["0"]["trace"]))


def cstate_to_state_dict(cstate: CompressionState) -> dict:
    """The minimax state as ``to_state_dict`` of the JAX package's
    ``CompressionState``: its fields, each tiny optimizer's as ``m`` /
    ``v`` / ``count``."""
    out = {}
    for f in dataclasses.fields(cstate):
        v = getattr(cstate, f.name)
        if isinstance(v, OptState):
            v = {"m": v.m, "v": v.v, "count": _count(v.count)}
        out[f.name] = v
    return out


def cstate_from_state_dict(state: dict, device) -> CompressionState:
    """``cstate_to_state_dict``'s inverse, the tensors on ``device``."""
    def t(a):
        return None if a is None else torch.as_tensor(a).to(device)

    fields = {}
    for f in dataclasses.fields(CompressionState):
        v = state[f.name]
        if f.name.endswith("_opt"):
            v = OptState(m=t(v["m"]), v=t(v["v"]), count=int(v["count"]))
        else:
            v = t(v)
        fields[f.name] = v
    return CompressionState(**fields)
