"""The baseline fine-tune step (counterpart of
``uvc_tpu/baselines/finetune.py``): masked-weight fine-tuning of the
pruning baselines with the DeiT recipe's on-device pieces.

One step runs

  random erasing -> mixup / cutmix -> forward through ``w * mask``
  (drop-path, optional Gumbel token top-k) -> loss (soft-target CE,
  label-smoothing CE or CE; soft distillation when a teacher is given) ->
  backward -> global-norm clip -> AdamW -> EMA

With drop-path on, every block runs the separate-LN branch: the bare
attention sublayer kernel forward and backward, and the composed MLP.
The weight masks multiply the f32 parameters inside the loss, so the
gradient at a masked coordinate is exactly zero; AdamW's decoupled weight
decay still moves those coordinates, and the next forward's mask zeroes
them again, as in the JAX package.

Every random number of a step comes in ``BaselineNoise``, drawn by
``draw_baseline_noise``: the rectangles and mixup decisions on the host,
the pixel fill of random erasing on the batch's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch

from uvc_tpu_torch.baselines.pruning import apply_weight_masks
from uvc_tpu_torch.configs import ViTConfig
from uvc_tpu_torch.data.augment import (ErasingDraw, random_erasing,
                                        sample_erasing)
from uvc_tpu_torch.data.mixup import MixupDraw, mixup_cutmix, sample_mixup
from uvc_tpu_torch.distill.losses import distillation_loss
from uvc_tpu_torch.interop import host_to_device, resolve_device
from uvc_tpu_torch.models import get_model
from uvc_tpu_torch.models.vit import sample_drop_path
from uvc_tpu_torch.ops.gumbel import gumbel_noise
from uvc_tpu_torch.train.state import (TrainHParams, clip_global_norm,
                                       make_weight_optimizer,
                                       zero_frozen_updates)
from uvc_tpu_torch.train.step import _base_loss, _teacher_logits
from uvc_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class BaselineState:
    step: int
    params: Any
    opt_state: Any
    ema_params: Optional[Any] = None


def create_baseline_state(params, thp: TrainHParams,
                          ema_decay: float = 0.0) -> BaselineState:
    """Step 0, fresh AdamW moments and, with ``ema_decay > 0``, an EMA copy
    of the parameters; every tensor on the parameters' device."""
    ema = tree_map(torch.clone, params) if ema_decay > 0 else None
    return BaselineState(step=0, params=params,
                         opt_state=make_weight_optimizer(thp).init(params),
                         ema_params=ema)


class BaselineNoise(NamedTuple):
    """Every random number of one baseline step (None where the
    configuration draws none)."""

    mixup: Optional[MixupDraw]        # the mixing decision(s)
    erasing: Optional[ErasingDraw]    # random-erasing rectangles and fill
    token: Optional[torch.Tensor]     # [B, N] Gumbel noise of the token top-k
    drop_path: Optional[torch.Tensor]  # [L, 2, B] drop-path keep decisions


def draw_baseline_noise(generator: torch.Generator, cfg: ViTConfig,
                        thp: TrainHParams, batch: int, *,
                        token_selection: bool = False,
                        drop_path_rate: float = 0.0, re_prob: float = 0.0,
                        re_count: int = 1, re_mode: str = "pixel",
                        device="cuda") -> BaselineNoise:
    """Draw one step's noise from the CPU ``generator`` onto ``device``
    (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    mix = None
    if thp.mixup > 0 or thp.cutmix > 0:
        mix = sample_mixup(
            generator, cfg.img_size, cfg.img_size,
            decisions=None if thp.mixup_mode == "batch" else batch,
            mixup_alpha=thp.mixup, cutmix_alpha=thp.cutmix,
            prob=thp.mixup_prob, switch_prob=thp.mixup_switch_prob,
            cutmix_minmax=thp.cutmix_minmax)
        mix = MixupDraw(*(host_to_device(t, device) for t in mix))
    erasing = None
    if re_prob > 0:
        erasing = sample_erasing(generator, batch, cfg.img_size,
                                 cfg.img_size, cfg.in_chans, prob=re_prob,
                                 count=re_count, mode=re_mode, device=device)
    token = None
    if token_selection:
        token = host_to_device(
            gumbel_noise(generator, (batch, cfg.num_patches)), device)
    keep = None
    if drop_path_rate > 0:
        keep = host_to_device(
            sample_drop_path(generator, cfg.depth, drop_path_rate, batch),
            device)
    return BaselineNoise(mixup=mix, erasing=erasing, token=token,
                         drop_path=keep)


def build_baseline_step(cfg: ViTConfig, thp: TrainHParams, *,
                        token_selection: bool = False,
                        token_number: float = 0.7,
                        ema_decay: float = 0.0,
                        drop_path_rate: float = 0.0,
                        re_prob: float = 0.0):
    """Returns ``step(state, teacher_params, wmasks, x, labels, noise, tau)
    -> (state', metrics)``, ``noise`` a ``BaselineNoise`` drawn with the
    same settings (the erasing count and fill mode live in its draw).

    ``teacher_params=None`` (or ``thp.distillation_type`` "none") trains
    without distillation; ``wmasks=None`` trains dense.  The new state
    holds new tensors; ``state`` is not modified."""
    tx = make_weight_optimizer(thp)
    lr_fn = thp.lr_schedule()
    dtype = thp.compute_dtype
    use_distill = thp.distillation_type not in (None, "none")
    mixing = thp.mixup > 0 or thp.cutmix > 0
    model = get_model(cfg)

    def loss_fn(params, teacher_params, wmasks, x, targets, labels, noise,
                tau):
        p = apply_weight_masks(params, wmasks) if wmasks is not None \
            else params
        out = model.apply(
            p, x, cfg, tau=tau if token_selection else -1.0,
            patch_ratio=token_number,
            patch_gate_mode=2 if token_selection else 0,
            rng=noise.token, train=True, drop_path_rate=drop_path_rate,
            drop_path=noise.drop_path, dtype=dtype)
        base = _base_loss(out.logits, targets, labels, thp)
        if use_distill and teacher_params is not None:
            t_logits = _teacher_logits(teacher_params, x, cfg, dtype)
            return distillation_loss(
                base, out.logits_kd, t_logits, kind=thp.distillation_type,
                alpha=thp.distillation_alpha, tau=thp.distillation_tau)
        return base

    def step(state: BaselineState, teacher_params, wmasks,
             x: torch.Tensor, labels: torch.Tensor, noise: BaselineNoise,
             tau):
        if re_prob > 0 and noise.erasing is None:
            raise ValueError("re_prob > 0 needs noise.erasing")
        if noise.erasing is not None:
            x = random_erasing(x, noise.erasing)
        if mixing:
            x, targets = mixup_cutmix(x, labels, noise.mixup,
                                      num_classes=thp.num_classes,
                                      smoothing=thp.smoothing,
                                      mode=thp.mixup_mode)
        else:
            targets = torch.nn.functional.one_hot(
                labels.long(), thp.num_classes).float()

        leaves = [p.detach().requires_grad_() for p in
                  tree_leaves(state.params)]
        params = tree_unflatten(state.params, leaves)
        with torch.enable_grad():
            loss = loss_fn(params, teacher_params, wmasks, x, targets,
                           labels, noise, tau)
            # leaves the forward does not read (the gating logits, ...)
            # get zero gradients, as under jax.grad
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = tree_unflatten(state.params, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)])

        with torch.no_grad():
            grads, grad_norm = clip_global_norm(grads, thp.max_grad_norm)
            updates, opt_state = tx.update(grads, state.opt_state,
                                           state.params)
            updates = zero_frozen_updates(updates)
            new_params = tree_map(lambda p, u: p + u, state.params, updates)
            ema = state.ema_params
            if ema is not None:
                ema = tree_map(
                    lambda e, p: ema_decay * e + (1.0 - ema_decay) * p,
                    ema, new_params)
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm,
                   "lr": lr_fn(state.step)}
        return BaselineState(step=state.step + 1, params=new_params,
                             opt_state=opt_state, ema_params=ema), metrics

    return step


def build_baseline_eval_step(cfg: ViTConfig, thp: TrainHParams):
    """Returns ``step(params, wmasks, x, labels) -> {correct, loss_sum,
    count}`` over the masked weights, in the compute dtype; rows labelled
    -1 are padding and leave all three untouched."""
    dtype = thp.compute_dtype
    model = get_model(cfg)

    @torch.no_grad()
    def step(params, wmasks, x, labels) -> Dict[str, torch.Tensor]:
        p = apply_weight_masks(params, wmasks) if wmasks is not None \
            else params
        out = model.apply(p, x, cfg, train=False, dtype=dtype)
        logits = model.eval_logits(out, cfg)
        valid = labels >= 0
        safe = labels.clamp(min=0)
        nll = -torch.log_softmax(logits, dim=-1).gather(
            -1, safe[:, None].long())[:, 0]
        correct = (logits.argmax(dim=-1) == labels) & valid
        return {"correct": correct.sum(),
                "loss_sum": torch.where(valid, nll,
                                        torch.zeros_like(nll)).sum(),
                "count": valid.sum()}

    return step
