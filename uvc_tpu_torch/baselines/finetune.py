"""The baseline fine-tune (counterpart of ``uvc_tpu/baselines/finetune.py``):
masked-weight fine-tuning of the pruning baselines with the DeiT recipe's
on-device pieces, its step and its epoch loop (``run_baseline``).

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
the pixel fill of random erasing on the batch's device.  ``run_baseline``
draws each step's from a generator seeded by ``(seed, global step)``
(``draw_step_noise``, looked up at call time so that a test can feed the
JAX package's draws instead), so a resumed run repeats the uninterrupted
one bit for bit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from uvc_tpu_torch.baselines.gmp import GMPSchedule
from uvc_tpu_torch.baselines.pruning import (apply_weight_masks,
                                             mask_sparsity, masks_from_flat,
                                             masks_to_flat)
from uvc_tpu_torch.configs import ViTConfig
from uvc_tpu_torch.data.augment import (ErasingDraw, random_erasing,
                                        sample_erasing)
from uvc_tpu_torch.data.mixup import MixupDraw, mixup_cutmix, sample_mixup
from uvc_tpu_torch.data.pipeline import device_prefetch, normalize_on_device
from uvc_tpu_torch.distill.losses import distillation_loss
from uvc_tpu_torch.interop import host_to_device, resolve_device
from uvc_tpu_torch.models import get_model
from uvc_tpu_torch.models.vit import sample_drop_path
from uvc_tpu_torch.ops.gumbel import gumbel_noise
from uvc_tpu_torch.train.stage1 import MULTI_DEVICE, eval_totals
from uvc_tpu_torch.train.state import (TrainHParams, clip_global_norm,
                                       make_weight_optimizer,
                                       opt_state_from_state_dict,
                                       opt_state_to_state_dict,
                                       zero_frozen_updates)
from uvc_tpu_torch.train.step import _base_loss, _teacher_logits
from uvc_tpu_torch.utils.checkpoint import (load_checkpoint, restore_like,
                                            save_checkpoint)
from uvc_tpu_torch.utils.logging import AverageMeter, MetricLogger
from uvc_tpu_torch.utils.schedules import get_tau
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


# ---------------------------------------------------------------------------
# the epoch loop
# ---------------------------------------------------------------------------


def draw_step_noise(seed: int, global_step: int, cfg: ViTConfig,
                    thp: TrainHParams, batch: int, *, device,
                    **settings) -> BaselineNoise:
    """The noise of the step taken at ``global_step``: ``draw_baseline_noise``
    from a CPU generator seeded by ``(seed, global_step)`` alone, so that
    a step draws the same whether or not the run was resumed before it."""
    key = int(np.random.SeedSequence([int(seed), int(global_step)])
              .generate_state(1)[0])
    return draw_baseline_noise(torch.Generator().manual_seed(key), cfg, thp,
                               batch, device=device, **settings)


@dataclasses.dataclass
class BaselineResult:
    state: BaselineState
    masks: Any
    best_acc: float


def _copy(tree, dev):
    return tree_map(lambda t: torch.as_tensor(t).detach().to(dev,
                                                             copy=True),
                    tree)


def run_baseline(cfg: ViTConfig, thp: TrainHParams, *, train_loader,
                 test_loader, params, wmasks=None, teacher_params=None,
                 gmp: Optional[GMPSchedule] = None,
                 token_selection: bool = False, token_number: float = 0.7,
                 ema_decay: float = 0.0, drop_path_rate: float = 0.0,
                 re_prob: float = 0.0, re_count: int = 1,
                 re_mode: str = "pixel", seed: int = 0,
                 output_dir: str = "output", name: str = "baseline",
                 resume: Optional[str] = None, start_epoch: int = 0,
                 save_checkpoints: bool = True, mesh=None, mp: int = 1,
                 logger: Optional[MetricLogger] = None,
                 device="cuda") -> BaselineResult:
    """Epochs of masked (or GMP) fine-tuning, each followed by an eval and
    a checkpoint ``{cfg.name}_baseline_{epoch}.ckpt`` holding the params,
    the optimizer state, the EMA, the flat masks, the step, the epoch, the
    best accuracy and the GMP events; ``resume`` restores all of them.
    Runs on ``device`` (the card unless the caller asks for the CPU);
    ``params`` / ``teacher_params`` are copied, never changed."""
    if mesh is not None or mp != 1:
        raise NotImplementedError(MULTI_DEVICE)
    dev = resolve_device(device)
    logger = logger or MetricLogger(output_dir, name)
    state = create_baseline_state(_copy(params, dev), thp, ema_decay)
    if teacher_params is not None:
        teacher_params = _copy(teacher_params, dev)
    if wmasks is not None:
        wmasks = tree_map(lambda t: t.to(dev), wmasks)
    global_step = 0
    best_acc = 0.0

    if resume:
        ck = load_checkpoint(resume)
        restored = restore_like(state.params, ck["params"])
        ema = ck.get("ema_params") or None
        if ema is not None:
            ema = (restore_like(state.ema_params, ema)
                   if state.ema_params is not None else _copy(ema, dev))
        elif state.ema_params is not None:
            # EMA on but the checkpoint carries none: warm-start it from
            # the restored weights, not the pre-resume ones
            ema = _copy(restored, dev)
        state = BaselineState(
            step=int(ck["step"]), params=restored,
            opt_state=opt_state_from_state_dict(ck["opt_state"],
                                                state.opt_state),
            ema_params=ema)
        if ck.get("masks"):
            wmasks = masks_from_flat(ck["masks"], state.params)
        start_epoch = int(ck.get("epoch", 0)) + 1
        global_step = int(ck["step"])
        best_acc = float(ck.get("best_acc", 0.0))
        if gmp is not None:
            gmp.events = int(ck.get("gmp_events", 0))
        logger.info(f"Resumed from {resume} at epoch {start_epoch}")

    settings = dict(token_selection=token_selection,
                    drop_path_rate=drop_path_rate, re_prob=re_prob,
                    re_count=re_count, re_mode=re_mode)
    step_fn = build_baseline_step(cfg, thp, token_selection=token_selection,
                                  token_number=token_number,
                                  ema_decay=ema_decay,
                                  drop_path_rate=drop_path_rate,
                                  re_prob=re_prob)
    eval_fn = build_baseline_eval_step(cfg, thp)
    t_total = len(train_loader) * thp.num_epochs
    metrics = None

    for epoch in range(start_epoch, thp.num_epochs):
        train_loader.set_epoch(epoch)
        losses = AverageMeter()
        images = 0
        t0 = time.time()
        for x, y in device_prefetch(iter(train_loader), device=dev):
            tau = (get_tau(10.0, 0.1, global_step, t_total)
                   if token_selection else -1.0)
            noise = draw_step_noise(seed, global_step, cfg, thp, x.shape[0],
                                    device=dev, **settings)
            state, metrics = step_fn(state, teacher_params, wmasks,
                                     normalize_on_device(x), y.long(), noise,
                                     tau)
            images += x.shape[0]
            global_step += 1
            if gmp is not None:
                new_masks = gmp.maybe_prune(global_step, state.params)
                if new_masks is not None:
                    wmasks = new_masks
                    logger.info(
                        f"[GMP] step {global_step}: pruning event "
                        f"{gmp.events}, remaining "
                        f"{mask_sparsity(wmasks) * 100:.2f}%")
            if global_step % 50 == 0:
                losses.update(float(metrics["loss"]))
        if losses.count == 0 and metrics is not None:
            losses.update(float(metrics["loss"]))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.time() - t0
        logger.info(f"[Baseline Epoch {epoch}] {dt:.1f}s "
                    f"({images / max(dt, 1e-9):.1f} img/s) "
                    f"loss {losses.avg:.4f}")

        if test_loader is not None:
            correct, loss_sum, count = eval_totals(
                eval_fn, state.params, wmasks, test_loader, dev)
            acc = correct / max(count, 1)
            logger.info(f"[Baseline Eval|Epoch {epoch}] acc {acc * 100:.3f}% "
                        f"loss {loss_sum / max(count, 1):.5f}")
            best_acc = max(best_acc, acc)

        if save_checkpoints:
            save_checkpoint(
                f"{logger.dir}/{cfg.name}_baseline_{epoch}.ckpt",
                {"params": state.params,
                 "opt_state": opt_state_to_state_dict(state.opt_state),
                 "ema_params": state.ema_params or {},
                 "masks": masks_to_flat(wmasks) if wmasks is not None
                 else {},
                 "step": state.step, "epoch": epoch, "best_acc": best_acc,
                 "gmp_events": gmp.events if gmp is not None else 0})

    return BaselineResult(state=state, masks=wmasks, best_acc=best_acc)
