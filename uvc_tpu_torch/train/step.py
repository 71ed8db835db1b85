"""The stage-1 and stage-2 UVC train steps and the eval step (counterpart
of ``uvc_tpu/train/step.py``).

PyTorch runs eagerly, so a step is a plain function where the JAX package
returns a jitted program; the JAX ``bundle`` (several steps scanned in one
program) and ``donate`` (buffer donation) are jit devices and have no
counterpart here.

The stage-1 step (``build_stage1_step``) runs

  mixup -> student forward (Gumbel block gating + Gumbel token top-k) ->
  teacher forward (no grad) -> soft distillation loss -> backward ->
  global-norm clip -> AdamW -> prox -> s / r primal steps -> gating
  interval step -> dual ascent

through the LN-fused sublayer kernels and their backward kernels; with
part gating (``hp.enable_part_gating``) the student's sublayers run the
separate-LN branch instead (the bare attention kernel and the composed
MLP, each scaled by its part-gating distribution).  Every random number of
a step is drawn up front by ``draw_stage1_noise`` from a CPU
``torch.Generator`` (a few kB: mixup, the gating, part-gating and token
Gumbel noise, the resource's two draws), so a run on the card and a run on
the CPU from one seed see the same draws, and a test can hand the step the
JAX package's own draws instead.

The stage-2 step (``build_stage2_step``) fine-tunes the discovered
architecture: the masks on the activations, the block gating frozen to
its hard decision (the student's blend kernel K3 / A4 with a one-hot
distribution), the physical top-k token drop by the frozen scorer, soft
distillation, clip and AdamW or SGD.  Its only draw is the mixup
(``draw_stage2_noise``).

Given a ``mesh`` (``parallel/mesh.py``), a step is one rank's part of
the JAX package's SPMD step over the global batch: it averages the
gradient tree and the loss over the data group (``all_reduce_mean``)
before the clip and the architecture update, so every rank takes the same
update and holds the same bytes; the mixup partners come from the flipped
global batch (``flip_partners``); and the noise is the global batch's, of
which the rank keeps the rows of its data index (``shard_noise``).  Every
loss term is a mean over the samples, so the data shards' mean gradient
is the global batch's.  A micro-step does not reduce: the full step
reduces the folded gradient once.

With a model axis (``mesh.mp > 1``) the state holds this rank's shard of
each tensor-parallel leaf (``shard_params``): the step gathers the whole
student and teacher weights (``gather_params``) and runs the forward and
backward kernels on them whole, so a rank launches what one process
launches at its data shard's batch; it reduces and clips the whole
gradient, updates its shard of the weights and of the optimizer state,
and runs the architecture update (prox and group scores) on the whole
weights before it keeps its shard again.  This is the function the JAX
package's step computes under ``mp > 1``: XLA runs each TPU kernel whole
on every device of a model group.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from uvc_tpu_torch.compress.minimax import arch_update
from uvc_tpu_torch.compress.resource import MacsTable
from uvc_tpu_torch.compress.state import MinimaxHParams
from uvc_tpu_torch.configs import ViTConfig
from uvc_tpu_torch.data.mixup import (MixupDraw, mixup_cutmix, rows_of_draw,
                                      sample_mixup)
from uvc_tpu_torch.distill.losses import (distillation_loss,
                                          label_smoothing_cross_entropy,
                                          soft_target_cross_entropy)
from uvc_tpu_torch.interop import host_to_device, resolve_device
from uvc_tpu_torch.models import get_model
from uvc_tpu_torch.ops.gumbel import block_gating_distrib, gumbel_noise
from uvc_tpu_torch.parallel.mesh import (Mesh, all_reduce_mean,
                                         flip_partners, gather_params,
                                         shard_batch, shard_params)
from uvc_tpu_torch.train.state import (TrainHParams, TrainState,
                                       clip_global_norm,
                                       make_weight_optimizer,
                                       zero_frozen_updates)
from uvc_tpu_torch.utils.profiler import grad_in_span, span
from uvc_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


class Stage1Noise(NamedTuple):
    """Every random number of one stage-1 step (None where the
    configuration draws none)."""

    mixup: Optional[MixupDraw]      # the mixing decision(s)
    gate: Optional[torch.Tensor]    # [L, 2] Gumbel noise of block gating
    token: Optional[torch.Tensor]   # [B, N] Gumbel noise of the token top-k
    res1: Optional[torch.Tensor]    # [L, 2] the resource's first draw
    res2: Optional[torch.Tensor]    # [L, 2] the resource's second draw
    part_attn: Optional[torch.Tensor] = None  # [L, 2] attention part gating
    part_mlp: Optional[torch.Tensor] = None   # [L, 2] MLP part gating


def _draw_mixup(generator: torch.Generator, cfg: ViTConfig,
                thp: TrainHParams, batch: int, device) -> Optional[MixupDraw]:
    """One step's mixing decision(s) on ``device``, None when mixup and
    cutmix are off."""
    if not (thp.mixup > 0 or thp.cutmix > 0):
        return None
    mix = sample_mixup(
        generator, cfg.img_size, cfg.img_size,
        decisions=None if thp.mixup_mode == "batch" else batch,
        mixup_alpha=thp.mixup, cutmix_alpha=thp.cutmix, prob=thp.mixup_prob,
        switch_prob=thp.mixup_switch_prob, cutmix_minmax=thp.cutmix_minmax)
    return MixupDraw(*(host_to_device(t, device) for t in mix))


def draw_stage1_noise(generator: torch.Generator, cfg: ViTConfig,
                      hp: MinimaxHParams, thp: TrainHParams, batch: int,
                      device="cuda") -> Stage1Noise:
    """Draw one step's noise from ``generator`` (on its device, usually
    the CPU) and move it to ``device`` (the card unless the caller asks
    for the CPU).  A data-parallel rank draws at the global batch and
    keeps its rows with ``shard_noise``."""
    device = resolve_device(device)
    gating = hp.enable_block_gating and hp.use_gumbel
    l2 = (cfg.depth, 2)

    def draw(shape, on):
        if not on:
            return None
        return host_to_device(gumbel_noise(generator, shape), device)

    with span("uvc.draw"):
        mix = _draw_mixup(generator, cfg, thp, batch, device)
        return Stage1Noise(
            mixup=mix, gate=draw(l2, gating),
            token=draw((batch, cfg.num_patches),
                       hp.enable_patch_gating == 2),
            res1=draw(l2, gating), res2=draw(l2, gating),
            part_attn=draw(l2, hp.enable_part_gating),
            part_mlp=draw(l2, hp.enable_part_gating))


class Stage2Noise(NamedTuple):
    """The random numbers of one stage-2 step: the mixup only (None when
    mixup and cutmix are off)."""

    mixup: Optional[MixupDraw]


def draw_stage2_noise(generator: torch.Generator, cfg: ViTConfig,
                      thp: TrainHParams, batch: int,
                      device="cuda") -> Stage2Noise:
    """Draw one stage-2 step's mixup from ``generator`` (on its device,
    usually the CPU) and move it to ``device`` (the card unless the caller
    asks for the CPU)."""
    with span("uvc.draw"):
        return Stage2Noise(mixup=_draw_mixup(generator, cfg, thp, batch,
                                             resolve_device(device)))


# the axis of the batch's rows in the per-row draws of a step's noise
_ROW_AXIS = {"token": 0, "drop_path": 2, "erasing": 1}


def shard_noise(noise, thp: TrainHParams, mesh: Optional[Mesh]):
    """This rank's part of a global batch's noise (a ``Stage1Noise``,
    ``Stage2Noise`` or the baseline's ``BaselineNoise``): every rank draws
    the global batch's noise from the same generator and keeps its rows
    of the per-row draws (the token noise, drop-path, random erasing, the
    ``elem`` / ``pair`` mixup decisions); the ``[L, 2]`` draws and the
    ``batch`` mode's one decision are every rank's.  The noise as it is
    without a mesh."""
    if mesh is None:
        return noise
    fields = {}
    for name, value in noise._asdict().items():
        if value is None:
            continue
        if name in _ROW_AXIS:
            fields[name] = shard_batch(value, mesh, axis=_ROW_AXIS[name])
        elif name == "mixup":
            rows = shard_batch(torch.arange(value.lam.shape[0]), mesh) \
                if thp.mixup_mode != "batch" else None
            fields[name] = rows_of_draw(value, thp.mixup_mode, rows)
    return noise._replace(**fields)


def _base_loss(logits, targets, labels, thp: TrainHParams):
    """SoftTargetCE with mixup, else label-smoothing CE, else plain CE."""
    if thp.mixup > 0 or thp.cutmix > 0:
        return soft_target_cross_entropy(logits, targets)
    if thp.smoothing > 0:
        return label_smoothing_cross_entropy(logits, labels, thp.smoothing)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[:, None]).mean()


@torch.no_grad()
def _teacher_logits(teacher_params, x, cfg: ViTConfig, dtype):
    """Dense teacher forward in eval mode, without gradients."""
    model = get_model(cfg)
    with span("uvc.teacher"):
        out = model.apply(teacher_params, x, cfg, dtype=dtype, train=False)
        return model.eval_logits(out, cfg)


def _mixed(x, labels, mixup: Optional[MixupDraw], thp: TrainHParams,
           mesh: Optional[Mesh] = None):
    """The step's images and soft targets: mixup / cutmix when on (with a
    mesh, against the flipped global batch's rows), else the one-hot
    labels."""
    with span("uvc.mixup"):
        if thp.mixup > 0 or thp.cutmix > 0:
            partner = (None if mesh is None
                       else flip_partners(x, labels, mesh))
            return mixup_cutmix(x, labels, mixup,
                                num_classes=thp.num_classes,
                                smoothing=thp.smoothing, mode=thp.mixup_mode,
                                partner=partner)
        return x, torch.nn.functional.one_hot(labels.long(),
                                              thp.num_classes).float()


def _distilled_loss(out, x, targets, labels, teacher_params,
                    cfg: ViTConfig, thp: TrainHParams):
    """The base loss plus distillation against the dense teacher (without
    distillation the teacher's forward, whose value the loss would not
    read, is not run).  The teacher runs first, so that the loss's terms
    make one span."""
    t_logits = None
    if thp.distillation_type not in (None, "none"):
        t_logits = _teacher_logits(teacher_params, x, cfg, thp.compute_dtype)
    with span("uvc.loss"):
        base = _base_loss(out.logits, targets, labels, thp)
        if t_logits is None:
            return base
        return distillation_loss(
            base, out.logits_kd, t_logits, kind=thp.distillation_type,
            alpha=thp.distillation_alpha, tau=thp.distillation_tau)


def model_axis(mesh: Optional[Mesh]) -> int:
    """The mesh's tensor-parallel size (1 without a mesh)."""
    return 1 if mesh is None else mesh.mp


def _value_and_grad(loss_fn, tree):
    """(loss, gradient tree) of ``loss_fn(tree)``; leaves the loss does not
    read (part-gating logits, ...) get zero gradients, as under
    ``jax.grad``."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(tree)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(tree, leaves))
        with span("uvc.backward"):
            grads = grad_in_span(loss, leaves, allow_unused=True)
    return loss.detach(), tree_unflatten(tree, [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(leaves, grads)])


def build_stage1_step(cfg: ViTConfig, table: MacsTable, hp: MinimaxHParams,
                      thp: TrainHParams, *, warmup: bool,
                      micro: bool = False, mesh: Optional[Mesh] = None):
    """Returns ``step(state, teacher_params, x, labels, noise, tau) ->
    (state', metrics)``, ``noise`` a ``Stage1Noise``.

    ``warmup`` selects the phase: the gating distribution pinned to
    (0.5, 0.5), the hard Gumbel draw, the constant ``thp.warmup_lr``, and
    the block gating frozen (its gradient and its AdamW update, decay
    included, zeroed).  ``micro=True`` is the gradient-accumulation
    micro-step: it only adds ``grad / accum_steps`` into
    ``state.grad_accum``; the full step folds the buffer into its own
    gradient, applies clip + AdamW + the architecture update and clears
    it.  The new state holds new tensors; ``state`` is not modified.
    ``mesh``: this rank's part of a data-parallel step (see the top).

    With ``hp.enable_part_gating`` the attention and MLP part-gating
    distributions are hard-or-soft Gumbel draws (``noise.part_attn`` /
    ``noise.part_mlp``, never the warmup's pinned (0.5, 0.5)); their logits
    train under AdamW in both phases.

    CaiT raises ValueError: it has no block gating (nor in the JAX
    package); it trains through the baseline fine-tune."""
    if cfg.cls_attn_layers > 0:
        raise ValueError(f"{cfg.name}: CaiT has no block gating, token "
                         "scorer or structural masks for the stage-1 step; "
                         "it trains through build_baseline_step")
    if warmup:
        def lr_fn(step):
            return torch.tensor(thp.warmup_lr, dtype=torch.float32)
    else:
        lr_fn = thp.lr_schedule()
    tx = make_weight_optimizer(thp, lr_fn=lr_fn)
    gumbel_hard = warmup
    dtype = thp.compute_dtype
    accum = thp.accum_steps
    model = get_model(cfg)

    def forward(params, cstate, x, noise, tau):
        gating_distrib = None
        if hp.enable_block_gating:
            gating_distrib = block_gating_distrib(
                noise.gate, params["block_gating"], use_gumbel=hp.use_gumbel,
                gumbel_hard=gumbel_hard, eps=cstate.eps, warmup=warmup)
        attn_d = mlp_d = None
        if hp.enable_part_gating:
            attn_d, mlp_d = (block_gating_distrib(
                n, params[k], use_gumbel=True, gumbel_hard=gumbel_hard,
                eps=cstate.eps, warmup=False) for n, k in (
                    (noise.part_attn, "attn_gating"),
                    (noise.part_mlp, "mlp_gating")))
        return model.apply(
            params, x, cfg, gating_distrib=gating_distrib,
            attn_distrib=attn_d, mlp_distrib=mlp_d,
            tau=tau if hp.enable_patch_gating == 2 else -1.0,
            patch_ratio=hp.patch_ratio,
            patch_gate_mode=hp.enable_patch_gating,
            jumping=hp.enable_jumping, rng=noise.token, train=True,
            dtype=dtype)

    def loss_fn(params, cstate, teacher_params, x, targets, labels, noise,
                tau):
        with span("uvc.forward"):
            out = forward(params, cstate, x, noise, tau)
        return _distilled_loss(out, x, targets, labels, teacher_params, cfg,
                               thp)

    mp = model_axis(mesh)

    def step(state: TrainState, teacher_params, x: torch.Tensor,
             labels: torch.Tensor, noise: Stage1Noise, tau):
        with span("uvc.step"):
            return _step(state, teacher_params, x, labels, noise, tau)

    def _step(state, teacher_params, x, labels, noise, tau):
        x, targets = _mixed(x, labels, noise.mixup, thp, mesh)
        teacher = gather_params(teacher_params, mesh)
        loss, grads = _value_and_grad(
            lambda params: loss_fn(params, state.cstate, teacher, x,
                                   targets, labels, noise, tau),
            gather_params(state.params, mesh))

        with torch.no_grad():
            if micro:
                with span("uvc.optimizer"):
                    new_accum = tree_map(lambda a, g: a + g / accum,
                                         state.grad_accum,
                                         shard_params(grads, mesh, mp))
                return state.replace(grad_accum=new_accum), {"loss": loss}
            grads, loss = _fold_and_reduce(grads, loss, state, accum, mesh)
            with span("uvc.optimizer"):
                if warmup:
                    grads = dict(grads, block_gating=torch.zeros_like(
                        grads["block_gating"]))
                grads, grad_norm = clip_global_norm(grads,
                                                    thp.max_grad_norm)
                # this rank's shard of the clipped gradient updates its
                # shard
                updates, opt_state = tx.update(shard_params(grads, mesh, mp),
                                               state.opt_state, state.params)
                updates = zero_frozen_updates(updates)
                if warmup:
                    # decoupled weight decay would still move the frozen
                    # logits
                    updates = dict(updates, block_gating=torch.zeros_like(
                        updates["block_gating"]))
                new_params = gather_params(
                    tree_map(lambda p, u: p + u, state.params, updates),
                    mesh)
        with span("uvc.arch_update"):
            lr = lr_fn(state.step)
            new_params, cstate, arch_metrics = arch_update(
                new_params, state.cstate, noise=(noise.res1, noise.res2),
                step=state.step,
                gating_loss_grad=(grads["block_gating"]
                                  if hp.enable_block_gating else None),
                main_lr=float(lr), hp=hp, cfg=cfg, table=table,
                warmup=warmup, gumbel_hard=gumbel_hard)
        metrics = {"loss": loss, "grad_norm": grad_norm, "lr": lr,
                   **arch_metrics}
        grad_accum = state.grad_accum
        if accum > 1:
            grad_accum = tree_map(torch.zeros_like, state.grad_accum)
        new_params = shard_params(new_params, mesh, mp)
        return TrainState(step=state.step + 1, params=new_params,
                          opt_state=opt_state, cstate=cstate,
                          grad_accum=grad_accum), metrics

    return step


def _fold_and_reduce(grads, loss, state: TrainState, accum: int,
                     mesh: Optional[Mesh]):
    """A full step's gradient and loss before the clip: the accumulated
    micro-steps folded in (a ``uvc.optimizer`` span of its own), then,
    given a mesh, averaged over the data group (``uvc.all_reduce``): the
    global batch's gradient, before the clip (its norm) and the
    architecture update (the gating gradient)."""
    if accum > 1:
        with span("uvc.optimizer"):
            grads = tree_map(lambda a, g: a + g / accum,
                             gather_params(state.grad_accum, mesh), grads)
    if mesh is not None:
        with span("uvc.all_reduce"):
            grads, loss = all_reduce_mean(grads, mesh, loss)
    return grads, loss


def _zero_subtrees(tree: dict, paths) -> dict:
    """``tree`` with the subtree at each key path of ``paths`` zeroed (a
    path that is absent is skipped); only the dicts on the way are
    copied."""
    for path in paths:
        tree = _zero_at(tree, path)
    return tree


def _zero_at(tree: dict, path) -> dict:
    key = path[0]
    if key not in tree:
        return tree
    sub = (tree_map(torch.zeros_like, tree[key]) if len(path) == 1
           else _zero_at(tree[key], path[1:]))
    return dict(tree, **{key: sub})


def _stage2_step(thp: TrainHParams, loss_fn, *, frozen_grads=(),
                 frozen_updates=(), micro: bool = False,
                 mesh: Optional[Mesh] = None):
    """The stage-2 update around ``loss_fn(params, teacher_params, masks,
    x, targets, labels)``: mixup, the loss and its gradient, the
    accumulation, the all-reduce over ``mesh``'s ranks, the gradients at
    ``frozen_grads`` zeroed before the clip, clip, the weight optimizer,
    the updates at ``frozen_updates`` (and of ``prm_w``) zeroed.  Shared
    by the dense step and the compact one (``train/compact_ft.py``)."""
    tx = make_weight_optimizer(thp)
    lr_fn = thp.lr_schedule()
    accum = thp.accum_steps
    mp = model_axis(mesh)

    def step(state: TrainState, teacher_params, masks, x: torch.Tensor,
             labels: torch.Tensor, noise: Stage2Noise):
        with span("uvc.step"):
            return _step(state, teacher_params, masks, x, labels, noise)

    def _step(state, teacher_params, masks, x, labels, noise):
        x, targets = _mixed(x, labels, noise.mixup, thp, mesh)
        teacher = gather_params(teacher_params, mesh)
        loss, grads = _value_and_grad(
            lambda params: loss_fn(params, teacher, masks, x, targets,
                                   labels), gather_params(state.params, mesh))
        with torch.no_grad():
            if micro:
                with span("uvc.optimizer"):
                    new_accum = tree_map(lambda a, g: a + g / accum,
                                         state.grad_accum,
                                         shard_params(grads, mesh, mp))
                return state.replace(grad_accum=new_accum), {"loss": loss}
            grads, loss = _fold_and_reduce(grads, loss, state, accum, mesh)
            with span("uvc.optimizer"):
                grads = _zero_subtrees(grads, frozen_grads)
                grads, grad_norm = clip_global_norm(grads,
                                                    thp.max_grad_norm)
                updates, opt_state = tx.update(shard_params(grads, mesh, mp),
                                               state.opt_state, state.params)
                # weight decay would otherwise still move the frozen leaves
                updates = _zero_subtrees(zero_frozen_updates(updates),
                                         frozen_updates)
                params = tree_map(lambda p, u: p + u, state.params, updates)
        grad_accum = state.grad_accum
        if accum > 1:
            grad_accum = tree_map(torch.zeros_like, state.grad_accum)
        metrics = {"loss": loss, "grad_norm": grad_norm,
                   "lr": lr_fn(state.step)}
        return state.replace(step=state.step + 1, params=params,
                             opt_state=opt_state,
                             grad_accum=grad_accum), metrics

    return step


def build_stage2_step(cfg: ViTConfig, hp: MinimaxHParams, thp: TrainHParams,
                      *, micro: bool = False, mesh: Optional[Mesh] = None):
    """Returns the mask-frozen distillation fine-tune step ``step(state,
    teacher_params, masks, x, labels, noise) -> (state', metrics)``,
    ``noise`` a ``Stage2Noise``; metrics ``loss``, ``grad_norm``, ``lr``.

    The masks act on the activations every step.  The block gating is
    frozen to its hard decision ``keep = g1 > g0``, passed as the detached
    one-hot distribution ``(1 - keep, keep)``, so a skipped block's blend
    passes its input through and every gradient into the block is exactly
    zero.  With ``hp.enable_patch_gating == 2`` the student drops tokens
    physically by the deterministic top-k of the frozen scorer (the
    serving semantics); the T2T forward ignores the token arguments.  The
    ``block_gating`` gradient is zeroed before the clip, and its update
    (and, under token selection, the ``token_scorer`` updates) after the
    optimizer, as is ``prm_w``'s.  ``micro=True`` is the
    gradient-accumulation micro-step and ``mesh`` a data-parallel rank's
    step, as in ``build_stage1_step``.  The new state holds new tensors;
    ``state`` is not modified."""
    model = get_model(cfg)
    mode = 2 if hp.enable_patch_gating == 2 else 0

    def loss_fn(params, teacher_params, masks, x, targets, labels):
        with span("uvc.forward"):
            g = params["block_gating"].detach()
            keep = (g[:, 1] > g[:, 0]).float()
            out = model.apply(
                params, x, cfg,
                gating_distrib=torch.stack([1.0 - keep, keep], dim=-1),
                masks=masks, patch_gate_mode=mode,
                patch_ratio=hp.patch_ratio, patch_physical=True, train=True,
                dtype=thp.compute_dtype)
        return _distilled_loss(out, x, targets, labels, teacher_params, cfg,
                               thp)

    frozen = (("block_gating",),) + ((("token_scorer",),) if mode == 2
                                     else ())
    return _stage2_step(thp, loss_fn, frozen_grads=(("block_gating",),),
                        frozen_updates=frozen, micro=micro, mesh=mesh)


@torch.no_grad()
def eval_step(params: dict, masks: Optional[Dict[str, torch.Tensor]],
              x: torch.Tensor, labels: torch.Tensor, cfg: ViTConfig,
              hp: MinimaxHParams, *, dtype=torch.bfloat16
              ) -> Dict[str, torch.Tensor]:
    """Validation step: the hard-gated forward (``keep = g1 > g0`` as the
    block-gating distribution when ``hp.enable_block_gating``), masks
    applied unless ``masks`` is None, and the deterministic top-k token
    drop applied physically.  Returns the top-1 ``correct`` count, the
    summed cross-entropy ``loss_sum`` and the ``count`` of rows; rows
    labelled -1 are padding and leave all three untouched."""
    gating_distrib = None
    if hp.enable_block_gating:
        g = params["block_gating"]
        keep = (g[:, 1] > g[:, 0]).float()
        gating_distrib = torch.stack([1.0 - keep, keep], dim=-1)
    tau = 1.0 if hp.enable_patch_gating == 2 else -1.0
    model = get_model(cfg)
    out = model.apply(params, x, cfg, gating_distrib=gating_distrib,
                      masks=masks, tau=tau, patch_ratio=hp.patch_ratio,
                      patch_gate_mode=hp.enable_patch_gating,
                      patch_hard=True, patch_physical=True, rng=None,
                      train=False, dtype=dtype)
    logits = model.eval_logits(out, cfg)
    valid = labels >= 0
    safe = labels.clamp(min=0)
    nll = -torch.log_softmax(logits, dim=-1).gather(
        -1, safe[:, None])[:, 0]
    correct = (logits.argmax(dim=-1) == labels) & valid
    return {"correct": correct.sum(),
            "loss_sum": torch.where(valid, nll, torch.zeros_like(nll)).sum(),
            "count": valid.sum()}
