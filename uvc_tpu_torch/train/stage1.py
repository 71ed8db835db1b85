"""Stage-1 driver: joint weight + architecture training under a FLOPs
budget (counterpart of ``uvc_tpu/train/stage1.py``).

  epoch loop (host):
    - phase select (epochs <= warmup_epochs: frozen gating,
      distrib = (.5, .5), hard Gumbel draws)
    - zlr staircase and eps decay per UVC epoch
    - per batch: the stage-1 step (forward + KD + backward + AdamW + prox +
      minimax updates), or its accumulation micro-step
    - epoch end: masks rebuilt, the sparsity and Expectation / Real /
      argmax FLOPs report, validation, checkpoint.

Every random number comes from a CPU ``torch.Generator``: epoch 1's
seeded from ``seed``, each later epoch's from the ``key_seed`` that the
previous epoch's checkpoint records (``seed + epoch``), so that a run
resumed from a checkpoint draws what the uninterrupted run drew.  The
draws go through two functions looked up at call time: ``train/step.py::draw_stage1_noise``
for each step and ``draw_report_noise`` for the epoch-end report, so that
a test can feed the JAX driver's key chain in their place.  The step runs
eagerly: ``steps_per_launch`` (several steps in one program) has no
counterpart and is logged as ignored.

With a ``mesh`` (``parallel/mesh.py``) the run is one rank of a
data-parallel run: every rank resumes from the same file, the state and
the teacher are broadcast from rank 0 after the resume (as the JAX driver
places them on its mesh), each step is the rank's part of the global
batch's (``train/step.py``), the noise is the global batch's sharded by
rows, the eval totals are summed over the data group, and rank 0 writes
the checkpoints.  With a model axis (``mp > 1``) each rank then keeps its
shard of the tensor-parallel leaves of the state and the teacher
(``shard_params``); the epoch's masks, report, eval and checkpoint read
the gathered weights, so rank 0 writes the file a data-parallel run
writes, and the result holds the whole state.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Any, Optional

import torch

from uvc_tpu_torch.compress.masks import (build_masks, count_remaining_params,
                                          total_maskable_params)
from uvc_tpu_torch.compress.minimax import init_compression_state
from uvc_tpu_torch.compress.resource import (build_macs_table,
                                             flops2_fraction, flops_fraction)
from uvc_tpu_torch.compress.scores import group_scores
from uvc_tpu_torch.compress.state import MinimaxHParams
from uvc_tpu_torch.configs import ViTConfig
from uvc_tpu_torch.data.pipeline import device_prefetch, normalize_on_device
from uvc_tpu_torch.interop import host_to_device, resolve_device
from uvc_tpu_torch.models import get_model
from uvc_tpu_torch.ops.gumbel import block_gating_distrib, gumbel_noise
from uvc_tpu_torch.ops.stes import ste_ceil
from uvc_tpu_torch.parallel.mesh import (check_model_axis, gather_params,
                                         replicate, shard_params, sum_across)
from uvc_tpu_torch.train import step as step_mod
from uvc_tpu_torch.train.state import (TrainHParams, TrainState,
                                       create_train_state,
                                       cstate_from_state_dict,
                                       cstate_to_state_dict,
                                       gather_state,
                                       opt_state_from_state_dict,
                                       opt_state_to_state_dict,
                                       shard_state)
from uvc_tpu_torch.utils.checkpoint import (CheckpointManager,
                                            load_checkpoint, restore_like,
                                            save_checkpoint)
from uvc_tpu_torch.utils.logging import AverageMeter, MetricLogger
from uvc_tpu_torch.utils.schedules import get_tau
from uvc_tpu_torch.utils.tree import tree_map


def copy_tree(tree):
    """A tree of new tensors with the same values (the caller's tensors,
    such as a teacher that aliases the student's first weights, stay
    untouched)."""
    return tree_map(lambda t: t.detach().clone(), tree)


def draw_report_noise(generator: torch.Generator, cfg: ViTConfig,
                      hp: MinimaxHParams, device) -> Optional[torch.Tensor]:
    """The epoch-end report's one ``[L, 2]`` Gumbel draw, shared by its
    soft and hard samples of the block gating (None when the report
    draws nothing)."""
    if not (hp.flops_with_mhsa and hp.enable_block_gating
            and hp.use_gumbel):
        return None
    return host_to_device(gumbel_noise(generator, (cfg.depth, 2)), device)


@torch.no_grad()
def expectation_and_real_flops(params, cstate, cfg: ViTConfig,
                               hp: MinimaxHParams, table, noise):
    """The epoch-end report: one soft ("expectation") and one hard-gated
    ("real") resource evaluation from the same Gumbel draw ``noise``, and
    the deterministic argmax gating's value ("real_argmax", ``keep = g1 >
    g0``: the FLOPs of the architecture stage 2 extracts)."""
    _, scores2, _ = group_scores(params["blocks"], cfg.num_heads)
    gating = params.get("block_gating")
    s, r = ste_ceil(cstate.s), ste_ceil(cstate.r)

    if not hp.flops_with_mhsa:
        # the flops2 alternative is deterministic (gating / eps invariant)
        f = float(flops2_fraction(s, r, scores2, cfg))
        return f, f, f

    def frac(distrib):
        return float(flops_fraction(s, r, scores2, distrib, table, cfg))

    if hp.enable_block_gating and gating is not None:
        def sample(hard):
            return block_gating_distrib(
                noise, gating, use_gumbel=hp.use_gumbel, gumbel_hard=hard,
                eps=cstate.eps, warmup=False)[:, 1]
        argmax_keep = (gating[:, 1] > gating[:, 0]).float()
        return frac(sample(False)), frac(sample(True)), frac(argmax_keep)
    return frac(1.0), frac(1.0), frac(1.0)


def eval_totals(eval_fn, params, masks, loader, device="cuda", mesh=None):
    """(correct, loss sum, count) of ``eval_fn(params, masks, x, labels)``
    (the counts of ``train/step.py::eval_step``) over ``loader``, summed
    on the device and read once; with a ``mesh``, summed over the ranks'
    shards in one all-reduce (padding rows, labelled -1, count nowhere)."""
    totals = None
    for x, y in device_prefetch(iter(loader), device=device):
        m = eval_fn(params, masks, normalize_on_device(x), y.long())
        totals = m if totals is None else {k: totals[k] + m[k]
                                           for k in totals}
    values = [0.0] * 3 if totals is None else torch.stack(
        [totals[k].double() for k in ("correct", "loss_sum", "count")]
    ).tolist()
    correct, loss_sum, count = sum_across(values, mesh)
    return int(correct), float(loss_sum), int(count)


def run_validation(eval_fn, params, masks, loader, logger, step: int,
                   device="cuda", mesh=None) -> float:
    """Top-1 accuracy of ``eval_totals`` over ``loader`` (over every
    rank's shard with a ``mesh``); logged as ``test/accuracy`` and
    ``test/loss``."""
    correct, loss_sum, count = eval_totals(eval_fn, params, masks, loader,
                                           device, mesh)
    acc = correct / max(1, count)
    logger.info(f"Validation @ step {step}: loss "
                f"{loss_sum / max(1, count):.5f} acc {acc * 100:.3f}%")
    logger.log_scalars(step, {"test/accuracy": acc,
                              "test/loss": loss_sum / max(1, count)})
    return acc


def eval_fn_for(cfg: ViTConfig, hp: MinimaxHParams, thp: TrainHParams, *,
                masked: bool):
    """The validation step of ``build_eval_step(..., masked=masked)``:
    ``eval_step`` in the compute dtype, the masks applied or not."""
    def fn(params, masks, x, labels):
        return step_mod.eval_step(params, masks if masked else None, x,
                                  labels, cfg, hp, dtype=thp.compute_dtype)
    return fn


@dataclasses.dataclass
class Stage1Result:
    state: TrainState
    masks: Any
    best_acc: float


def run_stage1(cfg: ViTConfig, hp: MinimaxHParams, thp: TrainHParams, *,
               train_loader, test_loader, params=None, teacher_params=None,
               seed: int = 42, output_dir: str = "output",
               name: str = "debug", log_interval: int = 2000,
               eval_each_epoch: bool = True, save_checkpoints: bool = True,
               resume: Optional[str] = None, mesh=None, mp: int = 1,
               use_orbax: bool = False, steps_per_launch: int = 1,
               logger: Optional[MetricLogger] = None,
               profiler=None, init_cstate=None,
               device="cuda") -> Stage1Result:
    """Stage 1 on ``device`` (the card unless the caller asks for the
    CPU).  ``params`` / ``teacher_params`` are copied, never changed;
    ``params=None`` draws a fresh model from the seeded generator.
    ``use_orbax`` keeps the checkpoints in a ``CheckpointManager``
    directory (``<run>/checkpoints``) instead of ``<name>_<epoch>.ckpt``
    files; ``resume`` takes either.  ``mesh`` (``parallel/mesh.py::
    make_mesh``) makes the run one rank of a data-parallel run, and with
    ``mp > 1`` (the mesh's model axis) of a tensor-parallel one (see the
    top)."""
    check_model_axis(mesh, mp)
    dev = resolve_device(device)
    logger = logger or MetricLogger(output_dir, name)
    table = build_macs_table(cfg)
    gen = torch.Generator().manual_seed(int(seed))

    if params is None:
        params = get_model(cfg).init_params(
            gen, cfg, patch_gating=hp.enable_patch_gating == 1, device=dev)
    if teacher_params is None:
        # the reference defaults the teacher to the same pretrained weights
        # (joint_train.py:949-952)
        teacher_params = params
    teacher_params = tree_map(lambda t: t.to(dev), teacher_params)

    # init_cstate: start from a caller-provided compression state;
    # --resume still takes precedence below
    cstate = (init_cstate if init_cstate is not None
              else init_compression_state(cfg, hp, dev))
    # the state owns copies: the caller's tensors routinely alias the
    # teacher and outlive stage 1
    state = create_train_state(
        copy_tree(tree_map(lambda t: t.to(dev), params)), thp, cstate)
    start_epoch = 1
    resumed_step = 0
    if resume:
        # full resume: weights, AdamW moments, every minimax variable and
        # optimizer trace, progress, and the draws re-seeded
        ck = (CheckpointManager(resume).restore() if os.path.isdir(resume)
              else load_checkpoint(resume))
        state = TrainState(
            step=int(ck["global_step"]),
            params=restore_like(state.params, ck["params"]),
            opt_state=opt_state_from_state_dict(ck["opt_state"],
                                                state.opt_state),
            cstate=cstate_from_state_dict(ck["cstate"], dev),
            grad_accum=state.grad_accum)
        start_epoch = int(ck.get("epoch", 0)) + 1
        resumed_step = int(ck.get("global_step", 0))
        gen = torch.Generator().manual_seed(int(ck.get("key_seed", seed)))
        logger.info(f"Resumed stage-1 from {resume} at epoch {start_epoch}")
    total_param = float(total_maskable_params(state.params))
    if mesh is not None:
        # after the resume, as the JAX driver places the restored state
        state, teacher_params = replicate((state, teacher_params), mesh)
        state = shard_state(state, mesh, mp)
        teacher_params = shard_params(teacher_params, mesh, mp)
    world = 1 if mesh is None else mesh.dp
    logger.info(f"** Initial FLOP size: {table.dense_flops / 2e6:.2f}M MACs "
                f"(dense {table.dense_flops / 1e6:.2f}M FLOPs)")

    gas = max(1, thp.accum_steps)
    steps_per_epoch = len(train_loader)
    # optimizer / arch updates (and the tau anneal) tick on accumulation
    # boundaries, not micro-batches
    t_total = (steps_per_epoch // gas) * thp.num_epochs
    if steps_per_launch > 1:
        logger.info("steps_per_launch ignored (the eager step has no "
                    "multi-step program)")
    build = functools.partial(step_mod.build_stage1_step, mesh=mesh)
    warm_step = build(cfg, table, hp, thp, warmup=True)
    uvc_step = build(cfg, table, hp, thp, warmup=False)
    if gas > 1:
        warm_micro = build(cfg, table, hp, thp, warmup=True, micro=True)
        uvc_micro = build(cfg, table, hp, thp, warmup=False, micro=True)
    eval_fn = eval_fn_for(cfg, hp, thp, masked=False)

    ck_mgr = None
    if save_checkpoints and use_orbax:
        ck_mgr = CheckpointManager(f"{logger.dir}/checkpoints")

    best_acc = 0.0
    global_step = resumed_step
    losses = AverageMeter()
    # built from the (possibly restored) cstate up front, so resuming from
    # a checkpoint whose epoch >= num_epochs still returns real masks
    masks = build_masks(gather_params(state.params, mesh),
                        ste_ceil(state.cstate.s), ste_ceil(state.cstate.r),
                        cfg)
    metrics = None

    for epoch in range(start_epoch, thp.num_epochs + 1):
        warmup = epoch <= thp.warmup_epochs
        stage = "Warm Up" if warmup else "UVC Train"
        step_fn = warm_step if warmup else uvc_step
        micro_fn = (warm_micro if warmup else uvc_micro) if gas > 1 else None
        train_loader.set_epoch(epoch)

        # masks rebuild + sparsity report at epoch start
        whole = gather_params(state.params, mesh)
        masks = build_masks(whole, ste_ceil(state.cstate.s),
                            ste_ceil(state.cstate.r), cfg)
        remained = float(count_remaining_params(whole, masks, cfg))
        logger.info("=" * 60)
        logger.info(f"Start [Epoch {epoch}] at Stage {stage}")
        logger.info(f"[Initial Sparsity|Epoch {epoch}] Parameter size: "
                    f"{remained / 1e6:.2f}M / {total_param / 1e6:.2f}M = "
                    f"{remained / total_param * 100:.2f}%")

        if not warmup:
            # eps decay and the zlr staircase
            cs = state.cstate
            state = state.replace(cstate=cs.replace(
                eps=cs.eps * hp.eps_decay,
                zlr=torch.full_like(cs.zlr, hp.zlr_for_epoch(
                    epoch, thp.num_epochs))))

        t0 = time.time()
        for bi, (x, y) in enumerate(device_prefetch(iter(train_loader),
                                                    device=dev)):
            if profiler is not None:
                profiler.step(global_step)
            noise = step_mod.shard_noise(step_mod.draw_stage1_noise(
                gen, cfg, hp, thp, x.shape[0] * world, dev), thp, mesh)
            tau = get_tau(10.0, 0.1, global_step, t_total) \
                if hp.enable_patch_gating == 2 else -1.0
            xb = normalize_on_device(x)
            y = y.long()
            if gas > 1 and (bi + 1) % gas != 0:
                # accumulate grads only; a trailing partial window at epoch
                # end carries into the next boundary
                state, _ = micro_fn(state, teacher_params, xb, y, noise, tau)
                continue
            state, metrics = step_fn(state, teacher_params, xb, y, noise,
                                     tau)
            global_step += 1
            if global_step % 50 == 0:
                losses.update(float(metrics["loss"]))
                logger.log_scalars(global_step, {
                    "train/loss": metrics["loss"],
                    "train/lr": metrics["lr"],
                    "resource": metrics["resource"],
                })
            if global_step % log_interval == 0 and not warmup:
                logger.log_series("s", global_step, state.cstate.s)
                logger.log_series("r", global_step, state.cstate.r)
                if hp.enable_block_gating:
                    logger.log_series("gating", global_step,
                                      state.params["block_gating"])
        if losses.count == 0 and metrics is not None:
            losses.update(float(metrics["loss"]))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.time() - t0
        imgs = steps_per_epoch * train_loader.batch_size * world
        logger.info(f"[Epoch {epoch}] {dt:.1f}s "
                    f"({imgs / max(dt, 1e-9):.1f} img/s) "
                    f"loss {losses.avg:.4f}")
        losses.reset()

        # the whole state: the masks, the report, eval and the checkpoint
        whole = gather_state(state, mesh)
        masks = build_masks(whole.params, ste_ceil(state.cstate.s),
                            ste_ceil(state.cstate.r), cfg)
        remained = float(count_remaining_params(whole.params, masks, cfg))
        exp_f, real_f, argmax_f = expectation_and_real_flops(
            whole.params, state.cstate, cfg, hp, table,
            draw_report_noise(gen, cfg, hp, dev))
        logger.info(f"[Validation Sparsity|Step {global_step}|Epoch {epoch}]")
        logger.info(f"Parameter size: {remained / 1e6:.2f}M / "
                    f"{total_param / 1e6:.2f}M = "
                    f"{remained / total_param * 100:.2f}%")
        logger.info(f"Expectation FLOPs: {exp_f * 100:.4f}% "
                    f"Real FLOPs: {real_f * 100:.4f}% "
                    f"(argmax {argmax_f * 100:.4f}%)")
        logger.log_scalars(global_step, {
            "train/param_size": remained / total_param,
            "train/flops_expectation": exp_f,
            "train/flops_real": real_f,
            "train/flops_real_argmax": argmax_f,
            "train/z": float(state.cstate.z),
        })

        if eval_each_epoch and test_loader is not None:
            acc = run_validation(eval_fn, whole.params, masks, test_loader,
                                 logger, global_step, device=dev, mesh=mesh)
            best_acc = max(best_acc, acc)

        if save_checkpoints:
            # the full resumable state: AdamW moments, the minimax
            # optimizers' traces, the gating accumulator
            tree = {"params": whole.params,
                    "cstate": cstate_to_state_dict(state.cstate),
                    "opt_state": opt_state_to_state_dict(whole.opt_state),
                    "masks": masks, "epoch": epoch, "step": global_step,
                    "global_step": global_step, "key_seed": seed + epoch}
            if ck_mgr is not None:
                ck_mgr.save(epoch, tree)
            else:
                save_checkpoint(f"{logger.dir}/{cfg.name}_{epoch}.ckpt",
                                tree)
        # the next epoch draws from this epoch's key_seed, as a run
        # resumed from its checkpoint does: a resumed run repeats the
        # uninterrupted one's draws
        gen = torch.Generator().manual_seed(seed + epoch)

    if profiler is not None:
        profiler.close()
    state = gather_state(state, mesh)
    return Stage1Result(state=state, masks=masks, best_acc=best_acc)
