"""Stage-2 driver: mask-frozen distillation fine-tuning (counterpart of
``uvc_tpu/train/stage2.py``).

Takes stage 1's params and masks, scales the learning rate linearly by
the global batch / 512, and fine-tunes with soft distillation while the
architecture stays fixed: the dense step (``train/step.py::
build_stage2_step``, the masks on the activations) or, with
``compact=True``, the physically sliced one (``train/compact_ft.py``),
whose checkpoints and validation stay in the dense layout through
``scatter_to_dense``.  The only draws are the mixup's, one
``train/step.py::draw_stage2_noise`` a batch from a CPU generator seeded
from ``seed`` for the first epoch and from the previous epoch's
checkpoint's ``key_seed`` for each later one (and on resume), looked up
at call time so that a test can feed the JAX driver's key chain instead.

With a ``mesh`` (``parallel/mesh.py``) the run is one rank of a
data-parallel run, as in ``train/stage1.py``: the global batch is the
loader's batch times the data-parallel ranks, the state (dense or
compact), teacher and masks are broadcast from rank 0, the eval totals
are summed over the data group and rank 0 writes the checkpoints.  With a
model axis (``mp > 1``) the dense run keeps each rank's shard of the
tensor-parallel leaves of the state and the teacher, and gathers the
weights for eval, the checkpoints and the result; the compact run takes
data-parallel meshes only and raises ValueError, as the JAX driver does.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Any, Optional

import torch

from uvc_tpu_torch.compress.state import MinimaxHParams
from uvc_tpu_torch.configs import ViTConfig
from uvc_tpu_torch.data.pipeline import device_prefetch, normalize_on_device
from uvc_tpu_torch.interop import resolve_device
from uvc_tpu_torch.train import step as step_mod
from uvc_tpu_torch.parallel.mesh import (check_model_axis, gather_params,
                                         replicate, shard_params)
from uvc_tpu_torch.train.stage1 import (copy_tree, eval_fn_for,
                                        run_validation)
from uvc_tpu_torch.train.state import (TrainHParams, create_train_state,
                                       gather_state,
                                       opt_state_from_state_dict,
                                       opt_state_to_state_dict,
                                       shard_state)
from uvc_tpu_torch.utils.checkpoint import (CheckpointManager,
                                            load_checkpoint, restore_like,
                                            save_checkpoint)
from uvc_tpu_torch.utils.logging import AverageMeter, MetricLogger
from uvc_tpu_torch.utils.tree import tree_map


@dataclasses.dataclass
class Stage2Result:
    state: Any
    best_acc: float


def run_stage2(cfg: ViTConfig, hp: MinimaxHParams, thp: TrainHParams, *,
               params, masks, teacher_params=None, train_loader,
               test_loader, seed: int = 42, output_dir: str = "output",
               name: str = "post", eval_every: int = 1000,
               world_batch: Optional[int] = None,
               save_checkpoints: bool = True, mesh=None, mp: int = 1,
               steps_per_launch: int = 1, resume: Optional[str] = None,
               use_orbax: bool = False, compact: bool = False,
               logger: Optional[MetricLogger] = None,
               profiler=None, device="cuda") -> Stage2Result:
    """Stage 2 on ``device`` (the card unless the caller asks for the
    CPU).  ``compact=True`` fine-tunes the physically compacted model:
    the skipped blocks removed, the pruned heads sliced out, the kept MLP
    units padded to a multiple of 128; the checkpoints hold the dense
    layout (``scatter_to_dense``) and its compact-shaped optimizer state,
    so a compact run resumes with ``compact=True``, re-slicing the
    restored dense params.  ``mesh`` makes the run one rank of a
    data-parallel run, and with ``mp > 1`` (the mesh's model axis) of a
    tensor-parallel one (see the top); ``world_batch`` defaults to the
    global batch, the loader's batch times the data-parallel ranks."""
    check_model_axis(mesh, mp)
    if compact and mesh is not None and mp > 1:
        raise ValueError("compact stage-2 supports data-parallel "
                         "meshes only (mp == 1)")
    world = 1 if mesh is None else mesh.dp
    dev = resolve_device(device)
    logger = logger or MetricLogger(output_dir, name)
    if teacher_params is None:
        teacher_params = params
    teacher_params = tree_map(lambda t: t.to(dev), teacher_params)
    params = tree_map(lambda t: t.to(dev), params)
    masks = tree_map(lambda t: t.to(dev), masks)
    if mesh is not None:
        # rank 0's, before the compact tree and the dense template are cut
        params, teacher_params, masks = replicate(
            (params, teacher_params, masks), mesh)

    # linear lr scaling: lr * global_batch / 512 (post_train.py:297-302)
    if world_batch is None:
        world_batch = train_loader.batch_size * world
    thp = dataclasses.replace(
        thp, learning_rate=thp.learning_rate * world_batch / 512.0)

    cmeta = None
    if compact:
        from uvc_tpu_torch.train.compact_ft import (compact_train_tree,
                                                    scatter_to_dense)
        dense_template = copy_tree(params)
        ctree, cmeta = compact_train_tree(params, masks, cfg)

        def to_dense(p):
            return scatter_to_dense(p, cmeta, dense_template)

        state = create_train_state(ctree, thp, None)
        logger.info(
            f"[compact] training {len(ctree['layers'])} of "
            f"{len(cmeta.block_keep)} blocks at sliced shapes")
    else:
        def to_dense(p):
            return p

        # the state owns copies: the caller keeps its tensors
        state = create_train_state(copy_tree(params), thp, None)
    start_epoch = 0
    resumed_step = 0
    resumed_best = 0.0
    gen = torch.Generator().manual_seed(int(seed))
    if resume:
        # full mid-run resume: weights, optimizer moments, progress and the
        # best accuracy
        ck = (CheckpointManager(resume).restore() if os.path.isdir(resume)
              else load_checkpoint(resume))
        if compact:
            # checkpoints are dense-layout: re-slice the restored params;
            # the optimizer state was saved compact-shaped by this mode
            restored, _ = compact_train_tree(
                restore_like(dense_template, ck["params"]), masks, cfg)
        else:
            restored = restore_like(state.params, ck["params"])
        state = state.replace(
            step=int(ck["global_step"]), params=restored,
            opt_state=opt_state_from_state_dict(ck["opt_state"],
                                                state.opt_state))
        start_epoch = int(ck.get("epoch", -1)) + 1
        resumed_step = int(ck.get("global_step", 0))
        resumed_best = float(ck.get("best_acc", 0.0))
        gen = torch.Generator().manual_seed(int(ck.get("key_seed", seed)))
        logger.info(f"Resumed stage-2 from {resume} at epoch {start_epoch} "
                    f"(step {resumed_step}, best {resumed_best:.4f})")
    if mesh is not None:
        state = replicate(state, mesh)
        state = shard_state(state, mesh, mp)
        teacher_params = shard_params(teacher_params, mesh, mp)
    gas = max(1, thp.accum_steps)
    if compact:
        from uvc_tpu_torch.train.compact_ft import build_compact_stage2_step
        _build = functools.partial(build_compact_stage2_step,
                                   cfg, hp, thp, cmeta, mesh=mesh)
    else:
        _build = functools.partial(step_mod.build_stage2_step, cfg, hp, thp,
                                   mesh=mesh)
    step_fn = _build()
    micro_fn = _build(micro=True) if gas > 1 else None
    if steps_per_launch > 1:
        logger.info("steps_per_launch ignored (the eager step has no "
                    "multi-step program)")
    eval_fn = eval_fn_for(cfg, hp, thp, masked=True)

    ck_mgr = None
    if save_checkpoints and use_orbax:
        ck_mgr = CheckpointManager(f"{logger.dir}/checkpoints")

    best_acc = resumed_best
    global_step = resumed_step
    losses = AverageMeter()
    metrics = None

    def validate():
        nonlocal best_acc
        dense = to_dense(gather_params(state.params, mesh))
        acc = run_validation(eval_fn, dense, masks, test_loader, logger,
                             global_step, device=dev, mesh=mesh)
        if acc > best_acc:
            best_acc = acc
            if save_checkpoints:
                save_checkpoint(
                    f"{logger.dir}/{cfg.name}_best.ckpt",
                    {"params": dense, "masks": masks,
                     "step": global_step, "acc": acc})

    logger.info("***** [Stage 2] Post Training *****")
    for epoch in range(start_epoch, thp.num_epochs):
        train_loader.set_epoch(epoch)
        t0 = time.time()
        for bi, (x, y) in enumerate(device_prefetch(iter(train_loader),
                                                    device=dev)):
            if profiler is not None:
                profiler.step(global_step)
            noise = step_mod.shard_noise(step_mod.draw_stage2_noise(
                gen, cfg, thp, x.shape[0] * world, dev), thp, mesh)
            xb = normalize_on_device(x)
            y = y.long()
            if gas > 1 and (bi + 1) % gas != 0:
                state, _ = micro_fn(state, teacher_params, masks, xb, y,
                                    noise)
                continue
            state, metrics = step_fn(state, teacher_params, masks, xb, y,
                                     noise)
            global_step += 1
            if global_step % 50 == 0:
                losses.update(float(metrics["loss"]))
                logger.log_scalars(global_step, {
                    "train/loss": metrics["loss"],
                    "train/lr": metrics["lr"]})
            if (eval_every and global_step % eval_every == 0
                    and test_loader is not None):
                validate()
        if losses.count == 0 and metrics is not None:
            losses.update(float(metrics["loss"]))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.time() - t0
        logger.info(f"[Stage2 Epoch {epoch}] {dt:.1f}s loss {losses.avg:.4f}")
        losses.reset()

        if save_checkpoints:
            # resumable per-epoch state, symmetric with stage 1
            whole = gather_state(state, mesh)
            tree = {"params": to_dense(whole.params),
                    "compact": compact,
                    "opt_state": opt_state_to_state_dict(whole.opt_state),
                    "masks": masks, "epoch": epoch,
                    "global_step": global_step, "best_acc": best_acc,
                    "key_seed": seed + 10_000 + epoch}
            if ck_mgr is not None:
                ck_mgr.save(epoch, tree)
            else:
                save_checkpoint(
                    f"{logger.dir}/{cfg.name}_post_{epoch}.ckpt", tree)
        # the next epoch draws from this epoch's key_seed (see stage1.py)
        gen = torch.Generator().manual_seed(seed + 10_000 + epoch)

    if test_loader is not None:
        acc = run_validation(eval_fn,
                             to_dense(gather_params(state.params, mesh)),
                             masks, test_loader, logger, global_step,
                             device=dev, mesh=mesh)
        best_acc = max(best_acc, acc)
    if profiler is not None:
        profiler.close()
    state = gather_state(state, mesh)
    return Stage2Result(state=state, best_acc=best_acc)
