"""Stage-1 CLI: joint UVC training, then the inline stage-2 fine-tune
(counterpart of ``uvc_tpu/cli/joint_train.py``).

  python -m uvc_tpu_torch.cli.joint_train \\
      --model_type deit_small_patch16_224 --dataset imagenet \\
      --data_dir /data/imagenet --budget 0.5 --num_epochs 30 \\
      --warmup_epochs 5 --train_batch_size 512

The flags are the JAX package's (``cli/flags.py``) plus ``--device``: the
run computes on the card unless ``--device cpu`` is given.

Across GPUs, one process per GPU, started by torchrun or by
``cli/slurm_launch.py`` (or by hand with ``--coordinator host:port
--num_processes N --process_id r``):

  torchrun --nproc_per_node 8 -m uvc_tpu_torch.cli.joint_train ...

``--train_batch_size`` is the global batch; each data-parallel shard
loads its share.  ``--mp M`` splits the world of ``dp x M`` ranks into
model groups of M that share a batch shard and split the blocks' weights
(``parallel/mesh.py``); ``--dp`` defaults to the world size over M.
"""

from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from uvc_tpu_torch.cli import flags
from uvc_tpu_torch.configs import get_config


def setup_mesh(args):
    """Join the ranks (``parallel/mesh.py::initialize_multihost`` from
    ``--coordinator`` / ``--num_processes`` / ``--process_id`` or
    torchrun's environment) and return the ``--dp x --mp`` mesh: one
    when the process group is up or ``--dp`` / ``--mp`` ask for one, none
    under ``--dp 1 --mp 1`` in one process.  ``--dp * --mp`` other than
    the world size raises ValueError."""
    from uvc_tpu_torch.parallel.mesh import initialize_multihost, make_mesh
    initialize_multihost(args.coordinator, args.num_processes,
                         args.process_id, device=args.device)
    up = dist.is_initialized()
    single = args.dp == 1 and args.mp == 1
    if not (up or args.dp is not None or args.mp > 1) or \
            (single and not (up and dist.get_world_size() > 1)):
        return None
    mesh = make_mesh(dp=args.dp, mp=args.mp)
    print(f"Mesh: {mesh.shape} (rank {mesh.rank})")
    return mesh


def shutdown() -> None:
    """Leave the process group, if one was formed."""
    if dist.is_initialized():
        dist.destroy_process_group()


def build_loaders(args, num_classes: int, img_size: int, mesh=None):
    """The train and test loaders of ``--dataset``, each rank loading the
    shard of its data index (the ranks of a model group load the same
    rows)."""
    from uvc_tpu_torch.data.pipeline import (ArrayLoader, FolderLoader,
                                             ProceduralLoader,
                                             SyntheticLoader, cifar_arrays)
    if mesh is not None:
        pid, pcount = mesh.data_index, mesh.dp
    elif dist.is_initialized():
        pid, pcount = dist.get_rank(), dist.get_world_size()
    else:
        pid, pcount = 0, 1
    per_host_train = args.train_batch_size // pcount
    if args.dataset == "procedural":
        train = ProceduralLoader(per_host_train,
                                 num_batches=args.synthetic_steps,
                                 img_size=img_size,
                                 num_classes=num_classes, train=True,
                                 seed=args.seed, pid=pid, pcount=pcount)
        test = ProceduralLoader(args.eval_batch_size, num_batches=8,
                                img_size=img_size, num_classes=num_classes,
                                train=False, seed=args.seed)
        return train, test
    if args.dataset == "synthetic":
        train = SyntheticLoader(per_host_train,
                                num_batches=args.synthetic_steps,
                                img_size=img_size, num_classes=num_classes,
                                seed=args.seed)
        test = SyntheticLoader(args.eval_batch_size, num_batches=4,
                               img_size=img_size, num_classes=num_classes,
                               seed=args.seed + 1)
        return train, test
    if args.dataset in ("cifar10", "cifar100"):
        xtr, ytr = cifar_arrays(args.data_dir, args.dataset, train=True)
        xte, yte = cifar_arrays(args.data_dir, args.dataset, train=False)
        train = ArrayLoader(xtr, ytr, per_host_train, train=True,
                            img_size=img_size, seed=args.seed, pid=pid,
                            pcount=pcount)
        test = ArrayLoader(xte, yte, args.eval_batch_size, train=False,
                           img_size=img_size, pid=pid, pcount=pcount)
        return train, test
    train = FolderLoader(os.path.join(args.data_dir, "train"),
                         per_host_train, train=True, img_size=img_size,
                         seed=args.seed, num_workers=args.num_workers,
                         pid=pid, pcount=pcount)
    test = FolderLoader(os.path.join(args.data_dir, "val"),
                        args.eval_batch_size, train=False,
                        img_size=img_size, num_workers=args.num_workers,
                        pid=pid, pcount=pcount)
    return train, test


def load_weights(path: str, cfg):
    """The parameter tree of a weights file, on the CPU: a ``.ckpt`` of
    either package (its ``params``, lists rebuilt), an upstream ViT or
    R50+ViT ``.npz``, else a timm / torch ``.pth`` (both through
    ``models/convert.py``)."""
    from uvc_tpu_torch.models import convert
    from uvc_tpu_torch.utils.checkpoint import load_checkpoint, params_of
    if path.endswith(".ckpt"):
        return params_of(load_checkpoint(path))
    if path.endswith(".npz"):
        return convert.load_npz_checkpoint(path, cfg)
    return convert.load_torch_checkpoint(path, cfg)


def load_params(args, cfg, generator=None):
    """The weights of ``--model_path`` (``load_weights``) or, without it,
    a model drawn from ``generator`` (seeded from ``--seed``) on
    ``--device``."""
    from uvc_tpu_torch.models import get_model
    if args.pretrained and args.model_path:
        return load_weights(args.model_path, cfg)
    generator = generator or torch.Generator().manual_seed(args.seed)
    return get_model(cfg).init_params(
        generator, cfg,
        patch_gating=getattr(args, "enable_patch_gating", 0) == 1,
        device=args.device)


def load_teacher(args, cfg, params):
    """The distillation teacher: ``--teacher-path`` (else
    ``--model_path``) when distilling, else the student's weights."""
    teacher_path = args.teacher_path or args.model_path
    if args.distillation_type != "none" and teacher_path:
        t_args = argparse.Namespace(**vars(args))
        t_args.model_path = teacher_path
        return load_params(t_args, cfg)
    return params


def main(argv=None):
    parser = argparse.ArgumentParser("uvc_tpu_torch stage-1 joint training")
    flags.add_common_flags(parser)
    flags.add_uvc_flags(parser)
    args = flags.parse_with_config(parser, argv)
    mesh = setup_mesh(args)
    try:
        _run(args, mesh)
    finally:
        shutdown()


def _run(args, mesh):
    num_classes = flags.num_classes_for(args.dataset)
    if args.img_size is None:
        args.img_size = get_config(args.model_type).img_size
    cfg = get_config(args.model_type).replace(
        img_size=args.img_size, num_classes=num_classes,
        distilled=bool(args.enable_deit))

    train_loader, test_loader = build_loaders(args, num_classes,
                                              args.img_size, mesh)
    hp = flags.to_hparams(args)
    thp = flags.to_train_hparams(args, len(train_loader), num_classes)

    params = load_params(args, cfg)
    teacher = load_teacher(args, cfg, params)

    from uvc_tpu_torch.train.stage1 import run_stage1
    from uvc_tpu_torch.utils import profiler as prof
    from uvc_tpu_torch.utils.logging import MetricLogger
    logger = MetricLogger(args.output_dir, args.name,
                          enable_tensorboard=bool(args.enable_writer))
    try:
        logger.info(f"Training parameters {args}")
        profiler = prof.from_args(args, logger)
        result = run_stage1(cfg, hp, thp, train_loader=train_loader,
                            test_loader=test_loader, params=params,
                            teacher_params=teacher, seed=args.seed,
                            output_dir=args.output_dir, name=args.name,
                            log_interval=args.log_interval,
                            resume=args.resume, mesh=mesh, mp=args.mp,
                            use_orbax=bool(args.use_orbax),
                            steps_per_launch=args.steps_per_launch,
                            logger=logger, profiler=profiler,
                            device=args.device)

        # inline stage 2 (reference: joint_train.py:1032-1033)
        from uvc_tpu_torch.train.stage2 import run_stage2
        thp2 = flags.to_train_hparams(args, len(train_loader), num_classes,
                                      stage2=True)
        run_stage2(cfg, hp, thp2, params=result.state.params,
                   masks=result.masks, teacher_params=teacher,
                   train_loader=train_loader, test_loader=test_loader,
                   seed=args.seed,
                   output_dir=args.output_dir, name=args.name + "_post",
                   eval_every=args.eval_every, mesh=mesh, mp=args.mp,
                   world_batch=args.train_batch_size,
                   steps_per_launch=args.steps_per_launch, logger=logger,
                   device=args.device)
    finally:
        logger.close()


if __name__ == "__main__":
    main()
